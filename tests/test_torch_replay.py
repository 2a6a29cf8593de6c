"""Kernel X1's replay on the CPU (`ops/align_tpu.py`): `replay_plain`,
which turns the traceback's moves into the gapped rows and path
lengths, against the JAX package's `align_batch` (whose numpy replay it
replaces) and `align_pair`; its edge cases (single bases, all-up and
all-left paths, a path of exactly L moves, the ladder's padding rows, L
off every 16 and 32); the CPU model of the kernel's warp walk
(`replay_warp_model`: 16-byte chunks for the first 3, ballot prefixes
over chunks of REPLAY_SUB x 32 positions) array-equal to it at every
chunk boundary; and the one buffer that brings the rows to the host.
All comparisons are exact. The kernel itself is held against the same
plain version in tests/test_torch_cuda.py."""

import random

import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import align_tpu as j_align
from pbdagcon_tpu.simulate import NoiseProfile, random_seq, sample_read
from pbdagcon_tpu_torch.aligner import align_pair
from pbdagcon_tpu_torch.ops import align_tpu

CHUNK = 32 * align_tpu.REPLAY_SUB


def _pairs(seed, n, lo=1, hi=300):
    rng = random.Random(seed)
    noise = NoiseProfile(sub=0.05, ins=0.12, dele=0.08)
    out = []
    for _ in range(n):
        t = random_seq(rng, rng.randint(lo, hi))
        q, _ = sample_read(rng, t, 0, len(t), noise)
        out.append((q.replace("-", "") or "A", t))
    return out


def _moves(pairs):
    """The prepared batch, its tensors and its moves (the plain scan and
    traceback)."""
    p = align_tpu.prepare_batch(pairs)
    args = [torch.from_numpy(p[k]) for k in ("qb", "tb_pad", "m", "n", "bw")]
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    mv = align_tpu.traceback_plain(packed, args[2], args[3], M, Wa, dmin, L)
    return p, args, mv


def _decode(gq, gt, plen, B):
    return [(bytes(gq[r, :ln].tolist()).decode(),
             bytes(gt[r, :ln].tolist()).decode())
            for r, ln in enumerate(plen[:B].tolist())]


def _hold_model(mv, qb, tb, m, n, dmin):
    """The warp model against the plain version; returns the latter."""
    want = align_tpu.replay_plain(mv, qb, tb, m, n, dmin)
    got = align_tpu.replay_warp_model(mv, qb, tb, m, n, dmin)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return want


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_replay_rows_equal_the_jax_batch_and_align_pair(seed):
    pairs = _pairs(seed, random.Random(seed).randint(1, 40))
    p, args, mv = _moves(pairs)
    gq, gt, plen = align_tpu.replay_plain(mv, args[0], args[1], args[2],
                                          args[3], p["dmin"])
    assert gq.shape == gt.shape == (len(p["m"]), p["L"])
    assert gq.dtype == gt.dtype == torch.uint8 and plen.dtype == torch.int32
    got = _decode(gq, gt, plen, p["B"])
    assert got == j_align.align_batch(pairs)
    assert got == [align_pair(q, t) for q, t in pairs]
    # Past each path the rows are 0.
    past = torch.arange(p["L"])[None] >= plen[:, None]
    assert not gq[past].any() and not gt[past].any()


def test_replay_single_bases_and_the_ladder_padding():
    """Length-1 pairs; 37 pairs padded to B = 64 (m = n = 1, zero
    bases): the padding rows replay too, and only the real rows come
    back from `fetch_gapped`."""
    pairs = [("A", "A"), ("A", "C"), ("G", "TTA"), ("CGT", "G")]
    pairs += _pairs(31, 33)
    p, args, mv = _moves(pairs)
    assert len(p["m"]) == 64 and p["B"] == 37
    want = _hold_model(mv, args[0], args[1], args[2], args[3], p["dmin"])
    assert (want[2][37:] == 1).all()
    assert _decode(*want, 37) == [align_pair(q, t) for q, t in pairs]
    flat = align_tpu.device_replay(p, "cpu")
    assert align_tpu.fetch_gapped(flat, p) == _decode(*want, 37)


@pytest.mark.parametrize("kind", ["all-up", "all-left", "exact-L"])
def test_replay_one_kind_of_move(kind):
    """A path of up moves only (n = 0), of left moves only (m = 0), and
    of L diagonal moves with no 3 after them (plen = L)."""
    rng = np.random.default_rng(7)
    L, M, T, dmin = 300, 300, 400, -64
    lens = [1, 5, 31, 32, 33, 127, 128, 129, 299, 300]
    B = len(lens)
    qb = torch.from_numpy(rng.integers(65, 91, (B, M)).astype(np.uint8))
    tb = torch.from_numpy(rng.integers(65, 91, (B, T)).astype(np.uint8))
    mv = torch.full((B, L), 3, dtype=torch.uint8)
    move = {"all-up": 1, "all-left": 2, "exact-L": 0}[kind]
    for r, k in enumerate(lens):
        mv[r, : (L if kind == "exact-L" else k)] = move
    ks = torch.tensor(lens, dtype=torch.int32)
    full = torch.full((B,), L, dtype=torch.int32)
    zero = torch.zeros(B, dtype=torch.int32)
    m, n = {"all-up": (ks, zero), "all-left": (zero, ks),
            "exact-L": (full, full)}[kind]
    gq, gt, plen = _hold_model(mv, qb, tb, m, n, dmin)
    for r, k in enumerate(lens):
        k = L if kind == "exact-L" else k
        assert plen[r] == k
        q = bytes(qb[r, :k].tolist())
        t = bytes(tb[r, 1 - dmin: 1 - dmin + k].tolist())
        want = {"all-up": (q, b"-" * k), "all-left": (b"-" * k, t),
                "exact-L": (q, t)}[kind]
        assert (bytes(gq[r, :k].tolist()), bytes(gt[r, :k].tolist())) == want


@pytest.mark.parametrize("L", [1, 17, 37, 130, 600])
def test_replay_warp_model_at_chunk_boundaries(L):
    """Paths ending on either side of every 16-byte chunk, 512-byte
    round and REPLAY_SUB x 32 walk chunk (and at L: no 3), moves past
    the first 3 of any value, L off 16 and 32; m and n the path's own
    counts on even rows, one off on odd rows (plen -1)."""
    rng = np.random.default_rng(L)
    ends = sorted({min(e, L) for e in (
        0, 1, 15, 16, 17, 31, 32, 33, CHUNK - 1, CHUNK, CHUNK + 1,
        511, 512, 513, L - 1, L)})
    B, M, T, dmin = 2 * len(ends), 700, 800, -64
    mv = torch.from_numpy(rng.integers(0, 3, (B, L)).astype(np.uint8))
    junk = torch.from_numpy(rng.integers(0, 256, (B, L)).astype(np.uint8))
    m = torch.zeros(B, dtype=torch.int32)
    n = torch.zeros(B, dtype=torch.int32)
    for r in range(B):
        e = ends[r // 2]
        if e < L:
            mv[r, e] = 3
            mv[r, e + 1:] = junk[r, e + 1:]
        path = mv[r, :e]
        m[r] = int((path != 2).sum()) + r % 2
        n[r] = int((path != 1).sum())
    qb = torch.from_numpy(rng.integers(65, 91, (B, M)).astype(np.uint8))
    tb = torch.from_numpy(rng.integers(65, 91, (B, T)).astype(np.uint8))
    gq, gt, plen = _hold_model(mv, qb, tb, m, n, dmin)
    want = torch.tensor([-1 if r % 2 else ends[r // 2] for r in range(B)],
                        dtype=torch.int32)
    assert torch.equal(plen, want)


def test_replay_clamps_indices_to_the_row():
    """Random moves whose paths take more bases than the rows hold: the
    index past the row reads its last byte, in both versions."""
    rng = np.random.default_rng(3)
    B, L, M, T, dmin = 9, 200, 8, 12, -4
    mv = torch.from_numpy(rng.choice(4, (B, L), p=(0.4, 0.3, 0.25, 0.05))
                          .astype(np.uint8))
    qb = torch.from_numpy(rng.integers(65, 91, (B, M)).astype(np.uint8))
    tb = torch.from_numpy(rng.integers(65, 91, (B, T)).astype(np.uint8))
    mn = torch.full((B,), 5, dtype=torch.int32)
    gq, gt, plen = _hold_model(mv, qb, tb, mn, mn, dmin)
    assert (plen == -1).all()
    clamped = 0
    for r in range(B):
        took = gq[r][(gq[r] != ord("-")) & (gq[r] != 0)]
        assert torch.equal(took[:M], qb[r, : len(took[:M])])
        assert (took[M:] == qb[r, M - 1]).all()
        clamped += len(took) > M
    assert clamped


def test_replay_views_share_one_buffer():
    """gq, gt and plen are views of one `replay_bytes` buffer (plen on a
    4-byte boundary), which `replay` fills in place."""
    p, args, mv = _moves(_pairs(41, 5))
    Bp, L = mv.shape
    assert align_tpu.replay_bytes(3, 5) == 32 + 12
    flat = torch.zeros(align_tpu.replay_bytes(Bp, L), dtype=torch.uint8)
    got = align_tpu.replay(mv, args[0], args[1], args[2], args[3],
                           p["dmin"], flat)
    want = align_tpu.replay_plain(mv, args[0], args[1], args[2], args[3],
                                  p["dmin"])
    for g, w, v in zip(got, want, align_tpu.replay_views(flat, Bp, L)):
        assert torch.equal(g, w) and torch.equal(v, w)
        assert g.data_ptr() == v.data_ptr()
    assert got[2].data_ptr() % 4 == 0


def test_fetch_gapped_refuses_a_path_that_misses_its_bases():
    pairs = _pairs(43, 4)
    p = align_tpu.prepare_batch(pairs)
    flat = align_tpu.device_replay(p, "cpu")
    plen = align_tpu.replay_views(flat, len(p["m"]), p["L"])[2]
    plen[2] = -1
    with pytest.raises(RuntimeError, match="pair 2"):
        align_tpu.fetch_gapped(flat, p)
