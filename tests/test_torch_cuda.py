"""Tests of the port that need a CUDA card (marker `cuda`): the
hand-written kernels against their plain PyTorch versions (the DP
bitwise; the histogram and scatter kernels, the microbench's variants
among them, with integer equality), the golden
files through the port with the DP on the card, and the devbuild path on
the card against the CPU and the host engine. Each skips without a
card. This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import io
import os

import numpy as np
import pytest
import torch

from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.ops import dp as tdp
from pbdagcon_tpu_torch.ops import _build, dp_cuda, mxu, mxu_cuda, pk, pk_cuda
from pbdagcon_tpu_torch.pipeline import run_stream
from pbdagcon_tpu_torch.simulate import NoiseProfile, simulate_targets, to_m5

DATA = os.path.join(os.path.dirname(__file__), "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32)
    )


@pytest.mark.parametrize("W", [16, 32, 64, 128])
@pytest.mark.parametrize("K", [0, 8, 32, 128])
def test_dp_kernel_matches_plain_version(card, W, K):
    rng = np.random.default_rng(1000 * W + K)
    t = batch_to_torch(tdp.random_batch(rng, 37, 333, W, K), card)
    args = [t[k] for k in tdp.DP_ARGS]
    before = dp_cuda.launches
    got = tdp.dp_scores(*args)
    assert dp_cuda.launches == before + 1
    want = tdp.dp_scores_reference(*args)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


@pytest.mark.parametrize("B,V,W,K", [
    (1, 1, 16, 8), (2, 31, 16, 0), (3, 33, 24, 8), (5, 64, 128, 128),
    (300, 97, 64, 32),
])
def test_dp_kernel_edge_shapes(card, B, V, W, K):
    rng = np.random.default_rng(B * 1000 + V)
    t = batch_to_torch(tdp.random_batch(rng, B, V, W, K), card)
    args = [t[k] for k in tdp.DP_ARGS]
    got = dp_cuda.dp_scores_cuda(*args)
    want = tdp.dp_scores_reference(*args)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


def test_dp_kernel_rejects_what_it_does_not_take(card):
    rng = np.random.default_rng(5)
    t = batch_to_torch(tdp.random_batch(rng, 3, 64, 16, 8), card)
    args = [t[k] for k in tdp.DP_ARGS]
    with pytest.raises(TypeError):
        dp_cuda.dp_scores_cuda(args[0].int(), *args[1:])
    with pytest.raises(ValueError):
        dp_cuda.dp_scores_cuda(args[0][:, :, :12].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        dp_cuda.dp_scores_cuda(args[0].transpose(0, 1), *args[1:])


@pytest.mark.parametrize("W,K,V", [(16, 32, 90), (48, 8, 77), (8, 128, 61),
                                   (128, 0, 150), (24, 64, 700)])
@pytest.mark.parametrize("name", [
    "far_below", "last_row", "long_only", "span_w_plus_1", "short_registers",
    "unsup_all", "empty", "ties",
])
def test_dp_kernel_edge_cases(card, name, W, K, V):
    """The kernel's scan order at its edges (`tdp.edge_batches`): start
    rows far below V or on row V-1, long-edge-only targets, span W + 1,
    short registers, unsup everywhere, empty targets, ties."""
    rng = np.random.default_rng(W * 1000 + K + V)
    t = batch_to_torch(tdp.edge_batches(rng, 37, V, W, K)[name], card)
    args = [t[k] for k in tdp.DP_ARGS]
    got = dp_cuda.dp_scores_cuda(*args)
    want = tdp.dp_scores_reference(*args)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


@pytest.mark.parametrize("V", [700, 701, 512, 768])
@pytest.mark.parametrize("W,K", [(16, 32), (48, 32), (128, 128)])
def test_dp_kernel_staging_alignment(card, V, W, K):
    """Rows of exit, cov and unsup that are 16-byte aligned (V % 256 ==
    0) and not (V = 700, 701), in one arena as the packer lays it out
    and as tensors at odd offsets: the bulk copies and the lanes' head
    and tail copies."""
    rng = np.random.default_rng(V + W + K)
    B = 33
    arena = tdp.to_arena(tdp.random_batch(rng, B, V, W, K))
    args = tdp.unpack_arena(torch.from_numpy(arena).to(card), B, V, W, K)
    want = tdp.dp_scores_reference(*args)
    assert _same_bits(dp_cuda.dp_scores_cuda(*args), want)
    shifted = []
    for i, a in enumerate(args):
        if 1 <= i <= 3:  # exit, cov, unsup at an offset of one element
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=card)
            buf[1:].copy_(a.reshape(-1))
            a = buf[1:].view(a.shape)
        shifted.append(a)
    got = dp_cuda.dp_scores_cuda(*shifted)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


@pytest.mark.parametrize("use_native", [True, False])
def test_golden_on_card(card, use_native):
    if use_native and not native.available():
        pytest.skip("native library not built")
    before = dp_cuda.launches
    out = io.StringIO()
    with open(os.path.join(DATA, "golden1.m5")) as f:
        run_stream(
            f, FastaWriter(out),
            DagconConfig(min_weight=6, min_length=100, use_native=use_native,
                         device="cuda"),
        )
    assert out.getvalue() == open(os.path.join(DATA, "golden1.fa")).read()
    assert dp_cuda.launches > before


def test_golden_align_on_card(card):
    if not native.available():
        pytest.skip("native library not built")
    out = io.StringIO()
    with open(os.path.join(DATA, "golden2.pre")) as f:
        run_stream(
            f, FastaWriter(out),
            DagconConfig(min_weight=5, min_length=80, fmt="pre", align=True,
                         device="cuda", batch_targets=2),
        )
    assert out.getvalue() == open(os.path.join(DATA, "golden2.fa")).read()


# (B, N, D): B not a multiple of 8; D on both sides of the kernel's
# shared-memory limit (48K bins); a single element.
@pytest.mark.parametrize("B,N,D", [
    (3, 700, 257), (37, 41000, 15000), (5, 5000, 60000), (129, 100, 8),
    (1, 1, 1), (7, 20000, 245000),
])
def test_hist_kernel_matches_plain_version(card, B, N, D):
    rng = np.random.default_rng(B * 7 + D)
    v = torch.from_numpy(rng.integers(-3, D + 5, (B, N)).astype(np.int32)).to(card)
    before = mxu_cuda.launches["hist"]
    got = mxu_cuda.hist_cuda(v, None, D)
    assert mxu_cuda.launches["hist"] == before + 1
    want = mxu.hist_reference(v, None, D)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,N,D,nbytes,repeat", [
    (3, 700, 800, 1, False), (37, 5000, 5000, 2, False),
    (5, 40000, 4000, 4, True), (11, 3000, 300, 3, True),
])
def test_scatter_kernel_matches_plain_version(card, B, N, D, nbytes, repeat):
    """Negative and over-wide payloads, ranks below 0 and past D, unique
    ranks (a transport) or repeated ones (a wrapping sum)."""
    rng = np.random.default_rng(N + nbytes)
    if repeat:
        r = rng.integers(-3, D + 5, (B, N))
    else:
        r = np.stack([rng.permutation(N) for _ in range(B)]) - 2
    r = torch.from_numpy(r.astype(np.int32)).to(card)
    ps = tuple(
        torch.from_numpy(
            rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
        ).to(card)
        for _ in range(2)
    )
    mask = (1 << (8 * nbytes)) - 1
    before = mxu_cuda.launches["scatter"]
    got = mxu_cuda.scatter_cuda(r, None, ps, D, mask)
    assert mxu_cuda.launches["scatter"] == before + 1
    want = mxu.scatter_reference(r, None, ps, D, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mxu_wrappers_on_card_equal_cpu(card):
    rng = np.random.default_rng(9)
    v = rng.integers(-2, 600, (6, 3000)).astype(np.int32)
    m = rng.random((6, 3000)) < 0.8
    w = rng.integers(0, 1 << 20, (6, 3000)).astype(np.int32)
    for dev in (card, torch.device("cpu")):
        vt, mt, wt = (torch.from_numpy(x).to(dev) for x in (v, m, w))
        res = [mxu.mxu_hist(vt, mt, 512)]
        res += list(mxu.mxu_weighted_hist(vt, mt, (wt,), 512))
        res += list(mxu.mxu_scatter(vt, mt, (wt,), 700, max_payload=1 << 24))
        res.append(mxu.mxu_gather(wt, vt, max_val=1 << 20, valid=mt))
        if dev == card:
            got = [x.cpu() for x in res]
        else:
            want = res
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_kernel_wrappers_reject_what_they_do_not_take(card):
    v = torch.zeros((3, 10), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        mxu_cuda.hist_cuda(v.long(), None, 4)
    with pytest.raises(ValueError):
        mxu_cuda.hist_cuda(v.t(), None, 4)
    with pytest.raises(ValueError):
        mxu_cuda.scatter_cuda(v, None, (v,) * 5, 4, 0xFF)
    with pytest.raises(ValueError):
        mxu_cuda.scatter_cuda(v, None, (v[:, :5].contiguous(),), 4, 0xFF)
    with pytest.raises(TypeError):
        mxu_cuda.hist_cuda(v, v.to(torch.uint8), 4)
    bad = mxu_cuda.BinPlan("cluster", 2, 4, 256, 16)  # 8 bins < D = 9
    with pytest.raises(RuntimeError, match="hist launch"):
        mxu_cuda.hist_cuda(v, None, 9, plan=bad)


# (B, N, D, planes, forced cluster size): the planned route of each kind
# (one CTA per row as in the bench window, short rows too; clusters of
# 5, 3 and 16 CTAs for the shared memory; global),
# then clusters forced on small domains, where most adds are remote and a
# few hot bins take many; N not a multiple of 4 takes the scalar loads.
ROUTE_CASES = [
    (129, 100, 8, 1, None), (300, 100, 50, 2, None),
    (128, 40960, 1026, 1, None), (7, 20000, 245000, 1, None),
    (128, 6144, 78848, 2, None), (2, 40000, 4000, 4, None),
    (3, 9000, 929_792, 1, None), (2, 100, 1_000_000, 1, None),
    (5, 3001, 300, 3, 2), (5, 3000, 300, 1, 4), (3, 40000, 64, 2, 8),
    (3, 40000, 4000, 1, 16),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,N,D,NP,cs", ROUTE_CASES)
def test_bin_kernels_on_every_route(card, B, N, D, NP, cs, masked):
    """Histogram and scatter on each route, with and without `valid`,
    into outputs allocated over garbage (every bin must be written):
    repeated ranks (every fifth element in the last bin), ranks outside
    [0, D), over-wide payloads cut to 3 bytes."""
    rng = np.random.default_rng(B * 13 + N + D + NP)
    r = rng.integers(-3, D + 5, (B, N)).astype(np.int32)
    r[:, ::5] = D - 1
    r = torch.from_numpy(r).to(card)
    valid = (torch.from_numpy(rng.random((B, N)) < 0.8).to(card)
             if masked else None)
    ps = tuple(torch.from_numpy(rng.integers(
        -(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)).to(card)
        for _ in range(NP))
    hplan = None if cs is None else mxu_cuda.cluster_plan(N, D, 1, cs)
    splan = None if cs is None else mxu_cuda.cluster_plan(N, D, NP, cs)
    if cs is None:
        assert mxu_cuda.hist_plan(B, N, D).route in mxu_cuda.ROUTES
    torch.full((NP + 1, B, D), -7, dtype=torch.int32, device=card)  # garbage
    before = dict(mxu_cuda.launches)
    got_h = mxu_cuda.hist_cuda(r, valid, D, plan=hplan)
    got_s = mxu_cuda.scatter_cuda(r, valid, ps, D, 0xFFFFFF, plan=splan)
    assert mxu_cuda.launches["hist"] == before["hist"] + 1
    assert mxu_cuda.launches["scatter"] == before["scatter"] + 1
    want_h = mxu.hist_reference(r, valid, D)
    want_s = mxu.scatter_reference(r, valid, ps, D, 0xFFFFFF)
    torch.cuda.synchronize()
    assert torch.equal(got_h, want_h)
    assert all(torch.equal(g, w) for g, w in zip(got_s, want_s))


def test_bin_kernels_take_broadcast_and_offset_masks(card):
    """A [B, 1] mask, a non-contiguous one, and rows at an odd offset
    (no 16-byte loads)."""
    rng = np.random.default_rng(77)
    B, N, D = 6, 4096, 3000
    buf = torch.from_numpy(rng.integers(-2, D + 2, B * N + 1).astype(np.int32)).to(card)
    r = buf[1:].view(B, N)
    p = torch.from_numpy(rng.integers(0, 1 << 20, (B, N)).astype(np.int32)).to(card)
    for valid in (torch.tensor([[True], [False], [True], [True], [False], [True]],
                               device=card),
                  (torch.rand((N, B), device=card) < 0.5).t()):
        assert torch.equal(mxu_cuda.hist_cuda(r, valid, D),
                           mxu.hist_reference(r, valid, D))
        (got,) = mxu_cuda.scatter_cuda(r, valid, (p,), D, 0xFFFFF)
        assert torch.equal(got, mxu.scatter_reference(r, valid, (p,), D,
                                                      0xFFFFF)[0])


def test_bin_kernels_capture_in_a_graph_without_memsets(card):
    """One kernel node per call, no memset node; replays agree."""
    from pbdagcon_tpu_torch.tools.cuda_graph import node_counts

    rng = np.random.default_rng(3)
    B, N = 128, 6144
    r = torch.from_numpy(rng.integers(-1, 8300, (B, N)).astype(np.int32)).to(card)
    valid = r % 3 != 0
    p = (r * 5, r + 11)

    def calls():
        return (mxu_cuda.hist_cuda(r, valid, 8208),
                *mxu_cuda.scatter_cuda(r, valid, p, 14364, 0xFFFFFFFF),
                mxu_cuda.hist_cuda(r[:, :64].contiguous(), None, 2052))

    calls()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        outs = calls()
    counts = node_counts(g.raw_cuda_graph())
    g.replay()
    torch.cuda.synchronize()
    want = (mxu.hist_reference(r, valid, 8208),
            *mxu.scatter_reference(r, valid, p, 14364, 0xFFFFFFFF),
            mxu.hist_reference(r[:, :64], None, 2052))
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert counts.get("memset", 0) == 0
    # the slice's .contiguous() copy is one more kernel
    assert counts["kernel"] == 4


# The kernel-variant microbench's kernels (P1-P3). (B, N, D): B not a
# multiple of 8, D not a multiple of 128 (and one that is), N = 0 (the
# output is torch.empty, so every bin must be written), P2's largest
# domain, then the microbench's shapes; then P1's hi widths at each
# padding edge (D = 128 and 1024 fill wgmma widths 8 exactly, 129 and 1025
# spill into the next; HIST_V1_MAX_WIDTH * 128 is one full tile, one more
# bin takes two), with N not a multiple of 4 or of 32.
_CAP = pk_cuda.HIST_V1_MAX_WIDTH * 128
PK_HIST_CASES = [
    (3, 700, 257), (37, 41000, 15000), (129, 100, 8), (1, 1, 1), (5, 0, 300),
    (9, 3001, 384), (5, 5000, 48 * 1024), (128, 40960, 1026),
    (128, 40960, 9234), (128, 6144, 8208),
    (3, 1001, 128), (2, 999, 129), (4, 4099, 1024), (5, 2050, 1025),
    (3, 5003, _CAP), (3, 5003, _CAP + 1),
]


@pytest.mark.parametrize("name", ["hist_v1", "hist_v2"])
@pytest.mark.parametrize("B,N,D", PK_HIST_CASES)
def test_pk_hist_kernels_match_plain_version(card, name, B, N, D):
    rng = np.random.default_rng(B * 7 + N + D)
    v = rng.integers(-3, D + 300, (B, N)).astype(np.int32)
    v[:, 1::29] = D - 1
    v = torch.from_numpy(v).to(card)
    before = pk_cuda.launches[name]
    got = getattr(pk_cuda, f"{name}_cuda")(v, D)
    assert pk_cuda.launches[name] == before + 1
    want = mxu.hist_reference(v, None, D)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,D,aligned", [(70001, 9234, True),
                                          (70000, 1025, False)])
def test_pk_hist_v1_counts_past_int8_in_one_bin(card, N, D, aligned):
    """Every value of row 0 in the last bin and of row 1 in bin 0 (counts
    of N, past any 8- or 16-bit range); rows 2-3 random. Unaligned: the
    rows start off 16 bytes (the kernel's 4-byte copies)."""
    rng = np.random.default_rng(N + D)
    v = rng.integers(-3, D + 300, (4, N)).astype(np.int32)
    v[0], v[1] = D - 1, 0
    flat = torch.from_numpy(v).reshape(-1).to(card)
    if not aligned:
        flat = torch.cat([flat[:1], flat])[1:]
        assert flat.data_ptr() % 16 != 0
    got = pk_cuda.hist_v1_cuda(flat.view(4, N), D)
    torch.cuda.synchronize()
    assert int(got[0, D - 1]) == N and int(got[1, 0]) == N
    assert torch.equal(got.cpu(), mxu.hist_reference(torch.from_numpy(v), None, D))


def test_pk_hist_wgmma_entry_refuses_bad_plans(card):
    """D = 1025 has 9 hi rows: (16, 1, 255) and (8, 2, 255) cover them;
    an illegal or too wide width, a cover that falls short or leaves a
    tile empty, and a sentinel that is a row or not a byte are refused."""
    lib = _build.load("pk_variants")
    v = torch.zeros((2, 64), dtype=torch.int32, device=card)
    out = torch.empty((2, 1025), dtype=torch.int32, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream

    def rc(width, tiles, sentinel):
        return lib.dagcon_hist_wgmma(v.data_ptr(), out.data_ptr(), 2, 64,
                                     1025, width, tiles, sentinel, stream)

    assert rc(16, 1, 255) == 0 and rc(8, 2, 255) == 0
    for plan in ((40, 1, 255), (256, 1, 255), (8, 1, 255), (16, 2, 255),
                 (16, 1, 15), (16, 1, 256)):
        assert rc(*plan) != 0, plan
    torch.cuda.synchronize()


def test_pk_hist_v1_past_the_shared_memory_limit(card):
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.integers(-3, 245005, (7, 20000)).astype(np.int32))
    got = pk.hist_v1(v.to(card), 245000)
    assert torch.equal(got.cpu(), mxu.hist_reference(v, None, 245000))


# (B, N, D, nbytes, NP, repeat): D past one shared-memory tile at every
# NP (several tiles per row), unique and repeated ranks, then the
# microbench's shapes.
PK_SCATTER_CASES = [
    (3, 700, 800, 1, 1, False), (37, 5000, 5000, 2, 2, False),
    (5, 40000, 4000, 4, 3, True), (11, 3000, 300, 3, 4, True),
    (3, 0, 100, 4, 2, False), (7, 30000, 70001, 2, 1, True),
    (6, 20000, 60000, 4, 4, False), (128, 6144, 78848, 4, 2, False),
    (128, 6144, 5632, 4, 2, True), (128, 3072, 12 * 5632, 4, 2, False),
]


@pytest.mark.parametrize("B,N,D,nbytes,NP,repeat", PK_SCATTER_CASES)
def test_pk_scatter_kernel_matches_plain_version(card, B, N, D, nbytes, NP,
                                                 repeat):
    """Negative and over-wide payloads, ranks below 0 and past D."""
    rng = np.random.default_rng(N + D + nbytes)
    if repeat:
        r = rng.integers(-3, D + 5, (B, N))
    else:
        r = np.stack([rng.permutation(D + 5)[:N] for _ in range(B)]) - 2
    r = torch.from_numpy(r.astype(np.int32)).to(card)
    ps = tuple(
        torch.from_numpy(
            rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
        ).to(card)
        for _ in range(NP)
    )
    mask = (1 << (8 * nbytes)) - 1
    before = pk_cuda.launches["pallas_scatter"]
    got = pk_cuda.scatter_tile_cuda(r, ps, D, mask)
    assert pk_cuda.launches["pallas_scatter"] == before + 1
    want = mxu.scatter_reference(r, None, ps, D, mask)
    torch.cuda.synchronize()
    assert len(got) == NP and all(torch.equal(g, w) for g, w in zip(got, want))


def test_pk_variants_on_card_equal_cpu(card):
    rng = np.random.default_rng(21)
    v = rng.integers(-2, 1400, (6, 3000)).astype(np.int32)
    w = rng.integers(-(1 << 31), (1 << 31) - 1, (6, 3000)).astype(np.int32)
    res = {}
    for dev in (card, torch.device("cpu")):
        vt, wt = (torch.from_numpy(x).to(dev) for x in (v, w))
        res[dev.type] = [pk.hist_v0(vt, 1300), pk.hist_v1(vt, 1300),
                         pk.hist_v2(vt, 1300),
                         *pk.pallas_scatter(vt, (wt, vt), 1300, 3)]
    assert all(torch.equal(g.cpu(), x) for g, x in zip(res["cuda"], res["cpu"]))


def test_pk_wrappers_reject_what_they_do_not_take(card):
    v = torch.zeros((3, 10), dtype=torch.int32, device=card)
    for f in (pk_cuda.hist_v1_cuda, pk_cuda.hist_v2_cuda):
        with pytest.raises(TypeError):
            f(v.long(), 4)
        with pytest.raises(ValueError, match="contiguous"):
            f(v.t(), 4)
    with pytest.raises(ValueError, match="shared memory"):
        pk_cuda.hist_v2_cuda(v, pk_cuda.MAX_ROW_BINS + 1)
    with pytest.raises(TypeError):
        pk_cuda.scatter_tile_cuda(v, (v.long(),), 4, 0xFF)
    strided = torch.zeros((3, 20), dtype=torch.int32, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        pk_cuda.scatter_tile_cuda(v, (strided,), 4, 0xFF)
    with pytest.raises(ValueError):
        pk_cuda.scatter_tile_cuda(v, (v,) * 5, 4, 0xFF)


def _offset_rows(card, a: np.ndarray, off: int) -> torch.Tensor:
    """`a` on the card as a view whose value 0 lies `off` values past the
    start of its (16-byte-aligned) allocation."""
    flat = torch.empty(a.size + off, dtype=torch.int32, device=card)
    flat[off:] = torch.from_numpy(a.reshape(-1)).to(card)
    return flat[off:].view(a.shape)


# P3's plans: (B, N, D, NP, tiles the plan takes, value offset of the
# ranks' and each payload's allocation). One tile and 3 to 6 tiles, NP
# 1-4, every N mod 4 (odd rows start off their allocation's alignment by
# N mod 4), payload rows misaligned unlike the ranks' (read from global
# memory), N = 0.
PK_TILE_ROUTES = [
    (5, 3000, 300, 1, 1, (0, 0)), (3, 3001, 60001, 2, 3, (1, 1, 1)),
    (4, 2042, 40003, 3, 3, (2, 2, 2, 2)),
    (3, 4099, 50000, 4, 6, (3, 3, 3, 3, 3)),
    (5, 1500, 80, 2, 1, (0, 1, 3)), (7, 1021, 41, 1, 1, (3, 0)),
    (2, 20000, 4000, 2, 1, (0, 0, 0)), (3, 5003, 1000, 4, 1, (1, 2, 3, 0, 1)),
    (3, 0, 100, 2, 1, (0, 0, 0)), (2, 3000, 250_000, 1, 6, (1, 2)),
]


@pytest.mark.parametrize("B,N,D,NP,tiles,offsets", PK_TILE_ROUTES)
def test_pk_scatter_tile_on_every_route(card, B, N, D, NP, tiles, offsets):
    """Repeated ranks (every fifth in the last bin), ranks outside [0,
    D), over-wide payloads cut to 3 bytes, outputs allocated over
    garbage."""
    rng = np.random.default_rng(B * 13 + N + D + NP)
    r = rng.integers(-3, D + 5, (B, N)).astype(np.int32)
    r[:, ::5] = D - 1
    ranks = _offset_rows(card, r, offsets[0])
    ps = tuple(_offset_rows(card, rng.integers(
        -(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32), offsets[1 + k])
        for k in range(NP))
    assert pk_cuda.tile_plan(N, D, NP).tiles == tiles
    torch.full((NP + 1, B, D), -7, dtype=torch.int32, device=card)  # garbage
    before = pk_cuda.launches["pallas_scatter"]
    got = pk_cuda.scatter_tile_cuda(ranks, ps, D, 0xFFFFFF)
    assert pk_cuda.launches["pallas_scatter"] == before + 1
    want = mxu.scatter_reference(ranks, None, ps, D, 0xFFFFFF)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# P2's routes: (N, D, value offset of the rows' allocation): staged rows
# of every N mod 4, the largest staged row, rows past one CTA (the ring),
# N = 0.
PK_ROW_ROUTES = [
    (9000, 700, 0), (9001, 700, 1), (8186, 33, 2),
    (4095, 1026, 3), (41000, 15000, 1), (70001, 9234, 1),
    (100_000, 48 * 1024, 2), (0, 300, 0),
]


@pytest.mark.parametrize("N,D,off", PK_ROW_ROUTES)
def test_pk_hist_row_on_every_route(card, N, D, off):
    """Row 0 all in the last bin (a count of N in one bin), values
    outside [0, D), outputs allocated over garbage."""
    rng = np.random.default_rng(N + D + off)
    v = rng.integers(-3, D + 300, (3, N)).astype(np.int32)
    v[0] = D - 1
    values = _offset_rows(card, v, off)
    plan = pk_cuda.hist_row_plan(N, D)
    assert plan.route == ("ring" if N > 60_000 else "staged")
    torch.full((2, 3, D), -7, dtype=torch.int32, device=card)  # garbage
    before = pk_cuda.launches["hist_v2"]
    got = pk_cuda.hist_v2_cuda(values, D, plan=plan)
    assert pk_cuda.launches["hist_v2"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, mxu.hist_reference(values, None, D))


def test_pk_entries_refuse_plans_they_do_not_take(card):
    """Tile plans: tiles that miss D or leave one empty, bins not a
    multiple of 4, one stage, nine stages, wrong shared bytes, more than
    one CTA's. Row plans: one slot for three pieces, more slots than
    pieces, wrong shared bytes."""
    v = torch.zeros((2, 9000), dtype=torch.int32, device=card)
    T, tsm = pk_cuda.TilePlan, pk_cuda.tile_smem
    for plan in (T(2, 12, 2, tsm(1, 12, 2)), T(4, 12, 2, tsm(1, 12, 2)),
                 T(3, 10, 2, tsm(1, 10, 2)), T(3, 12, 1, tsm(1, 12, 1)),
                 T(3, 12, 9, tsm(1, 12, 9)), T(3, 12, 2, 999),
                 T(1, 60000, 2, tsm(1, 60000, 2))):
        with pytest.raises(RuntimeError, match="pallas_scatter launch"):
            pk_cuda.scatter_tile_cuda(v, (v,), 30, 0xFF, plan=plan)
    R, rsm = pk_cuda.RowPlan, pk_cuda.row_smem
    for plan in (R("staged", 1, rsm(9000, 30, 1)),
                 R("ring", 4, rsm(9000, 30, 4)),
                 R("ring", 2, rsm(9000, 30, 2) + 16)):
        with pytest.raises(RuntimeError, match="hist_v2 launch"):
            pk_cuda.hist_v2_cuda(v, 30, plan=plan)
    torch.cuda.synchronize()


def _devbuild_text() -> str:
    lines = [
        to_m5(a)
        for _t, _b, alns in simulate_targets(4242, 40, 300, 20, NoiseProfile())
        for a in alns
    ]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("use_native", [True, False])
def test_devbuild_on_card_matches_host(card, use_native):
    if use_native and not native.available():
        pytest.skip("native library not built")
    text = _devbuild_text()
    kw = dict(min_weight=5, min_length=50, use_native=use_native)
    want = io.StringIO()
    run_stream(io.StringIO(text), FastaWriter(want),
               DagconConfig(backend="host", **kw))
    before = (dp_cuda.launches, dict(mxu_cuda.launches))
    got = io.StringIO()
    stats = run_stream(io.StringIO(text), FastaWriter(got),
                       DagconConfig(backend="devbuild", device="cuda", **kw))
    assert got.getvalue() == want.getvalue()
    assert stats.targets == 40 and stats.host_fallbacks < 40
    assert dp_cuda.launches > before[0]
    for k in ("hist", "scatter"):
        assert mxu_cuda.launches[k] > before[1][k]


def test_device_build_on_card_equals_cpu(card):
    """Every output array of the device build, built on the card (the
    kernels, CUDA sorts and gathers) and on the CPU (plain versions)."""
    from pbdagcon_tpu_torch.ops.devbuild import encode_group
    from pbdagcon_tpu_torch.devpipe import _pack_batch
    from pbdagcon_tpu_torch.ops.devbuild_torch import Caps, device_build

    caps = Caps(B=8, R=24, C=400, L=320, CH=64, SM=12, NC=1536, ND=1536,
                SE=16, DQ=8, V=1536, W=64)
    encs = [
        encode_group(bb, alns, sid=str(t))
        for t, bb, alns in simulate_targets(5, 8, 300, 18, NoiseProfile())
    ]
    host = _pack_batch(encs, caps)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{pre}.{k}")
        else:
            yield pre, tree

    outs = [
        dict(flat(device_build(*(torch.from_numpy(a).to(d) for a in host), caps)))
        for d in (card, torch.device("cpu"))
    ]
    assert set(outs[0]) == set(outs[1])
    for k, v in outs[1].items():
        assert torch.equal(outs[0][k].cpu(), v), k
    assert not outs[1][".flags"].all()


# ---- kernel X1: the device aligner (csrc/align_scan.cu) ----

def _align_pairs(case: str):
    import random

    from pbdagcon_tpu_torch.simulate import random_seq, sample_read

    rng = random.Random({"random": 1, "skew": 2, "identical": 3}[case])
    noise = NoiseProfile(sub=0.05, ins=0.12, dele=0.08)
    pairs = []
    if case == "random":  # B = 45: not a multiple of 32
        for _ in range(45):
            t = random_seq(rng, rng.randint(1, 600))
            q, _ = sample_read(rng, t, 0, len(t), noise)
            pairs.append((q.replace("-", "") or "A", t))
    elif case == "skew":  # Wa past 1024 lanes: several bytes a thread
        for k in range(6):
            t = random_seq(rng, 1500 + 100 * k)
            pairs.append((t[200 + 50 * k: 700], t))
            pairs.append((t, t[100: 400 + 30 * k]))
    elif case == "identical":
        for n in (1, 2, 3, 17, 255, 256, 257, 1000, 2000):
            s = random_seq(rng, n)
            pairs.append((s, s))
    return pairs


@pytest.mark.parametrize("tb_route", ["warp", "thread"])
@pytest.mark.parametrize("case,route", [
    ("random", "warp"), ("random", "cta"), ("skew", "cta"),
    ("identical", "warp"), ("identical", "cta"),
])
def test_align_kernels_match_plain_versions(card, case, route, tb_route):
    from pbdagcon_tpu_torch.aligner import align_pair
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    pairs = _align_pairs(case)
    p = align_tpu.prepare_batch(pairs)
    if case == "skew":
        assert p["Wa"] > 1024
    # The kernels take any B: cut the ladder's padding off.
    args = [torch.from_numpy(np.ascontiguousarray(p[k][: len(pairs)]))
            .to(card) for k in ("qb", "tb_pad", "m", "n", "bw")]
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    plan = align_cuda.scan_plan(args[2], args[3], args[4], M, Wa, dmin,
                                route=route)
    assert align_cuda.scan_plan(args[2], args[3], args[4], M, Wa, dmin)[
        "route"] == ("cta" if case == "skew" else "warp")
    tb_plan = align_cuda.traceback_plan(args[2], args[3], M, Wa, L,
                                        route=tb_route)
    assert align_cuda.traceback_plan(args[2], args[3], M, Wa, L)[
        "route"] == "warp"
    before = dict(align_cuda.launches)
    routes = dict(align_cuda.traceback_routes)
    packed = align_tpu.align_scan(*args, M, Wa, dmin, plan)
    moves = align_tpu.traceback(packed, args[2], args[3], M, Wa, dmin, L,
                                tb_plan)
    rows = align_tpu.replay(moves, *args[:4], dmin)
    assert align_cuda.launches == {k: v + 1 for k, v in before.items()}
    routes[tb_route] += 1
    assert align_cuda.traceback_routes == routes
    want = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    want_mv = align_tpu.traceback_plain(want, args[2], args[3], M, Wa, dmin, L)
    want_rows = align_tpu.replay_plain(want_mv, *args[:4], dmin)
    torch.cuda.synchronize()
    assert torch.equal(packed, want)
    assert torch.equal(moves, want_mv)
    assert all(torch.equal(g, w) for g, w in zip(rows, want_rows))
    assert align_tpu.align_batch(pairs, card) == [
        align_pair(q, t) for q, t in pairs]


@pytest.mark.parametrize("case", ["cpl-edges", "short", "ladder"])
def test_align_scan_warp_route_edge_cases(card, case):
    """The warp route on the CPU model's edge cases
    (tests/test_torch_align_plan.py): spans on both sides of every CPL
    class edge, bands drifting both ways, length-1 and short pairs, and
    a batch with its ladder padding (m = n = 1, bw = 64) whose B is not
    a multiple of the warps a CTA holds."""
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    pairs = {"cpl-edges": align_tpu.warp_edge_pairs,
             "short": align_tpu.short_pairs,
             "ladder": lambda: _align_pairs("random")[:37]}[case]()
    p = align_tpu.prepare_batch(pairs)
    B = len(p["m"]) if case == "ladder" else len(pairs)
    assert case != "ladder" or B == 64
    args = [torch.from_numpy(np.ascontiguousarray(p[k][:B])).to(card)
            for k in ("qb", "tb_pad", "m", "n", "bw")]
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    plan = align_cuda.scan_plan(args[2], args[3], args[4], M, Wa, dmin,
                                route="warp")
    got = align_cuda.align_scan_cuda(*args, M, Wa, dmin, plan)
    cut = B - 3  # and a B that is not a multiple of the warps a CTA holds
    assert cut % 8
    got_cut = align_cuda.align_scan_cuda(
        *(a[:cut].contiguous() for a in args), M, Wa, dmin, align_cuda.scan_plan(
            args[2][:cut], args[3][:cut], args[4][:cut], M, Wa, dmin,
            route="warp", warps=8))
    want = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_cut, want[:cut])


def test_align_scan_refuses_a_bad_plan(card):
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    p = align_tpu.prepare_batch(_align_pairs("identical"))
    qb, tb, m, n, bw = (torch.from_numpy(p[k]).to(card)
                        for k in ("qb", "tb_pad", "m", "n", "bw"))
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    plan = align_cuda.scan_plan(m, n, bw, M, Wa, dmin, route="warp")
    before = dict(align_cuda.launches)
    B = len(p["m"])
    order9 = np.full(-(-B // 9) * 9, -1, dtype=np.int32)
    order9[:B] = np.arange(B)
    for bad in ({**plan, "warps": 9, "smem": 9 * align_cuda.warp_slot(M),
                 "order": order9},
                {**plan, "cpl_max": 6}, {**plan, "smem": plan["smem"] - 16},
                {"route": "cta", "smem": align_cuda.scan_smem(Wa) + 4}):
        with pytest.raises(RuntimeError, match="align_scan launch"):
            align_cuda.align_scan_cuda(qb, tb, m, n, bw, M, Wa, dmin, bad)
    with pytest.raises(ValueError):
        align_cuda.align_scan_cuda(qb, tb, m, n, bw, M, Wa, dmin,
                                   {"route": "rows", "smem": 0})
    with pytest.raises(ValueError, match="order"):  # a plan of another B
        align_cuda.align_scan_cuda(qb, tb, m, n, bw, M, Wa, dmin,
                                   {**plan, "order": plan["order"][:-8]})
    skew = align_tpu.prepare_batch(_align_pairs("skew"))
    with pytest.raises(ValueError, match="warp route"):
        align_cuda.scan_plan(skew["m"], skew["n"], skew["bw"], skew["M"],
                             skew["Wa"], skew["dmin"], route="warp")
    assert align_cuda.launches == before


def _random_pointers(seed, B, M, Wa, probs, n_hi):
    """Random packed pointers (2-bit fields drawn from `probs` over diag,
    up, left, 3) and m in 0..M, n in 0..n_hi."""
    rng = np.random.default_rng(seed)
    f = rng.choice(4, size=(B, M, Wa // 4, 4), p=probs).astype(np.uint8)
    packed = (f << np.array([0, 2, 4, 6], np.uint8)).sum(axis=3,
                                                         dtype=np.uint8)
    m = rng.integers(0, M + 1, B).astype(np.int32)
    n = rng.integers(0, n_hi + 1, B).astype(np.int32)
    m[0], n[0] = M, n_hi
    return [torch.from_numpy(x) for x in (packed, m, n)]


@pytest.mark.parametrize("B", [1, 33, 200])
@pytest.mark.parametrize("probs", [(0.2, 0.1, 0.7, 0.0),
                                   (0.1, 0.7, 0.2, 0.0),
                                   (0.25, 0.25, 0.25, 0.25)])
def test_traceback_routes_on_random_pointers(card, B, probs):
    """Walks that leave every window (long left runs, climbing lanes,
    pointer 3s), lanes below 0 and past Wa - 1, on both routes and on a
    tiny forced window, each array-equal to the plain version and to
    the CPU model."""
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    M, Wa, dmin, L = 300, 256, -64, 700
    pk, m, n = _random_pointers(B, B, M, Wa, probs, 500)
    want = align_tpu.traceback_plain(pk, m, n, M, Wa, dmin, L)
    model, _ = align_tpu.traceback_window_model(pk, m, n, M, Wa, dmin, L,
                                                rows=8, window=32)
    assert torch.equal(model, want)
    args = [x.to(card) for x in (pk, m, n)]
    for kw in ({}, {"route": "thread"}, {"rows": 8, "window": 32},
               {"rows": 200, "window": 16}, {"warps": 3}):
        plan = align_cuda.traceback_plan(m, n, M, Wa, L, **kw)
        got = align_cuda.traceback_cuda(*args, M, Wa, dmin, L, plan)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), kw


@pytest.mark.parametrize("L", [1, 15, 17, 37, 300])
def test_traceback_warp_route_cuts_long_paths(card, L):
    """L shorter than the paths and not a multiple of 16 (rows start off
    16-byte boundaries); B = 1 and B = 33."""
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    for B in (1, 33):
        pairs = _align_pairs("random")[:B]
        p = align_tpu.prepare_batch(pairs)
        args = [torch.from_numpy(np.ascontiguousarray(p[k][:B])).to(card)
                for k in ("qb", "tb_pad", "m", "n", "bw")]
        M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
        packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
        plan = align_cuda.traceback_plan(args[2], args[3], M, Wa, L)
        assert plan["route"] == "warp"
        got = align_cuda.traceback_cuda(packed, args[2], args[3], M, Wa, dmin,
                                        L, plan)
        want = align_tpu.traceback_plain(packed, args[2], args[3], M, Wa,
                                         dmin, L)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_traceback_refuses_a_bad_plan(card):
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    p = align_tpu.prepare_batch(_align_pairs("identical"))
    m, n = (torch.from_numpy(p[k]).to(card) for k in ("m", "n"))
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = torch.zeros((len(p["m"]), M, Wa // 4), dtype=torch.uint8,
                         device=card)
    plan = align_cuda.traceback_plan(p["m"], p["n"], M, Wa, L)
    before = dict(align_cuda.launches)
    routes = dict(align_cuda.traceback_routes)
    B = len(p["m"])
    order9 = np.full(-(-B // 9) * 9, -1, dtype=np.int32)
    order9[:B] = np.arange(B)
    slot = align_cuda.tb_slot(plan["rows"], plan["window"])
    for bad in ({**plan, "warps": 9, "smem": 9 * slot, "order": order9},
                {**plan, "smem": plan["smem"] - 16},
                {**plan, "rows": 0, "smem": plan["warps"] * (
                    align_cuda.tb_slot(0, plan["window"]))},
                {**plan, "window": 48},
                {**plan, "rows": 300, "smem": plan["warps"] * (
                    align_cuda.tb_slot(300, plan["window"]))},
                {"route": "thread", "warps": 8, "smem": 0},
                {"route": "thread", "warps": 4, "smem": 16}):
        with pytest.raises(RuntimeError, match="align_traceback launch"):
            align_cuda.traceback_cuda(packed, m, n, M, Wa, dmin, L, bad)
    with pytest.raises(ValueError):
        align_cuda.traceback_cuda(packed, m, n, M, Wa, dmin, L,
                                  {"route": "cta", "smem": 0})
    with pytest.raises(ValueError, match="order"):  # a plan of another B
        align_cuda.traceback_cuda(packed, m, n, M, Wa, dmin, L,
                                  {**plan, "order": plan["order"][:-8]})
    with pytest.raises(ValueError, match="0..M"):  # m past the rows
        align_cuda.traceback_cuda(packed, m + M, n, M, Wa, dmin, L)
    assert align_cuda.launches == before
    assert align_cuda.traceback_routes == routes


def test_align_wrappers_reject_what_they_do_not_take(card):
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    p = align_tpu.prepare_batch(_align_pairs("identical"))
    qb, tb, m, n, bw = (torch.from_numpy(p[k]).to(card)
                        for k in ("qb", "tb_pad", "m", "n", "bw"))
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    before = dict(align_cuda.launches)
    with pytest.raises(ValueError):  # tb_pad rows too short for Wa
        align_cuda.align_scan_cuda(qb, tb[:, : M + Wa - 1].contiguous(),
                                   m, n, bw, M, Wa, dmin)
    with pytest.raises(ValueError):  # Wa not a multiple of 128
        align_cuda.align_scan_cuda(qb, tb, m, n, bw, M, Wa - 4, dmin)
    with pytest.raises(TypeError):
        align_cuda.align_scan_cuda(qb, tb, m.long(), n, bw, M, Wa, dmin)
    with pytest.raises(ValueError):  # a CPU tensor: no fallback
        align_cuda.align_scan_cuda(qb.cpu(), tb.cpu(), m.cpu(), n.cpu(),
                                   bw.cpu(), M, Wa, dmin)
    with pytest.raises(ValueError):  # past one CTA's shared memory
        align_cuda.align_scan_cuda(qb, tb, m, n, bw, M, 29_056, dmin)
    packed = torch.zeros((len(p["m"]), M, Wa // 4), dtype=torch.uint8,
                         device=card)
    with pytest.raises(ValueError):  # packed of another width
        align_cuda.traceback_cuda(packed[:, :, 1:].contiguous(), m, n, M,
                                  Wa, dmin, p["L"])
    assert align_cuda.launches == before


def _bench_pairs(n=1024):
    """The first n raw records of the bench workload (512 targets x 1000
    bp x 30x, seed 1234), as `chip_smoke.py` makes it: the simulator's
    targets come one after another from one generator."""
    from pbdagcon_tpu_torch.simulate import to_pre_raw

    out = []
    for _tid, _bb, alns in simulate_targets(1234, 512, 1000, 30,
                                            NoiseProfile()):
        out += [to_pre_raw(a).split()[5:7] for a in alns]
        if len(out) >= n:
            return [tuple(f) for f in out[:n]]
    raise AssertionError("the workload has fewer records")


@pytest.mark.parametrize("case", ["random", "skew", "identical", "single",
                                  "ladder", "bench"])
def test_align_replay_matches_plain_version(card, case):
    """The replay kernel on the kernels' own moves, array-equal to its
    plain version (gq, gt, plen), one launch a call; the rows equal
    `align_pair`'s (the bench batch's first 64). "ladder" keeps the
    padding rows of B = 64 (m = n = 1)."""
    from pbdagcon_tpu_torch.aligner import align_pair
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    pairs = {"single": lambda: [("A", "A"), ("A", "C"), ("G", "TTA"),
                                ("CGT", "G")],
             "ladder": lambda: _align_pairs("random")[:37],
             "bench": _bench_pairs}.get(case, lambda: _align_pairs(case))()
    p = align_tpu.prepare_batch(pairs)
    B = len(p["m"]) if case == "ladder" else len(pairs)
    args = [torch.from_numpy(np.ascontiguousarray(p[k][:B])).to(card)
            for k in ("qb", "tb_pad", "m", "n", "bw")]
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_tpu.align_scan(*args, M, Wa, dmin)
    moves = align_tpu.traceback(packed, args[2], args[3], M, Wa, dmin, L)
    before = align_cuda.launches["align_replay"]
    got = align_cuda.replay_cuda(moves, *args[:4], dmin)
    assert align_cuda.launches["align_replay"] == before + 1
    want = align_tpu.replay_plain(moves, *args[:4], dmin)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    gq, gt, plen = (x.cpu() for x in got)
    k = min(len(pairs), 64)
    rows = [(bytes(gq[r, :ln].tolist()).decode(),
             bytes(gt[r, :ln].tolist()).decode())
            for r, ln in enumerate(plen[:k].tolist())]
    assert rows == [align_pair(q, t) for q, t in pairs[:k]]


@pytest.mark.parametrize("L", [1, 17, 37, 130, 600])
def test_align_replay_on_constructed_moves(card, L):
    """Paths ending on either side of every chunk edge (the CPU model's
    cases, tests/test_torch_replay.py), all-up and all-left paths, moves
    of any value past the first 3, rows off 16-byte boundaries (L off
    16), m and n one off on odd rows (plen -1); B = 1 and B = 41."""
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    rng = np.random.default_rng(L)
    for B in (1, 41):
        mv = rng.integers(0, 3, (B, L)).astype(np.uint8)
        for r in range(B):
            e = int(rng.integers(0, L + 1))
            if r % 3 == 1:
                mv[r, :e] = 1 + r % 2  # all up or all left
            if e < L:
                mv[r, e] = 3
                mv[r, e + 1:] = rng.integers(0, 256, L - e - 1)
        path = [row[: (list(row).index(3) if 3 in row else L)] for row in mv]
        m = np.array([(x != 2).sum() + r % 2 for r, x in enumerate(path)],
                     np.int32)
        n = np.array([(x != 1).sum() for x in path], np.int32)
        qb = rng.integers(65, 91, (B, 700)).astype(np.uint8)
        tb = rng.integers(65, 91, (B, 800)).astype(np.uint8)
        cpu = [torch.from_numpy(x) for x in (mv, qb, tb, m, n)]
        want = align_tpu.replay_plain(*cpu, -64)
        got = align_cuda.replay_cuda(*(x.to(card) for x in cpu), -64)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (B, L)


def test_align_replay_rejects_what_it_does_not_take(card):
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu

    B, L, M, T = 5, 40, 30, 50
    mv = torch.zeros((B, L), dtype=torch.uint8, device=card)
    qb = torch.zeros((B, M), dtype=torch.uint8, device=card)
    tb = torch.zeros((B, T), dtype=torch.uint8, device=card)
    mn = torch.ones(B, dtype=torch.int32, device=card)
    before = dict(align_cuda.launches)
    with pytest.raises(TypeError):  # moves not uint8
        align_cuda.replay_cuda(mv.int(), qb, tb, mn, mn, -64)
    with pytest.raises(TypeError):  # m not int32
        align_cuda.replay_cuda(mv, qb, tb, mn.long(), mn, -64)
    with pytest.raises(ValueError):  # qb of another B
        align_cuda.replay_cuda(mv, qb[:4], tb, mn, mn, -64)
    with pytest.raises(ValueError):  # no query bytes
        align_cuda.replay_cuda(mv, qb[:, :0].contiguous(), tb, mn, mn, -64)
    with pytest.raises(ValueError):  # a CPU tensor: no fallback
        align_cuda.replay_cuda(mv.cpu(), qb.cpu(), tb.cpu(), mn.cpu(),
                               mn.cpu(), -64)
    with pytest.raises(ValueError):  # not contiguous
        align_cuda.replay_cuda(mv.t().contiguous().t(), qb, tb, mn, mn, -64)
    with pytest.raises(ValueError):  # an out buffer of another size
        align_cuda.replay_cuda(mv, qb, tb, mn, mn, -64, torch.empty(
            align_tpu.replay_bytes(B, L) - 4, dtype=torch.uint8, device=card))
    assert align_cuda.launches == before


def test_golden2_device_aligner_on_card(card):
    out = io.StringIO()
    with open(os.path.join(DATA, "golden2.pre")) as f:
        run_stream(f, FastaWriter(out), DagconConfig(
            min_weight=5, min_length=80, fmt="pre", align=True,
            align_backend="device", backend="cuda", device="cuda"))
    assert out.getvalue() == open(os.path.join(DATA, "golden2.fa")).read()


@pytest.mark.parametrize("W", [16, 32, 64, 128])
@pytest.mark.parametrize("V,K", [(704, 16), (8192, 0)])
def test_blocked_kernels_match_plain_version(card, W, V, K):
    """Kernel X2 (compose, propagate, fill) against its plain version:
    one solve's half-unit integers equal; the Kleene-iterated scores
    bitwise and the flags equal; unflagged rows equal B1's."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda

    rng = np.random.default_rng(100 * W + K)
    batch = tdp.random_batch(rng, 5 if V > 1000 else 37, V, W, K)
    t = batch_to_torch(batch, card)
    args = [t[k] for k in tdp.DP_ARGS]
    L = tbl._blocked_L(V)
    e_ex = tbl.exit_half_units(args[1])
    before = dict(dp_blocked_cuda.launches)
    got = tbl.solve_band(args[0], args[2], args[3], e_ex, L)
    assert all(dp_blocked_cuda.launches[k] == before[k] + 1 for k in before)
    want = tbl.solve_band_reference(args[0], args[2], args[3], e_ex, L)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    s, f = tbl.dp_scores_blocked(*args, L=L)
    s_plain, f_plain = tbl.dp_scores_blocked_reference(*args, L=L)
    assert _same_bits(s, s_plain) and torch.equal(f, f_plain)
    seq = tdp.dp_scores(*args)
    ok = ~f
    assert _same_bits(s[ok], seq[ok])


def test_colshard_and_blocked_backend_on_card(card):
    """The oversize route (v_buckets below golden1's targets) and
    backend="blocked" on the card: golden1 byte for byte, X2 launched."""
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda

    if not native.available():
        pytest.skip("native library not built")
    for kw, what in ((dict(backend="cuda", v_buckets=(1200,)), "colshard"),
                     (dict(backend="blocked"), "batches")):
        before = dp_blocked_cuda.launches["blocked_compose"]
        out = io.StringIO()
        with open(os.path.join(DATA, "golden1.m5")) as f:
            stats = run_stream(f, FastaWriter(out), DagconConfig(
                min_weight=6, min_length=100, device="cuda", **kw))
        assert out.getvalue() == open(os.path.join(DATA, "golden1.fa")).read()
        assert getattr(stats, what) > 0
        assert dp_blocked_cuda.launches["blocked_compose"] > before


def _offset_copy(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of `t` that starts k elements into its buffer
    (off the 16-byte boundaries the kernels' bulk copies want)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("W", [16, 32, 64, 128])
@pytest.mark.parametrize("V,K", [(704, 16), (8192, 0)])
def test_blocked_routes_match_plain_phases(card, W, V, K):
    """The compose's "column" and "cta" routes, the propagate's "warp"
    and "cta" routes and the fill's "lane" and "reduce" routes, each
    integer-equal to its plain phase and to the other route; the band,
    M and x_in also off 16-byte boundaries."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    rng = np.random.default_rng(300 * W + K)
    batch = tdp.random_batch(rng, 5 if V > 1000 else 37, V, W, K)
    t = batch_to_torch(batch, card)
    win, cov, uns = t["win_count"], t["cov"], t["unsup"]
    e_ex = tbl.exit_half_units(t["exit_count"])
    B, L = win.shape[0], tbl._blocked_L(V)
    G = V // L
    a = tbl._rows(tbl._esc2_band(win, cov, uns), e_ex, L)
    M_p = tbl._compose(a)
    x_p = tbl._propagate(M_p)
    plans = [C.compose_plan(B, G, W, L), C.compose_plan(B, G, W, L, route="cta")]
    assert plans[0]["route"] == ("column" if W in C.COLUMN_WIDTHS else "cta")
    if W in C.COLUMN_WIDTHS:
        plans.append(C.compose_plan(B, G, W, L, blocks=3))
    for plan in plans:
        M = C.compose_cuda(win, cov, uns, e_ex, L, plan=plan)
        M_off = C.compose_cuda(_offset_copy(win, 3), cov, uns,
                               _offset_copy(e_ex, 1), L, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(M, M_p), plan
        assert torch.equal(M_off, M_p), plan
    for plan in (C.propagate_plan(B, G, W),
                 C.propagate_plan(B, G, W, route="cta"),
                 C.propagate_plan(B, G, W, warps=3 if W < 128 else 1,
                                  depth=min(G, 2), chunk=1),
                 C.propagate_plan(B, G, W, warps=1, depth=2,
                                  chunk=min(-(-G // 2), 5 if W < 64 else 1))):
        for k in range(4):
            x_in = C.propagate_cuda(_offset_copy(M_p, k), plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(x_in, x_p), (plan, k)
    s_p = tbl._fill(a, x_p)
    plans = [C.fill_plan(B, G, W, L), C.fill_plan(B, G, W, L, route="reduce")]
    assert plans[0]["route"] == "lane"
    if W <= 16:
        plans.append(C.fill_plan(B, G, W, L, blocks=1))
    for plan in plans:
        s2 = C.fill_cuda(win, cov, uns, e_ex, x_p, L, plan=plan)
        s2_off = C.fill_cuda(_offset_copy(win, 3), cov, uns,
                             _offset_copy(e_ex, 1), _offset_copy(x_p, 2), L,
                             plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(s2, s_p), plan
        assert torch.equal(s2_off, s_p), plan


@pytest.mark.parametrize("B,G,W,L", [(0, 3, 16, 64), (3, 1, 32, 64),
                                     (4, 3, 1, 64), (2, 2, 128, 64),
                                     (2, 3, 128, 128), (5, 2, 1, 128),
                                     (7, 3, 17, 128), (3, 2, 40, 64),
                                     (1, 245, 32, 128)])
def test_blocked_fill_on_random_band(card, B, G, W, L):
    """Both fill routes on a random band and x_in (no-edge slots, a
    third of them; x_in and exits at and just above SENT, and large;
    exits below SENT on rows with no edge),
    integer-equal to the plain phase, with every tensor at each of four
    offsets off the 16-byte boundaries; B = 0 launches nothing."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    rng = np.random.default_rng(B * 1000 + G * 10 + W + L)
    V = G * L
    win = rng.integers(0, 200, (B, V, W))
    win = np.where(rng.random(win.shape) < 0.33, -1, win)
    win = torch.from_numpy(win.astype(np.int16)).to(card)
    cov = torch.from_numpy(rng.integers(-50, 300, (B, V)).astype(np.int16)).to(card)
    uns = torch.from_numpy(rng.random((B, V)) < 0.2).to(card)

    def near_sent(shape, top):
        raw = rng.integers(-(1 << 20), top, shape)
        pick = rng.random(shape)
        raw = np.where(pick < 0.25, tbl.SENT, raw)
        raw = np.where((pick >= 0.25) & (pick < 0.5),
                       tbl.SENT + rng.integers(1, 64, shape), raw)
        return torch.from_numpy(raw.astype(np.int32)).to(card)

    e_ex = near_sent((B, V), 1 << 26)
    # Exits below SENT where a row has no edge: its clamp decides it.
    bare = (win < 0).all(-1) & (torch.rand((B, V), device=card) < 0.5)
    e_ex[bare] = tbl.SENT - 1000
    x_in = near_sent((B, G, W + 1), 1 << 27)
    x_in[..., W] = 0
    a = tbl._rows(tbl._esc2_band(win, cov, uns), e_ex, L)
    want = tbl._fill(a, x_in)
    before = dict(C.fill_routes)
    n = 0
    for plan in (C.fill_plan(B, G, W, L), C.fill_plan(B, G, W, L, route="reduce")):
        for k in range(4):
            got = C.fill_cuda(_offset_copy(win, k), _offset_copy(cov, k),
                              _offset_copy(uns, k), _offset_copy(e_ex, k),
                              _offset_copy(x_in, k), L, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plan, k)
        n += 4 if B else 0
    assert C.fill_routes == {"reduce": before["reduce"] + n // 2,
                             "lane": before["lane"] + n // 2}


@pytest.mark.parametrize("B,G,W", [(3, 1, 32), (4, 7, 1), (2, 5, 128),
                                   (0, 4, 16), (9, 40, 16), (1, 245, 32),
                                   (5, 3, 65)])
def test_blocked_propagate_on_random_m(card, B, G, W):
    """Both propagate routes on random M (entries in [SENT, 2^28], so
    the exit row is no identity row and many values are contaminated),
    integer-equal to the plain phase, at every misalignment of M. Past
    G = 4 the top entry is cut to 2^30 / G, so that no chain of G steps
    leaves int32."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    rng = np.random.default_rng(B * 1000 + G * 10 + W)
    Wp = W + 1
    top = min(1 << 28, (1 << 30) // G)
    raw = rng.integers(tbl.SENT, top, (B, G, Wp, Wp), dtype=np.int64)
    near = rng.random(raw.shape) < 0.3  # values at and near SENT
    raw = np.where(near, tbl.SENT + rng.integers(0, 64, raw.shape), raw)
    M = torch.from_numpy(raw.astype(np.int32)).to(card)
    want = tbl._propagate(M)
    before = dict(C.propagate_routes)
    for route, kw in (("warp", {}),
                      ("warp", dict(warps=2 if W < 128 else 1,
                                    depth=min(G, 2), chunk=1)),
                      ("cta", {})):
        plan = C.propagate_plan(B, G, W, route=route, **kw)
        for k in range(4):
            got = C.propagate_cuda(_offset_copy(M, k), plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plan, k)
    n = 8 if B else 0
    assert C.propagate_routes["warp"] == before["warp"] + n
    assert C.propagate_routes["cta"] == before["cta"] + n // 2


def test_blocked_solve_counts_routes(card):
    """A solve at W = 16 and W = 32 takes the new routes, by the route
    counts and by (kernel, route, W)."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    rng = np.random.default_rng(13)
    for W in (16, 32):
        t = batch_to_torch(tdp.random_batch(rng, 4, 512, W, 4), card)
        e_ex = tbl.exit_half_units(t["exit_count"])
        comp, prop = dict(C.compose_routes), dict(C.propagate_routes)
        fill = dict(C.fill_routes)
        widths = dict(C.route_widths)
        got = tbl.solve_band(t["win_count"], t["cov"], t["unsup"], e_ex, 64)
        want = tbl.solve_band_reference(t["win_count"], t["cov"], t["unsup"],
                                        e_ex, 64)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert C.compose_routes == {**comp, "column": comp["column"] + 1}
        assert C.propagate_routes == {**prop, "warp": prop["warp"] + 1}
        assert C.fill_routes == {**fill, "lane": fill["lane"] + 1}
        for key in (("blocked_compose", "column", W),
                    ("blocked_propagate", "warp", W),
                    ("blocked_fill", "lane", W)):
            assert C.route_widths[key] == widths.get(key, 0) + 1


def test_blocked_entries_refuse_bad_plans(card):
    """Each C entry refuses a plan it does not take, with no launch, at
    B = 0 too: the wrong route, shared memory, threads, blocks, warps or
    depth."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    rng = np.random.default_rng(4)
    t = batch_to_torch(tdp.random_batch(rng, 3, 256, 16, 4), card)
    win, cov, uns = t["win_count"], t["cov"], t["unsup"]
    e_ex = tbl.exit_half_units(t["exit_count"])
    M = C.compose_cuda(win, cov, uns, e_ex, 64)
    good_c, good_p = C.compose_plan(3, 4, 16, 64), C.propagate_plan(3, 4, 16)
    before = (dict(C.launches), dict(C.compose_routes),
              dict(C.propagate_routes), dict(C.fill_routes))
    for bad in ({**good_c, "smem": good_c["smem"] + 16},
                {**good_c, "threads": good_c["threads"] + 32},
                {**good_c, "blocks": 0},
                {**good_c, "blocks": 40, "threads": 704,
                 "smem": C.column_smem(16, 64, 40)},
                C.compose_plan(3, 4, 32, 64),  # another W's plan
                {**C.compose_plan(3, 4, 16, 64, route="cta"), "blocks": 2}):
        with pytest.raises(RuntimeError, match="blocked_compose launch"):
            C.compose_cuda(win, cov, uns, e_ex, 64, plan=bad)
    for bad in ({**good_p, "smem": good_p["smem"] + 16},
                {**good_p, "depth": 5},  # past G = 4
                {**good_p, "depth": 1, "chunk": 1},  # would wait on itself
                {**good_p, "chunk": 5},  # past G = 4
                {**good_p, "warps": 9},
                {"route": "cta", "warps": 1, "depth": 0, "chunk": 0,
                 "smem": C.propagate_smem(16)},
                C.propagate_plan(3, 4, 32)):
        with pytest.raises(RuntimeError, match="blocked_propagate launch"):
            C.propagate_cuda(M, plan=bad)
    assert (C.launches, C.compose_routes, C.propagate_routes,
            C.fill_routes) == before
    x_in = C.propagate_cuda(M)
    good_f = C.fill_plan(3, 4, 16, 64)
    before = (dict(C.launches), dict(C.compose_routes),
              dict(C.propagate_routes), dict(C.fill_routes))
    for bad in ({**good_f, "smem": good_f["smem"] + 16},
                {**good_f, "blocks": 3},  # past 32 // 16
                {**good_f, "blocks": 0},
                {**good_f, "warps": 9},
                {**good_f, "warps": 0},
                C.fill_plan(3, 4, 32, 64),  # another W's plan
                {**C.fill_plan(3, 4, 16, 64, route="reduce"), "warps": 2},
                {**C.fill_plan(3, 4, 16, 64, route="reduce"), "blocks": 2}):
        for n in (3, 0):
            with pytest.raises(RuntimeError, match="blocked_fill launch"):
                C.fill_cuda(win[:n], cov[:n], uns[:n], e_ex[:n], x_in[:n], 64,
                            plan=bad)
    assert (C.launches, C.compose_routes, C.propagate_routes,
            C.fill_routes) == before


def test_blocked_wrappers_reject_what_they_do_not_take(card):
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    rng = np.random.default_rng(3)
    t = batch_to_torch(tdp.random_batch(rng, 3, 256, 16, 4), card)
    win, cov, uns = t["win_count"], t["cov"], t["unsup"]
    e_ex = tbl.exit_half_units(t["exit_count"])
    before = dict(C.launches)
    # Plans: an unknown route, a forced route that does not fit.
    with pytest.raises(ValueError, match="not a compose plan"):
        C.compose_cuda(win, cov, uns, e_ex, 64, plan={"route": "warp"})
    with pytest.raises(ValueError, match="not a fill plan"):
        C.fill_cuda(win, cov, uns, e_ex, torch.zeros(
            (3, 4, 17), dtype=torch.int32, device=card), 64,
            plan={"route": "cta"})
    with pytest.raises(ValueError, match="not a propagate plan"):
        C.propagate_cuda(torch.zeros((3, 4, 17, 17), dtype=torch.int32,
                                     device=card), plan={"route": "column"})
    with pytest.raises(ValueError):
        C.compose_plan(3, 4, 17, 64, route="column")
    with pytest.raises(ValueError):
        C.propagate_plan(3, 4, 16, depth=5)
    with pytest.raises(ValueError):  # L does not divide V
        C.solve_band_cuda(win, cov, uns, e_ex, 96)
    with pytest.raises(TypeError):  # the kernels read the int16 band
        C.solve_band_cuda(win.int(), cov, uns, e_ex, 64)
    with pytest.raises(TypeError):
        C.solve_band_cuda(win, cov, uns, e_ex.long(), 64)
    with pytest.raises(ValueError):  # a CPU tensor: no fallback
        C.solve_band_cuda(win.cpu(), cov.cpu(), uns.cpu(), e_ex.cpu(), 64)
    with pytest.raises(ValueError):  # W past the kernels' 128
        C.compose_cuda(torch.zeros((1, 256, 136), dtype=torch.int16,
                                   device=card), cov[:1], uns[:1], e_ex[:1], 64)
    assert C.launches == before


def _target_band(seed, length, cov, W):
    """One simulated target's band arrays (as the oversize route packs
    them), or None when an edge outspans W."""
    import random

    from pbdagcon_tpu_torch.alignment import normalize_gaps
    from pbdagcon_tpu_torch.oracle.graph import AlnGraph
    from pbdagcon_tpu_torch.ops.linearize import linearize
    from pbdagcon_tpu_torch.simulate import NoiseProfile, simulate_pileup

    backbone, alns = simulate_pileup(random.Random(seed), f"r{seed}", length,
                                     cov, NoiseProfile())
    g = AlnGraph(backbone)
    for a in alns:
        g.add_aln(normalize_gaps(a))
    g.merge_nodes()
    lin = linearize(g)
    if lin.span > W:
        return None
    u = np.repeat(np.arange(lin.n, dtype=np.int32), np.diff(lin.edge_off))
    inner = lin.edge_tgt < lin.n
    win = np.full((lin.n, W), -1, dtype=np.int32)
    win[u[inner], (lin.edge_tgt - u - 1)[inner]] = lin.edge_cnt[inner]
    return win, lin.exit_count, lin.cov, lin.unsup


def test_sharded_dp_on_two_slots_of_one_card(card):
    """`dp_scores_sharded` over (cuda:0, cuda:0): B1 once a slot, the
    scores bitwise equal to one `dp_scores` call on the whole batch."""
    from pbdagcon_tpu_torch.parallel.mesh import Mesh, dp_scores_sharded

    rng = np.random.default_rng(77)
    batch = tdp.random_batch(rng, 37, 333, 32, 8)
    before = dp_cuda.launches
    got = dp_scores_sharded(batch, Mesh((card, card)))
    assert dp_cuda.launches == before + 2
    t = batch_to_torch(batch, card)
    want = tdp.dp_scores(*(t[k] for k in tdp.DP_ARGS)).cpu()
    assert _same_bits(torch.from_numpy(got), want)


@pytest.mark.parametrize("index", [None, 0])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("W,length,cov", [(32, 700, 12), (64, 400, 20)])
def test_ring_on_card_matches_one_slot_and_plain(card, D, W, length, cov,
                                                 index):
    """The colshard's ring over D slots of one card (a bare "cuda", and
    an explicit cuda:0, the one-slot mesh of an indexed run): X2's three
    kernels once a slot, D - 1 hops, the scores integer-equal to one
    slot's and to the plain version's on the CPU."""
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C
    from pbdagcon_tpu_torch.parallel import colshard
    from pbdagcon_tpu_torch.parallel.mesh import Mesh, make_mesh

    if index is not None:
        card = torch.device("cuda", index)
        assert make_mesh(device=card).devices == (card,)
    arrs = next(a for a in (_target_band(s, length, cov, W)
                            for s in range(30, 45)) if a is not None)
    one = colshard.colsharded_scores(*arrs, Mesh((card,)))
    plain = colshard.colsharded_scores(*arrs, device="cpu")
    before, hops = dict(C.launches), colshard.hops
    got = colshard.colsharded_scores(*arrs, Mesh((card,) * D))
    assert {k: C.launches[k] - before[k] for k in before} == dict.fromkeys(
        before, D)
    assert colshard.hops == hops + D - 1
    for want in (one, plain):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_boundary_chain_on_card(card):
    """X2's propagate over [I, M.., M_x] carries x exactly, as the plain
    propagate does."""
    from pbdagcon_tpu_torch.ops import dp_blocked as tbl
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C
    from pbdagcon_tpu_torch.parallel import colshard

    rng = np.random.default_rng(5)
    for g, Wp in ((3, 17), (40, 33), (9, 65)):
        M = rng.integers(-(1 << 20), 1 << 20, size=(1, g, Wp, Wp),
                         dtype=np.int32)
        M[rng.random(M.shape) < 0.3] = tbl.SENT
        x = rng.integers(-(1 << 20), 1 << 20, size=Wp, dtype=np.int32)
        x[rng.random(Wp) < 0.3] = tbl.SENT
        x[-1] = 0
        chain = colshard.boundary_chain(torch.from_numpy(M), torch.from_numpy(x))
        want = tbl._propagate(chain)
        got = C.propagate_cuda(chain.to(card)).cpu()
        assert torch.equal(got, want)
        assert torch.equal(got[0, g], torch.from_numpy(x))


def test_make_mesh_on_card_and_without_one(card):
    """Every visible card a slot; with none visible, make_mesh raises."""
    import subprocess
    import sys

    from pbdagcon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert mesh.devices[0] == torch.device("cuda", 0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c",
         "from pbdagcon_tpu_torch.parallel.mesh import make_mesh\n"
         "try:\n    make_mesh()\nexcept RuntimeError as e:\n"
         "    print('raised', e)\n"],
        capture_output=True, text=True, timeout=120, cwd=root,
        env=dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES=""),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("raised"), res.stdout
