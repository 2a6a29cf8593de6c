"""Kernel X2's plain PyTorch version (`pbdagcon_tpu_torch/ops/dp_blocked.py`)
against the JAX package's blocked solve (`pbdagcon_tpu/ops/dp_blocked.py`,
run on the CPU as its own tests run it) on the same numpy inputs: the
decoded scores bitwise, the flags equal, and the half-unit integers of
one solve equal; then against the port's sequential scan
(`dp_scores_reference`) and the host DP on every unflagged row. The
kernels themselves are held against this version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.alignment import normalize_gaps
from pbdagcon_tpu.oracle.graph import AlnGraph
from pbdagcon_tpu.ops import dp as jdp
from pbdagcon_tpu.ops import dp_blocked as jbl
from pbdagcon_tpu.ops.linearize import host_scores, linearize
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops import dp as tdp
from pbdagcon_tpu_torch.ops import dp_blocked as tbl
from pbdagcon_tpu_torch.ops import dp_blocked_cuda

NOISY = NoiseProfile(sub=0.04, ins=0.18, dele=0.09, max_ins_run=4)


def _lins(seeds, length, cov, noise=None):
    out = []
    for seed in seeds:
        rng = random.Random(seed)
        backbone, alns = simulate_pileup(
            rng, f"blk{seed}", length, cov, noise or NoiseProfile()
        )
        g = AlnGraph(backbone)
        for a in alns:
            g.add_aln(normalize_gaps(a))
        g.merge_nodes()
        out.append(linearize(g, sid=f"blk{seed}"))
    return out


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _both(batch: dict, L: int, max_iters: int = 8):
    """(reference scores, flags), (port scores, flags) on one batch."""
    args = [batch[k] for k in tdp.DP_ARGS]
    js, jf = jbl.dp_scores_blocked(
        *(jnp.asarray(a) for a in args), L=L, max_iters=max_iters
    )
    t = batch_to_torch(batch, "cpu")
    ts, tf = tbl.dp_scores_blocked(
        *(t[k] for k in tdp.DP_ARGS), L=L, max_iters=max_iters
    )
    return (np.asarray(js), np.asarray(jf)), (ts.numpy(), tf.numpy())


def _assert_same(batch: dict, L: int, max_iters: int = 8) -> np.ndarray:
    (js, jf), (ts, tf) = _both(batch, L, max_iters)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(tf, jf)
    # Unflagged rows equal the port's sequential scan, bitwise.
    t = batch_to_torch(batch, "cpu")
    seq = tdp.dp_scores_reference(*(t[k] for k in tdp.DP_ARGS)).numpy()
    np.testing.assert_array_equal(_bits(ts[~tf]), _bits(seq[~tf]))
    return tf


# The reference's pileups (tests/test_dp_blocked.py): plain, deep noisy,
# long edges at 80x, 150x depth, and a wide band at V = 8192, L = 128.
PILEUPS = {
    "cov20": dict(seeds=range(4), length=150, cov=20, V=1024),
    "cov60_noisy": dict(seeds=range(4, 6), length=120, cov=60, noise=NOISY,
                        V=2048),
    "cov80_long_edges": dict(seeds=[50, 51], length=100, cov=80, noise=NOISY,
                             V=2048),
    "high_depth": dict(seeds=[70], length=60, cov=150, V=2048),
    "wide_band_large_v": dict(seeds=[90], length=200, cov=100, noise=NOISY,
                              V=8192, WK=(64, 64)),
}


@pytest.mark.parametrize("case", sorted(PILEUPS))
def test_blocked_matches_reference_on_pileups(case):
    kw = dict(PILEUPS[case])
    V = kw.pop("V")
    WK = kw.pop("WK", None)
    lins = _lins(**kw)
    assert max(l.n for l in lins) <= V
    W, K = WK or jdp.choose_layout(lins)
    batch = jdp.pad_batch(lins, V, W, K)
    L = tbl._blocked_L(V)
    assert L == jdp._blocked_L(V)
    flags = _assert_same(batch, L)
    assert not flags.any(), "the reference converges on these pileups"
    t = batch_to_torch(batch, "cpu")
    s, _ = tbl.dp_scores_blocked(*(t[k] for k in tdp.DP_ARGS), L=L)
    for i, lin in enumerate(lins):
        np.testing.assert_array_equal(
            _bits(s[i, : lin.n].numpy()), _bits(host_scores(lin))
        )


@pytest.mark.parametrize("W", [16, 32, 64, 128])
def test_blocked_matches_reference_random_long_edges(W):
    rng = np.random.default_rng(7000 + W)
    batch = tdp.random_batch(rng, 6, 256, W, 16)
    assert (batch["long_u"] >= 0).any()
    _assert_same(batch, 64)
    # One solve's half-unit integers equal the reference's, sentinel-
    # contaminated values included.
    args = [batch[k] for k in ("win_count", "exit_count", "cov", "unsup")]
    je, jx = jbl._esc2_dense(*(jnp.asarray(a) for a in args))
    te, tx = tbl._esc2_dense(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(
        tbl._solve_band(te, tx, 64).numpy(),
        np.asarray(jbl._solve_band(je, jx, L=64)),
    )


def test_blocked_kleene_flags_at_max_iters():
    """A chain of long edges, each landing where the next one leaves,
    needs a Kleene round per edge: it stays active past `max_iters` and
    flags the same rows as the reference at every cap."""
    rng = np.random.default_rng(11)
    batch = tdp.random_batch(rng, 4, 192, 16, 16)
    for b in (0, 1):  # rows 2, 3 keep random_batch's long edges
        k = np.arange(10)
        batch["long_u"][b] = -1
        batch["long_w"][b] = -1
        batch["long_esc"][b] = -np.inf
        batch["long_u"][b, :10] = 190 - 18 * (k + 1)
        batch["long_w"][b, :10] = 190 - 18 * k
        batch["long_esc"][b, :10] = 5000.0  # above any band path
        batch["exit_count"][b, 190] = 5
    flagged = [_assert_same(batch, 64, max_iters=m) for m in (1, 2, 8, 12)]
    assert flagged[2][:2].all(), "a 10-edge chain outlasts 8 rounds"
    assert not flagged[3].any(), "and converges within 12"
    assert [f.sum() for f in flagged] == sorted(
        (f.sum() for f in flagged), reverse=True)


@pytest.mark.parametrize("name", ["far_below", "long_only", "span_w_plus_1",
                                  "unsup_all", "empty", "ties"])
def test_blocked_matches_reference_on_scan_edge_cases(name):
    rng = np.random.default_rng(42)
    batch = tdp.edge_batches(rng, 5, 128, 16, 8)[name]
    _assert_same(batch, 64)


def test_blocked_f32_parity_line_flags():
    """Scores past 2^24 - 2^17 half-units flag the row, as in the
    reference (tests/test_dp_blocked.py); blocked_scores re-runs it
    through the scan."""
    V, W = 128, 4
    win = np.full((2, V, W), -1, np.int32)
    win[0, :-1, 0] = 70000  # beyond the int16 wire; int32 input
    win[1, :-1, 0] = 7
    exit_c = np.full((2, V), -1, np.int32)
    exit_c[:, -1] = 0
    batch = {
        "win_count": win, "exit_count": exit_c,
        "cov": np.zeros((2, V), np.int32), "unsup": np.zeros((2, V), bool),
        "long_u": np.full((2, 1), -1, np.int32),
        "long_w": np.full((2, 1), -1, np.int32),
        "long_esc": np.full((2, 1), -np.inf, np.float32),
    }
    flags = _assert_same(batch, 64)
    assert flags.tolist() == [True, False]
    t = batch_to_torch(batch, "cpu")
    args = [t[k] for k in tdp.DP_ARGS]
    s, reruns = tbl.blocked_scores(*args, L=64)
    assert reruns == 1
    np.testing.assert_array_equal(
        _bits(s.numpy()), _bits(tdp.dp_scores_reference(*args).numpy())
    )


def test_blocked_safe_block_length_and_eligibility_grid():
    for v in (64, 4608, 8192, 8256, 14848, 16384, 34816, 1 << 20):
        assert tbl._blocked_L(v) == jdp._blocked_L(v)
        for esc in (0.0, 5.0, 30.0, 500.0, 760.0, 8191.0, 10000.0, 20000.0):
            assert tbl.blocked_safe(esc, v) == jbl.blocked_safe(esc, v)
            assert tbl.blocked_safe(-esc, v) == jbl.blocked_safe(-esc, v)
    # The reference's guard for backend="blocked" (ops/dp.py:796-803).
    rng = np.random.default_rng(3)
    for B, V, W, c in ((4, 4608, 16, 10), (2, 14848, 32, 400), (2, 700, 16, 5),
                       (1, 16384, 16, 8000), (3, 256, 64, 30000)):
        batch = {"win_count": np.full((B, V, W), c, np.int16),
                 "cov": rng.integers(0, c + 1, (B, V)).astype(np.int16)}
        max_esc = max(float(np.abs(batch["cov"]).max(initial=0)) * 0.5
                      + float(batch["win_count"].max(initial=0)), 10.0)
        want = V % jdp._blocked_L(V) == 0 and jbl.blocked_safe(max_esc, V)
        assert tbl.max_escore(batch) == max_esc
        assert tbl.blocked_eligible(batch) == want


def test_dispatch_cpu_never_launches_and_kernels_reject_cpu():
    rng = np.random.default_rng(5)
    t = batch_to_torch(tdp.random_batch(rng, 3, 128, 16, 4), "cpu")
    args = [t[k] for k in tdp.DP_ARGS]
    before = dict(dp_blocked_cuda.launches)
    tbl.dp_scores_blocked(*args)
    assert dp_blocked_cuda.launches == before
    e_ex = tbl.exit_half_units(args[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_blocked_cuda.solve_band_cuda(args[0], args[2], args[3], e_ex, 64)
    with pytest.raises(ValueError, match="no blocked DP"):
        tbl.solve_band(args[0].to("meta"), args[2], args[3], e_ex, 64)
    with pytest.raises(ValueError, match="multiple of L"):
        tbl.dp_scores_blocked(*(a[:, :100] if a.dim() > 1 and a.shape[1] == 128
                                else a for a in args))
    # Shared memory: the compose's CTA at the widest band and block.
    assert dp_blocked_cuda.compose_smem(128, 128) <= dp_blocked_cuda.MAX_SMEM
    assert dp_blocked_cuda.fill_smem(128, 128) <= dp_blocked_cuda.MAX_SMEM
