"""The new routes of kernel X2 on the CPU: the models of the compose's
"column" route (`ops/dp_blocked.py::compose_column_model`: a thread a
column, the column in per-thread registers renamed by the step, split
accumulators, the CTA packing of the plan) and of the propagate's "warp"
route (`propagate_ring_model`: the run of M staged in ring slots as a
bulk-copied middle and lane-copied head and tail words, a row set a
lane, split accumulators, the exit row over the lanes), integer-equal
to the plain phases `_compose` and `_propagate`; the solve built from
them through `_fill` integer-equal to the JAX package's `_solve_band` on
its pileups, on random batches and on values at the sentinel; and the
launch plans (`ops/dp_blocked_cuda.py::compose_plan`, `propagate_plan`).
All comparisons are exact. The kernels themselves are held against the
plain phases in tests/test_torch_cuda.py and chip_smoke.py phase 11."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import dp as jdp
from pbdagcon_tpu.ops import dp_blocked as jbl
from pbdagcon_tpu_torch.ops import dp as tdp
from pbdagcon_tpu_torch.ops import dp_blocked as tbl
from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C
from test_torch_dp_blocked import PILEUPS, _lins

BAND = ("win_count", "exit_count", "cov", "unsup")


def _hold(batch: dict, L: int, plans=(None, None), bases=(0, 3)) -> None:
    """The models against the plain phases, and the solve built from
    them against the JAX package's `_solve_band`, on one batch."""
    t = {k: torch.from_numpy(np.asarray(batch[k])) for k in BAND}
    esc2, ex2 = tbl._esc2_dense(*(t[k] for k in BAND))
    a = tbl._rows(esc2, ex2, L)
    M = tbl._compose(a)
    M_model = tbl.compose_column_model(a, plans[0])
    assert torch.equal(M_model, M)
    x_in = tbl._propagate(M)
    for base in bases:
        assert torch.equal(tbl.propagate_ring_model(M, plans[1], base), x_in)
    je, jx = jbl._esc2_dense(*(jnp.asarray(batch[k]) for k in BAND))
    want = np.asarray(jbl._solve_band(je, jx, L=L))
    got = tbl._fill(a, tbl.propagate_ring_model(M_model, plans[1]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [64, 128])
@pytest.mark.parametrize("W", [1, 16, 17, 32, 33, 64, 128])
def test_models_equal_plain_phases_and_reference_solve(W, L, G):
    rng = np.random.default_rng(1000 * W + 10 * L + G)
    _hold(tdp.random_batch(rng, 3, G * L, W, 4), L)


def test_models_on_one_oversize_sized_target():
    """G = 245 blocks of L = 128 at W = 32: the oversize cell's shape."""
    rng = np.random.default_rng(245)
    _hold(tdp.random_batch(rng, 1, 245 * 128, 32, 4), 128, bases=(1,))


@pytest.mark.parametrize("case", sorted(PILEUPS))
def test_models_on_the_reference_pileups(case):
    kw = dict(PILEUPS[case])
    V = kw.pop("V")
    WK = kw.pop("WK", None)
    lins = _lins(**kw)
    W, K = WK or jdp.choose_layout(lins)
    _hold(jdp.pad_batch(lins, V, W, K), tbl._blocked_L(V))


@pytest.mark.parametrize("W", [16, 32, 64])
def test_models_at_the_sentinel(W):
    """Edge scores and exits at and just above SENT, and M entries near
    it: the contaminated values the clamps decide."""
    rng = np.random.default_rng(77 + W)
    B, L, G = 2, 64, 3
    Wp = W + 1
    a = np.where(rng.random((B, G, L, Wp)) < 0.5,
                 tbl.SENT + rng.integers(0, 40, (B, G, L, Wp)),
                 rng.integers(-30, 30, (B, G, L, Wp)))
    a = torch.from_numpy(a.astype(np.int32))
    M = tbl._compose(a)
    assert (M < tbl._REAL_MIN).any() and (M > tbl.SENT).any()
    assert torch.equal(tbl.compose_column_model(a), M)
    raw = np.where(rng.random((B, G, Wp, Wp)) < 0.6,
                   tbl.SENT + rng.integers(0, 64, (B, G, Wp, Wp)),
                   rng.integers(-1000, 1000, (B, G, Wp, Wp)))
    Mr = torch.from_numpy(raw.astype(np.int32))
    want = tbl._propagate(Mr)
    for base in range(4):
        assert torch.equal(tbl.propagate_ring_model(Mr, base=base), want)


@pytest.mark.parametrize("blocks", [1, 2, 3, 9, 15])
def test_column_model_under_forced_packings(blocks):
    """Every packing the plan can force covers each column once (the
    model asserts it) and gives the same M, across CTA and target
    edges (B * G not a multiple of the blocks)."""
    rng = np.random.default_rng(blocks)
    batch = tdp.random_batch(rng, 3, 5 * 64, 16, 4)
    t = {k: torch.from_numpy(batch[k]) for k in BAND}
    a = tbl._rows(*tbl._esc2_dense(*(t[k] for k in BAND)), 64)
    plan = C.compose_plan(3, 5, 16, 64, blocks=blocks)
    assert torch.equal(tbl.compose_column_model(a, plan), tbl._compose(a))


@pytest.mark.parametrize("depth,chunk", [(2, 1), (3, 1), (7, 1), (2, 3),
                                         (3, 2), (2, 4), (1, 7)])
def test_ring_model_under_forced_plans(depth, chunk):
    """Every depth and chunk a plan can force keeps the producer and the
    consumer apart (the model asserts no deadlock and no x overwritten
    before x_in has it), at a misaligned tensor, with a short last
    chunk."""
    rng = np.random.default_rng(10 * depth + chunk)
    raw = rng.integers(tbl.SENT, 1 << 20, (2, 7, 18, 18))
    M = torch.from_numpy(raw.astype(np.int32))
    plan = C.propagate_plan(2, 7, 17, warps=2, depth=depth, chunk=chunk)
    assert torch.equal(tbl.propagate_ring_model(M, plan, base=2),
                       tbl._propagate(M))
    with pytest.raises(ValueError):  # one slot of two chunks or more
        C.propagate_plan(2, 7, 17, depth=1, chunk=chunk % 7 or 1)


def test_models_refuse_the_other_routes_plans():
    a = torch.zeros((1, 1, 64, 17), dtype=torch.int32)
    with pytest.raises(ValueError):
        tbl.compose_column_model(a, C.compose_plan(1, 1, 16, 64, route="cta"))
    with pytest.raises(ValueError):
        tbl.propagate_ring_model(torch.zeros((1, 1, 17, 17), dtype=torch.int32),
                                 C.propagate_plan(1, 1, 16, route="cta"))


@pytest.mark.parametrize("L", [64, 128])
def test_compose_plan_at_every_width(L):
    for W in range(1, 129):
        for B, G in ((1, 1), (1, 245), (37, 11), (512, 88)):
            plan = C.compose_plan(B, G, W, L)
            new = W in C.COLUMN_WIDTHS and L % W == 0
            assert plan["route"] == ("column" if new else "cta"), (W, L)
            assert plan["smem"] <= C.MAX_SMEM
            cta = C.compose_plan(B, G, W, L, route="cta")
            assert cta == {"route": "cta", "blocks": 1,
                           "threads": -(-(W + 1) // 32) * 32,
                           "smem": C.compose_smem(W, L)}
            if not new:
                assert plan == cta
                with pytest.raises(ValueError):
                    C.compose_plan(B, G, W, L, route="column")
                continue
            nb = plan["blocks"]
            assert plan["threads"] == -(-nb * (W + 1) // 32) * 32
            assert plan["threads"] <= C.COLUMN_MAX_THREADS
            assert plan["smem"] == C.column_smem(W, L, nb)
            assert plan["smem"] <= C.COLUMN_SMEM_TARGET or nb == 1
            assert -(-B * G // nb) >= min(B * G, 2 * C.SMS)
            for bad in (0, C.COLUMN_MAX_BLOCKS + 1):
                with pytest.raises(ValueError):
                    C.compose_plan(B, G, W, L, blocks=bad)
    with pytest.raises(ValueError):
        C.compose_plan(1, 1, 16, L, route="tile")
    with pytest.raises(ValueError):
        C.compose_plan(1, 1, 129, L)


def test_compose_plan_packs_the_lanes():
    """The bench batch's packing: 3 blocks of 17 columns on 64 threads
    (51 busy); one oversize target: a block a CTA, 245 CTAs."""
    assert C.compose_plan(512, 88, 16, 64) == {
        "route": "column", "blocks": 3, "threads": 64,
        "smem": C.column_smem(16, 64, 3)}
    assert C.compose_plan(1, 245, 32, 128)["blocks"] == 1


def test_propagate_plan_at_every_width():
    for W in range(1, 129):
        for B, G in ((0, 3), (1, 1), (1, 245), (37, 11), (512, 88)):
            plan = C.propagate_plan(B, G, W)
            assert plan["route"] == "warp"
            K, d = plan["chunk"], plan["depth"]
            nc = -(-G // K)
            assert plan["smem"] == plan["warps"] * C.prop_warp_bytes(
                W, d, K) <= C.MAX_SMEM
            assert 1 <= plan["warps"] <= C.PROP_WARPS
            assert 1 <= K <= min(G, C.PROP_CHUNK)
            assert min(nc, 2) <= d <= min(nc, C.PROP_DEPTH)
            assert C.propagate_plan(B, G, W, route="cta") == {
                "route": "cta", "warps": 0, "depth": 0, "chunk": 0,
                "smem": C.propagate_smem(W)}
            for kw in (dict(depth=nc + 1), dict(depth=0), dict(warps=0),
                       dict(warps=C.PROP_MAX_WARPS + 1), dict(chunk=0),
                       dict(chunk=G + 1), dict(route="cta", warps=2),
                       *([dict(depth=1, chunk=1)] if G > 1 else [])):
                with pytest.raises(ValueError):
                    C.propagate_plan(B, G, W, **kw)
    # A ring that outgrows a CTA's shared memory is refused.
    with pytest.raises(ValueError):
        C.propagate_plan(8, 64, 128, warps=8, depth=8)
    with pytest.raises(ValueError):
        C.propagate_plan(1, 1, 16, route="ring")
