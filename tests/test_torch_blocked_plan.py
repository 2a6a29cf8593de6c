"""The new routes of kernel X2 on the CPU: the models of the compose's
"column" route (`ops/dp_blocked.py::compose_column_model`: a thread a
column, the column in per-thread registers renamed by the step, split
accumulators, the CTA packing of the plan), of the propagate's "warp"
route (`propagate_ring_model`: the run of M staged in ring slots as a
bulk-copied middle and lane-copied head and tail words, a row set a
lane, split accumulators, the exit row over the lanes) and of the fill's
"lane" route (`fill_lane_model`: a lane per pending row, the newest
score passed by a shuffle, blocks packed into a warp, the start terms
from x_in, the clamp as the accumulator's start, the terms formed from
the raw band at the clamped node index), integer-equal to the plain
phases `_compose`, `_propagate` and `_fill`; the solve built from the
three models integer-equal to the JAX package's `_solve_band` on its
pileups, on random batches and on values at the sentinel; and the
launch plans (`ops/dp_blocked_cuda.py::compose_plan`, `propagate_plan`,
`fill_plan`). All comparisons are exact. The kernels themselves are
held against the plain phases in tests/test_torch_cuda.py and
chip_smoke.py phase 11."""

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


def _hold(batch: dict, L: int, plans=(None, None, None), bases=(0, 3)
          ) -> None:
    """The models against the plain phases, and the solve built from
    them (the fill's terms from the raw band) against the JAX package's
    `_solve_band`, on one batch."""
    t = {k: torch.from_numpy(np.asarray(batch[k])) for k in BAND}
    esc2, ex2 = tbl._esc2_dense(*(t[k] for k in BAND))
    a = tbl._rows(esc2, ex2, L)
    M = tbl._compose(a)
    M_model = tbl.compose_column_model(a, plans[0])
    assert torch.equal(M_model, M)
    x_in = tbl._propagate(M)
    for base in bases:
        assert torch.equal(tbl.propagate_ring_model(M, plans[1], base), x_in)
    assert torch.equal(tbl.fill_lane_model(a, x_in, plans[2]),
                       tbl._fill(a, x_in))
    je, jx = jbl._esc2_dense(*(jnp.asarray(batch[k]) for k in BAND))
    want = np.asarray(jbl._solve_band(je, jx, L=L))
    band = (t["win_count"], t["cov"], t["unsup"])
    got = tbl.fill_lane_model(a, tbl.propagate_ring_model(M_model, plans[1]),
                              plans[2], band)
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
        tbl.fill_lane_model(a, torch.zeros((1, 1, 17), dtype=torch.int32),
                            C.fill_plan(1, 1, 16, 64, route="reduce"))
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


def _band_case(rng, B, G, L, W, none=0.3):
    """A raw band (win_count with `none` of its slots -1, cov, unsup),
    its exits and its a rows, as the solve forms them."""
    V = G * L
    win = rng.integers(0, 60, (B, V, W))
    win = np.where(rng.random((B, V, W)) < none, -1, win)
    t = {"win_count": torch.from_numpy(win.astype(np.int16)),
         "cov": torch.from_numpy(rng.integers(0, 120, (B, V)).astype(np.int16)),
         "unsup": torch.from_numpy(rng.random((B, V)) < 0.2)}
    ex = np.where(rng.random((B, V)) < 0.5, tbl.SENT,
                  rng.integers(-40, 40, (B, V)))
    t["e_ex"] = torch.from_numpy(ex.astype(np.int32))
    esc2 = tbl._esc2_band(t["win_count"], t["cov"], t["unsup"])
    return t, tbl._rows(esc2, t["e_ex"], L)


@pytest.mark.parametrize("W", [1, 16, 32, 33, 128])
def test_fill_model_at_the_sentinel(W):
    """No-edge slots (count < 0) beside large scores, and x_in at and
    just above SENT: each no-edge term SENT + s[u] is a term of its row
    (a sentinel-contaminated value above SENT where s[u] > 0), and the
    model keeps it where `_fill` does, on the raw band too. Exits below
    SENT on rows with no edge: the row's clamp to SENT decides them."""
    rng = np.random.default_rng(500 + W)
    B, G, L = 2, 2, 64
    t, a = _band_case(rng, B, G, L, W, none=0.7)
    # Rows with no edge and no exit: only their no-edge terms reach them.
    bare = torch.from_numpy(rng.random((B, G * L)) < 0.3)
    t["win_count"][bare] = -1
    t["e_ex"][bare] = tbl.SENT
    t["e_ex"] = torch.where(t["e_ex"] == tbl.SENT, t["e_ex"],
                            t["e_ex"] + (1 << 26))  # large exits: large s
    low = bare & torch.from_numpy(rng.random((B, G * L)) < 0.5)
    t["e_ex"][low] = tbl.SENT - torch.from_numpy(
        rng.integers(1, 1 << 20, int(low.sum())).astype(np.int32))
    a = tbl._rows(tbl._esc2_band(t["win_count"], t["cov"], t["unsup"]),
                  t["e_ex"], L)
    raw = rng.integers(-(1 << 20), 1 << 27, (B, G, W + 1))
    near = rng.random(raw.shape)
    raw = np.where(near < 0.3, tbl.SENT, raw)
    raw = np.where((near >= 0.3) & (near < 0.6),
                   tbl.SENT + rng.integers(1, 64, raw.shape), raw)
    x_in = torch.from_numpy(raw.astype(np.int32))
    x_in[..., W] = 0
    want = tbl._fill(a, x_in)
    assert ((want > tbl.SENT) & (want < tbl._REAL_MIN)).any()
    assert (want > 0).any()
    assert torch.equal(tbl.fill_lane_model(a, x_in), want)
    band = (t["win_count"], t["cov"], t["unsup"])
    assert torch.equal(tbl.fill_lane_model(a, x_in, band=band), want)


@pytest.mark.parametrize("W,G", [(16, 1), (32, 3), (128, 2), (128, 3)])
def test_fill_model_clamps_the_last_blocks_node_index(W, G):
    """The last blocks' boundary slots target nodes past V - 1: their
    cov and unsup are node V - 1's (x_in there is whatever the propagate
    gave, here random). The model, forming each term from the raw band,
    equals `_fill` on the esc2 that `_esc2_band` clamps; with W = 128 at
    L = 64 the clamp reaches the last two blocks."""
    rng = np.random.default_rng(40 + W + G)
    B, L = 2, 64
    t, a = _band_case(rng, B, G, L, W, none=0.1)
    t["cov"][:, -1] = 1000
    t["unsup"][:, -1] = False
    a = tbl._rows(tbl._esc2_band(t["win_count"], t["cov"], t["unsup"]),
                  t["e_ex"], L)
    x_in = torch.from_numpy(rng.integers(-500, 500, (B, G, W + 1)).astype(np.int32))
    band = (t["win_count"], t["cov"], t["unsup"])
    want = tbl._fill(a, x_in)
    assert torch.equal(tbl.fill_lane_model(a, x_in, band=band), want)
    # Node V - 1's cov reaches the scores: a band with another cov there
    # gives other scores.
    t["cov"][:, -1] = 0
    other = tbl.fill_lane_model(a, x_in, band=(t["win_count"], t["cov"],
                                                t["unsup"]))
    assert not torch.equal(other, want)


@pytest.mark.parametrize("W,blocks", [(16, 1), (16, 2), (8, 3), (5, 6),
                                      (1, 1), (1, 7), (1, 32)])
def test_fill_model_under_forced_packings(W, blocks):
    """Every packing the plan can force gives every slot one lane and the
    same scores, across warp and target edges (B * G not a multiple of
    the blocks)."""
    rng = np.random.default_rng(W * 100 + blocks)
    B, G, L = 3, 5, 64
    t, a = _band_case(rng, B, G, L, W)
    x_in = tbl._propagate(tbl._compose(a))
    plan = C.fill_plan(B, G, W, L, blocks=blocks)
    assert plan["blocks"] == blocks
    band = (t["win_count"], t["cov"], t["unsup"])
    want = tbl._fill(a, x_in)
    assert torch.equal(tbl.fill_lane_model(a, x_in, plan), want)
    assert torch.equal(tbl.fill_lane_model(a, x_in, plan, band), want)


@pytest.mark.parametrize("L", [64, 128])
def test_fill_plan_at_every_width(L):
    for W in range(1, 129):
        for B, G in ((0, 3), (1, 1), (1, 245), (37, 11), (512, 88)):
            plan = C.fill_plan(B, G, W, L)
            assert plan["route"] == "lane"
            nb, warps = plan["blocks"], plan["warps"]
            assert 1 <= nb <= C.lane_max_blocks(W)
            assert nb == C.lane_max_blocks(W) or C.lane_warp_bytes(
                W, L, nb + 1) > C.LANE_WARP_TARGET
            assert 1 <= warps <= C.LANE_WARPS
            assert plan["smem"] == warps * C.lane_warp_bytes(W, L, nb)
            assert plan["smem"] <= C.MAX_SMEM
            # Two CTAs an SM where the warps allow it.
            assert warps == 1 or -(-B * G // nb) >= 2 * C.SMS * warps
            assert C.fill_plan(B, G, W, L, route="reduce") == {
                "route": "reduce", "blocks": 1, "warps": C.FILL_WARPS,
                "smem": C.fill_smem(W, L)}
            for bad in (0, C.lane_max_blocks(W) + 1):
                with pytest.raises(ValueError):
                    C.fill_plan(B, G, W, L, blocks=bad)
            with pytest.raises(ValueError):
                C.fill_plan(B, G, W, L, route="reduce", blocks=2)
    bench = C.fill_plan(512, 88, 16, 64)
    assert (bench["blocks"], bench["warps"]) == (2, 4)
    assert C.fill_plan(1, 245, 32, 128) == {
        "route": "lane", "blocks": 1, "warps": 1,
        "smem": C.lane_warp_bytes(32, 128, 1)}
    for bad in (dict(route="warp"), dict(W=129), dict(L=0), dict(G=0),
                dict(B=-1)):
        args = {"B": 1, "G": 1, "W": 16, "L": L, **bad}
        route = args.pop("route", None)
        with pytest.raises(ValueError):
            C.fill_plan(args["B"], args["G"], args["W"], args["L"], route=route)
