"""The warp route of kernel X1's traceback on the CPU: its model
(`ops/align_tpu.py::traceback_window_model`: stages of rows from m down,
each a window of bytes staged when the walk enters the stage before it,
the j == 0 lanes marked, steps outside the windows read from the packed
pointers by the reference's rules, the moves out as 16-byte blocks)
array-equal to `traceback_plain` on the scan's pointers, on random
pointer tensors whose walks leave every window, on tiny windows, on
lanes outside 0..Wa - 1, on cut L, and on one batch to the JAX package's
`_traceback_scan`; and the launch plan (`ops/align_cuda.py::
traceback_plan`). All comparisons are exact. The kernel itself is held
against the same plain version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import align_tpu as j_align
from pbdagcon_tpu_torch.ops import align_cuda, align_tpu
from test_torch_align import CASES
from test_torch_align_plan import MODEL_CASES, _batch


def _pointer_steps(moves, m, n):
    """Steps of each walk, from its moves, that read a pointer (i > 0
    and j > 0), and those off row 0 (i > 0: a window may hold j == 0)."""
    out = []
    for mv, i, j in zip(moves.numpy(), m.tolist(), n.tolist()):
        k = [0, 0]
        for p in mv.tolist():
            k[0] += i > 0 and j > 0
            k[1] += i > 0
            if p == 3:  # (0, 0), or a pointer 3 read there
                break
            i -= p <= 1
            j -= p in (0, 2)
        out.append(k)
    return np.array(out).reshape(-1, 2).T


def _hold(packed, m, n, M, Wa, dmin, L, **kw):
    """The model against the plain version; returns its counts."""
    got, counts = align_tpu.traceback_window_model(packed, m, n, M, Wa,
                                                   dmin, L, **kw)
    want = align_tpu.traceback_plain(packed, m, n, M, Wa, dmin, L)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    reads, off_row0 = _pointer_steps(want, m, n)
    assert (reads <= counts["fast"] + counts["slow"]).all()
    assert (counts["fast"] + counts["slow"] <= off_row0).all()
    assert ((want != 3).sum(dim=1).numpy() <= counts["steps"]).all()
    return counts


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_window_model_equals_the_plain_traceback(case):
    p, args = _batch(MODEL_CASES[case]())
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    counts = _hold(packed, args[2], args[3], M, Wa, dmin, L)
    # The windows hold the walks of pairs near the diagonal; the CPL
    # edges' skewed pairs take left runs past the margin, or more up
    # steps than a window holds to the right.
    near = abs((args[3] - args[2]).numpy()) < align_tpu.TB_WINDOW

    assert near.any() and (counts["slow"][near] == 0).all()
    # An event takes a diagonal run and the step after it at once.
    assert counts["events"].sum() < counts["fast"].sum()
    assert (counts["slow"].sum() > 0) == (case == "cpl-edges")


def test_window_model_on_a_cta_route_skew_batch():
    """Length skew past Wa = 1024 lanes: the scan plan sends it to
    "cta", whose pointers outside the band are not the closed form."""
    rng = np.random.default_rng(7)
    t = "".join(rng.choice(list("ACGT"), 1700))
    pairs = [(t[300 + 40 * k: 800], t[: 1200 + 100 * k]) for k in range(4)]
    pairs += [(t[: 1200 + 100 * k], t[50: 400 + 25 * k]) for k in range(4)]
    p, args = _batch(pairs, B=8)
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    assert Wa > 1024
    assert align_cuda.scan_plan(args[2], args[3], args[4], M, Wa,
                                dmin)["route"] == "cta"
    packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    _hold(packed, args[2], args[3], M, Wa, dmin, L)


def _random_walks(seed, B, M, Wa, probs, n_hi):
    """Random pointer tensors: each 2-bit field drawn from `probs` over
    (diag, up, left, 3); m in 0..M, n in 0..n_hi."""
    rng = np.random.default_rng(seed)
    f = rng.choice(4, size=(B, M, Wa // 4, 4), p=probs).astype(np.uint8)
    packed = (f << np.array([0, 2, 4, 6], np.uint8)).sum(
        axis=3, dtype=np.uint8)
    m = rng.integers(0, M + 1, B).astype(np.int32)
    n = rng.integers(0, n_hi + 1, B).astype(np.int32)
    m[0], n[0] = M, n_hi
    return (torch.from_numpy(packed), torch.from_numpy(m),
            torch.from_numpy(n))


@pytest.mark.parametrize("seed,probs", [
    (1, (0.2, 0.1, 0.7, 0.0)),     # long left runs: past every margin
    (2, (0.1, 0.7, 0.2, 0.0)),     # mostly up: the lane climbs
    (3, (0.25, 0.25, 0.25, 0.25)),  # with 3s: walks that stop
])
def test_window_model_on_random_pointers(seed, probs):
    packed, m, n = _random_walks(seed, 13, 200, 256, probs, 300)
    counts = _hold(packed, m, n, 200, 256, -64, 600)
    if probs[3] == 0:
        assert counts["slow"].sum() > 0 and counts["fast"].sum() > 0


@pytest.mark.parametrize("rows,window", [(1, 32), (8, 32), (32, 32),
                                         (64, 64), (96, 256), (200, 16),
                                         (128, 128)])
def test_window_model_on_forced_windows(rows, window):
    """Tiny windows and stages: walks leave them, by the count."""
    packed, m, n = _random_walks(4, 9, 150, 128, (0.3, 0.3, 0.4, 0.0), 200)
    counts = _hold(packed, m, n, 150, 128, -64, 400, rows=rows,
                   window=window)
    assert counts["slow"].sum() > 0
    p, args = _batch(CASES["noisy"]())
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    sp = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    _hold(sp, args[2], args[3], M, Wa, dmin, L, rows=rows, window=window)


def test_window_model_clamps_lanes_outside_the_row():
    """Walks from lanes below 0 and past Wa - 1: the byte index clamps
    and the shift takes lane & 3, negative lanes too."""
    packed, m, n = _random_walks(5, 6, 120, 64, (0.4, 0.3, 0.3, 0.0), 10)
    m[:] = torch.tensor([120, 100, 90, 5, 3, 60], dtype=torch.int32)
    n[:] = torch.tensor([2, 0, 7, 110, 90, 60], dtype=torch.int32)
    dmin = -8
    lanes = n - m - dmin
    assert (lanes < 0).any() and (lanes >= 64).any()
    counts = _hold(packed, m, n, 120, 64, dmin, 300)
    assert counts["slow"].sum() > 0


@pytest.mark.parametrize("L", [1, 2, 15, 17, 37, 100])
def test_window_model_cuts_long_paths(L):
    """L shorter than the paths, not a multiple of 16: rows start off
    16-byte boundaries, and a cut path has no 3."""
    p, args = _batch(CASES["mixed"]())
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    _hold(packed, args[2], args[3], M, Wa, dmin, L)
    pk, m, n = _random_walks(6, 5, 96, 128, (0.3, 0.3, 0.4, 0.0), 90)
    _hold(pk, m, n, 96, 128, -64, L)


@pytest.mark.parametrize("B", [1, 13])
def test_window_model_takes_a_batch_of_any_size(B):
    p, args = _batch(CASES["noisy"](), B=B)
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    _hold(packed, args[2], args[3], M, Wa, dmin, L)
    plan = align_cuda.traceback_plan(args[2], args[3], M, Wa, L, warps=8)
    assert len(plan["order"]) == 8 * -(-B // 8)


def test_window_model_equals_the_jax_traceback():
    p, args = _batch(align_tpu.warp_edge_pairs())
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    want = np.asarray(j_align._traceback_scan(
        jnp.asarray(packed.numpy()), jnp.asarray(p["m"]), jnp.asarray(p["n"]),
        M=M, Wa=Wa, dmin=dmin, L=L))
    got, _ = align_tpu.traceback_window_model(packed, args[2], args[3], M,
                                              Wa, dmin, L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_model_refuses_what_the_route_does_not_take():
    packed, m, n = _random_walks(8, 2, 16, 128, (0.4, 0.3, 0.3, 0.0), 16)
    with pytest.raises(ValueError, match="window"):
        align_tpu.traceback_window_model(packed, m, n, 16, 128, -64, 40,
                                         window=48)
    with pytest.raises(ValueError, match="window"):
        align_tpu.traceback_window_model(packed, m, n, 16, 96, -64, 40)


def test_traceback_plan_takes_the_bench_and_dazcon_geometry():
    rng = np.random.default_rng(0)
    m = rng.integers(300, 1280, 1024)
    n = np.clip(m + rng.integers(-150, 150, 1024), 1, None)
    M, Wa, L = 1280, 768, 2304
    plan = align_cuda.traceback_plan(m, n, M, Wa, L)
    assert plan["route"] == "warp"
    assert plan["warps"] == align_cuda.MAX_WARPS_PER_CTA  # 1024 / 132 SMs
    assert (plan["rows"], plan["window"]) == (align_tpu.TB_ROWS,
                                              align_tpu.TB_WINDOW)
    assert plan["smem"] == plan["warps"] * align_cuda.tb_slot(
        plan["rows"], plan["window"]) == 8 * (2 * 128 * 80 + 512)
    assert plan["smem"] <= align_cuda.MAX_SMEM
    order = plan["order"]
    assert sorted(order.tolist()) == list(range(1024))
    # Longest first: CTA g's first warp holds the g-th longest pair.
    G = len(order) // plan["warps"]
    firsts = order.reshape(G, plan["warps"])[:, 0]
    assert (np.diff((m + n)[firsts]) <= 0).all()
    assert firsts[0] == np.argmax(m + n)
    small = align_cuda.traceback_plan(m[:32], n[:32], M, Wa, L)
    assert small["route"] == "warp" and small["warps"] == 1
    assert len(small["order"]) == 32
    assert align_cuda.traceback_plan(m, n, M, Wa, L, route="thread") == {
        "route": "thread", "warps": 4, "smem": 0}
    # Tensors take the same plan as numpy arrays.
    got = align_cuda.traceback_plan(torch.from_numpy(m), torch.from_numpy(n),
                                    M, Wa, L)
    assert (got["order"] == plan["order"]).all()
    assert {k: v for k, v in got.items() if k != "order"} == {
        k: v for k, v in plan.items() if k != "order"}


def test_traceback_plan_refuses_what_a_route_does_not_take():
    m, n = np.array([5, 9]), np.array([4, 12])
    M, Wa, L = 16, 128, 64
    with pytest.raises(ValueError, match="0..M"):
        align_cuda.traceback_plan(np.array([5, 17]), n, M, Wa, L)
    with pytest.raises(ValueError, match="0..M"):
        align_cuda.traceback_plan(np.array([-1, 3]), n, M, Wa, L)
    with pytest.raises(ValueError, match="0..M"):
        align_cuda.traceback_plan(m, np.array([3, -2]), M, Wa, L)
    with pytest.raises(ValueError, match="route"):
        align_cuda.traceback_plan(m, n, M, Wa, L, route="cta")
    with pytest.raises(ValueError, match="multiple of 4"):
        align_cuda.traceback_plan(m, n, M, 130, L)
    with pytest.raises(ValueError, match="multiple of 64"):
        align_cuda.traceback_plan(m, n, M, 96, L, route="warp")
    # Only a forced plan takes "thread": an unforced one raises as well.
    with pytest.raises(ValueError, match="multiple of 64"):
        align_cuda.traceback_plan(m, n, M, 96, L)
    assert align_cuda.traceback_plan(m, n, M, 96, L, route="thread")[
        "route"] == "thread"
    with pytest.raises(ValueError, match="window"):
        align_cuda.traceback_plan(m, n, M, Wa, L, rows=257)
    with pytest.raises(ValueError, match="window"):
        align_cuda.traceback_plan(m, n, M, Wa, L, window=48)
    with pytest.raises(ValueError, match="window"):
        align_cuda.traceback_plan(m, n, M, Wa, L, window=512, rows=8)
    with pytest.raises(ValueError, match="warps"):
        align_cuda.traceback_plan(m, n, M, Wa, L, warps=9)
    with pytest.raises(ValueError, match="L must"):
        align_cuda.traceback_plan(m, n, M, Wa, -1)
    forced = align_cuda.traceback_plan(m, n, M, Wa, L, warps=3, rows=8,
                                       window=32)
    assert forced["warps"] == 3 and len(forced["order"]) == 3
