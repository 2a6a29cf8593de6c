"""The warp route of kernel X1's scan on the CPU: its model
(`ops/align_tpu.py::align_scan_window_model`: each pair's lane span from
`scan_windows`, rows 1..min(m + 1, M) computed, row 1 over all lanes, the
closed form everywhere else) array-equal to `align_scan_plain` and, on
one batch, to the JAX package's `_align_scan`; and the launch plan
(`ops/align_cuda.py::scan_plan`) that routes a batch to "warp" or "cta".
All comparisons are exact. The kernel itself is held against the same
plain version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import align_tpu as j_align
from pbdagcon_tpu_torch.aligner import band_halfwidth
from pbdagcon_tpu_torch.ops import align_cuda, align_tpu
from test_torch_align import CASES

KEYS = ("qb", "tb_pad", "m", "n", "bw")


MODEL_CASES = {
    **{f"align-{k}": v for k, v in CASES.items()},
    "cpl-edges": align_tpu.warp_edge_pairs,
    "short": align_tpu.short_pairs,
}


def _batch(pairs, B=None):
    p = align_tpu.prepare_batch(pairs)
    B = len(p["m"]) if B is None else B
    return p, [torch.from_numpy(np.ascontiguousarray(p[k][:B]))
               for k in KEYS]


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_window_model_equals_the_plain_scan(case):
    p, args = _batch(MODEL_CASES[case]())
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    got = align_tpu.align_scan_window_model(*args, M, Wa, dmin)
    want = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)


def test_window_model_cases_reach_their_edges():
    p, _ = _batch(align_tpu.warp_edge_pairs())
    B = p["B"]
    m, n, bw = p["m"][:B], p["n"][:B], p["bw"][:B]
    _, cpl = align_tpu.scan_windows(m, n, bw, p["Wa"], p["dmin"])
    assert set(cpl.tolist()) == set(align_cuda.CPL_CLASSES)
    assert (n < m).any() and (n > m).any()
    # Ladder padding: m = n = 1, bw = 64 past the real pairs.
    assert len(p["m"]) > B and (p["m"][B:] == 1).all()
    assert (p["bw"][B:] == 64).all()
    sp, _ = _batch(align_tpu.short_pairs())
    assert (sp["m"][: sp["B"]] == 1).any()
    assert (sp["m"] + 1 <= -sp["dmin"]).all()


def test_window_model_takes_a_batch_of_any_size():
    """B not a multiple of the warps a CTA holds, the ladder cut off."""
    p, args = _batch(CASES["noisy"](), B=21)
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    assert torch.equal(align_tpu.align_scan_window_model(*args, M, Wa, dmin),
                       align_tpu.align_scan_plain(*args, M, Wa, dmin))


def test_window_model_equals_the_jax_scan():
    p, args = _batch(align_tpu.warp_edge_pairs())
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    want = np.asarray(j_align._align_scan(
        *(jnp.asarray(p[k]) for k in KEYS), M=M, Wa=Wa, dmin=dmin))
    got = align_tpu.align_scan_window_model(*args, M, Wa, dmin).numpy()
    np.testing.assert_array_equal(got, want)


def test_closed_form_marks_the_j0_lane():
    out = align_tpu.scan_closed_form(2, 6, 128, -4)
    assert out.shape == (2, 6, 32)
    # Rows 1-4 hold j == 0 at lanes 3, 2, 1, 0; rows 5-6 at lanes < 0.
    for i, k0 in ((1, 3), (2, 2), (3, 1), (4, 0)):
        row = out[0, i - 1].clone()
        assert int(row[k0 // 4]) == 0xAA ^ (3 << (2 * (k0 % 4)))
        row[k0 // 4] = 0xAA
        assert (row == 0xAA).all()
    assert (out[:, 4:] == 0xAA).all()


def _geometry(ms, ns):
    """m, n, bw, M, Wa, dmin of pairs of these lengths, as
    `prepare_batch` pads them."""
    pairs = [("A" * a, "C" * b) for a, b in zip(ms, ns)]
    p = align_tpu.prepare_batch(pairs)
    return p["m"], p["n"], p["bw"], p["M"], p["Wa"], p["dmin"]


def test_plan_routes_the_bench_geometry_to_warp():
    rng = np.random.default_rng(0)
    ms = rng.integers(300, 1280, 1024)
    ns = np.clip(ms + rng.integers(-150, 150, 1024), 1, None)
    m, n, bw, M, Wa, dmin = _geometry(ms, ns)
    assert (M, len(m)) == (1280, 1024) and Wa <= 1024
    plan = align_cuda.scan_plan(m, n, bw, M, Wa, dmin)
    assert plan["route"] == "warp"
    assert plan["warps"] == align_cuda.MAX_WARPS_PER_CTA  # 1024 / 132 SMs
    assert plan["smem"] == plan["warps"] * align_cuda.warp_slot(M)
    # The snake: every pair once, the -1 slots last; each CTA's work
    # within the heaviest pair's of the mean.
    order = plan["order"]
    assert len(order) == 1024 and sorted(order.tolist()) == list(range(1024))
    _, cpl = align_tpu.scan_windows(m, n, bw, Wa, dmin)
    work = (np.minimum(m + 1, M) * cpl)[order].reshape(-1, plan["warps"])
    assert np.ptp(work.sum(axis=1)) <= work.max()
    _, cpl = align_tpu.scan_windows(m, n, bw, Wa, dmin)
    assert plan["cpl_max"] == cpl.max() <= align_tpu.WARP_MAX_CPL
    assert sum(plan["cpl_counts"].values()) == len(m)
    assert set(plan["cpl_counts"]) <= set(align_cuda.CPL_CLASSES)
    assert align_cuda.scan_plan(m, n, bw, M, Wa, dmin, route="cta") == {
        "route": "cta", "smem": align_cuda.scan_smem(Wa)}
    p3 = align_cuda.scan_plan(m[:21], n[:21], bw[:21], M, Wa, dmin,
                              route="warp", warps=3)
    assert p3["warps"] == 3 and len(p3["order"]) == 21
    assert align_cuda.scan_plan(m[:21], n[:21], bw[:21], M, Wa, dmin)[
        "warps"] == 1
    order = align_cuda.scan_plan(m[:22], n[:22], bw[:22], M, Wa, dmin,
                                 warps=4)["order"]
    assert len(order) == 24 and sorted(order.tolist())[:2] == [-1, -1]
    with pytest.raises(ValueError, match="warps"):
        align_cuda.scan_plan(m, n, bw, M, Wa, dmin, warps=9)


def test_plan_routes_wide_skew_to_cta_and_refuses_warp():
    """Length skew past Wa = 1024 lanes (tests/test_torch_cuda.py's skew
    case): the spans outgrow a warp."""
    ms = [500 - 50 * k for k in range(6)] + [1500 + 100 * k for k in range(6)]
    ns = [1500 + 100 * k for k in range(6)] + [300 + 30 * k for k in range(6)]
    m, n, bw, M, Wa, dmin = _geometry(ms, ns)
    assert Wa > 1024
    assert align_cuda.scan_plan(m, n, bw, M, Wa, dmin)["route"] == "cta"
    with pytest.raises(ValueError, match="lanes a thread"):
        align_cuda.scan_plan(m, n, bw, M, Wa, dmin, route="warp")


def test_plan_refuses_what_a_route_does_not_take():
    m, n, bw, M, Wa, dmin = _geometry([40, 50], [45, 60])
    with pytest.raises(ValueError, match="band"):  # a band too narrow
        align_cuda.scan_plan(m, n, bw - 1, M, Wa, dmin, route="warp")
    assert align_cuda.scan_plan(m, n, bw - 1, M, Wa, dmin)["route"] == "cta"
    m0 = m.copy()
    m0[0] = 0
    with pytest.raises(ValueError, match="below 1"):
        align_cuda.scan_plan(m0, n, bw, M, Wa, dmin, route="warp")
    with pytest.raises(ValueError, match="shared memory"):  # M too long
        align_cuda.scan_plan(m, n, bw, 240_000, Wa, dmin, route="warp")
    with pytest.raises(ValueError, match="shared memory"):  # Wa too wide
        align_cuda.scan_plan(m, n, bw, M, 29_056, dmin, route="cta")
    with pytest.raises(ValueError, match="route"):
        align_cuda.scan_plan(m, n, bw, M, Wa, dmin, route="block")
    with pytest.raises(ValueError, match="multiple of 128"):
        align_cuda.scan_plan(m, n, bw, M, Wa - 4, dmin)
    # Tensors take the same plan as numpy arrays.
    got = align_cuda.scan_plan(
        *(torch.from_numpy(x) for x in (m, n, bw)), M, Wa, dmin)
    want = align_cuda.scan_plan(m, n, bw, M, Wa, dmin)
    assert got.keys() == want.keys() and (got["order"] == want["order"]).all()
    assert {k: v for k, v in got.items() if k != "order"} == {
        k: v for k, v in want.items() if k != "order"}
    assert band_halfwidth(40, 45) == bw[0]
