"""The plain-PyTorch model of the Hopper DP kernel's scan order
(`ops/dp.py::dp_scores_split_model`: each target starts at its last row
with a candidate, s[i] = max(near(i), far(i)) split at d0, far computed
d0 rows early, short long-edge registers folded into near) against the
plain version `dp_scores_reference` and the JAX package's `dp_scores`
(the XLA scan on the JAX CPU backend). The kernel, `csrc/dp_scan.cu`,
runs d0 = `kernel_d0(W)` (16 at W = 16, else 8); the model is also held
at other d0. Inputs come from numpy with fixed seeds. Tolerance: none
(bitwise, int32 views)."""

import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.alignment import normalize_gaps
from pbdagcon_tpu.ops import dp as jdp
from pbdagcon_tpu.ops.linearize import host_scores
from pbdagcon_tpu.ops.linearize import linearize as j_linearize
from pbdagcon_tpu.oracle.graph import AlnGraph
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops import dp as tdp

def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _hold(batch: dict, d0s=()) -> np.ndarray:
    """The model at each d0 and at the kernel's == reference == JAX,
    bitwise; the scores."""
    W = batch["win_count"].shape[2]
    d0s = sorted({*d0s, tdp.kernel_d0(W)})
    t = batch_to_torch(batch, "cpu")
    args = [t[k] for k in tdp.DP_ARGS]
    ref = tdp.dp_scores_reference(*args).numpy()
    jax = np.asarray(jdp.dp_scores(*(jnp.asarray(batch[k]) for k in tdp.DP_ARGS)))
    np.testing.assert_array_equal(_bits(ref), _bits(jax))
    for d0 in d0s:
        got = tdp.dp_scores_split_model(*args, d0=d0).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=f"d0={d0}")
    return ref


def _pallas_case_lins(seeds, length, cov, noise=None):
    """The inputs of tests/test_dp_pallas.py (same simulator, seeds and
    shapes)."""
    out = []
    for seed in seeds:
        rng = random.Random(seed)
        backbone, alns = simulate_pileup(
            rng, f"p{seed}", length, cov, noise or NoiseProfile()
        )
        g = AlnGraph(backbone)
        for a in alns:
            g.add_aln(normalize_gaps(a))
        g.merge_nodes()
        out.append(j_linearize(g, sid=f"p{seed}"))
    return out


@pytest.mark.parametrize("seeds,length,cov,noise", [
    (range(4), 150, 20, None),
    ([50, 51], 100, 80,
     NoiseProfile(sub=0.04, ins=0.18, dele=0.09, max_ins_run=4)),
    ([60, 61, 62], 80, 10, None),
], ids=["pallas_matches_xla", "high_depth_long_edges", "nonmultiple_batch"])
def test_split_model_on_dp_pallas_inputs(seeds, length, cov, noise):
    lins = _pallas_case_lins(seeds, length, cov, noise)
    need = max(l.n for l in lins)
    V = next(v for v in (64, 128, 256, 512, 1024, 2048) if need <= v)
    W, K = jdp.choose_layout(lins)
    ref = _hold(jdp.pad_batch(lins, V, W, K), d0s=(1, 4, 8))
    for i, lin in enumerate(lins):
        np.testing.assert_array_equal(_bits(ref[i, : lin.n]),
                                      _bits(host_scores(lin)))


@pytest.mark.parametrize("W", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("K", [8, 32, 128])
def test_split_model_random_grid(W, K):
    rng = np.random.default_rng(104729 * W + K)
    batch = tdp.random_batch(rng, 3, 2 * W + 37, W, K)
    assert (batch["long_u"] >= 0).any() and batch["unsup"].any()
    ref = _hold(batch)
    assert np.isfinite(ref).mean() > 0.3  # real paths, not all -inf


def test_kernel_d0():
    assert [tdp.kernel_d0(W) for W in (8, 16, 24, 32, 48, 128)] == [
        8, 16, 8, 8, 8, 8]


@pytest.mark.parametrize("d0", [1, 2, 3, 4, 8, 16])
def test_split_model_at_other_d0(d0):
    rng = np.random.default_rng(31 + d0)
    batch = tdp.random_batch(rng, 4, 83, 16, 32)
    edges = tdp.edge_batches(rng, 4, 83, 16, 32)
    _hold(batch, d0s=(d0,))
    _hold(edges["short_registers"], d0s=(d0,))


@pytest.mark.parametrize("W,K,V", [(16, 32, 90), (48, 8, 77), (8, 128, 61),
                                   (128, 8, 150)])
@pytest.mark.parametrize("name", [
    "far_below", "last_row", "long_only", "span_w_plus_1", "short_registers",
    "unsup_all", "empty", "ties",
])
def test_split_model_edge_cases(name, W, K, V):
    rng = np.random.default_rng(zlib.crc32(f"{name} {W} {K}".encode()))
    batch = tdp.edge_batches(rng, 5, V, W, K)[name]
    ref = _hold(batch, d0s=(4,))
    if name == "empty":
        assert np.isneginf(np.delete(ref, 5 // 2, axis=0)).all()
    if name == "far_below":
        top = tdp.start_rows(*(torch.from_numpy(batch[k]) for k in (
            "win_count", "exit_count", "long_u")))
        assert int(top.max()) < V // 8
    if name == "short_registers" and K:
        lu, lw = batch["long_u"], batch["long_w"]
        assert ((lw > lu) & (lw <= lu + tdp.kernel_d0(W))).any()


def test_start_rows():
    rng = np.random.default_rng(5)
    batch = tdp.random_batch(rng, 6, 120, 16, 8)
    batch["win_count"][0] = -1
    batch["exit_count"][0] = -1
    batch["long_u"][0] = -1
    batch["win_count"][1, 100:] = -1
    batch["exit_count"][1, 100:] = -1
    batch["exit_count"][1, 99] = 0
    batch["long_u"][1] = np.minimum(batch["long_u"][1], 50)
    batch["long_u"][2, 0] = 119
    batch["long_u"][3, 0] = 120  # past V: not a candidate
    top = tdp.start_rows(*(torch.from_numpy(batch[k]) for k in (
        "win_count", "exit_count", "long_u"))).tolist()
    want = []
    for b in range(6):
        rows = np.nonzero((batch["win_count"][b] >= 0).any(1)
                          | (batch["exit_count"][b] >= 0))[0]
        lu = batch["long_u"][b]
        lu = lu[(lu >= 0) & (lu < 120)]
        want.append(max([-1, *rows.tolist(), *lu.tolist()]))
    assert top == want
    assert top[0] == -1 and top[1] == 99 and top[2] == 119
    ref = _hold(batch)
    for b in range(6):
        assert np.isneginf(ref[b, top[b] + 1:]).all()
