"""The port's DP (`pbdagcon_tpu_torch.ops.dp`) against the JAX package's
three forms of it: the XLA scan `ops.dp.dp_scores` on the JAX CPU
backend, the Pallas kernel `ops.dp_pallas.dp_scores_pallas` in interpret
mode, and the host DP `ops.linearize.host_scores`. Both packages get the
same packed batch (the JAX package's `pad_batch`, handed over by
`convert.batch_to_torch`). Tolerance: none, scores must be bitwise equal
(the DP's candidates are exact float32 sums and max is exact).

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.alignment import normalize_gaps
from pbdagcon_tpu.ops import dp as jdp
from pbdagcon_tpu.ops.dp_pallas import dp_scores_pallas
from pbdagcon_tpu.ops.linearize import host_scores, linearize
from pbdagcon_tpu.oracle.graph import AlnGraph
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops import dp as tdp
from pbdagcon_tpu_torch.ops import dp_cuda


def _lins(seeds, length=150, cov=20, noise=None):
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
        out.append(linearize(g, sid=f"p{seed}"))
    return out


def _v_bucket(lins):
    need = max(l.n for l in lins)
    return next(v for v in (64, 128, 256, 512, 1024, 2048) if need <= v)


# The three cases of tests/test_dp_pallas.py.
CASES = {
    "four_targets": dict(seeds=range(4)),
    "cov80_long_edges": dict(
        seeds=[50, 51], length=100, cov=80,
        noise=NoiseProfile(sub=0.04, ins=0.18, dele=0.09, max_ins_run=4),
    ),
    "batch_of_3": dict(seeds=[60, 61, 62], length=80, cov=10),
}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _jax_forms(batch: dict) -> tuple[np.ndarray, np.ndarray]:
    args = [batch[k] for k in tdp.DP_ARGS]
    scan = np.asarray(jdp.dp_scores(*(jnp.asarray(a) for a in args)))
    pallas = np.asarray(dp_scores_pallas(*args, tile_v=8, interpret=True))
    return scan, pallas


def _port(batch: dict, device="cpu") -> np.ndarray:
    t = batch_to_torch(batch, device)
    return tdp.dp_scores(*(t[k] for k in tdp.DP_ARGS)).cpu().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_matches_jax_scan_pallas_and_host(case):
    lins = _lins(**CASES[case])
    V = _v_bucket(lins)
    W, K = jdp.choose_layout(lins)
    assert tdp.choose_layout(lins) == (W, K)
    if case == "cov80_long_edges":
        assert K >= 8  # the point of this case: long edges present
    batch = jdp.pad_batch(lins, V, W, K)
    ported = tdp.pad_batch(lins, V, W, K)
    for k, v in batch.items():
        np.testing.assert_array_equal(ported[k], v)
        assert ported[k].dtype == v.dtype

    port = _port(batch)
    scan, pallas = _jax_forms(batch)
    assert port.shape == (len(lins), V)
    np.testing.assert_array_equal(_bits(port), _bits(scan))
    np.testing.assert_array_equal(_bits(port), _bits(pallas))
    for i, lin in enumerate(lins):
        np.testing.assert_array_equal(
            _bits(port[i, : lin.n]), _bits(host_scores(lin))
        )
        assert np.all(np.isneginf(port[i, lin.n :]))  # rows past n


def test_dp_reference_takes_int32_and_arena_views():
    """The plain version takes the JAX contract's int32/bool inputs and
    the arena's uint8 unsup view alike."""
    lins = _lins([3, 4], length=120)
    V = _v_bucket(lins)
    W, K = tdp.choose_layout(lins)
    batch = tdp.pad_batch(lins, V, W, K)
    want = _port(batch)
    wide = dict(batch)
    for k in ("win_count", "exit_count", "cov"):
        wide[k] = batch[k].astype(np.int32)
    np.testing.assert_array_equal(_bits(_port(wide)), _bits(want))

    arena = tdp.to_arena(wide)
    views = tdp.unpack_arena(torch.from_numpy(arena), len(lins), V, W, K)
    assert views[3].dtype == torch.uint8
    got = tdp.submit_arena_scores(
        torch.from_numpy(arena), (len(lins), V, W, K), "cpu"
    ).result()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(tdp.dp_scores(*views).numpy()), _bits(want)
    )


def test_dp_cpu_never_launches_and_kernel_rejects_cpu():
    lins = _lins([7])
    batch = tdp.pad_batch(lins, _v_bucket(lins), *tdp.choose_layout(lins))
    before = dp_cuda.launches
    _port(batch)
    assert dp_cuda.launches == before
    t = batch_to_torch(batch, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_cuda.dp_scores_cuda(*(t[k] for k in tdp.DP_ARGS))


def test_pad_batch_overflow_and_oversize():
    lins = _lins(**CASES["cov80_long_edges"])
    W, K = tdp.choose_layout(lins)
    with pytest.raises(tdp.LongEdgeOverflow):
        tdp.pad_batch(lins, _v_bucket(lins), 16, 0)
    with pytest.raises(ValueError, match="bucket V"):
        tdp.pad_batch(lins, 8, W, K)
