"""The port's DP against the JAX package's XLA scan and Pallas kernel
(interpret mode) on random packed batches over the whole (W, K) ladder:
W in {16, 32, 64, 128} x K in {8, 32, 128}, B not a multiple of 32, long
edges, unsup nodes, -1 gaps and empty rows past each target's n. Inputs
come from numpy with fixed seeds. Tolerance: none (bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pbdagcon_tpu.ops import dp as jdp
from pbdagcon_tpu.ops.dp_pallas import dp_scores_pallas
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops import dp as tdp


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("W", [16, 32, 64, 128])
@pytest.mark.parametrize("K", [8, 32, 128])
def test_dp_random_grid_matches_jax(W, K):
    rng = np.random.default_rng(7919 * W + K)
    batch = tdp.random_batch(rng, 5, 2 * W + 40, W, K)
    assert (batch["long_u"] >= 0).any() and batch["unsup"].any()
    args = [batch[k] for k in tdp.DP_ARGS]
    t = batch_to_torch(batch, "cpu")
    for k in tdp.DP_ARGS:
        assert t[k].dtype.itemsize == batch[k].dtype.itemsize
    port = tdp.dp_scores(*(t[k] for k in tdp.DP_ARGS)).numpy()
    scan = np.asarray(jdp.dp_scores(*(jnp.asarray(a) for a in args)))
    pallas = np.asarray(dp_scores_pallas(*args, tile_v=8, interpret=True))
    assert np.isfinite(port).mean() > 0.3  # real paths, not all -inf
    np.testing.assert_array_equal(_bits(port), _bits(scan))
    np.testing.assert_array_equal(_bits(port), _bits(pallas))
