"""The port's batch packer (`pbdagcon_tpu_torch.native.pack_batch`)
against the JAX package's `NativeEngine.pack_batch`: the same C entry
point, so the arena must be byte-identical, and the same targets must
overflow. Also the port's layout choice against the JAX pipeline's, and
the packed batch's scores against the native host DP (bitwise)."""

import os

import numpy as np
import pytest
import torch

from pbdagcon_tpu import native as jnative
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.ops.dp import LongEdgeOverflow as JaxOverflow
from pbdagcon_tpu.pipeline import _choose_layout_native as jax_layout
from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops import dp as tdp
from pbdagcon_tpu_torch.pipeline import _choose_layout_native

DATA = os.path.join(os.path.dirname(__file__), "data")


def _engine(mod):
    e = mod.NativeEngine(min_weight=6, min_length=100, threads=2)
    with open(os.path.join(DATA, "golden1.m5"), "rb") as f:
        count = e.linearize_text(f.read(), fmt="m5")
    assert count == 4
    return e


@pytest.fixture
def eng():
    if not native.available():
        pytest.skip("native library not built")
    with _engine(native) as e:
        yield e


@pytest.fixture
def jeng():
    """The JAX package's engine on the same input: its `pack_batch` is
    the reference the port's packer is held against."""
    if not jnative.available():
        pytest.skip("native library not built")
    with _engine(jnative) as e:
        yield e


def _v(eng) -> int:
    return 1 << int(eng.metas(4)[:, 0].max() - 1).bit_length()


@pytest.mark.parametrize("b_pad", [None, 7])
def test_pack_batch_arena_bytes_match_native(eng, jeng, b_pad):
    idxs = [0, 1, 2, 3]
    W, K, outliers = _choose_layout_native(eng, idxs, DagconConfig())
    assert (W, K, outliers) == jax_layout(jeng, idxs, JaxConfig())
    V = _v(eng)
    got = native.pack_batch(eng, idxs, V, W, K, b_pad=b_pad)
    want = jeng.pack_batch(idxs, V, W, K, b_pad=b_pad)
    assert got["_dims"] == want["_dims"]
    assert got["_arena"].dtype == torch.uint8
    assert got["_arena"].numpy().tobytes() == want["_arena"].tobytes()
    for k in tdp.DP_ARGS:
        np.testing.assert_array_equal(got[k], want[k])


def test_pack_batch_subset_and_order(eng, jeng):
    V = _v(eng)
    got = native.pack_batch(eng, [3, 1], V, 32, 8)
    want = jeng.pack_batch([3, 1], V, 32, 8)
    assert got["_arena"].numpy().tobytes() == want["_arena"].tobytes()


@pytest.mark.parametrize("W,K", [(16, 0), (16, 1), (16, 2), (32, 0)])
def test_pack_batch_overflow_on_same_targets(eng, jeng, W, K):
    V = _v(eng)
    for i in range(4):
        try:
            jeng.pack_batch([i], V, W, K)
            jax_raised = False
        except JaxOverflow:
            jax_raised = True
        if jax_raised:
            with pytest.raises(tdp.LongEdgeOverflow):
                native.pack_batch(eng, [i], V, W, K)
        else:
            native.pack_batch(eng, [i], V, W, K)
    if (W, K) == (16, 0):
        # Every golden target has long edges at W=16.
        with pytest.raises(tdp.LongEdgeOverflow, match="does not fit"):
            native.pack_batch(eng, [0, 1, 2, 3], V, W, K)


def test_packed_scores_match_native_host_dp(eng):
    idxs = [0, 1, 2, 3]
    W, K, _ = _choose_layout_native(eng, idxs, DagconConfig())
    batch = native.pack_batch(eng, idxs, _v(eng), W, K)
    s = tdp.submit_arena_scores(batch["_arena"], batch["_dims"], "cpu").result()
    t = batch_to_torch(batch, "cpu")
    assert t["unsup"].dtype == torch.bool and t["win_count"].dtype == torch.int16
    s2 = tdp.dp_scores(*(t[k] for k in tdp.DP_ARGS)).numpy()
    np.testing.assert_array_equal(s.view(np.int32), s2.view(np.int32))
    for j, i in enumerate(idxs):
        n = int(eng.metas(4)[i, 0])
        host = eng.target_scores(i, n)
        np.testing.assert_array_equal(
            s[j, :n].view(np.int32), host[:n].view(np.int32)
        )
