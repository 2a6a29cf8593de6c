"""Tests of the port that need a CUDA card (marker `cuda`): the
hand-written DP kernel against its plain PyTorch version, bitwise, and
the golden files through the port with the DP on the card. Each skips
without a card. This file imports no jax, so it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import io
import os

import numpy as np
import pytest
import torch

from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops import dp as tdp
from pbdagcon_tpu_torch.ops import dp_cuda
from pbdagcon_tpu_torch.pipeline import run_stream

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
