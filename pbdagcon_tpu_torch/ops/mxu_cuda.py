"""Wrappers of the hand-written Hopper histogram and scatter kernels
(`csrc/hist_scatter.cu`).

`hist_cuda` replaces the TPU kernel `pbdagcon_tpu/ops/mxu.py::_pallas_hist`
and `scatter_cuda` replaces `pbdagcon_tpu/ops/mxu.py::_pallas_scatter`;
the contracts are those of `ops/mxu.py` (the plain PyTorch versions sit
there too). Neither wrapper falls back to the plain version: each checks
what it is given, raises on anything the kernel does not take, and
raises if the build or the launch fails. Both allocate their zeroed
outputs and launch on the current stream without synchronising.

`launches` counts each kernel's launches by name ("hist", "scatter").
"""

from __future__ import annotations

import ctypes

import torch

from pbdagcon_tpu_torch.ops import _build

launches = {"hist": 0, "scatter": 0}
MAX_PAYLOADS = 4


def _check_rows(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dims(values: torch.Tensor, D: int) -> tuple[int, int]:
    if values.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {values.device}")
    if values.dim() != 2:
        raise ValueError(f"expected [B, N], got {tuple(values.shape)}")
    B, N = values.shape
    if B > 65535 or N >= 1 << 31 or not 0 <= D < 1 << 31:
        raise ValueError(f"kernel takes B <= 65535, N, D < 2^31; got "
                         f"B={B}, N={N}, D={D}")
    return B, N


def hist_cuda(values: torch.Tensor, D: int) -> torch.Tensor:
    """[B, D] int32 counts of each row's values in [0, D) (others
    dropped) by the CUDA kernel. values: [B, N] int32, contiguous."""
    B, N = _dims(values, D)
    _check_rows(values, "values", (B, N), values.device)
    lib = _build.load("hist_scatter")
    out = torch.zeros((B, D), dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.dagcon_hist(values.data_ptr(), out.data_ptr(), B, N, D, stream)
    _build.check(lib, rc, "hist launch")
    launches["hist"] += 1
    return out


def _check_scatter(ranks, payloads, D: int, cut_mask: int) -> tuple[int, int]:
    """(B, N) of a scatter's arguments; raises on what the kernels do not
    take."""
    B, N = _dims(ranks, D)
    if not 1 <= len(payloads) <= MAX_PAYLOADS:
        raise ValueError(f"kernel takes 1..{MAX_PAYLOADS} payloads, got "
                         f"{len(payloads)}")
    if not 0 < cut_mask <= 0xFFFFFFFF:
        raise ValueError(f"cut_mask must be a nonzero 32-bit mask, got {cut_mask}")
    _check_rows(ranks, "ranks", (B, N), ranks.device)
    for k, p in enumerate(payloads):
        _check_rows(p, f"payloads[{k}]", (B, N), ranks.device)
    return B, N


def scatter_cuda(
    ranks: torch.Tensor, payloads: tuple[torch.Tensor, ...], D: int,
    cut_mask: int,
) -> tuple[torch.Tensor, ...]:
    """out[k][b, ranks[b, n]] += payloads[k][b, n] & cut_mask, int32 with
    wraparound, by the CUDA kernel; ranks outside [0, D) dropped.
    ranks and each payload: [B, N] int32, contiguous. Returns one [B, D]
    int32 tensor per payload."""
    B, N = _check_scatter(ranks, payloads, D, cut_mask)
    lib = _build.load("hist_scatter")
    outs = tuple(
        torch.zeros((B, D), dtype=torch.int32, device=ranks.device)
        for _ in payloads
    )
    NP = len(payloads)
    p_arr = (ctypes.c_void_p * NP)(*(p.data_ptr() for p in payloads))
    o_arr = (ctypes.c_void_p * NP)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(ranks.device):
        stream = torch.cuda.current_stream(ranks.device).cuda_stream
        rc = lib.dagcon_scatter(
            ranks.data_ptr(), p_arr, o_arr, NP, B, N, D, cut_mask, stream
        )
    _build.check(lib, rc, "scatter launch")
    launches["scatter"] += 1
    return outs
