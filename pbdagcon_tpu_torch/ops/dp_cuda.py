"""Wrapper of the hand-written Hopper DP kernel (`csrc/dp_scan.cu`).

Replaces the TPU kernel `pbdagcon_tpu/ops/dp_pallas.py::_dp_kernel`:
the same contract as `ops/dp.py::dp_scores`, bitwise. The kernel source
says what bounds it on the card and how its design answers that. The
plain PyTorch version is `ops/dp.py::dp_scores_reference`; this wrapper
never falls back to it. It checks what it is given, raises on anything
the kernel does not take, and raises if the build or the launch fails.

`launches` counts the kernel's launches (one per call that launches).
"""

from __future__ import annotations

import torch

from pbdagcon_tpu_torch.ops import _build

launches = 0


def _check(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dp_scores_cuda(
    win_count: torch.Tensor,  # [B, V, W] int16, -1 = no edge
    exit_count: torch.Tensor,  # [B, V] int16, -1 = no edge
    cov: torch.Tensor,  # [B, V] int16
    unsup: torch.Tensor,  # [B, V] bool or uint8
    long_u: torch.Tensor,  # [B, K] int32, -1 = unused slot
    long_w: torch.Tensor,  # [B, K] int32
    long_esc: torch.Tensor,  # [B, K] float32
) -> torch.Tensor:
    """Scores [B, V] f32 by the CUDA kernel, on the inputs' device and
    its current stream (no synchronisation)."""
    global launches
    device = win_count.device
    if device.type != "cuda":
        raise ValueError(f"dp_scores_cuda needs CUDA tensors, got {device}")
    if win_count.dim() != 3:
        raise ValueError(f"win_count must be [B, V, W], got {win_count.shape}")
    B, V, W = win_count.shape
    K = long_u.shape[1] if long_u.dim() == 2 else -1
    _check(win_count, "win_count", (torch.int16,), (B, V, W), device)
    _check(exit_count, "exit_count", (torch.int16,), (B, V), device)
    _check(cov, "cov", (torch.int16,), (B, V), device)
    _check(unsup, "unsup", (torch.bool, torch.uint8), (B, V), device)
    _check(long_u, "long_u", (torch.int32,), (B, K), device)
    _check(long_w, "long_w", (torch.int32,), (B, K), device)
    _check(long_esc, "long_esc", (torch.float32,), (B, K), device)
    if not (8 <= W <= 128 and W % 8 == 0):
        raise ValueError(f"kernel takes 8 <= W <= 128 with W % 8 == 0, got {W}")
    if K > 128:
        raise ValueError(f"kernel takes K <= 128 long edges, got {K}")
    if win_count.data_ptr() % 16:
        raise ValueError("win_count must be 16-byte aligned")
    lib = _build.load("dp_scan")
    out = torch.empty((B, V), dtype=torch.float32, device=device)
    if B == 0 or V == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_dp_scan(
            win_count.data_ptr(), exit_count.data_ptr(), cov.data_ptr(),
            unsup.data_ptr(), long_u.data_ptr(), long_w.data_ptr(),
            long_esc.data_ptr(), out.data_ptr(), B, V, W, K, stream,
        )
    _build.check(lib, rc, "dp_scan launch")
    launches += 1
    return out
