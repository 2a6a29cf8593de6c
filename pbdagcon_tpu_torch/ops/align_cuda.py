"""Wrappers of kernel X1, the hand-written Hopper aligner
(`csrc/align_scan.cu`).

`align_scan_cuda` replaces the XLA program
`pbdagcon_tpu/ops/align_tpu.py::_align_scan` and `traceback_cuda`
replaces `_traceback_scan`; the contracts are those of the plain PyTorch
versions `ops/align_tpu.py::align_scan_plain` and `traceback_plain`,
array-equal. Neither wrapper falls back to the plain version: each
checks what it is given, raises on anything the kernel does not take,
and raises if the build or the launch fails. Both launch on the current
stream without synchronising; outputs are `torch.empty` (every byte is
written).

`launches` counts each kernel's launches by name ("align_scan",
"align_traceback").
"""

from __future__ import annotations

import torch

from pbdagcon_tpu_torch.ops import _build

launches = {"align_scan": 0, "align_traceback": 0}

# The scan's CTA holds two rows of Wa + 1 int32 and 8 warp totals in
# shared memory: at most 227 KB on Hopper.
MAX_SMEM = 232_448


def scan_smem(Wa: int) -> int:
    """Dynamic shared memory of the scan's CTA (the kernel file's
    `dagcon_align_scan_smem`)."""
    return (2 * (Wa + 1) + 8) * 4


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def align_scan_cuda(
    qb: torch.Tensor,  # [B, M] uint8
    tb_pad: torch.Tensor,  # [B, T] uint8, T >= M + Wa
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    bw: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
) -> torch.Tensor:
    """Packed traceback pointers [B, M, Wa // 4] uint8 by the kernel."""
    device = qb.device
    if device.type != "cuda":
        raise ValueError(f"align_scan_cuda needs CUDA tensors, got {device}")
    if qb.dim() != 2 or tb_pad.dim() != 2:
        raise ValueError("qb and tb_pad must be [B, M] and [B, T]")
    B, T = qb.shape[0], tb_pad.shape[1]
    _check(qb, "qb", torch.uint8, (B, M), device)
    _check(tb_pad, "tb_pad", torch.uint8, (B, T), device)
    for name, t in (("m", m), ("n", n), ("bw", bw)):
        _check(t, name, torch.int32, (B,), device)
    if Wa <= 0 or Wa % 128:
        raise ValueError(f"Wa must be a positive multiple of 128, got {Wa}")
    if T < M + Wa:
        raise ValueError(f"tb_pad rows must hold M + Wa = {M + Wa} bytes, got {T}")
    if scan_smem(Wa) > MAX_SMEM:
        raise ValueError(f"Wa = {Wa} outgrows one CTA's shared memory")
    lib = _build.load("align_scan")
    packed = torch.empty((B, M, Wa // 4), dtype=torch.uint8, device=device)
    if B == 0 or M == 0:
        return packed
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_align_scan(
            qb.data_ptr(), tb_pad.data_ptr(), m.data_ptr(), n.data_ptr(),
            bw.data_ptr(), packed.data_ptr(), B, M, T, Wa, dmin, stream,
        )
    _build.check(lib, rc, "align_scan launch")
    launches["align_scan"] += 1
    return packed


def traceback_cuda(
    packed: torch.Tensor,  # [B, M, Wa // 4] uint8
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
    L: int,
) -> torch.Tensor:
    """Move streams [B, L] uint8 (0 diag, 1 up, 2 left, 3 done)."""
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"traceback_cuda needs CUDA tensors, got {device}")
    if packed.dim() != 3:
        raise ValueError(f"packed must be [B, M, Wa // 4], got {packed.shape}")
    B = packed.shape[0]
    if Wa <= 0 or Wa % 4:
        raise ValueError(f"Wa must be a positive multiple of 4, got {Wa}")
    _check(packed, "packed", torch.uint8, (B, M, Wa // 4), device)
    for name, t in (("m", m), ("n", n)):
        _check(t, name, torch.int32, (B,), device)
    if L < 0:
        raise ValueError(f"L must be >= 0, got {L}")
    lib = _build.load("align_scan")
    moves = torch.empty((B, L), dtype=torch.uint8, device=device)
    if B == 0 or L == 0:
        return moves
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_align_traceback(
            packed.data_ptr(), m.data_ptr(), n.data_ptr(), moves.data_ptr(),
            B, M, Wa, dmin, L, stream,
        )
    _build.check(lib, rc, "align_traceback launch")
    launches["align_traceback"] += 1
    return moves
