"""Wrappers of kernel X2, the hand-written Hopper blocked max-plus solve
(`csrc/dp_blocked.cu`).

`compose_cuda`, `propagate_cuda` and `fill_cuda` replace the three
scans of `pbdagcon_tpu/ops/dp_blocked.py::_solve_band` (and the
shard-local compose and fill of `pbdagcon_tpu/parallel/colshard.py`);
`solve_band_cuda` runs the three in order. The contract is the plain
PyTorch version `ops/dp_blocked.py::_solve_band`, integer-equal. No
wrapper falls back to it: each checks what it is given, raises on
anything the kernels do not take, and raises if the build or the launch
fails. They launch on the current stream without synchronising; every
output is `torch.empty` (every element is written).

`launches` counts each kernel's launches by name ("blocked_compose",
"blocked_propagate", "blocked_fill").
"""

from __future__ import annotations

import torch

from pbdagcon_tpu_torch.ops import _build

launches = {"blocked_compose": 0, "blocked_propagate": 0, "blocked_fill": 0}

MAX_W = 128
MAX_L = 128
# One CTA's shared memory on Hopper.
MAX_SMEM = 232_448


def _staged_bytes(W: int, L: int) -> int:
    """One block's raw inputs staged in shared memory (the kernel file's
    `staged_bytes`)."""
    return L * 4 + (L * W + L + W) * 2 + -(-(L + W) // 16) * 16


def compose_smem(W: int, L: int) -> int:
    """Dynamic shared memory of the compose's CTA: the block's L rows of
    a, W + 2 rows of M and the staged block (the kernel file's
    `dagcon_blocked_compose_smem`)."""
    return (L * (W + 1) + (W + 2) * (W + 1)) * 4 + _staged_bytes(W, L)


def fill_smem(W: int, L: int) -> int:
    """Four warps' window rings, scores and staged blocks
    (`dagcon_blocked_fill_smem`)."""
    return 4 * (-(-((W + L) * 4 + _staged_bytes(W, L)) // 16) * 16)


def _check(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(win_count, cov, unsup, e_ex2, L) -> tuple[int, int, int]:
    device = win_count.device
    if device.type != "cuda":
        raise ValueError(f"the blocked solve's kernels need CUDA tensors, got {device}")
    if win_count.dim() != 3:
        raise ValueError(f"win_count must be [B, V, W], got {win_count.shape}")
    B, V, W = win_count.shape
    _check(win_count, "win_count", (torch.int16,), (B, V, W), device)
    _check(cov, "cov", (torch.int16,), (B, V), device)
    _check(unsup, "unsup", (torch.bool, torch.uint8), (B, V), device)
    _check(e_ex2, "e_ex2", (torch.int32,), (B, V), device)
    if not 1 <= W <= MAX_W:
        raise ValueError(f"kernels take 1 <= W <= {MAX_W}, got {W}")
    if not 1 <= L <= MAX_L or V == 0 or V % L:
        raise ValueError(f"kernels take 1 <= L <= {MAX_L} dividing V > 0, got "
                         f"L={L}, V={V}")
    if max(compose_smem(W, L), fill_smem(W, L)) > MAX_SMEM:
        raise ValueError(f"W={W}, L={L} outgrow one CTA's shared memory")
    return B, V, W


def compose_cuda(win_count, cov, unsup, e_ex2, L: int) -> torch.Tensor:
    """Block transfer matrices M [B, V // L, W + 1, W + 1] int32."""
    B, V, W = _check_band(win_count, cov, unsup, e_ex2, L)
    device = win_count.device
    lib = _build.load("dp_blocked")
    M = torch.empty((B, V // L, W + 1, W + 1), dtype=torch.int32, device=device)
    if B == 0:
        return M
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_blocked_compose(
            win_count.data_ptr(), cov.data_ptr(), unsup.data_ptr(),
            e_ex2.data_ptr(), M.data_ptr(), B, V, W, L, stream,
        )
    _build.check(lib, rc, "blocked_compose launch")
    launches["blocked_compose"] += 1
    return M


def propagate_cuda(M: torch.Tensor) -> torch.Tensor:
    """Incoming boundary vectors x_in [B, G, W + 1] int32 of every block
    from the transfer matrices M [B, G, W + 1, W + 1]."""
    device = M.device
    if device.type != "cuda":
        raise ValueError(f"propagate_cuda needs CUDA tensors, got {device}")
    if M.dim() != 4 or M.shape[2] != M.shape[3]:
        raise ValueError(f"M must be [B, G, W + 1, W + 1], got {M.shape}")
    B, G, Wp, _ = M.shape
    _check(M, "M", (torch.int32,), (B, G, Wp, Wp), device)
    if not 2 <= Wp <= MAX_W + 1 or G == 0:
        raise ValueError(f"kernel takes 1 <= W <= {MAX_W} and G > 0, got "
                         f"W={Wp - 1}, G={G}")
    lib = _build.load("dp_blocked")
    x_in = torch.empty((B, G, Wp), dtype=torch.int32, device=device)
    if B == 0:
        return x_in
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_blocked_propagate(
            M.data_ptr(), x_in.data_ptr(), B, G, Wp - 1, stream
        )
    _build.check(lib, rc, "blocked_propagate launch")
    launches["blocked_propagate"] += 1
    return x_in


def fill_cuda(win_count, cov, unsup, e_ex2, x_in, L: int) -> torch.Tensor:
    """Half-unit scores s2 [B, V] int32 of every block's interior from
    its incoming boundary x_in [B, V // L, W + 1]."""
    B, V, W = _check_band(win_count, cov, unsup, e_ex2, L)
    device = win_count.device
    _check(x_in, "x_in", (torch.int32,), (B, V // L, W + 1), device)
    lib = _build.load("dp_blocked")
    s2 = torch.empty((B, V), dtype=torch.int32, device=device)
    if B == 0:
        return s2
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_blocked_fill(
            win_count.data_ptr(), cov.data_ptr(), unsup.data_ptr(),
            e_ex2.data_ptr(), x_in.data_ptr(), s2.data_ptr(), B, V, W, L,
            stream,
        )
    _build.check(lib, rc, "blocked_fill launch")
    launches["blocked_fill"] += 1
    return s2


def solve_band_cuda(
    win_count: torch.Tensor,  # [B, V, W] int16, -1 = no edge
    cov: torch.Tensor,  # [B, V] int16
    unsup: torch.Tensor,  # [B, V] bool or uint8
    e_ex2: torch.Tensor,  # [B, V] int32 half-units
    L: int,
) -> torch.Tensor:
    """Half-unit scores [B, V] int32 of one banded solve: compose,
    propagate, fill."""
    M = compose_cuda(win_count, cov, unsup, e_ex2, L)
    x_in = propagate_cuda(M)
    return fill_cuda(win_count, cov, unsup, e_ex2, x_in, L)
