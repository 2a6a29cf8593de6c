"""Build and load the port's CUDA kernels (`csrc/dp_scan.cu`,
`csrc/hist_scatter.cu`, `csrc/pk_variants.cu`, `csrc/align_scan.cu`,
`csrc/dp_blocked.cu`).

`nvcc` compiles `csrc/<name>.cu` at first use into a shared library with
a plain C interface, in `pbdagcon_tpu_torch/_build/` (listed in
.gitignore), and `ctypes` loads it. Nothing is built at import time. The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. A failed
build raises with nvcc's stderr.

Flags: `sm_90a` (Hopper), and `--fmad=false` so that no
multiply and add are contracted into an FMA (the DP's exactness rests on
round-to-nearest float32 steps, like the native engine's "never
-ffast-math" rule).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's stderr of each build made by this process (ptxas prints the
# kernels' registers, shared memory and spills there).
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        "source at first use"
    )


def build(name: str, defines: tuple[str, ...] = ()) -> str:
    """Compile `csrc/<name>.cu` if its library is missing; return the
    library's path. `defines` ("NAME=VALUE") are passed to nvcc as -D
    (the DP's ablation builds, `tools/dp_ablate.py`)."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    with open(src, "rb") as f:
        digest = hashlib.sha1(
            f.read() + " ".join(flags).encode()
        ).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[" ".join((name, *defines))] = res.stderr
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stderr}{res.stdout}"
        )
    os.replace(tmp, path)
    return path


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    key = " ".join((name, *defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(name, defines))
            _bind(name, lib)
            _libs[key] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "dp_scan":
        lib.dagcon_dp_scan.restype = ci
        lib.dagcon_dp_scan.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    if name == "hist_scatter":
        lib.dagcon_hist.restype = ci
        # (values, valid, out, B, N, D, plan x 5, stream)
        lib.dagcon_hist.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
        lib.dagcon_scatter.restype = ci
        # (ranks, valid, payloads, outs, NP, B, N, D, cut_mask, plan x 5,
        # stream)
        lib.dagcon_scatter.argtypes = [
            vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp), ci, ci, ci, ci,
            ctypes.c_uint, *[ci] * 5, vp,
        ]
    if name == "pk_variants":
        lib.dagcon_hist_wgmma.restype = ci
        lib.dagcon_hist_wgmma.argtypes = [vp, vp] + [ci] * 6 + [vp]
        lib.dagcon_hist_row.restype = ci
        # (values, out, B, N, D, slots, smem, stream)
        lib.dagcon_hist_row.argtypes = [vp, vp] + [ci] * 5 + [vp]
        lib.dagcon_scatter_tile.restype = ci
        # (ranks, payloads, outs, NP, B, N, D, cut_mask, tiles, bins,
        # stages, smem, stream)
        lib.dagcon_scatter_tile.argtypes = [
            vp, ctypes.POINTER(vp), ctypes.POINTER(vp), ci, ci, ci, ci,
            ctypes.c_uint, *[ci] * 4, vp,
        ]
    if name == "align_scan":
        lib.dagcon_align_scan.restype = ci
        # (qb, tb_pad, m, n, bw, packed, order, B, M, T, Wa, dmin, route,
        # warps, cpl_max, smem, stream)
        lib.dagcon_align_scan.argtypes = [vp] * 7 + [ci] * 9 + [vp]
        lib.dagcon_align_traceback.restype = ci
        # (packed, m, n, moves, order, B, M, Wa, dmin, L, route, warps,
        # rows, window, smem, stream)
        lib.dagcon_align_traceback.argtypes = [vp] * 5 + [ci] * 10 + [vp]
        lib.dagcon_align_replay.restype = ci
        # (moves, qb, tb_pad, m, n, gq, gt, plen, B, M, T, L, dmin, stream)
        lib.dagcon_align_replay.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    if name == "dp_blocked":
        for fn, argtypes in (
            # (win, cov, unsup, eex, M, B, V, W, L, route, blocks,
            # threads, smem, stream)
            ("dagcon_blocked_compose", [vp] * 5 + [ci] * 8 + [vp]),
            # (M, x_in, B, G, W, route, warps, depth, chunk, smem, stream)
            ("dagcon_blocked_propagate", [vp] * 2 + [ci] * 8 + [vp]),
            # (win, cov, unsup, eex, x_in, s2, B, V, W, L, route, blocks,
            # warps, smem, stream)
            ("dagcon_blocked_fill", [vp] * 6 + [ci] * 8 + [vp]),
        ):
            getattr(lib, fn).restype = ci
            getattr(lib, fn).argtypes = argtypes
    lib.dagcon_cuda_error_string.restype = ctypes.c_char_p
    lib.dagcon_cuda_error_string.argtypes = [ci]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.dagcon_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
