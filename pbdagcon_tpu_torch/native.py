"""The port's side of the native C++ engine.

The engine itself (`native/libdagcon.so`) and its ctypes bindings are
shared with the JAX package by import (`pbdagcon_tpu.native`), except
the batch packer: `NativeEngine.pack_batch` imports the JAX package's
`ops.dp`, which imports jax. `pack_batch` here calls the same C entry
point, `dagcon_pack_batch`, into one arena laid out by the port's
`ops.dp.arena_layout`, optionally in pinned host memory so that a single
non-blocking copy uploads the whole batch. `enc_fill_packed` does the
same for the device build's encoded inputs (`dagcon_enc_fill_packed`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pbdagcon_tpu.native import (  # noqa: F401
    NativeEngine,
    available,
    ensure_built,
)
from pbdagcon_tpu_torch.ops.dp import LongEdgeOverflow, arena_layout


def pack_batch(
    eng: NativeEngine,
    idxs: list[int],
    V: int,
    W: int,
    K: int,
    b_pad: int | None = None,
    pin_memory: bool = False,
) -> dict:
    """Threaded C++ packing of retained targets `idxs` into one arena
    (the contract of `NativeEngine.pack_batch`). Returns numpy views of
    the seven DP arrays, the arena as a uint8 tensor (`_arena`) and its
    `_dims` (B, V, W, K). Rows past len(idxs) up to `b_pad` stay empty.
    Raises `LongEdgeOverflow` on any target that does not fit."""
    B = len(idxs)
    Bp = max(b_pad or B, B)
    ia = np.asarray(idxs, dtype=np.int32)
    off = arena_layout(Bp, V, W, K)
    arena_t = torch.empty(off["_total"], dtype=torch.uint8, pin_memory=pin_memory)
    arena = arena_t.numpy()
    arena[off["win_count"][1] :] = 0  # the band is filled with -1 below

    def view(name, dtype, shape):
        a, b = off[name]
        return arena[a:b].view(dtype).reshape(shape)

    win = view("win_count", np.int16, (Bp, V, W))
    win[:] = -1
    exit_c = view("exit_count", np.int16, (Bp, V))
    exit_c[:] = -1
    cov = view("cov", np.int16, (Bp, V))
    unsup = view("unsup", np.uint8, (Bp, V))
    long_u = view("long_u", np.int32, (Bp, K))
    long_u[:] = -1
    long_w = view("long_w", np.int32, (Bp, K))
    long_w[:] = -1
    long_esc = view("long_esc", np.float32, (Bp, K))
    long_esc[:] = -np.inf

    def p(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = eng._lib.dagcon_pack_batch(
        eng._h, p(ia, ctypes.c_int32), B, V, W, K,
        p(win, ctypes.c_int16), p(exit_c, ctypes.c_int16),
        p(cov, ctypes.c_int16), p(unsup, ctypes.c_uint8),
        p(long_u, ctypes.c_int32), p(long_w, ctypes.c_int32),
        p(long_esc, ctypes.c_float),
    )
    if rc != 0:
        raise LongEdgeOverflow(
            f"target index {idxs[rc - 1]} does not fit (V={V}, W={W}, "
            f"K={K})"
        )
    return {
        "win_count": win,
        "exit_count": exit_c,
        "cov": cov,
        "unsup": unsup.view(bool),
        "long_u": long_u,
        "long_w": long_w,
        "long_esc": long_esc,
        "_arena": arena_t,
        "_dims": (Bp, V, W, K),
    }


def enc_fill_packed(
    eng: NativeEngine,
    idxs: list[int],
    R: int,
    C: int,
    L: int,
    NI: int,
    B: int | None = None,
    pin_memory: bool = False,
) -> tuple[torch.Tensor, ...]:
    """`NativeEngine.enc_fill_packed` into (optionally pinned) tensors,
    so that each uploads with one non-blocking copy: the device build's
    inputs (ops 2-bit packed [B, R, C//4] uint8, starts [B, R] int32, bb
    [B, L] uint8, ins [B, NI] uint8, Lr [B] int32) of the encoded
    targets `idxs`; rows past len(idxs) up to B stay empty."""
    if C % 4 != 0:
        raise ValueError(f"C={C} not a multiple of 4")
    n = len(idxs)
    Bp = max(B or n, n)
    shapes = (
        ((Bp, R, C // 4), torch.uint8), ((Bp, R), torch.int32),
        ((Bp, L), torch.uint8), ((Bp, NI), torch.uint8), ((Bp,), torch.int32),
    )
    ts = tuple(
        torch.zeros(s, dtype=dt, pin_memory=pin_memory) for s, dt in shapes
    )
    ops, starts, bb, ins, Lr = (t.numpy() for t in ts)
    ia = np.asarray(idxs, dtype=np.int32)

    def p(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = eng._lib.dagcon_enc_fill_packed(
        eng._h, p(ia, ctypes.c_int32), n, R, C, L, NI,
        p(ops, ctypes.c_uint8), p(starts, ctypes.c_int32),
        p(bb, ctypes.c_uint8), p(ins, ctypes.c_uint8), p(Lr, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"encoded target does not fit caps (rc={rc})")
    return ts
