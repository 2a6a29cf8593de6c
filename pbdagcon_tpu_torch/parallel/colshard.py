"""Column-sharded consensus DP of one oversized target (port of
`pbdagcon_tpu/parallel/colshard.py`) on one card.

The reference shards the linearized node axis of ONE target over its
device mesh: each device composes its rows into one max-plus transfer
matrix, the boundary vectors hop right to left over the ring
(`ppermute`), and each device fills its interior. On one card the
shards are the blocks of the blocked solve (`ops/dp_blocked.py`, kernel
X2 at B = 1): the node axis is cut into blocks of `_blocked_L(V)` rows,
one CTA each for the compose and the fill, and the boundary chain runs
through the blocks in one CTA. The ring across several cards waits for
the multi-device slice (ROADMAP A14).

Exactness is the blocked solve's: int32 half-units, with the caller
guaranteeing `blocked_safe` and no long edges (span <= W); scores past
the f32-parity line raise `OverflowError` (the caller takes the exact
host DP).
"""

from __future__ import annotations

import numpy as np
import torch

from pbdagcon_tpu_torch.ops.dp_blocked import (
    SENT,
    _blocked_L,
    decode,
    exit_half_units,
    solve_band,
)


def colsharded_scores(
    win_count: np.ndarray,  # [V, W] int16/int32, -1 = none (ONE target)
    exit_count: np.ndarray,  # [V]
    cov: np.ndarray,  # [V]
    unsup: np.ndarray,  # [V] bool
    device="cuda",
) -> np.ndarray:
    """DP scores [V] f32 of one target, bitwise equal to the sequential
    f32 scan, by the blocked solve on `device` (the kernels on a card,
    the plain version on the CPU). The caller guarantees no long edges
    and the `blocked_safe` bound. Raises OverflowError if any score
    crosses the f32-parity line."""
    device = torch.device(device)
    V, W = win_count.shape
    L = _blocked_L(V)
    Vp = -(-max(V, 1) // L) * L
    # The kernels read the int16 wire format; counts past it never come
    # from the packer (it refuses them).
    dt = torch.int16 if device.type == "cuda" else torch.int32
    if device.type == "cuda" and (
        np.abs(np.asarray(win_count)).max(initial=0) > 32767
        or np.abs(np.asarray(cov)).max(initial=0) > 32767
    ):
        raise ValueError("counts past int16 do not fit the kernels")
    win = torch.full((1, Vp, W), -1, dtype=dt)
    win[0, :V] = torch.from_numpy(np.asarray(win_count, dtype=np.int32))
    cv = torch.zeros((1, Vp), dtype=dt)
    cv[0, :V] = torch.from_numpy(np.asarray(cov, dtype=np.int32))
    uns = torch.zeros((1, Vp), dtype=torch.bool)
    uns[0, :V] = torch.from_numpy(np.asarray(unsup, dtype=bool))
    # Padded rows have no edge and no exit: SENT rows, as the
    # reference pads its mesh's shards.
    e_ex = torch.full((1, Vp), SENT, dtype=torch.int32)
    e_ex[0, :V] = exit_half_units(
        torch.from_numpy(np.asarray(exit_count, dtype=np.int32))
    )
    s2 = solve_band(win.to(device), cv.to(device), uns.to(device),
                    e_ex.to(device), L)[:, :V]
    scores, overflow = decode(s2)
    if bool(overflow.any()):
        raise OverflowError("colshard scores beyond the f32-parity line")
    return scores[0].cpu().numpy()
