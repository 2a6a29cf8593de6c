"""Column-sharded consensus DP of one oversized target over a mesh (port
of `pbdagcon_tpu/parallel/colshard.py`).

The reference shards the linearized node axis of ONE target over its
device mesh: each device composes its rows into one max-plus transfer
matrix, the boundary vectors hop right to left over the ring
(`ppermute`), and each device fills its interior. Here the node axis is
cut into the blocks of the blocked solve (`ops/dp_blocked.py`, kernel
X2 at B = 1) of `_blocked_L(V)` rows, and slot d of the mesh
(`parallel/mesh.py`) takes blocks [d G / D, (d + 1) G / D):

1. every slot composes its blocks' transfer matrices M_i (X2's compose;
   the slots are independent);
2. the boundary chain runs right to left over the slots: slot d
   propagates (X2's propagate) over [I, M_0 .. M_{g-1}, M_x], where M_x
   holds the incoming boundary x in its column W and SENT elsewhere, so
   that M_x (x) x0 = x exactly (x0: SENT, 0 at W, the propagate's own
   start), and the x_in of the identity I is the slot's outgoing
   boundary; that vector of W + 1 int32 is copied to slot d - 1's
   device (the hop);
3. every slot fills its blocks (X2's fill) from their x_in.

The chain is the one-device chain over all G blocks, link for link, so
the scores are integer-equal to D = 1 whatever D is. A slot's edges
reach W nodes into the next slot, whose coverage they read: every slot
but the last also holds the next ceil(W / L) blocks (its halo), which
it composes and fills but whose results it drops. With one slot the
solve is `solve_band`, the kernels in order, as before the mesh.

Exactness is the blocked solve's: int32 half-units, with the caller
guaranteeing `blocked_safe` and no long edges (span <= W); scores past
the f32-parity line raise `OverflowError` (the caller takes the exact
host DP).

`hops` counts the boundary copies between slots.
"""

from __future__ import annotations

import numpy as np
import torch

from pbdagcon_tpu_torch.ops import dp_blocked as dpb
from pbdagcon_tpu_torch.ops.dp_blocked import (
    SENT,
    _blocked_L,
    decode,
    exit_half_units,
    solve_band,
)
from pbdagcon_tpu_torch.parallel.mesh import Mesh

hops = 0


def _compose(band, L: int) -> torch.Tensor:
    """Block transfer matrices of one slot: X2's compose on a card, the
    plain phase on the CPU."""
    if band[0].device.type == "cuda":
        from pbdagcon_tpu_torch.ops.dp_blocked_cuda import compose_cuda

        return compose_cuda(*band, L)
    return dpb._compose(_a_rows(band, L))


def _propagate(M: torch.Tensor) -> torch.Tensor:
    if M.device.type == "cuda":
        from pbdagcon_tpu_torch.ops.dp_blocked_cuda import propagate_cuda

        return propagate_cuda(M)
    return dpb._propagate(M)


def _fill(band, x_in: torch.Tensor, L: int) -> torch.Tensor:
    if x_in.device.type == "cuda":
        from pbdagcon_tpu_torch.ops.dp_blocked_cuda import fill_cuda

        return fill_cuda(*band, x_in, L)
    return dpb._fill(_a_rows(band, L), x_in)


def _a_rows(band, L: int) -> torch.Tensor:
    win, cov, unsup, e_ex = band
    return dpb._rows(dpb._esc2_band(win, cov, unsup), e_ex, L)


def boundary_chain(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[I, M_0 .. M_{g-1}, M_x] [1, g + 2, W + 1, W + 1] int32 from one
    slot's matrices M [1, g, W + 1, W + 1] and its incoming boundary x
    [W + 1], on M's device. Propagated from x0, its x_in are: the
    slot's outgoing boundary (at I), its blocks' x_in, and x0."""
    _, g, Wp, _ = M.shape
    chain = torch.full((1, g + 2, Wp, Wp), SENT, dtype=torch.int32,
                       device=M.device)
    chain[0, 0].fill_diagonal_(0)
    chain[0, 1:g + 1] = M[0]
    chain[0, g + 1, :, Wp - 1] = x
    return chain


def _start(Wp: int, device) -> torch.Tensor:
    """x0: SENT everywhere, 0 at the exit slot W."""
    x = torch.full((Wp,), SENT, dtype=torch.int32, device=device)
    x[Wp - 1] = 0
    return x


def _ring(win, cv, uns, e_ex, L: int, mesh: Mesh) -> torch.Tensor:
    """Half-unit scores [1, Vp] int32 (on the CPU) of the padded band
    [1, Vp, W] (Vp a multiple of L x D) over the mesh's D slots."""
    global hops
    D = mesh.size
    Vp, W = win.shape[1:]
    Wp = W + 1
    g = Vp // L // D  # blocks a slot
    halo = -(-W // L)  # the next slot's blocks a slot's edges reach
    bands, extra = [], []
    for d, dev in enumerate(mesh.devices):
        h = halo if d < D - 1 else 0
        rows = torch.arange(d * g * L, (d * g + g + h) * L)
        real = rows < Vp
        node = rows.clamp_max(Vp - 1)  # the clamp of the whole band
        dt = torch.int16 if dev.type == "cuda" else torch.int32
        bands.append((
            torch.where(real[:, None], win[0, node], -1)[None].to(dev, dt),
            cv[0, node][None].to(dev, dt),
            uns[0, node][None].to(dev),
            torch.where(real, e_ex[0, node], SENT)[None].to(dev),
        ))
        extra.append(h)
    # 1. Every slot's matrices.
    Ms = [_compose(b, L)[:, :g] for b in bands]
    # 2. The boundary chain, right to left, one hop a slot.
    x_ins = [None] * D
    x = _start(Wp, mesh.devices[-1])
    for d in range(D - 1, -1, -1):
        x_in = _propagate(boundary_chain(Ms[d], x))
        pad = _start(Wp, x_in.device).expand(1, extra[d], Wp)
        x_ins[d] = torch.cat([x_in[:, 1:g + 1], pad], dim=1).contiguous()
        if d:
            x = x_in[0, 0].to(mesh.devices[d - 1], copy=True)
            hops += 1
    # 3. Every slot's interior, its halo dropped.
    outs = [_fill(b, xi, L)[:, :g * L] for b, xi in zip(bands, x_ins)]
    return torch.cat([o.cpu() for o in outs], dim=1)


def colsharded_scores(
    win_count: np.ndarray,  # [V, W] int16/int32, -1 = none (ONE target)
    exit_count: np.ndarray,  # [V]
    cov: np.ndarray,  # [V]
    unsup: np.ndarray,  # [V] bool
    mesh: Mesh | None = None,
    device="cuda",
) -> np.ndarray:
    """DP scores [V] f32 of one target, bitwise equal to the sequential
    f32 scan, by the blocked solve over `mesh` (without one, a mesh of
    one slot on `device`): the kernels on a card, the plain version on
    the CPU. The caller guarantees no long edges and the `blocked_safe`
    bound. Raises OverflowError if any score crosses the f32-parity
    line."""
    if mesh is None:
        mesh = Mesh((device,))
    D = mesh.size
    V, W = win_count.shape
    L = _blocked_L(V)
    Vp = -(-max(V, 1) // (L * D)) * (L * D)
    # The kernels read the int16 wire format; counts past it never come
    # from the packer (it refuses them).
    on_card = any(d.type == "cuda" for d in mesh.devices)
    if on_card and (
        np.abs(np.asarray(win_count)).max(initial=0) > 32767
        or np.abs(np.asarray(cov)).max(initial=0) > 32767
    ):
        raise ValueError("counts past int16 do not fit the kernels")
    win = torch.full((1, Vp, W), -1, dtype=torch.int32)
    win[0, :V] = torch.from_numpy(np.asarray(win_count, dtype=np.int32))
    cv = torch.zeros((1, Vp), dtype=torch.int32)
    cv[0, :V] = torch.from_numpy(np.asarray(cov, dtype=np.int32))
    uns = torch.zeros((1, Vp), dtype=torch.bool)
    uns[0, :V] = torch.from_numpy(np.asarray(unsup, dtype=bool))
    # Padded rows have no edge and no exit: SENT rows, as the
    # reference pads its mesh's shards.
    e_ex = torch.full((1, Vp), SENT, dtype=torch.int32)
    e_ex[0, :V] = exit_half_units(
        torch.from_numpy(np.asarray(exit_count, dtype=np.int32))
    )
    if D == 1:
        dev = mesh.devices[0]
        dt = torch.int16 if dev.type == "cuda" else torch.int32
        s2 = solve_band(win.to(dev, dt), cv.to(dev, dt), uns.to(dev),
                        e_ex.to(dev), L)
    else:
        s2 = _ring(win, cv, uns, e_ex, L, mesh)
    scores, overflow = decode(s2[:, :V])
    if bool(overflow.any()):
        raise OverflowError("colshard scores beyond the f32-parity line")
    return scores[0].cpu().numpy()
