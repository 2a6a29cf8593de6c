"""Blocked max-plus consensus DP in int32 half-units (port of
`pbdagcon_tpu/ops/dp_blocked.py`, kernel X2).

The same recurrence as `ops/dp.py::dp_scores`, reformulated as max-plus
linear algebra so that the sequential chain shortens from V steps to
~L + V/L + L:

  state  x_u = [s[u], .., s[u+W-1], 0]   (affine max-plus vector)
  step   x_u = A_u (x) x_{u+1}           (row 0 = [esc[u, :], e_exit[u]])

1. **compose**: per block of L rows, M_g = A_{gL} (x) ... (x) A_{gL+L-1}
   (all blocks in parallel);
2. **propagate**: the boundary vectors, block by block in reverse;
3. **fill**: every block's interior scores from its incoming boundary
   (all blocks in parallel).

Every edge score is a multiple of 0.5, so doubling makes every value an
integer and reassociation exact. Every stored value is clamped to
`>= SENT`, so every sum of two stored values is `>= INT32_MIN`;
`blocked_safe` keeps real path sums within +-2^28 and sentinel-
contaminated values below `_REAL_MIN`. Scores decode to f32 exactly
below the f32-parity line `_F32_LIMIT`; a row with a finite score at or
past it is flagged, as is a row whose long edges (span > W) are still
active after `max_iters` rounds of Kleene iteration. A flagged row must
take the sequential f32 scan (`blocked_scores` re-runs it through B1).
The reference's module docstring gives the full argument.

`solve_band` is the dispatcher of the solve: a CUDA tensor goes to the
hand-written kernels (`ops/dp_blocked_cuda.py`, `csrc/dp_blocked.cu`),
which raise if they cannot run; a CPU tensor goes to the plain PyTorch
version `solve_band_reference` (`_compose`, `_propagate`, `_fill`, one
function per kernel). The Kleene bookkeeping between solves is [B, K]
torch work on the same device, and the loop ends on a host check of
`active.any()` after each solve. `dp_scores_blocked_reference` runs the
whole of it on the plain solve, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
# Sentinel for "no path" in half-units. Clamping every stored value to
# >= SENT keeps any pairwise sum >= INT32_MIN (no wraparound).
SENT = -(1 << 30)
# Real scores are > -2^29 by the blocked_safe bound; anything at or
# below is sentinel-contaminated and decodes to -inf.
_REAL_MIN = -(1 << 29)
# Posterior f32-parity line: all finite half-unit scores must stay under
# 2^24 - 2^17 so the f32 scan's candidates are exactly representable too.
_F32_LIMIT = (1 << 24) - (1 << 17)
_PENALTY2 = -20  # -10.0 in half-units


def _blocked_L(V: int) -> int:
    """Block length: larger blocks at large V halve the sequential
    boundary chain and the transfer-matrix footprint."""
    return 128 if (V >= 8192 and V % 128 == 0) else 64


def blocked_safe(max_abs_esc: float, v: int) -> bool:
    """True if the int32 blocked algebra is safe for this batch: real
    path sums bounded by `v * 2*max|esc| < 2^28` half-units.
    `max_abs_esc` is in score units."""
    return v * max(abs(max_abs_esc), 10.0) < float(1 << 27)


def max_escore(batch: dict) -> float:
    """The bound on |esc| that the reference's routing hands to
    `blocked_safe` for a packed batch (numpy `cov` and `win_count`)."""
    return max(
        float(np.abs(batch["cov"]).max(initial=0)) * 0.5
        + float(batch["win_count"].max(initial=0)),
        10.0,
    )


def blocked_eligible(batch: dict) -> bool:
    """The reference's guard for `backend="blocked"`: V a multiple of
    the block length and the int32 bound held."""
    V = batch["win_count"].shape[1]
    return V % _blocked_L(V) == 0 and blocked_safe(max_escore(batch), V)


def _esc2_band(win_count, cov, unsup) -> torch.Tensor:
    """esc2[b, u, d] int32 (half-units): the band's edge scores, SENT
    where there is no edge."""
    B, V, W = win_count.shape
    dev = win_count.device
    wc = win_count.to(torch.int32)
    idx = (
        torch.arange(V, device=dev)[:, None] + 1
        + torch.arange(W, device=dev)[None, :]
    ).clamp_max(V - 1)  # [V, W] target node ids
    cov_w = cov.to(torch.int32)[:, idx]  # [B, V, W]
    unsup_w = unsup.to(torch.bool)[:, idx]
    return torch.where(
        wc >= 0,
        torch.where(unsup_w, torch.tensor(_PENALTY2, dtype=torch.int32,
                                          device=dev), 2 * wc - cov_w),
        torch.tensor(SENT, dtype=torch.int32, device=dev),
    )


def _esc2_dense(win_count, exit_count, cov, unsup):
    """esc2[b, u, d] int32 (half-units) and e_exit2[b, u] int32."""
    return _esc2_band(win_count, cov, unsup), exit_half_units(exit_count)


def exit_half_units(exit_count: torch.Tensor) -> torch.Tensor:
    """e_exit2[b, u] int32: twice the exit count, SENT where none."""
    ex = exit_count.to(torch.int32)
    return torch.where(ex >= 0, 2 * ex, torch.full_like(ex, SENT))


def _rows(esc2: torch.Tensor, e_exit2: torch.Tensor, L: int) -> torch.Tensor:
    """a[b, g, r, :] = [esc2 row, e_exit2] of node gL + r: row 0 of
    A_u for every node, by block. [B, V / L, L, W + 1] int32."""
    B, V, W = esc2.shape
    if V % L:
        raise ValueError(f"V={V} is not a multiple of L={L}")
    return torch.cat([esc2, e_exit2[..., None]], dim=-1).view(B, V // L, L, W + 1)


def _compose(a: torch.Tensor) -> torch.Tensor:
    """Phase 1: block transfer matrices M [B, G, W + 1, W + 1]."""
    B, G, L, Wp = a.shape
    W = Wp - 1
    eye = torch.full((Wp, Wp), SENT, dtype=torch.int32, device=a.device)
    eye.fill_diagonal_(0)
    M = eye.expand(B, G, Wp, Wp)
    for t in range(L):
        at = a[:, :, L - 1 - t, :]  # [B, G, Wp]
        row0 = (at[..., :, None] + M).amax(dim=-2).clamp_min(SENT)
        M = torch.cat([row0[..., None, :], M[..., : W - 1, :], M[..., W:, :]],
                      dim=-2)
    return M


def _propagate(M: torch.Tensor) -> torch.Tensor:
    """Phase 2: every block's incoming boundary vector x_in [B, G, W + 1],
    block by block in reverse."""
    B, G, Wp, _ = M.shape
    x = torch.full((B, Wp), SENT, dtype=torch.int32, device=M.device)
    x[:, Wp - 1] = 0
    x_in = torch.empty((B, G, Wp), dtype=torch.int32, device=M.device)
    for g in range(G - 1, -1, -1):
        x_in[:, g] = x
        x = (M[:, g] + x[:, None, :]).amax(dim=-1).clamp_min(SENT)
    return x_in


def _fill(a: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """Phase 3: interior scores [B, V] int32 of all blocks in parallel,
    each from its incoming boundary."""
    B, G, L, Wp = a.shape
    W = Wp - 1
    win = x_in[..., :W]
    out = torch.empty((B, G, L), dtype=torch.int32, device=a.device)
    for t in range(L):
        at = a[:, :, L - 1 - t, :]
        s = torch.maximum((at[..., :W] + win).amax(dim=-1), at[..., W])
        s = s.clamp_min(SENT)
        win = torch.cat([s[..., None], win[..., : W - 1]], dim=-1)
        out[:, :, L - 1 - t] = s
    return out.view(B, G * L)


def _solve_band(esc2: torch.Tensor, e_exit2: torch.Tensor, L: int = 64):
    """Plain PyTorch version of the banded solve: half-unit scores
    [B, V] int32 (sentinel-contaminated where unreachable), the same
    integers as the reference's `_solve_band` and the kernels."""
    a = _rows(esc2, e_exit2, L)
    return _fill(a, _propagate(_compose(a)))


def solve_band_reference(win_count, cov, unsup, e_ex2, L: int) -> torch.Tensor:
    """`solve_band`'s plain version, on the inputs' device."""
    return _solve_band(_esc2_band(win_count, cov, unsup), e_ex2, L)


def solve_band(
    win_count: torch.Tensor,  # [B, V, W] int16 (int32 on the CPU), -1 = none
    cov: torch.Tensor,  # [B, V]
    unsup: torch.Tensor,  # [B, V] bool/uint8
    e_ex2: torch.Tensor,  # [B, V] int32 half-units, SENT = none
    L: int,
) -> torch.Tensor:
    """Half-unit scores [B, V] int32 of one banded solve: the kernels
    for CUDA tensors, the plain version for CPU tensors. Raises for any
    other device."""
    kind = win_count.device.type
    if kind == "cuda":
        from pbdagcon_tpu_torch.ops.dp_blocked_cuda import solve_band_cuda

        return solve_band_cuda(win_count, cov, unsup, e_ex2, L)
    if kind == "cpu":
        return solve_band_reference(win_count, cov, unsup, e_ex2, L)
    raise ValueError(f"no blocked DP for device {win_count.device}")


def decode(s2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32, overflow [B] bool) from half-unit scores [B, V]:
    at or below `_REAL_MIN` is -inf; a row with a finite score at or
    past the f32-parity line overflows."""
    finite = s2 > _REAL_MIN
    scores = torch.where(
        finite, s2.to(torch.float32) * 0.5,
        torch.full((), NEG_INF, dtype=torch.float32, device=s2.device),
    )
    overflow = (finite & (s2.abs() >= _F32_LIMIT)).any(dim=-1)
    return scores, overflow


def dp_scores_blocked(
    win_count: torch.Tensor,  # [B, V, W] int16/int32
    exit_count: torch.Tensor,  # [B, V] int16/int32
    cov: torch.Tensor,  # [B, V] int16/int32
    unsup: torch.Tensor,  # [B, V] bool/uint8
    long_u: torch.Tensor,  # [B, K] int32 (-1 pad)
    long_w: torch.Tensor,  # [B, K] int32
    long_esc: torch.Tensor,  # [B, K] float32
    L: int = 64,
    max_iters: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked int32 DP with long-edge Kleene iteration, on the inputs'
    device (each solve by `solve_band`: the kernels on a card). Returns
    (scores [B, V] f32, flagged [B] bool): flagged rows (long edges
    still active after `max_iters`, or finite scores past the f32-parity
    line) must take the sequential f32 scan."""
    return _kleene(solve_band, win_count, exit_count, cov, unsup, long_u,
                   long_w, long_esc, L, max_iters)


def dp_scores_blocked_reference(
    win_count, exit_count, cov, unsup, long_u, long_w, long_esc,
    L: int = 64, max_iters: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`dp_scores_blocked`'s plain version, on the inputs' device (each
    solve by `solve_band_reference`)."""
    return _kleene(solve_band_reference, win_count, exit_count, cov, unsup,
                   long_u, long_w, long_esc, L, max_iters)


def _kleene(solve, win_count, exit_count, cov, unsup, long_u, long_w,
            long_esc, L, max_iters):
    B, V, W = win_count.shape
    dev = win_count.device
    sent = torch.tensor(SENT, dtype=torch.int32, device=dev)
    e_ex = exit_half_units(exit_count)
    valid = long_u >= 0
    lu = torch.where(valid, long_u, 0).long()
    lw = torch.where(valid, long_w, 0).long()
    fin = valid & torch.isfinite(long_esc)
    # long_esc values are half-integers well inside the f32-exact range;
    # doubling is exact.
    lesc2 = torch.where(
        fin, torch.where(fin, long_esc * 2.0, 0.0).to(torch.int32), sent
    )
    has_long = long_u.shape[1] > 0
    s2 = torch.zeros((B, V), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters and bool(active.any()):
        s2 = solve(win_count, cov, unsup, e_ex, L)
        it += 1
        if not has_long:
            active = torch.zeros_like(active)
            continue
        cand = torch.maximum(lesc2 + s2.gather(1, lw), sent)  # [B, K]
        # Only real candidates may activate: contaminated values are
        # conceptually -inf, and injecting them would let sentinel drift
        # accumulate across iterations.
        act = (cand > s2.gather(1, lu)) & (cand > _REAL_MIN)
        # Inject active candidates as constants for the next round
        # (monotone: previous injections stay through the max).
        extra = torch.full((B, V), SENT, dtype=torch.int32, device=dev)
        extra = extra.scatter_reduce(
            1, lu, torch.where(act, cand, sent), reduce="amax"
        )
        e_ex = torch.maximum(e_ex, extra)
        active = act.any(dim=1)
    scores, overflow = decode(s2)
    return scores, active | overflow


def blocked_scores(*args: torch.Tensor, L: int) -> tuple[torch.Tensor, int]:
    """Scores [B, V] f32 of a `dp_scores` batch by the blocked solve,
    with its flagged rows re-run through the sequential scan
    (`dp_scores`: B1 on the card), as the reference's `_BlockedFuture`
    does; and the number of rows re-run."""
    from pbdagcon_tpu_torch.ops.dp import dp_scores

    s, flagged = dp_scores_blocked(*args, L=L)
    n = int(flagged.sum())
    if n:
        s = torch.where(flagged[:, None], dp_scores(*args), s)
    return s, n
