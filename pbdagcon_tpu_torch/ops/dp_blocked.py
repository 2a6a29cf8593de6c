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


def compose_column_model(a: torch.Tensor, plan: dict | None = None
                         ) -> torch.Tensor:
    """`_compose` as the compose's "column" route computes it (the CPU
    model of `blocked_compose_col_kernel`), integer for integer: CTA c's
    thread t owns column t % (W+1) of block c * blocks + t // (W+1) (the
    packing of `plan`, `ops/dp_blocked_cuda.py::compose_plan`; the
    column route's own packing for this W where None); its W band
    entries are a list of per-thread "registers", and at step t logical
    row i sits in register (i - t) mod W, the new row 0 taking the
    register of the dropped row W - 1 (the static renaming that the
    kernel unrolls by groups of GS = min(W, 32) steps; past 32, the
    registers move back after each group, so that row i is in register
    i again); each max is split over accumulators i % NACC; row W stays
    the identity's. The kernel instantiates W in COLUMN_WIDTHS with L a
    multiple of W; the model takes any W and L (after a last, partial
    group of r steps, logical row k ends in register (k - r) mod W)."""
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    B, G, L, Wp = a.shape
    W = Wp - 1
    if plan is None:
        nb = C._column_blocks(B, G, W, L)
        plan = {"route": "column", "blocks": nb, "threads": C._r32(nb * Wp)}
    if plan["route"] != "column":
        raise ValueError(f"not a column-route plan: {plan}")
    nb, threads = plan["blocks"], plan["threads"]
    nacc = 4 if W >= 32 else 2
    nblk = B * G
    ctas = -(-nblk // nb)
    t = torch.arange(threads)
    q, j = t // Wp, t % Wp
    blk = torch.arange(ctas)[:, None] * nb + q[None, :]
    live = (q[None, :] < nb) & (blk < nblk)
    blk, j = blk[live], j.expand(ctas, threads)[live]
    cover = torch.zeros(nblk * Wp, dtype=torch.int64)
    cover.index_add_(0, blk * Wp + j, torch.ones_like(blk))
    if not bool((cover == 1).all()):
        raise AssertionError("the packing does not cover every column once")
    af = a.reshape(nblk, L, Wp)[blk]  # [N, L, Wp]: each thread's block
    sent = torch.full_like(j, SENT, dtype=torch.int32)
    zero = torch.zeros_like(sent)
    c = [torch.where(j == i, zero, sent) for i in range(W)]
    cW = torch.where(j == W, zero, sent)
    gs = min(W, 32)
    for step in range(L):
        u = step % gs  # the step within its group
        at = af[:, L - 1 - step]
        acc = [sent] * nacc
        for i in range(Wp):
            reg = cW if i == W else c[(i - u) % W]
            acc[i % nacc] = torch.maximum(at[:, i] + reg, acc[i % nacc])
        new = acc[0]
        for h in range(1, nacc):
            new = torch.maximum(new, acc[h])
        c[(W - 1 - u) % W] = new
        if u == gs - 1 and gs < W:  # the registers move back
            c = [c[(i - gs) % W] for i in range(W)]
    M = torch.empty((nblk, Wp, Wp), dtype=torch.int32)
    r = L % gs if gs < W else L % W
    for k in range(W):
        M[blk, k, j] = c[(k - r) % W]
    M[blk, W, j] = cW
    return M.view(B, G, Wp, Wp).to(a.device)


def propagate_ring_model(M: torch.Tensor, plan: dict | None = None,
                         base: int = 0) -> torch.Tensor:
    """`_propagate` as the propagate's "warp" route computes it (the CPU
    model of `blocked_propagate_warp_kernel`), integer for integer. The
    tensor starts `base` ints (0-3) past a 16-byte boundary; each
    target's M is one run of G (W+1)^2 int32, cut into chunks of K =
    `plan["chunk"]` matrices (chunk c: steps cK .. cK+K-1, matrix
    g = G-1-s at step s; `propagate_plan`'s own plan where None). A
    producer puts chunk c into ring slot c % depth as the kernel copies
    it: one bulk copy of its 16-byte-aligned superset (neighbouring
    matrices' words included), except where that superset leaves the
    tensor (a misaligned first or last run): there the bulk copy shrinks
    by a 16-byte word and lanes copy the run's words in it. Slot words
    nothing wrote hold a poison value above any score. The consumer
    waits on step s + 1's chunk (loading its row a step ahead) before it
    releases step s, so the producer's iteration c may run once the
    consumer finished chunk c - depth; the model runs it as late as that
    allows, and it writes to x_in the x of every step the consumer
    finished, from a history ring of depth x K vectors (it asserts that
    none is overwritten before). Lane l takes band rows l, l + 32, .. (one
    at W = 16 and 32, two up to W = 64, four past it; at most W: a lane
    past the band recomputes row W) with eight
    accumulators at W = 16 and 32, four elsewhere (term j on accumulator
    j % n); the exit row is lane W's row at W = 16, else the max over the
    lanes of each lane's columns l, l + 32, .."""
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    B, G, Wp, _ = M.shape
    W, WW = Wp - 1, Wp * Wp
    if plan is None:
        plan = C.propagate_plan(B, G, W)
    if plan["route"] != "warp":
        raise ValueError(f"not a warp-route plan: {plan}")
    depth, K = plan["depth"], plan["chunk"]
    H, NC = depth * K, -(-G // K)
    slot = C.prop_slot_ints(W, K)
    poison = (1 << 30) + 7
    flat = torch.cat([torch.zeros(base, dtype=torch.int32),
                      M.reshape(-1).cpu()])
    lo, hi = base, base + B * G * WW  # the tensor in `flat`, in ints
    ring = torch.full((B, depth, slot), poison, dtype=torch.int32)

    def lo_g(c: int) -> int:  # chunk c holds matrices lo_g(c) .. G-1-cK
        return max(0, G - (c + 1) * K)

    def issue(c: int) -> None:
        st = c % depth
        ring[:, st] = poison
        for b in range(B):
            src = base + (b * G + lo_g(c)) * WW
            n = (G - c * K - lo_g(c)) * WW
            mis = src % 4
            a0, a1 = src - mis, src + n + (4 - (mis + n) % 4) % 4
            b0 = a0 if a0 >= lo else a0 + 4
            b1 = a1 if a1 <= hi else a1 - 4
            assert (a1 - a0) % 4 == 0 and a1 - a0 <= slot
            for w in list(range(a0, b0)) + list(range(b1, a1)):  # lanes
                if src <= w < src + n:
                    ring[b, st, w - a0] = flat[w]
            if b1 > b0:
                ring[b, st, b0 - a0:b1 - a0] = flat[b0:b1]

    def matrix(b: int, s: int) -> torch.Tensor:
        c, g = s // K, G - 1 - s
        off = (base + (b * G + lo_g(c)) * WW) % 4 + (g - lo_g(c)) * WW
        return ring[b, c % depth, off:off + WW]

    hist = torch.full((B, H, Wp), poison, dtype=torch.int32)
    held = [-1] * H  # the step whose x each history vector holds
    hist[:, 0] = SENT
    hist[:, 0, W] = 0
    held[0] = 0
    x_in = torch.full((B, G, Wp), poison, dtype=torch.int32)
    prod = {"next": 0, "flushed": 0}

    def producer_until(c_last: int, cons: int) -> None:
        while prod["next"] <= c_last:
            c = prod["next"]
            need = G if c == NC else max(0, (c - depth + 1) * K)
            assert cons >= need, "the consumer and producer deadlock"
            ready = min(cons + 1, G)
            for t in range(prod["flushed"], ready):
                assert held[t % H] == t
                x_in[:, G - 1 - t] = hist[:, t % H]
            prod["flushed"] = max(prod["flushed"], ready)
            if c < NC:
                issue(c)
            prod["next"] += 1

    R = 1 if W in (16, 32) else (2 if W <= 64 else 4)  # rows a lane
    lanes = torch.arange(32)
    rows = torch.stack([(lanes + 32 * k).clamp_max(W) for k in range(R)], 1)
    owned = (lanes[:, None] + 32 * torch.arange(R)[None, :]) < W
    cols = torch.stack([lanes + 32 * k for k in range(-(-Wp // 32))], 1)
    sent = torch.full((), SENT, dtype=torch.int32)
    nacc = 8 if W in (16, 32) else 4
    part = torch.arange(Wp) % nacc  # term j's accumulator
    producer_until(depth - 1, 0)
    for s in range(G):
        if s + 1 < G:  # the next step's chunk, before this step's release
            producer_until((s + 1) // K, s)
        x = hist[:, s % H]
        m = torch.stack([matrix(b, s) for b in range(B)]).view(B, Wp, Wp)
        ex = m[:, W, cols.clamp_max(W)] + x[:, cols.clamp_max(W)]
        ex = torch.where(cols < Wp, ex, sent).amax(-1)  # each lane's columns
        e = torch.maximum(ex.amax(-1), sent)  # the max over the warp
        terms = m[:, rows] + x[:, None, None, :]  # [B, 32, R, Wp]
        acc = [torch.maximum(torch.where(part == h, terms, sent).amax(-1),
                             sent) for h in range(nacc)]
        mine = acc[0]
        for h in range(1, nacc):
            mine = torch.maximum(mine, acc[h])  # [B, 32, R]
        if W == 16:  # lane W's row is the exit row
            e = mine[:, W, 0]
        assert held[(s + 1) % H] < prod["flushed"], "x overwritten unwritten"
        xn = hist[:, (s + 1) % H]
        for k in range(R):
            for lane in range(32):
                if owned[lane, k]:
                    xn[:, lane + 32 * k] = mine[:, lane, k]
        xn[:, W] = e
        held[(s + 1) % H] = s + 1
    producer_until(NC, G)
    return x_in.to(M.device)


def fill_lane_model(a: torch.Tensor, x_in: torch.Tensor,
                    plan: dict | None = None, band=None) -> torch.Tensor:
    """`_fill` as the fill's "lane" route computes it (the CPU model of
    `blocked_fill_lane_kernel<R>`), integer for integer, vectorised over
    the lanes of every warp. Warp w holds blocks w * nb + q (nb =
    `plan["blocks"]`; `fill_plan`'s own plan where None): at W <= 32 in
    groups of W lanes (q = lane // W, slot k = lane % W; lanes of a group
    past the warp's blocks keep no row), past 32 one block with slot k on
    lane k % 32, register k // 32 (R = ceil(W / 32) slots a lane). Slot k
    starts with row L-1-k: its accumulator starts at max(SENT, exit)
    (the clamp as one more term of the row's max) and takes the row's
    terms from x_in (d = k .. W-1) on two accumulators (d - k even, odd).
    Step t (u = L-1-t) reads s[u] from the lane of slot t % W of the
    group (the model asserts that slot holds row u); the slot that holds
    row u then takes row u - W (starting at max(SENT, exit)), and every
    slot with a row r adds esc2[r, u-1-r] + s[u]. The steps run in chunks
    of CW (W at W <= 32, else 32): lane `me` (k at W <= 32, else the
    lane) keeps the score of chunk step me and writes it out after the
    chunk. The kernel reads slot k's band word at an index it keeps one
    less each step and sets to P(u) = (u - W)(W - 1) + u - 1 where the
    slot takes row u - W; the model keeps it too and asserts it is r (W
    - 1) + u - 1 for the slot's row r. The model asserts that every
    (block, slot) has one lane and every row gets its W terms. With
    `band` (win_count, cov, unsup of the batch), each term is formed as
    the kernel forms it, from the raw band and the node word (2, -cov or
    0, -20) of node min(gL + 1 + r + d, V - 1) (the clamped index of the
    last blocks), not from `a`'s esc2 columns; `a` then gives only the
    exits."""
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as C

    B, G, L, Wp = a.shape
    W = Wp - 1
    if plan is None:
        plan = C.fill_plan(B, G, W, L)
    if plan["route"] != "lane":
        raise ValueError(f"not a lane-route plan: {plan}")
    nb, R = plan["blocks"], C.lane_rows(W)
    if not 1 <= nb <= C.lane_max_blocks(W):
        raise ValueError(f"{nb} blocks a warp do not fit W={W}")
    dev = a.device
    nblk = B * G
    nwarps = -(-nblk // nb)
    af = a.cpu().reshape(nblk, L, Wp)
    ex = af[:, :, W]
    xs = x_in.cpu().reshape(nblk, Wp)[:, :W]
    if band is None:
        def esc(blk, r, d):
            return af[blk, r, d]
    else:
        win, cov, unsup = (t.cpu() for t in band)
        wq = win.to(torch.int32).reshape(nblk, L, W)
        node = (torch.arange(G)[:, None] * L + 1
                + torch.arange(L + W)[None, :]).clamp_max(G * L - 1)
        cq = cov.to(torch.int32)[:, node].reshape(nblk, L + W)
        uq = unsup.to(torch.bool)[:, node].reshape(nblk, L + W)
        mul = torch.where(uq, 0, 2).to(torch.int32)
        add = torch.where(uq, torch.tensor(_PENALTY2, dtype=torch.int32), -cq)

        def esc(blk, r, d):
            wc = wq[blk, r, d]
            i = r + d
            return torch.where(wc < 0, torch.tensor(SENT, dtype=torch.int32),
                               mul[blk, i] * wc + add[blk, i])

    none = -(1 << 30)
    sent = torch.tensor(SENT, dtype=torch.int32)
    lane = torch.arange(32)
    if R == 1:
        qg, k = lane // W, (lane % W)[:, None]
    else:
        qg, k = torch.zeros(32, dtype=torch.int64), (lane[:, None]
                                                     + 32 * torch.arange(R))
    blk = torch.arange(nwarps)[:, None, None] * nb + qg[None, :, None]
    live = (qg < nb)[None, :, None] & (blk < nblk)  # [nw, 32, 1]
    k = k.expand(32, R)[None].expand(nwarps, 32, R)
    blk = blk.expand(nwarps, 32, R)
    owned = live & (k < W)
    cover = torch.zeros(nblk * W, dtype=torch.int64)
    cover.index_add_(0, (blk * W + k)[owned], torch.ones(int(owned.sum()),
                                                         dtype=torch.int64))
    if not bool((cover == 1).all()):
        raise AssertionError("the packing does not give every slot one lane")
    bs = torch.where(owned, blk, 0)
    nterm = torch.zeros(nblk * L, dtype=torch.int64)

    def count(has, rows) -> None:
        nterm.index_add_(0, (bs * L + rows)[has], torch.ones(int(has.sum()),
                                                             dtype=torch.int64))

    cur = torch.where(owned & (L - 1 - k >= 0), L - 1 - k, none)
    has = cur >= 0
    rs = cur.clamp_min(0)
    acc0 = torch.maximum(ex[bs, rs], sent)
    acc1 = torch.full_like(acc0, SENT)
    for d in range(W):
        use = has & (k <= d)
        term = (esc(bs, rs, torch.full_like(rs, d))
                + xs[bs, (d - k).clamp_min(0)])
        even = (d - k) % 2 == 0
        acc0 = torch.where(use & even, torch.maximum(acc0, term), acc0)
        acc1 = torch.where(use & ~even, torch.maximum(acc1, term), acc1)
        count(use, rs)
    acc = torch.where(has, torch.maximum(acc0, acc1), sent)

    out = torch.full((nblk, L), (1 << 30) + 7, dtype=torch.int32)
    src0 = qg * W if R == 1 else qg
    wi = torch.arange(nwarps)[:, None]
    cw = W if R == 1 else 32
    me = (lane % W if R == 1 else lane)[None, :].expand(nwarps, 32)
    rec = torch.zeros((nwarps, 32), dtype=torch.int32)
    ix = (L - 1 - k) * (W - 1) + L - 1
    for t in range(L):
        u, o, tt = L - 1 - t, t % W, t % cw
        src = (src0 + o % 32) % 32  # the shuffle's source lane
        held = cur[wi, src[None, :], o // 32]
        if not bool((held[live[..., 0]] == u).all()):
            raise AssertionError(f"step {t}: the source slot lacks row {u}")
        s = acc[wi, src[None, :], o // 32][..., None].expand(nwarps, 32, R)
        own = cur == u
        if int(own.sum()) != int((live[..., 0].sum(1) // W
                                  if R == 1 else live[:, 0, 0]).sum()):
            raise AssertionError(f"step {t}: not one owner a block")
        rec = torch.where(me == tt, s[..., 0], rec)
        nr = u - W
        cur = torch.where(own, nr if nr >= 0 else none, cur)
        acc = torch.where(own, torch.maximum(ex[bs, max(nr, 0)], sent), acc)
        has = cur >= 0
        rs = cur.clamp_min(0)
        ix = torch.where(own, (u - W) * (W - 1) + u - 1, ix - 1)
        if not bool((ix == rs * (W - 1) + u - 1)[has].all()):
            raise AssertionError(f"step {t}: a band index is not its row's")
        term = esc(bs, rs, (u - 1 - rs).clamp(0, W - 1)) + s
        acc = torch.where(has, torch.maximum(acc, term), acc)
        count(has, rs)
        if tt == cw - 1 or t == L - 1:  # the chunk's scores
            t0 = t - tt
            put = live[..., 0] & (me <= tt)
            out[bs[..., 0][put], (L - 1 - t0 - me)[put]] = rec[put]
    if not bool((out != (1 << 30) + 7).all()):
        raise AssertionError("a score was never written")
    if not bool((nterm == W).all()):
        raise AssertionError("a row did not get its W terms")
    return out.view(B, G * L).to(dev)


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
