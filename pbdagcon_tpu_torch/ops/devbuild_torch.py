"""Device-side graph construction (port of `pbdagcon_tpu/ops/devbuild_jax.py`).

The batched, fixed-shape build of the order-free merged graph: encoded
reads in, the banded linear graph the DP and the device backtrack take
out. Every stage keeps the JAX function's name, arguments and outputs,
and its outputs are equal to the JAX build's array for array
(`tests/test_torch_devbuild.py`), which is itself held against the NumPy
oracle `pbdagcon_tpu/ops/devbuild.py`.

Pipeline (per batch of B targets, static caps in `Caps`):
  1. decode: per-column target positions, coverage/match histograms,
     matched-position tables, the compact insertion stream;
  2. chain extraction: one row per (read, inter-anchor segment with
     insertions): anchors, packed reversed bases, termination;
  3. transitions (chainless segments) and backbone absorption;
  4. suffix tries by sorting the chains on (termination, reversed
     string);
  5. linearization, the banded edge/key tables, the long-edge register
     file and the per-target overflow flags.

Histograms and known-rank scatters go through `ops/mxu.py` (the
hand-written kernels on the card). What differs from the JAX form:

- `jax.lax.sort(..., num_keys=k)` is a stable lexicographic sort; here
  `_sort` does successive stable `torch.sort` passes from the last key
  to the first. Sorts whose keys are a known permutation become a
  scatter.
- uint16/uint32 sort keys and payloads are int32/int64 here (same
  order, same bits); the casts' truncations are kept as masks.
- Every `take_along_axis` of the JAX build reads at an index it clipped
  first, so `torch.gather` at the same index is exact.
- The band is written per edge class with one scatter into a [B, V, W+1]
  buffer (the last lane takes the absent edges) in the JAX build's
  class order, instead of W-wide selects in a [B, W, V] layout; `win`
  and `wkey` come out contiguous in the DP's [B, V, W] layout.
- The read-bitmask form of the transitions' min-read runs whenever
  R <= 64, on every device; the sort form only for R > 64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbdagcon_tpu_torch.ops.devbuild import (
    KEY_UNCERTAIN,
    MAX_ABSORB_ROUNDS,
    OP_DEL,
    OP_INS,
    OP_MATCH,
)
from pbdagcon_tpu_torch.ops.mxu import (
    mxu_gather,
    mxu_gather_planes,
    mxu_hist,
    mxu_scatter,
    mxu_weighted_hist,
)

I32 = torch.int32
I64 = torch.int64
_F32_MIN = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class Caps:
    """Static shape caps for one build (the fields of the JAX package's
    `devbuild_jax.Caps`). Targets exceeding any cap are flagged and fall
    back to the host engine."""

    B: int  # targets per batch
    R: int  # reads per target
    C: int  # columns per read
    L: int  # backbone length
    CH: int  # chains per read (inter-anchor segments with insertions)
    SM: int  # max chain length (inserted bases per segment)
    NC: int  # chains per target (global table)
    ND: int  # trie nodes per target
    SE: int  # start edges per source anchor
    DQ: int  # max transition span (q - p)
    V: int  # linear nodes per target
    W: int  # band width (successor window)
    K: int = 32  # long-edge register slots (linear span > W)


# ---- helpers ---------------------------------------------------------------


def _ar(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=dev)


def _cs(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=I32)


def _sum(x: torch.Tensor, dim=-1) -> torch.Tensor:
    return torch.sum(x, dim=dim, dtype=I32)


def _any(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.amax(x.to(torch.uint8), dim=dims) > 0


def _gat(a: torch.Tensor, idx: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`take_along_axis` at an in-range index, the index broadcast over
    a's other dimensions."""
    shape = list(a.shape)
    shape[dim] = idx.shape[dim]
    return torch.gather(a, dim, idx.long().expand(shape))


def _sort(operands, num_keys: int):
    """`jax.lax.sort(operands, dimension=-1, num_keys=num_keys)`: stable
    lexicographic order over the first num_keys operands, the rest
    riding along. Successive stable passes, last key first."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else torch.gather(key, -1, perm)
        order = torch.sort(k, dim=-1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, -1, order)
    return tuple(torch.gather(op, -1, perm) for op in operands)


def _prev(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)


def _rev_cummin(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(a, [dim]), dim=dim).values, [dim])


def _seg_start_from_boundary(boundary: torch.Tensor) -> torch.Tensor:
    """[..., N] bool (True at run starts) -> index of each element's run
    start."""
    idx = _ar(boundary.shape[-1], boundary.device)
    return torch.cummax(
        torch.where(boundary, idx, torch.zeros_like(idx)), dim=-1
    ).values


def _seg_run_min(values: torch.Tensor, start_flags: torch.Tensor):
    """Full-run min broadcast to every member of each run; runs start at
    start_flags (and at index 0). Two segmented scans: the run id, as a
    large offset, keeps a prefix or suffix min inside its run."""
    seg = torch.cumsum(start_flags, dim=-1, dtype=I64)
    v = values.long()
    big = 1 << 34
    fwd = torch.cummin(v - seg * big, dim=-1).values + seg * big
    bwd = _rev_cummin(v + seg * big) - seg * big
    return torch.minimum(fwd, bwd).to(values.dtype)


def _seg_hold_fwd(values: torch.Tensor, start_flags: torch.Tensor):
    """Each run's start value broadcast to its members (elements before
    the first flag take element 0's)."""
    return torch.gather(values, -1, _seg_start_from_boundary(start_flags).long())


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of an int64 tensor, as int32."""
    v = x & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(I32)


def _ctz32(m: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of an int32 bit pattern (32 for 0), computed as
    popcount((m & -m) - 1) in int64."""
    u = m.long() & 0xFFFFFFFF
    return _popcount32((u & -u) - 1)


def _key_int(phase, gpre=0, rd=0):
    """32-bit creation key (devbuild.key_int): (phase << 28) |
    (gpre << 14) | rd."""
    return (phase << 28) | (gpre << 14) | rd


# ---- 1. decode --------------------------------------------------------------


def decode_columns(ops, starts, caps: Caps):
    """Per-column decode: consumed target position, per-read consumed/
    matched prefix counts. ops: [B, R, C] uint8; starts: [B, R] int32
    (1-based; 0 = padding read)."""
    is_m = ops == OP_MATCH
    consume = is_m | (ops == OP_DEL)
    ncons = _cs(consume)
    tpos = starts[..., None] - 1 + ncons
    nm = _cs(is_m)
    return {
        "consume": consume,
        "is_ins": ops == OP_INS,
        "tpos": tpos,
        "nm": nm,
        "seg": nm - is_m.to(I32),
        "n_matches": nm[..., -1],
        "n_cols": _sum(ops != 0),
        "ends": starts - 1 + ncons[..., -1],
    }


def coverage_and_matches(ops, starts, dec, caps: Caps):
    """cov[b, p] / matches[b, p] for p in 0..L+1 (index 0 unused): an
    interval-endpoint histogram prefix-summed, and a histogram of the
    match columns' target positions."""
    B, R, C, L = caps.B, caps.R, caps.C, caps.L
    HL = L + 2
    live = starts > 0
    ends1 = torch.clamp(dec["ends"] + 1, 0, HL - 1) + HL
    iv = torch.cat([starts, ends1], dim=-1)
    c_iv = mxu_hist(iv, torch.cat([live, live], dim=-1), 2 * HL)
    cov = _cs(c_iv[:, :HL] - c_iv[:, HL:])
    matches = mxu_hist(
        dec["tpos"].reshape(B, R * C), (ops == OP_MATCH).reshape(B, R * C), HL
    )
    return cov, matches


def matched_positions(ops, dec, starts, Lr, caps: Caps):
    """Match tables in match-rank space: (mpos, mchain, s0chain).

    mpos[b, r, j] = target position of read r's j-th match (Lr+1 past the
    last); mchain[b, r, j] = the segment after match j holds an
    insertion; s0chain[b, r] = the leading segment does. The JAX form's
    sort keys are a per-read permutation of column slots, so the sort is
    a scatter of the values to their slots."""
    B, R, C = caps.B, caps.R, caps.C
    dev = ops.device
    is_m = ops == OP_MATCH
    nm = dec["nm"]
    nmat = dec["n_matches"][..., None]
    cgrid = _ar(C, dev)[None, None, :]
    bnd = (is_m | (cgrid == 0)).reshape(B, R * C)
    runor = (
        -_seg_run_min(-dec["is_ins"].to(torch.int8).reshape(B, R * C), bnd)
    ).reshape(B, R, C) > 0
    s0chain = runor[:, :, 0] & ~is_m[:, :, 0]
    slot = torch.where(is_m, nm - 1, nmat + (cgrid - nm))
    rr = _ar(R, dev)[None, :, None]
    key = (rr * C + slot).reshape(B, R * C)
    val = torch.where(
        is_m, dec["tpos"] | (runor.to(I32) << 15), torch.zeros_like(nm)
    ).reshape(B, R * C)
    if R * C < (1 << 16):  # the JAX form sorts uint16 operands
        val = val & 0xFFFF
    sv = torch.empty_like(val).scatter_(1, key.long(), val)
    svg = sv.reshape(B, R, C)
    in_m = _ar(C, dev)[None, None, :] < nmat
    mpos = torch.where(in_m, svg & 0x7FFF, Lr[:, None, None] + 1)
    mchain = in_m & ((svg >> 15) > 0)
    return mpos, mchain, s0chain


def _row_ss_lr(rows, queries):
    """(left, right) searchsorted boundaries of integer queries in
    ascending rows: right(k) == left(k + 1)."""
    Q = queries.shape[-1]
    both = torch.searchsorted(
        rows.contiguous(), torch.cat([queries, queries + 1], dim=-1).contiguous()
    ).to(I32)
    return both[..., :Q], both[..., Q:]


def extract_chains(ops, starts, ins_base, dec, mpos, Lr, caps: Caps):
    """Chain table [B, R, CH] per (read, segment with insertions): valid,
    anchors p / t, length, packed reversed (anchor << 8 | base) strings
    depth-major [B, SM, R, CH], chain counts and the overflow flag."""
    B, R, C, CH, SM = caps.B, caps.R, caps.C, caps.CH, caps.SM
    dev = ops.device
    NI = ins_base.shape[1]
    RC = R * C
    BIGK = 1 << 24
    flat_ins = dec["is_ins"].reshape(B, RC)
    cum = _cs(flat_ins)
    total = cum[:, -1]
    k = _ar(NI, dev)
    fidx = _ar(RC, dev).expand(B, RC)
    seg = dec["seg"].reshape(B, RC)
    tpos = dec["tpos"].reshape(B, RC)
    # The JAX form sorts the insertion columns to the front (rank cum-1)
    # and the rest behind them in column order: a known-rank scatter.
    dest = torch.where(flat_ins, cum - 1, total[:, None] + fidx - cum).long()

    def compact(x):
        return torch.empty_like(x).scatter_(1, dest, x)[:, :NI]

    valid_k = k[None, :] < total[:, None]
    if RC < (1 << 16):  # uint16 operands in the JAX form
        posc = torch.clamp(compact(fidx & 0xFFFF), 0, RC - 1)
        seg_k = compact(seg & 0xFFFF)
        anchor_k = compact(tpos & 0xFFFF)
    else:
        posc = torch.clamp(compact(fidx), 0, RC - 1)
        sa = compact((seg << 15) | tpos)
        seg_k = sa >> 15
        anchor_k = sa & 0x7FFF
    r_of = posc // C

    # chain = run of equal (read, seg) in the compact stream.
    r_s = torch.where(valid_k, r_of, torch.full_like(r_of, R))
    seg_s = torch.where(valid_k, seg_k, torch.full_like(seg_k, BIGK))
    newc = valid_k & torch.cat(
        [
            torch.ones((B, 1), dtype=torch.bool, device=dev),
            (r_s[:, 1:] != r_s[:, :-1]) | (seg_s[:, 1:] != seg_s[:, :-1]),
        ],
        dim=-1,
    )
    gch = _cs(newc) - 1

    read_lo, read_hi = _row_ss_lr(r_s, _ar(R, dev).expand(B, R))
    has_ins = read_hi > read_lo
    first_g = _gat(gch, torch.clamp(read_lo, 0, NI - 1))
    last_g = _gat(gch, torch.clamp(read_hi - 1, 0, NI - 1))
    n_chains = torch.where(has_ins, last_g - first_g + 1, torch.zeros_like(first_g))

    ch = _ar(CH, dev)
    chain_valid = ch[None, None, :] < n_chains[..., None]
    g_grid = first_g[..., None] + ch[None, None, :]
    g_q = torch.where(chain_valid, g_grid, torch.full_like(g_grid, BIGK)).reshape(
        B, R * CH
    )
    # first/last stream position per chain id: histogram + exclusive
    # cumsum (lo[g]), and right(g) == lo[g + 1].
    hg = mxu_hist(gch, valid_k, NI)
    lo_t = _cs(hg) - hg
    lo_t = torch.cat([lo_t, _sum(hg)[:, None]], dim=-1)
    q2 = torch.cat(
        [torch.clamp(g_q, 0, NI), torch.clamp(g_q + 1, 0, NI)], dim=-1
    )
    both = mxu_gather(lo_t, q2, max_val=NI + 1)
    chain_first = both[:, : R * CH].reshape(B, R, CH)
    zero3 = torch.zeros_like(chain_first)
    chain_len = torch.where(
        chain_valid, both[:, R * CH :].reshape(B, R, CH) - chain_first, zero3
    )
    cf = torch.clamp(chain_first, 0, NI - 1)
    chain_seg = torch.where(
        chain_valid,
        mxu_gather(seg_k, cf.reshape(B, R * CH), max_val=1 << 15).reshape(
            B, R, CH
        ),
        zero3,
    )

    # p / t anchors from mpos: one packed lookup per (read, chain).
    nmat = dec["n_matches"]
    mprev = torch.cat([torch.zeros_like(mpos[..., :1]), mpos[..., :-1]], dim=-1)
    pairg = mxu_gather(
        ((mpos << 15) | mprev).reshape(B * R, C),
        torch.clamp(chain_seg, 0, C - 1).reshape(B * R, CH),
        max_val=1 << 30,
    ).reshape(B, R, CH)
    p_anchor = torch.where(chain_seg == 0, zero3, pairg & 0x7FFF)
    t_anchor = torch.where(
        chain_seg < nmat[..., None], pairg >> 15, Lr[:, None, None] + 1
    )

    # Depth d (0 = last base) reads the compact stream at last - d.
    d = _ar(SM, dev)
    src_ok = (d[None, :, None, None] < chain_len[:, None, :, :]) & chain_valid[
        :, None, :, :
    ]
    ba_k = (anchor_k << 8) | ins_base.to(I32)
    last = torch.clamp(
        (chain_first + chain_len - 1).reshape(B, R * CH), 0, NI - 1
    )
    at = last[:, None, :] - d[None, :, None]  # [B, SM, R*CH]
    ba = torch.gather(
        ba_k[:, None, :].expand(B, SM, NI), 2, at.clamp(min=0).long()
    )
    ba = torch.where(at >= 0, ba, torch.zeros_like(ba)).reshape(B, SM, R, CH)
    rev_ba = torch.where(src_ok, ba, torch.zeros_like(ba))
    overflow = chain_len > SM
    return {
        "overflow_any": _any(overflow & chain_valid, (1, 2))
        | _any(n_chains > CH, -1),
        "valid": chain_valid,
        "p": p_anchor,
        "t": t_anchor,
        "seg": chain_seg,
        "len": torch.clamp(chain_len, max=SM),
        "true_len": chain_len,
        "rev_ba": rev_ba,
        "n_chains": n_chains,
    }


# ---- 3. transitions and absorption -----------------------------------------


def transitions_table(dec, mtab, chains, starts, Lr, caps: Caps):
    """Aggregate chainless anchor transitions: counts and min creating
    read per interior (p, dq), exit and enter transition, plus the
    over-DQ flag (see the JAX function for the output layout)."""
    B, R, C, DQ, L = caps.B, caps.R, caps.C, caps.DQ, caps.L
    dev = starts.device
    BIG = 1 << 24
    nmat = dec["n_matches"]
    live = starts > 0
    mpos, mchain, s0chain = mtab

    jgrid = _ar(C, dev)[None, None, :]
    nxt = torch.cat([mpos[..., 1:], torch.zeros_like(mpos[..., :1])], dim=-1)
    is_match = (jgrid < nmat[..., None]) & live[..., None]
    is_last = (jgrid + 1) >= nmat[..., None]
    nxt = torch.where(is_last, Lr[:, None, None] + 1, nxt)
    contrib = is_match & ~mchain
    delta = nxt - mpos
    over_dq = _any(contrib & ~is_last & (delta > DQ), (1, 2))

    STRIDE = DQ + 2
    EOFF = (L + 2) * STRIDE
    key = torch.where(
        contrib & ~is_last & (delta >= 1) & (delta <= DQ),
        mpos * STRIDE + delta,
        torch.where(
            contrib & is_last, mpos * STRIDE + DQ + 1, torch.full_like(mpos, BIG)
        ),
    )
    first_q = torch.where(nmat > 0, mpos[..., 0], Lr[:, None] + 1)
    e_key = torch.where(live & ~s0chain, EOFF + first_q, torch.full_like(first_q, BIG))
    keys = torch.cat([key.reshape(B, R * C), e_key], dim=-1)
    reads = torch.cat(
        [
            _ar(R, dev)[None, :, None].expand(B, R, C).reshape(B, R * C),
            _ar(R, dev)[None, :].expand(B, R),
        ],
        dim=-1,
    )
    DKEY = (L + 2) * (STRIDE + 1)
    ev_valid = keys < BIG
    h = mxu_hist(keys, ev_valid, DKEY)

    def grid_parts(a):
        intr = a[:, :EOFF].reshape(B, L + 2, STRIDE)
        return intr[..., 1 : DQ + 2], a[:, EOFF : EOFF + L + 2]

    def grid_cat(a):
        ai, ae = grid_parts(a)
        return torch.cat([ai.reshape(B, -1), ae], dim=-1)

    cnt = grid_cat(h)
    if R <= 64:
        # (key, read) pairs are unique (a read's event keys strictly
        # increase), so the weighted histogram of 1 << read per key is
        # an exact read bitmask and the min read its trailing zeros.
        one = torch.ones_like(reads)
        if R <= 32:
            wbits = (one << reads,)
        else:
            sh = one << (reads & 31)
            zero = torch.zeros_like(reads)
            wbits = (
                torch.where(reads < 32, sh, zero),
                torch.where(reads >= 32, sh, zero),
            )
        masks = mxu_weighted_hist(keys, ev_valid, wbits, DKEY)
        if R <= 32:
            rk_full = _ctz32(masks[0])
        else:
            rk_full = torch.where(
                masks[0] != 0, _ctz32(masks[0]), 32 + _ctz32(masks[1])
            )
        rk_grid = grid_cat(rk_full)
    else:
        # Wide R: the first read of each key's run in the (key, read)
        # sort.
        lo = grid_cat(_cs(h) - h)
        _sk, sr = _sort((keys, reads), 2)
        rk_grid = _gat(sr, torch.clamp(lo, 0, sr.shape[1] - 1))
    rkey = torch.where(cnt > 0, rk_grid, torch.full_like(rk_grid, BIG))
    ni = (L + 2) * (DQ + 1)
    cnt_i = cnt[:, :ni].reshape(B, L + 2, DQ + 1)
    rk_i = rkey[:, :ni].reshape(B, L + 2, DQ + 1)
    return {
        "count_pq": cnt_i[..., :DQ],
        "rkey_pq": rk_i[..., :DQ],
        "exit_cnt": cnt_i[..., DQ],
        "exit_rkey": rk_i[..., DQ],
        "enter_cnt": cnt[:, ni:],
        "enter_rkey": rkey[:, ni:],
        "over_dq": over_dq,
    }


def apply_absorption(chains, trans, bb, Lr, caps: Caps):
    """Multi-round backbone absorption on the flat chain table [B, N]
    (N = R*CH), in closed form per chain (see the JAX function): strip
    counts, died chains as (p, dq) transitions or long-edge candidates,
    the absorbed-count bonus and the strip landings."""
    B, R, CH, SM, L = caps.B, caps.R, caps.CH, caps.SM, caps.L
    N = R * CH
    HL = L + 2
    dev = bb.device

    valid = chains["valid"].reshape(B, N)
    pf = chains["p"].reshape(B, N)
    tf = chains["t"].reshape(B, N)
    lenf = chains["len"].reshape(B, N)
    ba = chains["rev_ba"].reshape(B, SM, N)
    read = _ar(R, dev)[None, :, None].expand(B, R, CH).reshape(B, N)
    seq = _ar(N, dev)[None, :].expand(B, N)

    skip_any = _sum(trans["count_pq"][..., 1:]) > 0
    pidx = _ar(HL, dev)[None, :]
    exit_skip = (trans["exit_cnt"] > 0) & (pidx < Lr[:, None])
    chain_start_cnt = mxu_hist(pf, valid, HL)
    multi = skip_any | exit_skip | (chain_start_cnt > 0)
    outdeg1 = (pidx >= 1) & (pidx <= Lr[:, None]) & ~multi

    ABR = MAX_ABSORB_ROUNDS
    J = ABR + 1
    assert SM >= J, "SM ladder must cover the absorption probe depth"
    jj = torch.arange(1, J + 1, dtype=I32, device=dev)
    tj = tf[:, None, :] - jj[None, :, None]
    bbp = torch.nn.functional.pad(bb.to(I32), (1, 1))
    ent = torch.where(outdeg1, ((bbp & 0x3F) << 1) | 1, torch.zeros_like(bbp))
    word = torch.zeros_like(ent)
    for j2 in range(1, J + 1):
        sh = torch.cat([torch.zeros_like(ent[:, :j2]), ent[:, :-j2]], dim=-1)
        word = word | (sh << (7 * (j2 - 1)))
    wt = mxu_gather(word, torch.clamp(tf, 0, L + 1), max_val=1 << (7 * J))
    ent_j = (wt[:, None, :] >> (7 * (jj[None, :, None] - 1))) & 0x7F
    ok = (
        valid[:, None, :]
        & (jj[None, :, None] <= lenf[:, None, :])
        & (tj >= 1)
        & ((ent_j & 1) == 1)
        & ((ent_j >> 1) == (ba[:, :J, :] & 0x3F))
    )
    pref = _cs((~ok).to(I32), dim=1) == 0  # prefix-AND over rounds
    kx = _sum(pref[:, :ABR, :], dim=1)
    cascade = _any(pref[:, J - 1, :], -1)

    # strip kx rounds at once: select among the constant depth-shifts.
    ba2 = ba
    for k2 in range(1, ABR + 1):
        shifted = torch.cat([ba[:, k2:, :], torch.zeros_like(ba[:, :k2, :])], dim=1)
        ba2 = torch.where(kx[:, None, :] == k2, shifted, ba2)
    len2 = lenf - kx
    t2 = tf - kx
    died = valid & (kx > 0) & (len2 == 0)
    valid2 = valid & ~died

    DQ = caps.DQ
    pmN = torch.clamp(t2, 0, L + 1)
    dd = pmN - pf
    BIG = 1 << 24
    K = caps.K
    # died strips spanning more than DQ: long-edge candidates (p, pm),
    # deduplicated and counted through one sort.
    dl_m = died & (dd > DQ)
    dl_key = torch.where(dl_m, pf * HL + pmN, torch.full_like(pf, 1 << 28))
    dl_rd = torch.where(dl_m, read, torch.full_like(read, 1 << 20))
    sdk, sdr = _sort((dl_key, dl_rd), 2)
    true1 = torch.ones((B, 1), dtype=torch.bool, device=dev)
    dl_uniq = (sdk < (1 << 28)) & torch.cat([true1, sdk[:, 1:] != sdk[:, :-1]], -1)
    posd = _ar(N, dev)[None, :].expand(B, N)
    dl_nb = torch.where(
        torch.cat([dl_uniq[:, 1:] | (sdk[:, 1:] >= (1 << 28)), true1], -1),
        posd + 1,
        torch.full_like(posd, N),
    )
    dl_end = _rev_cummin(dl_nb)
    cu_key = torch.where(dl_uniq, sdk, torch.full_like(sdk, 1 << 28))
    cuk, cup = _sort((cu_key, posd), 2)
    cuk, cup = cuk[:, :K], torch.clamp(cup[:, :K], 0, N - 1)
    live_k = cuk < (1 << 28)
    died_long = {
        "p": torch.where(live_k, cuk // HL, torch.full_like(cuk, -1)),
        "q": torch.where(live_k, cuk % HL, torch.full_like(cuk, -1)),
        "cnt": _gat(dl_end - posd, cup),
        "rd": _gat(sdr, cup),
    }
    over_dd = _sum(dl_uniq) > K

    # min (read, orig t) per (p, dq) of the died chains: the first of
    # each key's run in a (key, read, t) sort.
    KPAD = HL * (DQ + 2) + 1
    dmask = died & (dd >= 1) & (dd <= DQ)
    dkey = torch.where(dmask, pf * (DQ + 2) + dd, torch.full_like(pf, KPAD))
    if KPAD < 0xFFFF:
        dkey = dkey & 0xFFFF
    h2 = mxu_hist(pf * (DQ + 2) + dd, dmask, HL * (DQ + 2))
    lo2 = _cs(h2) - h2
    died_cnt_pq = h2.reshape(B, HL, DQ + 2)[..., 1 : DQ + 1]
    fi = lo2.reshape(B, HL, DQ + 2)[..., 1 : DQ + 1].reshape(B, -1)
    fic = torch.clamp(fi, 0, N - 1)
    kmatch = died_cnt_pq.reshape(B, -1) > 0
    if KPAD < 0xFFFF and R * HL <= 0xFFFF:
        _sk2, s_pack = _sort((dkey, (read * HL + tf) & 0xFFFF), 2)
        g_pack = mxu_gather(s_pack, fic, max_val=1 << 16)
        g_rd = g_pack // HL
        g_tf = g_pack % HL
    else:
        if KPAD < 0xFFFF and R < 0xFFFF and HL < 0xFFFF:
            rd_op, tf_op = read & 0xFFFF, tf & 0xFFFF
        else:
            rd_op, tf_op = read, tf
        _sk2, s_rd, s_tf = _sort((dkey, rd_op, tf_op), 3)
        g_rd = mxu_gather(s_rd & 0xFFFF, fic, max_val=1 << 16)
        g_tf = mxu_gather(s_tf & 0xFFFF, fic, max_val=1 << 16)
    died_read = torch.where(kmatch, g_rd, torch.full_like(g_rd, BIG)).reshape(
        B, HL, DQ
    )
    died_t = torch.where(kmatch, g_tf, torch.zeros_like(g_tf)).reshape(B, HL, DQ)

    # bonus (+1 per absorbed chain on backbone [t-kx, t-1]) and strip
    # landings, from one (t, kx, died)-class histogram.
    assert 2 * ABR + 1 <= 7
    abs_any = valid & (kx > 0)
    cnt_key = mxu_hist(
        torch.clamp(tf, 0, HL - 1) * 8 + 2 * kx + died.to(I32), abs_any, 8 * HL
    ).reshape(B, HL, 8)
    csuf = torch.flip(_cs(torch.flip(cnt_key, [-1])), [-1])
    bonus = torch.zeros((B, HL), dtype=I32, device=dev)
    strip_cnt = torch.zeros_like(bonus)
    for j3 in range(1, ABR + 1):
        n_ge = csuf[:, :, 2 * j3]
        term_s = n_ge - cnt_key[:, :, 2 * j3 + 1]
        pad = torch.zeros_like(bonus[:, :j3])
        bonus = bonus + torch.cat([n_ge[:, j3:], pad], -1)
        strip_cnt = strip_cnt + torch.cat([term_s[:, j3:], pad], -1)

    return {
        "valid": valid2,
        "p": pf,
        "t": t2,
        "len": len2,
        "rev_ba": ba2,
        "read": read,
        "seq": seq,
        "phase": kx,
        "bonus": bonus,
        "died_cnt_pq": died_cnt_pq,
        "died_read": died_read,
        "died_t": died_t,
        "died_long": died_long,
        "over_dd": over_dd,
        "cascade": cascade,
        "strip_t": strip_cnt > 0,
        "outdeg1": outdeg1,
    }


# ---- 4. suffix tries -------------------------------------------------------


def build_tries(fc, Lr, caps: Caps):
    """Suffix tries from the flat chain table (after absorption): the
    chains sorted by (termination, reversed string), their common
    prefixes, and the per-(depth, chain) node grid (creation ids, run
    ends, weights, survivors), depth-major [B, SM, N]."""
    B, N = fc["valid"].shape
    SM = caps.SM
    dev = fc["valid"].device
    BIGT = 1 << 20

    ba_dm = fc["rev_ba"]
    rb = (ba_dm & 0xFF).long()

    def lane(i0):
        out = torch.zeros_like(rb[:, 0, :])
        for j in range(4):
            if i0 + j < SM:
                out = out | (rb[:, i0 + j, :] << (24 - 8 * j))
        return out

    lanes = [lane(i) for i in range(0, SM, 4)]
    tkey = torch.where(fc["valid"], fc["t"], torch.full_like(fc["t"], BIGT))
    idx = _ar(N, dev)[None, :].expand(B, N)
    SB = max(14, (N - 1).bit_length())
    assert caps.SM <= 31 and caps.R <= (1 << 10) and 2 * SB + 2 <= 32
    SMASK = (1 << SB) - 1
    pay1 = (
        (fc["valid"].to(I32) << 30)
        | (fc["p"] << 15)
        | (fc["len"] << 10)
        | fc["read"]
    )
    pay2 = (
        (fc["phase"].long() << (2 * SB))
        | (fc["seq"].long() << SB)
        | idx.long()
    )
    sorted_ops = _sort([tkey] + lanes + [pay1, pay2], 1 + len(lanes))
    st, p1s, p2s = sorted_ops[0], sorted_ops[-2], sorted_ops[-1]
    sidx = (p2s & SMASK).to(I32)
    s_ba = _gat(ba_dm, sidx[:, None, :], dim=2)
    s = {
        "t": st,
        "valid": ((p1s >> 30) & 1) > 0,
        "p": (p1s >> 15) & 0x7FFF,
        "len": (p1s >> 10) & 0x1F,
        "read": p1s & 0x3FF,
        "phase": ((p2s >> (2 * SB)) & 3).to(I32),
        "seq": ((p2s >> SB) & SMASK).to(I32),
        "rev_ba": s_ba,
        "rb_nm": (s_ba & 0xFF).transpose(1, 2).reshape(B, N * SM),
    }

    # lcp with the previous chain (same t, shared reversed prefix).
    same_t = (s["t"] == _prev(s["t"])) & _prev(s["valid"]) & s["valid"]
    eq = same_t
    lcp = torch.zeros((B, N), dtype=I32, device=dev)
    s_rb = s_ba & 0xFF
    plen = _prev(s["len"])
    for d in range(1, SM + 1):
        col = s_rb[:, d - 1, :]
        eq = eq & (col == _prev(col)) & (s["len"] >= d) & (plen >= d)
        lcp = torch.where(eq, torch.full_like(lcp, d), lcp)

    dgrid = torch.arange(1, SM + 1, dtype=I32, device=dev)
    node_new = (
        s["valid"][..., None]
        & (dgrid[None, None, :] <= s["len"][..., None])
        & (dgrid[None, None, :] > lcp[..., None])
    )
    n_new = torch.where(s["valid"], s["len"] - lcp, torch.zeros_like(lcp))
    base_id = _cs(n_new) - n_new
    n_nodes = _sum(n_new)

    pos = idx
    seqpack = (s["phase"] << 14) | s["seq"]
    packed = (seqpack << 14) | pos
    zval = base_id - lcp

    dgrid2 = dgrid[None, :, None]
    posb = pos[:, None, :]
    bnd_dm = lcp[:, None, :] < dgrid2  # [B, SM, N] run starts
    owner_dm = torch.cummax(
        torch.where(bnd_dm, posb, torch.zeros_like(posb)), dim=2
    ).values
    nxt = torch.where(bnd_dm, posb, torch.full_like(posb, N))
    rev_cm = _rev_cummin(nxt, dim=2)
    run_end_dm = torch.cat(
        [rev_cm[..., 1:], torch.full((B, SM, 1), N, dtype=I32, device=dev)], -1
    )
    holdp = torch.cummax(
        torch.where(
            bnd_dm,
            (posb << 14) | torch.clamp(zval, max=0x3FFF)[:, None, :],
            torch.full_like(bnd_dm, -1, dtype=I32),
        ),
        dim=2,
    ).values
    nid_dm = (holdp & 0x3FFF) + dgrid2 - 1
    weight_dm = run_end_dm - owner_dm
    # survivor suffix-min over [i, run_end) by backward doubling.
    sv = packed[:, None, :].expand(B, SM, N)
    s_shift = 1
    while s_shift < N:
        shifted = torch.cat(
            [
                sv[..., s_shift:],
                torch.full((B, SM, s_shift), 1 << 30, dtype=I32, device=dev),
            ],
            dim=-1,
        )
        sv = torch.where(
            posb + s_shift < run_end_dm, torch.minimum(sv, shifted), sv
        )
        s_shift *= 2

    return {
        "sorted": s,
        "sidx": sidx,
        "lcp": lcp,
        "node_new": node_new,
        "n_nodes": n_nodes,
        "owner": owner_dm,
        "run_end": run_end_dm,
        "nid": nid_dm,
        "weight": weight_dm,
        "survivor": sv,
    }


# ---- 5. linearization and band ---------------------------------------------


def linearize_and_band(tri, fc, absb, trans, cov, matches, bb, Lr, caps: Caps):
    """Compact trie-node table, postorder placement among the backbone
    positions, parent links and the start edges with their creation keys
    (see the JAX function for each field)."""
    B, SM, ND, V, W, L = caps.B, caps.SM, caps.ND, caps.V, caps.W, caps.L
    s = tri["sorted"]
    N = s["t"].shape[1]
    dev = s["t"].device
    BIGT = 1 << 20

    # compact table: chain i's new nodes take the consecutive ranks
    # [base_id[i], base_id[i] + n_new[i]); scatter (i, zval) to the
    # first, forward-fill, and decode each rank's chain and depth.
    lcp = tri["lcp"]
    n_new = torch.where(s["valid"], s["len"] - lcp, torch.zeros_like(lcp))
    base_id = _cs(n_new) - n_new
    zval_c = base_id - lcp
    n_nodes = tri["n_nodes"]
    over_nd = n_nodes > ND
    i_arange = _ar(N, dev)[None, :].expand(B, N)
    assert ND <= (1 << 14) and N <= (1 << 15)
    st_tbl = mxu_scatter(
        base_id, n_new > 0, (((i_arange << 14) | zval_c) + 1,), ND,
        max_payload=1 << 30,
    )[0]
    filled = _seg_hold_fwd(st_tbl, st_tbl > 0) - 1
    i_r = torch.clamp(filled >> 14, 0, N - 1)
    zval_r = filled & 0x3FFF
    rankg = _ar(ND, dev)[None, :].expand(B, ND)
    comp_valid = rankg < n_nodes[:, None]
    cd = torch.clamp(rankg - zval_r + 1, 1, SM)

    re_dm = tri["run_end"]
    w_dm = tri["weight"]
    sv_dm = tri["survivor"] & ((1 << 14) - 1)
    nid_dm = tri["nid"]
    rb_dm = s["rev_ba"] & 0xFF
    pack_fld = N <= (1 << 14) and caps.R < (1 << 10)
    if pack_fld:
        ga = (
            (re_dm.long() << 17)
            | (torch.clamp(w_dm, 0, 0x3FF).long() << 7)
            | (rb_dm & 0x7F).long()
        )
        gb = (nid_dm.long() << 14) | sv_dm.long()
        planes = torch.cat([ga, gb, s["t"].long()[:, None, :]], dim=1)
    else:
        planes = torch.cat(
            [re_dm, w_dm, sv_dm, nid_dm, rb_dm, s["t"][:, None, :]], dim=1
        )
    gath = _gat(planes, i_r[:, None, :], dim=2)  # [B, P, ND]

    def dsel(off):
        """Plane off + cd - 1 of each row."""
        return torch.gather(gath, 1, (off + cd - 1)[:, None, :].long())[:, 0, :]

    if pack_fld:
        ga_sel = dsel(0)
        gb_prev = dsel(SM - 1)  # depth cd - 1 for cd >= 2
        t_sel = gath[:, 2 * SM, :].to(I32)
        cre = (ga_sel >> 17).to(I32)
        cw = ((ga_sel >> 7) & 0x3FF).to(I32)
        cbase = (ga_sel & 0x7F).to(I32)
        csv = dsel(SM).to(I32) & 0x3FFF
        cprev = (gb_prev >> 14).to(I32) & 0x3FFF
    else:
        cre = dsel(0)
        cw = dsel(SM)
        csv = dsel(2 * SM)
        cprev = dsel(3 * SM - 1)
        cbase = dsel(4 * SM) & 0x7F
        t_sel = gath[:, 5 * SM, :]

    ct = torch.where(comp_valid, t_sel, torch.full_like(t_sel, BIGT))

    # postorder of the compact table: (t, run_end, depth descending).
    st_t, nre, smcd, p1s, p2s, p3s = _sort(
        (
            ct, cre, SM - cd,
            (i_r << 14) | rankg,
            (torch.clamp(cprev, 0, 0x3FFF) << 17)
            | (torch.clamp(cw, 0, 0x3FF) << 7) | cbase,
            csv,
        ),
        3,
    )
    nvalid_t = st_t < BIGT
    nt = st_t
    nd_ = SM - smcd
    nrs = p1s >> 14
    nnid = p1s & 0x3FFF
    prev_s = p2s >> 17
    nw = (p2s >> 7) & 0x3FF
    nbase = p2s & 0x7F
    npar = torch.where(nd_ == 1, torch.full_like(prev_s, -1), prev_s)
    jc = torch.clamp(p3s, 0, N - 1)
    sv_pack = (s["len"] << 25) | (s["p"] << 10) | s["read"]
    svw = mxu_gather(sv_pack, jc, max_val=1 << 30)
    nsvlen = svw >> 25
    nsvp = (svw >> 10) & ((1 << 15) - 1)
    nsvrd = svw & ((1 << 10) - 1)
    # anchor at (survivor chain, depth d - 1).
    ga_r = _gat(s["rev_ba"] >> 8, jc[:, None, :], dim=2)  # [B, SM, ND]
    d_ok = (nd_ >= 1) & (nd_ <= SM)
    nanch = torch.gather(ga_r, 1, torch.clamp(nd_ - 1, 0, SM - 1)[:, None, :].long())
    nanch = torch.where(d_ok, nanch[:, 0, :], torch.zeros_like(nd_))

    rank = _ar(ND, dev)[None, :].expand(B, ND)
    lin_trie = torch.where(nvalid_t, rank + nt - 1, torch.full_like(nt, 1 << 28))
    # nid -> lin map: nid is the compact rank, so a unique-rank scatter.
    slin = mxu_scatter(nnid, nvalid_t, (rank + nt - 1,), ND)[0]

    def lin_of_nid(q):
        return mxu_gather(slin, torch.clamp(q, 0, ND - 1), max_val=1 << 16)

    # backbone linear index: p - 1 + #nodes with t <= p.
    pq = _ar(L + 2, dev)
    ct_le = _cs(mxu_hist(nt, nvalid_t, L + 2))
    lin_bb_full = pq[None, :] - 1 + ct_le
    n_total = Lr + n_nodes
    over_v = n_total > V

    # preorder rank (t, run start, depth ascending) among valid nodes.
    *_k, pr_src = _sort(
        (torch.where(nvalid_t, nt, torch.full_like(nt, BIGT)), nrs, nd_, rank), 3
    )
    pre_rank = mxu_scatter(
        pr_src, torch.ones_like(pr_src, dtype=torch.bool), (rank,), ND
    )[0]

    is_exit_parent = (nd_ == 1) & (nt == Lr[:, None] + 1)
    par_bb = mxu_gather(
        lin_bb_full + 1, torch.clamp(nt, 0, L + 1), max_val=1 << 16
    ) - 1
    par_lin = torch.where(nd_ == 1, par_bb, lin_of_nid(torch.clamp(npar, 0, ND - 1)))
    span_trie = par_lin - lin_trie
    trie_span_over = nvalid_t & ~is_exit_parent & ((span_trie < 1) | (span_trie > W))

    # ---- start edges: one candidate per chain, at its deepest node ----
    clen = s["len"]
    cvalid = s["valid"] & (clen >= 1)
    deep_nid = torch.gather(
        tri["nid"], 1, torch.clamp(clen - 1, 0, SM - 1)[:, None, :].long()
    )[:, 0, :]
    deep_lin = lin_of_nid(torch.clamp(deep_nid, 0, ND - 1))
    se16 = (L + 2) * 2 + 2 < 0xFFFF and V + ND < 0xFFFE
    PBIG = 0xFFFF if se16 else (1 << 20)
    NBIG = 0xFFFF if se16 else (1 << 28)
    cut = (lambda x: x & 0xFFFF) if se16 else (lambda x: x)
    se_key_p = torch.where(cvalid, cut(s["p"]), torch.full_like(s["p"], PBIG))
    se_key_n = torch.where(cvalid, cut(deep_lin), torch.full_like(deep_lin, NBIG))
    se_pay = (s["phase"] << 27) | (s["read"] << 14) | _ar(N, dev)[None, :]
    sp_, sn_, spay_ = _sort((se_key_p, se_key_n, se_pay), 3)
    se_invalid = sp_ >= PBIG
    prev_same = (
        sp_ == torch.cat([sp_[:, :1] - 1, sp_[:, :-1]], dim=-1)
    ) & (sn_ == torch.cat([sn_[:, :1] - 1, sn_[:, :-1]], dim=-1))
    uniq = ~se_invalid & ~prev_same
    posn = _ar(N, dev)[None, :].expand(B, N)
    true1 = torch.ones((B, 1), dtype=torch.bool, device=dev)
    nxtb = torch.where(
        torch.cat([uniq[:, 1:] | se_invalid[:, 1:], true1], -1),
        posn + 1,
        torch.full_like(posn, N),
    )
    se_count = _rev_cummin(nxtb) - posn
    se_bnd = uniq | se_invalid
    se_anystrip = -_seg_run_min(-(spay_ >> 27), se_bnd) > 0
    se_minrd = _seg_run_min((spay_ >> 14) & ((1 << 13) - 1), se_bnd)

    # per-node survivor words scattered into lin space, read at sn_.
    sn_clip = torch.clamp(torch.where(uniq, sn_, torch.zeros_like(sn_)), 0, V - 1)
    w1 = ((nsvlen == nd_).to(I32) << 25) | (nsvp << 10) | nsvrd
    unc_node = mxu_gather(
        absb["strip_t"].to(I32), torch.clamp(nt, 0, L + 1), max_val=2
    )
    w2 = (unc_node << 29) | (pre_rank << 15)
    w1_lin, w2_lin = mxu_scatter(
        lin_trie, nvalid_t, (w1, w2), V, max_payload=1 << 30
    )
    g1 = mxu_gather(w1_lin, sn_clip, max_val=1 << 26)
    g2w = mxu_gather(w2_lin, sn_clip, max_val=1 << 30)
    nd_first_deep = g1 >> 25
    nd_first_p = (g1 >> 10) & ((1 << 15) - 1)
    nd_first_rd = g1 & ((1 << 10) - 1)
    nd_pre = (g2w >> 15) & ((1 << 14) - 1)
    nd_unc = (g2w >> 29) > 0
    threaded = (nd_first_deep == 1) & (nd_first_p == sp_)
    unc = torch.where(
        nd_unc | se_anystrip,
        torch.full_like(sp_, KEY_UNCERTAIN),
        torch.zeros_like(sp_),
    )
    se_key = torch.where(
        threaded,
        _key_int(1, rd=nd_first_rd),
        _key_int(2, gpre=nd_pre, rd=se_minrd) | unc,
    )
    return {
        "s": s,
        "node": {
            "t": nt, "d": nd_, "re": nre, "rs": nrs, "nid": nnid,
            "w": nw, "base": nbase, "anchor": nanch, "valid": nvalid_t,
            "lin": lin_trie, "par_lin": par_lin, "pre": pre_rank,
            "is_exit_parent": is_exit_parent,
        },
        "lin_bb_full": lin_bb_full,
        "n_total": n_total,
        "start_edges": {
            "p": sp_, "node_lin": sn_, "uniq": uniq, "count": se_count,
            "key": se_key,
        },
        "flags_partial": over_nd | over_v | _any(trie_span_over, -1),
    }


def assemble_band(linz, absb, trans, cov, matches, bb, Lr, caps: Caps):
    """The banded linear graph: win/wkey [B, V, W], exit and long-edge
    tables, per-node arrays [B, V], enter candidates and flags (see the
    JAX function for each field)."""
    B, V, W, L, SE, DQ = caps.B, caps.V, caps.W, caps.L, caps.SE, caps.DQ
    ND = caps.ND
    SM = caps.SM
    node = linz["node"]
    lin_bb_full = linz["lin_bb_full"]
    n_total = linz["n_total"]
    dev = lin_bb_full.device
    HLp = L + 2
    vb = _ar(V, dev)[None, :].expand(B, V)

    # ---- classify + field transport by one merged sort on lin ---------
    assert 3 * caps.R < (1 << 14) and L + 1 < (1 << 15)
    parange = _ar(HLp, dev)[None, :]
    p_valid = (parange >= 1) & (parange <= Lr[:, None])
    BIGK = 1 << 28
    bonus = absb["bonus"]
    w_bb_full = 1 + matches + bonus
    bbchar = torch.nn.functional.pad(bb.to(I32), (1, 1))
    ctor_p = trans["count_pq"][..., 0] + absb["died_cnt_pq"][..., 0] + bonus
    xcnt_p = torch.where(
        parange == Lr[:, None], trans["exit_cnt"] + bonus, trans["exit_cnt"]
    )
    xrd_p = torch.clamp(trans["exit_rkey"], 0, (1 << 14) - 1)
    nxt_lin_p = torch.clamp(
        torch.cat([lin_bb_full[:, 1:], lin_bb_full[:, L + 1 :]], dim=-1),
        0, (1 << 18) - 1,
    )
    # trie-node base: depth d - 1 base of the node's run-start chain.
    rb_dm = linz["s"]["rev_ba"] & 0xFF
    gbase = _gat(rb_dm, torch.clamp(node["rs"], 0, rb_dm.shape[2] - 1)[:, None, :], 2)
    d_ok = (node["d"] >= 1) & (node["d"] <= SM)
    node_base_tbl = torch.gather(
        gbase, 1, torch.clamp(node["d"] - 1, 0, SM - 1)[:, None, :].long()
    )[:, 0, :]
    node_base_tbl = torch.where(d_ok, node_base_tbl, torch.zeros_like(node_base_tbl))
    cov_anchor_nd = mxu_gather(
        cov, torch.clamp(node["anchor"], 0, L + 1), max_val=1 << 15
    )

    def pk(x, hi):
        return torch.clamp(x.to(I32), 0, hi)

    # p-space planes of the dq transitions (count | sel | read).
    c1_all = trans["count_pq"]
    c2_all = absb["died_cnt_pq"]
    sel_all = c1_all > 0
    rd_all = torch.where(
        sel_all,
        torch.clamp(trans["rkey_pq"], 0, (1 << 14) - 1),
        torch.clamp(absb["died_read"], 0, (1 << 14) - 1),
    )
    packed_all = (
        (torch.clamp(c1_all + c2_all, 0, (1 << 14) - 1) << 15)
        | (sel_all.to(I32) << 14)
        | rd_all
    )

    def lin_shift(dq):  # lin_bb_full at min(p + dq, L + 1)
        return torch.cat(
            [lin_bb_full[:, dq:], lin_bb_full[:, L + 1 :].expand(B, dq)], dim=-1
        )

    # SE start-edge slot tables in p-space: slot si of p's run of unique
    # (p, node) rows (short edges first) goes to rank si*(L+2) + p.
    se = linz["start_edges"]
    N = se["p"].shape[1]
    se_ulin = mxu_gather(
        lin_bb_full + 1, torch.clamp(se["p"], 0, L + 1), max_val=1 << 16
    ) - 1
    se_ulin = torch.where(se["p"] == 0, torch.full_like(se_ulin, -1), se_ulin)
    se_span = se["node_lin"] - se_ulin
    se_islong = se["uniq"] & (se["p"] >= 1) & (se_span > W)
    su16 = 2 * (L + 2) + 2 < 0xFFFF and N < 0xFFFF
    BIGU = 0xFFFF if su16 else (1 << 21)
    ukey = se["p"] * 2 + se_islong.to(I32)
    if su16:
        ukey = ukey & 0xFFFF
    ukey = torch.where(se["uniq"], ukey, torch.full_like(ukey, BIGU))
    # (ukey, position) keys: a stable sort on ukey alone.
    su_key, su_n, su_c, su_k = _sort((ukey, se["node_lin"], se["count"], se["key"]), 1)
    su_nc = (su_n << 14) | su_c
    posn2 = _ar(N, dev)[None, :].expand(B, N)
    run_st = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev),
         su_key[:, 1:] != su_key[:, :-1]],
        dim=-1,
    )
    si_of = posn2 - _seg_start_from_boundary(run_st)
    sl_ok = (su_key < BIGU) & (su_key % 2 == 0) & (su_key >= 2) & (si_of < SE)
    t_nc, t_k = mxu_scatter(
        si_of * HLp + torch.clamp(su_key // 2, 0, HLp - 1), sl_ok,
        (su_nc, su_k), SE * HLp, max_payload=1 << 31,
    )
    t_nc = t_nc.reshape(B, SE, HLp)
    t_k = t_k.reshape(B, SE, HLp)

    # Operands of the merged sort (a tag bit tells the row kinds apart):
    #   M1 = tag(1)<<24 | p(15)<<9 | isx(1)<<8 | base(8)
    #   M2 = weight<<15 | cov
    #   M3 = trie: par_lin ; bb: xcnt(14)<<14 | ctor(14)
    #   M4 = bb: nxt_lin(18)<<14 | xrd(14) ; trie: 0
    m1_t = (1 << 24) | (node["is_exit_parent"].to(I32) << 8) | pk(node_base_tbl, 0xFF)
    m1_b = (parange << 9) | bbchar
    m2_t = (pk(node["w"], 0x7FFF) << 15) | pk(cov_anchor_nd, 0x7FFF)
    m2_b = (pk(w_bb_full, 0x7FFF) << 15) | pk(cov, 0x7FFF)
    m3_t = pk(node["par_lin"], (1 << 28) - 1)
    m3_b = (pk(xcnt_p, (1 << 14) - 1) << 14) | pk(ctor_p, (1 << 14) - 1)
    m4_t = torch.zeros((B, ND), dtype=I32, device=dev)
    m4_b = (nxt_lin_p << 14) | xrd_p
    key_t = node["lin"]
    key_b = torch.where(p_valid, lin_bb_full, torch.full_like(lin_bb_full, BIGK))

    def cat(a, b, padval=0):
        x = torch.cat([a, b], dim=-1)
        if x.shape[1] < V:
            pad = torch.full((B, V - x.shape[1]), padval, dtype=I32, device=dev)
            x = torch.cat([x, pad], dim=-1)
        return x

    _sk, s1, s2, s3, s4 = _sort(
        (cat(key_t, key_b, padval=1 << 28), cat(m1_t, m1_b), cat(m2_t, m2_b),
         cat(m3_t, m3_b), cat(m4_t, m4_b)),
        1,
    )
    s1, s2, s3, s4 = s1[:, :V], s2[:, :V], s3[:, :V], s4[:, :V]

    in_range = vb < n_total[:, None]
    tag = (s1 >> 24) & 1
    is_trie = in_range & (tag == 1)
    is_bb = in_range & (tag == 0)
    pic = torch.where(is_bb, (s1 >> 9) & 0x7FFF, torch.zeros_like(s1))

    # p-space -> v-space transport of the band-class planes at pic.
    qlin_all = [lin_shift(dq) for dq in range(2, DQ + 1)]
    plane_in = (
        [(q, 3) for q in qlin_all]
        + [(packed_all[:, :, i], 4) for i in range(1, DQ)]
        + [(t_nc[:, si, :], 4) for si in range(SE)]
        + [(t_k[:, si, :], 4) for si in range(SE)]
    )
    pv = mxu_gather_planes(plane_in, pic)
    qlin_v_l = pv[: DQ - 1]
    pk_v_l = pv[DQ - 1 : 2 * (DQ - 1)]
    se_nc_l = pv[2 * (DQ - 1) : 2 * (DQ - 1) + SE]
    se_k_l = pv[2 * (DQ - 1) + SE :]

    # ---- per-node arrays ---------------------------------------------
    base = (s1 & 0xFF).to(torch.uint8)
    weight = s2 >> 15
    cov_lin = s2 & 0x7FFF
    bbpos = torch.where(is_bb, pic, torch.zeros_like(pic))
    unsup = is_bb & (weight == 1)

    # ---- band classes ------------------------------------------------
    # Each class writes lane span-1 of its rows; absent rows write the
    # spare lane W. Classes apply in the JAX build's order, so a later
    # class overwrites an earlier one as its select chain does.
    win = torch.full((B, V, W + 1), -1, dtype=torch.int16, device=dev)
    wkey = torch.zeros((B, V, W + 1), dtype=I32, device=dev)
    exit_cnt = torch.full((B, V), -1, dtype=I32, device=dev)
    exit_key = torch.zeros((B, V), dtype=I32, device=dev)
    flags = torch.zeros((B,), dtype=torch.bool, device=dev)

    def add_class(flags, present, span, count, key):
        ok = present & (span >= 1) & (span <= W) & in_range
        flags = flags | _any(present & (span > W) & in_range, -1)
        lane = torch.where(ok, span - 1, torch.full_like(span, W))[..., None].long()
        win.scatter_(2, lane, count.to(torch.int16)[..., None])
        wkey.scatter_(2, lane, key.expand(B, V)[..., None].to(I32))
        return flags

    zeros_v = torch.zeros_like(vb)
    t_par = s3
    t_isx = is_trie & (((s1 >> 8) & 1) == 1)
    flags = add_class(flags, is_trie & ~t_isx, t_par - vb, weight, zeros_v)
    exit_cnt = torch.where(t_isx, weight, exit_cnt)

    nxt_lin = s4 >> 14
    ctor_cnt = s3 & ((1 << 14) - 1)
    at_L = pic == Lr[:, None]
    flags = add_class(flags, is_bb & ~at_L, nxt_lin - vb, ctor_cnt, zeros_v)

    def _maxspan(present, span):
        return torch.amax(
            torch.where(present & in_range & (span >= 1), span, zeros_v), dim=-1
        )

    wneed = torch.maximum(
        _maxspan(is_trie & ~t_isx, t_par - vb),
        _maxspan(is_bb & ~at_L, nxt_lin - vb),
    )
    xcnt = (s3 >> 14) & ((1 << 14) - 1)
    xkey = _key_int(1, rd=s4 & ((1 << 14) - 1))
    exit_cnt = torch.where(is_bb & at_L, xcnt, exit_cnt)
    exit_cnt = torch.where(is_bb & ~at_L & (xcnt > 0), xcnt, exit_cnt)
    exit_key = torch.where(is_bb & ~at_L & (xcnt > 0), xkey, exit_key)

    # transitions dq = 2..DQ: short spans to the band, long ones to the
    # K-register file.
    pgrid = parange
    lk_u, lk_w, lk_cnt, lk_key, lk_long, lk_esc = [], [], [], [], [], []

    def tbl_shift(a, dq):  # a[:, min(p + dq, L + 1)]
        return torch.cat([a[:, dq:], a[:, L + 1 :].expand(B, dq)], dim=-1)

    def esc_of(cnt, uns, cq):
        return torch.where(
            uns,
            torch.full(cnt.shape, -10.0, dtype=torch.float32, device=dev),
            cnt.to(torch.float32) - 0.5 * cq.to(torch.float32),
        )

    def bb_esc(cnt, q):
        qq = torch.clamp(q, 0, L + 1)
        return esc_of(cnt, _gat(w_bb_full, qq) == 1, _gat(cov, qq))

    for dq in range(2, DQ + 1):
        qlin = qlin_v_l[dq - 2]
        pkv = pk_v_l[dq - 2]
        c12 = pkv >> 15
        rd = pkv & ((1 << 14) - 1)
        key = torch.where(
            ((pkv >> 14) & 1) == 1,
            _key_int(1, rd=rd),
            _key_int(2, rd=rd) | KEY_UNCERTAIN,
        )
        ok = is_bb & (pic + dq <= Lr[:, None]) & (c12 > 0)
        span = qlin - vb
        flags = add_class(flags, ok & (span <= W), span, c12, key)
        qlin_p = qlin_all[dq - 2]
        c1p = trans["count_pq"][..., dq - 1]
        c2p = absb["died_cnt_pq"][..., dq - 1]
        okp = (pgrid >= 1) & (pgrid + dq <= Lr[:, None]) & ((c1p + c2p) > 0)
        k1p = _key_int(1, rd=torch.clamp(trans["rkey_pq"][..., dq - 1], 0, (1 << 14) - 1))
        k2p = _key_int(
            2, rd=torch.clamp(absb["died_read"][..., dq - 1], 0, (1 << 14) - 1)
        ) | KEY_UNCERTAIN
        lk_u.append(lin_bb_full)
        lk_w.append(qlin_p)
        lk_cnt.append(torch.where(okp, c1p + c2p, torch.zeros_like(c1p)))
        lk_key.append(torch.where(c1p > 0, k1p, k2p))
        lk_long.append(okp & ((qlin_p - lin_bb_full) > W))
        lk_esc.append(
            esc_of(c1p + c2p, tbl_shift(w_bb_full, dq) == 1, tbl_shift(cov, dq))
        )

    # died strips with dd > DQ are always long-edge candidates.
    dl = absb["died_long"]
    dl_ok = dl["p"] >= 0
    lk_u.append(_gat(lin_bb_full, torch.clamp(dl["p"], 0, L + 1)))
    lk_w.append(_gat(lin_bb_full, torch.clamp(dl["q"], 0, L + 1)))
    lk_cnt.append(torch.where(dl_ok, dl["cnt"], torch.zeros_like(dl["cnt"])))
    lk_key.append(
        _key_int(2, rd=torch.clamp(dl["rd"], 0, (1 << 14) - 1)) | KEY_UNCERTAIN
    )
    lk_long.append(dl_ok)
    lk_esc.append(bb_esc(dl["cnt"], dl["q"]))

    # start edges: the per-slot (node | cnt, key) planes.
    p_real = (parange >= 1) & (parange <= Lr[:, None])
    h_se = mxu_hist(se["p"] * 2 + se_islong.to(I32), se["uniq"], 2 * HLp)
    flags = flags | _any(p_real & (h_se[:, 0::2] > SE), -1)
    for si in range(SE):
        nc = se_nc_l[si]
        flags = add_class(
            flags, is_bb & (nc != 0), (nc >> 14) - vb, nc & ((1 << 14) - 1),
            se_k_l[si],
        )
    # long start edges -> K candidates; esc from the target trie node's
    # coverage(anchor).
    anch_lin = mxu_scatter(node["lin"], node["valid"], (node["anchor"],), V)[0]
    se_anch = torch.where(
        se_islong,
        mxu_gather(anch_lin, torch.clamp(se["node_lin"], 0, V - 1), max_val=1 << 15),
        torch.zeros_like(se_islong, dtype=I32),
    )
    se_cov = _gat(cov, torch.clamp(se_anch, 0, L + 1))
    lk_u.append(torch.where(se_islong, se_ulin, torch.full_like(se_ulin, -1)))
    lk_w.append(se["node_lin"])
    lk_cnt.append(torch.where(se_islong, se["count"], torch.zeros_like(se["count"])))
    lk_key.append(se["key"])
    lk_long.append(se_islong)
    lk_esc.append(se["count"].to(torch.float32) - 0.5 * se_cov.to(torch.float32))

    # compact the long candidates to K slots per target (known ranks).
    K = caps.K
    cu = torch.cat(lk_u, dim=-1)
    cw = torch.cat(lk_w, dim=-1)
    cc = torch.cat(lk_cnt, dim=-1)
    ck = torch.cat(lk_key, dim=-1)
    ce = torch.cat(lk_esc, dim=-1)
    cl = torch.cat(lk_long, dim=-1) & (cc > 0)
    NLC = cu.shape[1]
    lrank = _cs(cl) - 1
    sp_k = mxu_scatter(
        lrank, cl, (_ar(NLC, dev)[None, :].expand(B, NLC),), K,
        max_payload=1 << 24,
    )[0]
    n_long = _sum(cl)
    flags = flags | (n_long > K)
    spk = torch.clamp(sp_k, 0, NLC - 1)
    k_live = _ar(K, dev)[None, :] < torch.clamp(n_long, max=K)[:, None]
    long_u = torch.where(k_live, _gat(cu, spk), torch.full_like(spk, -1))
    long_w = torch.where(k_live, _gat(cw, spk), torch.full_like(spk, -1))
    long_cnt = torch.where(k_live, _gat(cc, spk), torch.zeros_like(spk))
    long_key = torch.where(k_live, _gat(ck, spk), torch.zeros_like(spk))
    long_esc = torch.where(
        k_live, _gat(ce, spk),
        torch.full(spk.shape, _F32_MIN, dtype=torch.float32, device=dev),
    )

    # ---- enter tables ------------------------------------------------
    q = parange
    nt_col = n_total[:, None].expand(B, HLp)
    e_tgt_bb = torch.where(q <= Lr[:, None], lin_bb_full, nt_col)
    e_tgt_bb = torch.where(q == Lr[:, None] + 1, nt_col, e_tgt_bb)
    e_cnt = trans["enter_cnt"]
    e_key = _key_int(1, rd=torch.clamp(trans["enter_rkey"], 0, (1 << 14) - 1))
    e_present = (e_cnt > 0) | (q == 1)
    e_present = e_present & (q >= 1) & (q <= Lr[:, None] + 1)
    e_key = torch.where(q == 1, torch.zeros_like(e_key), e_key)
    # enter start edges: the p == 0 rows lead the sorted table.
    hi0 = h_se[:, 0]
    flags = flags | (hi0 > SE)
    jj = torch.clamp(_ar(SE, dev), 0, N - 1)[None, :].expand(B, SE)
    es_ok = _ar(SE, dev)[None, :] < hi0[:, None]
    enter = {
        "tgt": torch.cat([e_tgt_bb, _gat(su_n, jj)], dim=-1),
        "cnt": torch.cat([e_cnt, _gat(su_c, jj)], dim=-1),
        "key": torch.cat([e_key, _gat(su_k, jj)], dim=-1),
        "present": torch.cat([e_present, es_ok], dim=-1),
    }

    zero_v = torch.zeros_like(cov_lin)
    return {
        "win": win[..., :W].contiguous(),
        "wkey": wkey[..., :W].contiguous(),
        "exit_cnt": exit_cnt,
        "exit_key": exit_key,
        "long_u": long_u,
        "long_w": long_w,
        "long_cnt": long_cnt,
        "long_key": long_key,
        "long_esc": long_esc,
        "cov": torch.where(in_range, cov_lin, zero_v),
        "unsup": unsup & in_range,
        "weight": torch.where(in_range, weight, zero_v),
        "base": torch.where(in_range, base, torch.zeros_like(base)),
        "bbpos": torch.where(in_range, bbpos, zero_v),
        "n": n_total,
        "enter": enter,
        "flags": flags,
        "wneed": wneed,
        "nlong": n_long,
    }


def device_build(ops, starts, bb, ins_base, Lr, caps: Caps):
    """Full device graph build: encoded reads -> banded linear graph.

    ops [B, R, C] uint8, starts [B, R] int32, bb [B, L] uint8, ins_base
    [B, NI] uint8, Lr [B] int32, all on one device. Returns the
    `assemble_band` dict plus the per-target fallback flags and their
    parts (`flag_detail`)."""
    dec = decode_columns(ops, starts, caps)
    cov, matches = coverage_and_matches(ops, starts, dec, caps)
    mtab = matched_positions(ops, dec, starts, Lr, caps)
    chains = extract_chains(ops, starts, ins_base, dec, mtab[0], Lr, caps)
    trans = transitions_table(dec, mtab, chains, starts, Lr, caps)
    absb = apply_absorption(chains, trans, bb, Lr, caps)
    fc = {
        "valid": absb["valid"].reshape(caps.B, -1),
        "p": absb["p"],
        "t": absb["t"],
        "len": absb["len"],
        "rev_ba": absb["rev_ba"],
        "read": absb["read"],
        "phase": absb["phase"],
        "seq": absb["seq"],
    }
    tri = build_tries(fc, Lr, caps)
    linz = linearize_and_band(tri, fc, absb, trans, cov, matches, bb, Lr, caps)
    out = assemble_band(linz, absb, trans, cov, matches, bb, Lr, caps)
    rbv = fc["rev_ba"] & 0xFF
    sentinel = _any(
        fc["valid"] & (_any(rbv == 94, 1) | _any(rbv == 36, 1)), -1
    )
    out["flag_detail"] = {
        "band": out["flags"],
        "caps": linz["flags_partial"],
        "cascade": absb["cascade"],
        "over_dd": absb["over_dd"],
        "over_dq": trans["over_dq"],
        "chain_len": chains["overflow_any"],
        "sentinel": sentinel,
    }
    out["flags"] = (
        out["flags"]
        | linz["flags_partial"]
        | absb["cascade"]
        | absb["over_dd"]
        | trans["over_dq"]
        | chains["overflow_any"]
        | sentinel
    )
    return out


def unpack_ops(opsp):
    """Unpack a 2-bit-packed ops stream [B, R, C//4] uint8 -> [B, R, C]
    uint8 (byte k holds columns 4k..4k+3, column 4k in bits 0-1: the
    wire format of `dagcon_enc_fill_packed`)."""
    shifts = torch.arange(4, dtype=torch.uint8, device=opsp.device) * 2
    u = (opsp[..., None] >> shifts) & 3
    return u.reshape(opsp.shape[0], opsp.shape[1], -1)


def device_build_packed(opsp, starts, bb, ins_base, Lr, caps: Caps):
    """device_build over a 2-bit-packed ops stream (see unpack_ops)."""
    return device_build(unpack_ops(opsp), starts, bb, ins_base, Lr, caps)
