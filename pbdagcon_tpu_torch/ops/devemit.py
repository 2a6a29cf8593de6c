"""Device backtrack and path emission for the device-built graph (port of
`pbdagcon_tpu/ops/devemit.py`).

The banded linear graph from `ops/devbuild_torch.py` feeds the DP
(`ops/dp.py::dp_scores`); `backtrack_emit` then picks every node's best
successor at once, with the reference's first-strict-max tie-break
through the 32-bit creation keys (equal scores pick the minimum key; a
tie involving a KEY_UNCERTAIN edge flags the target for the host), and
walks the path by pointer doubling. It emits per-step (base, kept,
backbone position) in fixed-shape arrays; the host assembles the FASTA
fragments (`assemble_fragments`, the semantics of
`ops/linearize.py::consensus_from_path`, SPEC §2.7; `assemble_batch`,
the same for a whole batch with array operations, is what the pipeline
calls).

Against the JAX form: the band's shifted score/cov/unsup windows are
`Tensor.unfold` views (no convolution, so no TF32 can touch a score;
the convolution's NaN on a window with an infinite score is reproduced),
and every gather is a `torch.gather` at an index clipped first (the JAX
form's CPU branches; its TPU branch clips the long-edge target to
0x7FFF, a known fault that is not carried over).
"""

from __future__ import annotations

import numpy as np
import torch

from pbdagcon_tpu_torch.ops.devbuild import KEY_MASK, KEY_UNCERTAIN
from pbdagcon_tpu_torch.oracle.graph import CnsResult

I32 = torch.int32
NEG_INF = float(np.finfo(np.float32).min)
_PENALTY = -10.0


def _pick(tot, keys, valid):
    """First-strict-max with key tie-break over the last axis: (argmax
    index, best score, uncertain-tie flag)."""
    tot = torch.where(valid, tot, torch.full_like(tot, NEG_INF))
    best = torch.amax(tot, dim=-1)
    is_max = valid & (tot == best[..., None]) & (best[..., None] > NEG_INF)
    n_max = torch.sum(is_max, dim=-1, dtype=I32)
    masked_key = torch.where(is_max, keys & KEY_MASK, torch.full_like(keys, 1 << 30))
    kmin = torch.amin(masked_key, dim=-1)
    sel = is_max & (masked_key == kmin[..., None])
    idx = torch.argmax(sel.to(torch.uint8), dim=-1)
    unc = (n_max > 1) & torch.any(is_max & ((keys & KEY_UNCERTAIN) != 0), dim=-1)
    return idx, best, unc


def _windows(x: torch.Tensor, V: int, W: int) -> torch.Tensor:
    """shifted[b, w, v] = x[b, v + 1 + w] for x [B, V + W + 1]."""
    return x[:, 1:].unfold(1, W, 1)[:, :V, :].transpose(1, 2)


def backtrack_emit(build, scores, min_weight, P: int):
    """Best path of every target from its scores: per-node best
    successors over the band, exit and long-edge candidates, the enter
    pick, then the path by pointer doubling (two-level walk). Returns
    bases/kept/bbpos [B, P], path_len [B] and the ambiguous/overflow
    flags [B]."""
    win = build["win"]
    B, V, W = win.shape
    K = build["long_u"].shape[1]
    dev = win.device
    n = build["n"]
    cov = build["cov"].to(torch.float32)
    unsup = build["unsup"]
    weight = build["weight"]
    vidx = torch.arange(V, dtype=I32, device=dev)[None, :]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    sc = torch.where(vidx < n[:, None], scores, neg)
    sc_ext = torch.cat(
        [sc, torch.full((B, W + 1), NEG_INF, dtype=torch.float32, device=dev)], -1
    )
    uns_ext = torch.cat(
        [unsup, torch.zeros((B, W + 1), dtype=torch.bool, device=dev)], -1
    )
    cov_ext = torch.cat(
        [cov, torch.zeros((B, W + 1), dtype=torch.float32, device=dev)], -1
    )
    sh_sc = _windows(sc_ext, V, W)
    # The JAX form extracts the windows with an identity-filter
    # convolution, so a window holding an infinite score (0 * inf) reads
    # NaN across the window and its node picks the exit. Only flagged
    # targets (their paths are discarded) have infinite scores below n;
    # the same NaNs keep their emitted arrays equal to the JAX form's.
    inf_win = _windows(torch.isinf(sc_ext), V, W).any(dim=1, keepdim=True)
    sh_sc = torch.where(inf_win, torch.full((), float("nan"), device=dev), sh_sc)
    sh_uns = _windows(uns_ext, V, W)
    sh_cov = _windows(cov_ext, V, W)
    winT = win.transpose(1, 2)
    wkeyT = build["wkey"].transpose(1, 2)
    esc_band = torch.where(
        sh_uns, torch.full((), _PENALTY, device=dev),
        winT.to(torch.float32) - 0.5 * sh_cov,
    )
    tot_band = torch.where(winT >= 0, esc_band + sh_sc, neg)

    x_cnt = build["exit_cnt"]
    tot_exit = torch.where(x_cnt >= 0, x_cnt.to(torch.float32), neg)
    l_u = build["long_u"]
    l_w = build["long_w"]
    sc1 = torch.cat([sc, torch.zeros((B, 1), dtype=torch.float32, device=dev)], -1)
    l_idx = torch.clamp(torch.where(l_w == n[:, None], V, l_w), 0, V)
    l_tot = build["long_esc"] + torch.gather(sc1, 1, l_idx.long())
    l_tot = torch.where(l_u >= 0, l_tot, neg)
    tot_long = torch.where(
        l_u[:, :, None] == vidx[:, None, :], l_tot[:, :, None], neg
    )

    # argpick over the (W + 1 + K) candidates of every node.
    cand_tot = torch.cat([tot_band, tot_exit[:, None, :], tot_long], dim=1)
    cand_key = torch.cat(
        [
            wkeyT,
            build["exit_key"][:, None, :],
            build["long_key"][:, :, None].expand(B, K, V),
        ],
        dim=1,
    )
    best = torch.amax(cand_tot, dim=1)
    is_max = (cand_tot == best[:, None, :]) & (best[:, None, :] > NEG_INF)
    kmask = torch.where(is_max, cand_key & KEY_MASK, torch.full_like(cand_key, 1 << 30))
    kmin = torch.amin(kmask, dim=1)
    n_max = torch.sum(is_max, dim=1, dtype=I32)
    node_unc = (n_max > 1) & torch.any(
        is_max & ((cand_key & KEY_UNCERTAIN) != 0), dim=1
    )
    sel = is_max & (kmask == kmin[:, None, :])
    j = torch.argmax(sel.to(torch.uint8), dim=1).to(I32)
    is_band = j < W
    is_exit = j == W
    lw_sel = torch.gather(l_w, 1, torch.clamp(j - W - 1, 0, K - 1).long())
    ncol = n[:, None].expand(B, V)
    best_next = torch.where(
        is_band,
        vidx + 1 + j,
        torch.where(is_exit, ncol, torch.where(lw_sel == ncol, ncol, lw_sel)),
    )
    nxt = torch.where(best > NEG_INF, best_next, ncol)

    # ---- enter pick ---------------------------------------------------
    ent = build["enter"]
    e_tgt = ent["tgt"]
    e_is_exit = e_tgt == n[:, None]
    e_sc = torch.where(
        e_is_exit, torch.zeros((), device=dev),
        torch.gather(sc1, 1, torch.clamp(e_tgt, 0, V).long()),
    )
    tc = torch.clamp(e_tgt, 0, V - 1).long()
    e_unsup = torch.gather(unsup, 1, tc)
    e_cov = torch.gather(cov, 1, tc)
    e_cnt = ent["cnt"].to(torch.float32)
    e_esc = torch.where(
        e_unsup, torch.full((), _PENALTY, device=dev), e_cnt - 0.5 * e_cov
    )
    e_esc = torch.where(e_is_exit, e_cnt, e_esc)
    e_tot = torch.where(ent["present"], e_esc + e_sc, neg)
    e_idx, _e_best, e_unc0 = _pick(e_tot, ent["key"], ent["present"])
    u0 = torch.gather(e_tgt, 1, e_idx[:, None])[:, 0]
    u0 = torch.where(torch.any(ent["present"], dim=-1), u0, n)

    # ---- pointer-jumping path extraction ------------------------------
    nxt_ext = torch.cat([nxt, n[:, None]], dim=-1)  # index V = exit
    unc_ext = torch.cat(
        [node_unc, torch.zeros((B, 1), dtype=torch.bool, device=dev)], -1
    )

    def ext_gather(tbl, idx):
        """Exit-absorbing gather: indices at or past n read slot V."""
        ic = torch.clamp(torch.where(idx >= n[:, None], V, idx), 0, V)
        return torch.gather(tbl, 1, ic.long())

    # Doubling tables up to 2^(LVL-1) steps, a chain of block starts,
    # then an in-block fill (the JAX form's two-level walk).
    nbits = max(1, (P - 1).bit_length())
    LVL = min(nbits, 6)
    jumps = [nxt_ext]
    for _ in range(LVL - 1):
        jt = jumps[-1]
        jumps.append(torch.cat([ext_gather(jt, jt[:, :V]), n[:, None]], dim=-1))
    BLK = 1 << LVL
    NB = -(-P // BLK)
    half = jumps[-1]
    starts = [u0]
    curs = u0
    for _ in range(NB - 1):
        curs = ext_gather(half, ext_gather(half, curs[:, None]))[:, 0]
        starts.append(curs)
    sgrid = torch.stack(starts, dim=1)
    cur = torch.repeat_interleave(sgrid, BLK, dim=1)[:, :P]
    ridx = (torch.arange(P, dtype=I32, device=dev) % BLK)[None, :]
    for k in range(LVL):
        stepped = ext_gather(jumps[k], cur)
        cur = torch.where(((ridx >> k) & 1) == 1, stepped, cur)
    path = cur
    valid = path < n[:, None]
    path_len = torch.sum(valid, dim=-1, dtype=I32)
    amb = e_unc0 | torch.any(ext_gather(unc_ext, path) & valid, dim=-1)
    last = path[:, -1]
    last_next = ext_gather(nxt_ext, last[:, None])[:, 0]
    overflow = (last < n) & (last_next < n)

    # ---- emission gathers ---------------------------------------------
    pclip = torch.clamp(path, 0, V - 1).long()
    zero = torch.zeros_like(path)
    bases = torch.where(
        valid, torch.gather(build["base"].to(I32), 1, pclip), zero
    ).to(torch.uint8)
    kept = valid & (torch.gather(weight, 1, pclip) >= min_weight)
    bpos = torch.where(valid, torch.gather(build["bbpos"], 1, pclip), zero)
    return {
        "bases": bases,
        "kept": kept,
        "bbpos": bpos.to(I32),
        "path_len": path_len,
        "ambiguous": amb,
        "overflow": overflow,
    }


def assemble_fragments(
    bases: np.ndarray,
    kept: np.ndarray,
    bbpos: np.ndarray,
    path_len: int,
    min_length: int,
) -> list[CnsResult]:
    """Host-side fragment assembly from one target's emitted path
    (consensus_from_path semantics, SPEC §2.7)."""
    results: list[CnsResult] = []
    bb_pos = 0
    kept_end = 0
    range_start = 0
    frag = bytearray()

    def close() -> None:
        nonlocal frag
        if len(frag) >= min_length and len(frag) > 0:
            results.append(CnsResult((range_start, kept_end), frag.decode()))
        frag = bytearray()

    for i in range(path_len):
        is_bb = bbpos[i] != 0
        if is_bb:
            bb_pos = int(bbpos[i])
        if kept[i]:
            if not frag:
                range_start = bb_pos - 1 if is_bb else bb_pos
            frag.append(int(bases[i]))
            kept_end = bb_pos
        else:
            close()
    close()
    return results


def assemble_batch(
    bases: np.ndarray,
    kept: np.ndarray,
    bbpos: np.ndarray,
    path_len: np.ndarray,
    min_length: int,
) -> list[list[CnsResult]]:
    """`assemble_fragments` of every row of a batch ([N, P] arrays,
    path_len [N]) at once: the backbone position's forward fill, the
    runs of kept steps and their ranges are array operations over the
    whole batch; Python touches each kept fragment once (its slice of
    the bases)."""
    path_len = np.asarray(path_len)
    N, P = kept.shape
    P = min(P, int(path_len.max(initial=0)))  # no step past a path counts
    bases, kept, bbpos = bases[:, :P], kept[:, :P], bbpos[:, :P]
    steps = np.arange(P, dtype=np.int32)
    live = kept & (steps[None, :] < path_len[:, None])
    on_bb = bbpos != 0
    # The last backbone step at or before each step (-1: none yet).
    last_bb = np.maximum.accumulate(np.where(on_bb, steps, -1), axis=1)
    edge = np.diff(live.view(np.int8), axis=1, prepend=0, append=0)
    rows, start = np.nonzero(edge == 1)
    _, end = np.nonzero(edge == -1)  # exclusive; row-major, so paired
    ok = end - start >= max(min_length, 1)
    rows, start, end = rows[ok], start[ok], end[ok]

    def bb_pos(i):  # bb_pos at step i of each fragment's row
        at = last_bb[rows, i]
        return np.where(at >= 0, bbpos[rows, np.maximum(at, 0)], 0)

    lo = bb_pos(start) - on_bb[rows, start]
    hi = bb_pos(end - 1)
    flat = np.ascontiguousarray(bases, dtype=np.uint8).tobytes()
    base0 = rows * P
    out: list[list[CnsResult]] = [[] for _ in range(N)]
    for r, a, b, s, e in zip(
        rows.tolist(), (base0 + start).tolist(), (base0 + end).tolist(),
        lo.tolist(), hi.tolist(),
    ):
        out[r].append(CnsResult((s, e), flat[a:b].decode()))
    return out
