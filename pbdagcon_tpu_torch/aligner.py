"""Pairwise re-aligner: banded global DP (SimpleAligner equivalent).

Python spec implementation of SPEC.md §1.5 — the reference's
`SimpleAligner::align` wraps blasr_libcpp's guided aligner
(`src/cpp/SimpleAligner.cpp`, SURVEY.md §2 C8; reconstructed, mount
empty). Used by the `-a` path (unaligned 'pre' pairs) and the
dazcon-equivalent frontend. The C++ engine implements the identical
integer DP; `ops/align_tpu.py` is the batched device version.

The port's copy of `pbdagcon_tpu/aligner.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import numpy as np

from pbdagcon_tpu_torch.alignment import Alignment

MATCH = 1
MISMATCH = -2
GAP = -3
NEG = -(1 << 30)


def band_halfwidth(m: int, n: int) -> int:
    return max(64, abs(m - n) + 32)


def align_pair(
    q: str,
    t: str,
    guide: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
) -> tuple[str, str]:
    """Banded global alignment of query `q` vs target `t` (SPEC §1.5).

    Returns gapped (qstr, tstr). Deterministic tie-break:
    diagonal > up (gap in t) > left (gap in q), chosen at traceback.

    `guide` — optional trace-guided banding (the reference seeds its
    aligner with overlap trace points, `src/cpp/SimpleAligner.cpp` +
    `align.c`, SURVEY.md §2 C8/C9): `(q_ck, t_ck, w_seg)` checkpoint
    arrays with q_ck[0] == 0, q_ck[-1] == len(q), t_ck matching target
    positions, and per-segment band halfwidths (sized from the
    segment's trace diff count). The band then follows the piecewise-
    linear checkpoint path instead of the straight diagonal — O(sum
    w_k * seg_len) work instead of O(band * m) with the global
    length-difference band, a large cut on long reads.
    """
    m, n = len(q), len(t)
    if m == 0:
        return "-" * n, t
    if n == 0:
        return q, "-" * m
    qb = np.frombuffer(q.encode(), dtype=np.uint8)
    tb = np.frombuffer(t.encode(), dtype=np.uint8)

    rows = np.arange(1, m + 1)
    if guide is None:
        centers = (rows * n) // m
        bws = np.full(m, band_halfwidth(m, n), dtype=np.int64)
    else:
        q_ck, t_ck, w_seg = guide
        centers = np.interp(rows, q_ck, t_ck).astype(np.int64)
        seg = np.clip(
            np.searchsorted(q_ck, rows, side="right") - 1,
            0, len(w_seg) - 1,
        )
        bws = w_seg[seg].astype(np.int64)

    H = np.full((m + 1, n + 1), NEG, dtype=np.int32)
    H[0, : n + 1] = np.arange(n + 1, dtype=np.int32) * GAP
    H[: m + 1, 0] = np.arange(m + 1, dtype=np.int32) * GAP
    # Row-vectorized banded fill.
    for i in range(1, m + 1):
        center = int(centers[i - 1])
        bw = int(bws[i - 1])
        lo = max(1, center - bw)
        hi = min(n, center + bw)
        if lo > hi:
            continue
        sub = np.where(qb[i - 1] == tb[lo - 1 : hi], MATCH, MISMATCH)
        diag = H[i - 1, lo - 1 : hi] + sub
        up = H[i - 1, lo : hi + 1] + GAP
        best = np.maximum(diag, up)
        # Left dependency is sequential within the row.
        row = H[i]
        prev = row[lo - 1]
        out = np.empty(hi - lo + 1, dtype=np.int32)
        for j in range(hi - lo + 1):
            v = best[j]
            left = prev + GAP
            if left > v:
                v = left
            out[j] = v
            prev = v
        row[lo : hi + 1] = out

    # Traceback with the normative tie-break.
    qs = bytearray()
    ts = bytearray()
    i, j = m, n
    while i > 0 or j > 0:
        h = H[i, j]
        if i > 0 and j > 0 and h == H[i - 1, j - 1] + (
            MATCH if qb[i - 1] == tb[j - 1] else MISMATCH
        ):
            qs.append(qb[i - 1])
            ts.append(tb[j - 1])
            i -= 1
            j -= 1
        elif i > 0 and h == H[i - 1, j] + GAP:
            qs.append(qb[i - 1])
            ts.append(ord("-"))
            i -= 1
        else:
            qs.append(ord("-"))
            ts.append(tb[j - 1])
            j -= 1
    return qs[::-1].decode(), ts[::-1].decode()


def align_pair_affine(
    q: str,
    t: str,
    params: tuple[int, int, int, int] = (1, -2, -4, -1),
) -> tuple[str, str]:
    """Affine-gap banded Gotoh alignment (SPEC §1.6) — the alternate
    scorer for the -a path. The reference wraps blasr_libcpp's guided
    affine aligner (`src/cpp/SimpleAligner.cpp`, SURVEY.md §2 C8;
    parameters unreadable, mount empty); this scorer exposes an affine
    option and drives the consensus-sensitivity experiment
    (docs/SCORER_SENSITIVITY.md). Exact mirror of the C++
    `align_pair_affine`.

    `params` = (match, mismatch, open, extend); a gap of length k
    scores open + (k-1)*extend, with open <= extend <= 0. Tie-breaks:
    in H, diag > up (gap in t) > left (gap in q); in a gap state,
    close (reopen from H) > extend.
    """
    M, X, O, E = (int(x) for x in params)
    m, n = len(q), len(t)
    if m == 0:
        return "-" * n, t
    if n == 0:
        return q, "-" * m
    qb = np.frombuffer(q.encode(), dtype=np.uint8)
    tb = np.frombuffer(t.encode(), dtype=np.uint8)
    bw = band_halfwidth(m, n)

    def border(k: int) -> int:
        return O + (k - 1) * E

    H = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    U = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    Lf = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    H[0, 0] = 0
    H[0, 1:] = Lf[0, 1:] = O + np.arange(n, dtype=np.int64) * E
    H[1:, 0] = U[1:, 0] = O + np.arange(m, dtype=np.int64) * E
    for i in range(1, m + 1):
        center = i * n // m
        lo = max(1, center - bw)
        hi = min(n, center + bw)
        if lo > hi:
            continue
        sub = np.where(qb[i - 1] == tb[lo - 1 : hi], M, X)
        # Vertical gap state: no within-row dependency.
        up_h = H[i - 1, lo : hi + 1]
        up_u = U[i - 1, lo : hi + 1]
        u = np.maximum(
            np.where(up_h == NEG, NEG, up_h + O),
            np.where(up_u == NEG, NEG, up_u + E),
        )
        diag = H[i - 1, lo - 1 : hi]
        cand = np.maximum(np.where(diag == NEG, NEG, diag + sub), u)
        U[i, lo : hi + 1] = u
        # Horizontal gap state: sequential within the row.
        left_h = H[i, lo - 1]
        left_l = Lf[i, lo - 1]
        hrow = H[i]
        lrow = Lf[i]
        for j in range(lo, hi + 1):
            lf = max(
                NEG if left_h == NEG else left_h + O,
                NEG if left_l == NEG else left_l + E,
            )
            v = max(cand[j - lo], lf)
            hrow[j] = v
            lrow[j] = lf
            left_h = v
            left_l = lf

    # State-machine traceback with the normative tie-break.
    qs = bytearray()
    ts = bytearray()
    i, j = m, n
    state = 0  # 0=H, 1=U (gap in t), 2=L (gap in q)
    while i > 0 or j > 0:
        if state == 0:
            hv = H[i, j]
            if i > 0 and j > 0 and hv == H[i - 1, j - 1] + (
                M if qb[i - 1] == tb[j - 1] else X
            ):
                qs.append(qb[i - 1])
                ts.append(tb[j - 1])
                i -= 1
                j -= 1
            elif i > 0 and hv == U[i, j]:
                state = 1
            else:
                state = 2
        elif state == 1:
            uv = U[i, j]
            qs.append(qb[i - 1])
            ts.append(ord("-"))
            if H[i - 1, j] != NEG and uv == H[i - 1, j] + O:
                state = 0
            i -= 1
        else:
            lv = Lf[i, j]
            qs.append(ord("-"))
            ts.append(tb[j - 1])
            if H[i, j - 1] != NEG and lv == H[i, j - 1] + O:
                state = 0
            j -= 1
    return qs[::-1].decode(), ts[::-1].decode()


def align_record(
    aln: Alignment,
    scorer: str = "simple",
    affine_params: tuple[int, int, int, int] = (1, -2, -4, -1),
) -> Alignment:
    """Fill gapped strings for a record carrying raw (ungapped) q/t
    sequences — the reference's `dagcon -a` semantics on 'pre' input."""
    if scorer == "affine":
        qstr, tstr = align_pair_affine(aln.qstr, aln.tstr, affine_params)
    else:
        qstr, tstr = align_pair(aln.qstr, aln.tstr)
    out = Alignment(
        id=aln.id, sid=aln.sid, tlen=aln.tlen, start=aln.start,
        qstr=qstr, tstr=tstr,
    )
    return out.recompute_end()
