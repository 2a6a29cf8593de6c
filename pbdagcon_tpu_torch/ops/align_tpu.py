"""Batched pairwise alignment on the device (port of
`pbdagcon_tpu/ops/align_tpu.py`, the SimpleAligner of the `-a` device
path and of dazcon).

`align_batch(pairs, device)` is byte-equal to `aligner.align_pair` for
every pair. The host prepares the padded batch exactly as the reference
does (M to 256s, dmin to 64s, Wa to 128s, B on the 32...2048 ladder), the
device runs the row scan (`align_scan`: 2-bit traceback pointers) and the
pointer walk (`traceback`: one move per step), and the host replays the
moves into gapped strings, vectorised over the batch.

The formulation is the reference's: lane k of row i holds column
j = i + dmin + k, so the diagonal predecessor is the same lane of the
previous row and the up predecessor lane k + 1; the in-row left chain
`H[i][j] = max(cand[j], H[i][j-1] - 3)` is a running max of
`cand + 3 * lane` minus `3 * lane` (integer, exact); lanes outside a
pair's band are masked to NEG each row; pointers take the priority
diag > up > left.

On a CUDA tensor `align_scan` and `traceback` launch kernel X1
(`csrc/align_scan.cu`, through `ops/align_cuda.py`) or raise; on a CPU
tensor they run the plain PyTorch versions `align_scan_plain` (a row
loop with `torch.cummax`) and `traceback_plain`, which the tests hold
against the reference's XLA programs.

The band centre `c = i * n // m` is formed in 64 bits (`band_centre`),
as `align_pair` forms it; the reference's device scan forms it in int32
and wraps once `i * n >= 2**31` (both lengths near 46 kb).
"""

from __future__ import annotations

import numpy as np
import torch

from pbdagcon_tpu_torch.aligner import GAP, MATCH, MISMATCH, band_halfwidth
from pbdagcon_tpu_torch.config import resolve_device

NEG = -(1 << 30)
# Pairs per dispatch are padded to this ladder (the reference's), so
# batches of similar size share one shape.
B_LADDER = (32, 64, 128, 256, 512, 1024, 2048)


def band_centre(i, n, m):
    """The band centre `(i * n) // m` of row i (0 where m == 0), in 64
    bits: `align_pair`'s rule. Takes ints, numpy arrays or tensors."""
    if isinstance(i, torch.Tensor) or isinstance(n, torch.Tensor):
        i64 = torch.as_tensor(i).long()
        n64 = torch.as_tensor(n).long()
        m64 = torch.as_tensor(m).long()
        return torch.where(
            m64 > 0, (i64 * n64) // torch.clamp(m64, min=1),
            torch.zeros_like(i64 * n64),
        )
    i64, n64, m64 = (np.asarray(x, dtype=np.int64) for x in (i, n, m))
    return np.where(m64 > 0, (i64 * n64) // np.maximum(m64, 1), 0)


def align_scan_plain(
    qb: torch.Tensor,  # [B, M] uint8 query bytes (0 pad)
    tb_pad: torch.Tensor,  # [B, T] uint8: t[x] at x + 1 - dmin, 0 pad
    m: torch.Tensor,  # [B] int32 true query lengths
    n: torch.Tensor,  # [B] int32 true target lengths
    bw: torch.Tensor,  # [B] int32 band half-widths
    M: int,
    Wa: int,
    dmin: int,
) -> torch.Tensor:
    """Packed 2-bit pointers [B, M, Wa // 4] uint8 (lane 4c + r at bits
    2r of byte c): the plain version of kernel X1's scan."""
    B = qb.shape[0]
    dev = qb.device
    i32 = torch.int32
    lanes = torch.arange(Wa, dtype=i32, device=dev)
    ramp = -GAP * lanes  # +3 * lane
    n_col = n.to(i32)[:, None]
    m64, n64, bw64 = m.long(), n.long(), bw.long()
    j0 = dmin + lanes
    H = torch.where(
        (j0[None] >= 0) & (j0[None] <= n_col), (GAP * j0)[None], NEG
    ).to(i32)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    out = torch.empty((B, M, Wa // 4), dtype=torch.uint8, device=dev)
    for i in range(1, M + 1):
        j = i + dmin + lanes  # [Wa]
        trow = tb_pad[:, i : i + Wa]  # t[j - 1]
        qrow = qb[:, i - 1 : i]
        sub = torch.where(qrow == trow, MATCH, MISMATCH).to(i32)
        diag = H + sub
        up = torch.cat([H[:, 1:], neg_col], dim=1) + GAP
        tmp = torch.maximum(diag, up)
        c = band_centre(torch.full_like(m64, i), n64, m64)
        valid = (
            (j[None] >= 1)
            & (j[None] <= n_col)
            & (j[None] >= (c - bw64)[:, None])
            & (j[None] <= (c + bw64)[:, None])
            & (i <= m64)[:, None]
        )
        tmp = torch.where(valid, tmp, NEG)
        tmp = torch.where((j == 0)[None], GAP * i, tmp)
        cm = torch.cummax(tmp + ramp, dim=1).values
        h = cm - ramp
        ptr = torch.where(
            h == diag, 0, torch.where(h == up, 1, 2)
        ).to(torch.uint8)
        H = torch.where(valid | (j == 0)[None], h, NEG)
        out[:, i - 1] = (ptr.view(B, Wa // 4, 4) << shifts).sum(
            dim=2, dtype=torch.uint8
        )
    return out


def traceback_plain(
    packed: torch.Tensor,  # [B, M, Wa // 4] uint8
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
    L: int,
) -> torch.Tensor:
    """Move streams [B, L] uint8 (0 diag, 1 up, 2 left, 3 done) walked
    from (m, n): the plain version of kernel X1's traceback."""
    B = packed.shape[0]
    Wa4 = Wa // 4
    flat = packed.reshape(B, M * Wa4)
    i = m.to(torch.int32).clone()
    j = n.to(torch.int32).clone()
    moves = torch.empty((B, L), dtype=torch.uint8, device=packed.device)
    for s in range(L):
        done = (i == 0) & (j == 0)
        lane = j - i - dmin
        lin = torch.clamp(i - 1, min=0) * Wa4 + torch.clamp(lane >> 2, 0, Wa4 - 1)
        byte = flat.gather(1, lin.long()[:, None])[:, 0].to(torch.int32)
        p = (byte >> (2 * (lane & 3))) & 3
        p = torch.where(i == 0, 2, p)
        p = torch.where((j == 0) & (i > 0), 1, p)
        p = torch.where(done, 3, p)
        i = i - ((p == 0) | (p == 1)).to(torch.int32)
        j = j - ((p == 0) | (p == 2)).to(torch.int32)
        moves[:, s] = p.to(torch.uint8)
    return moves


def align_scan(qb, tb_pad, m, n, bw, M: int, Wa: int, dmin: int):
    """Kernel X1's scan on a CUDA tensor, its plain version on the CPU."""
    if qb.device.type == "cpu":
        return align_scan_plain(qb, tb_pad, m, n, bw, M, Wa, dmin)
    from pbdagcon_tpu_torch.ops import align_cuda

    return align_cuda.align_scan_cuda(qb, tb_pad, m, n, bw, M, Wa, dmin)


def traceback(packed, m, n, M: int, Wa: int, dmin: int, L: int):
    """Kernel X1's traceback on a CUDA tensor, its plain version on the
    CPU."""
    if packed.device.type == "cpu":
        return traceback_plain(packed, m, n, M, Wa, dmin, L)
    from pbdagcon_tpu_torch.ops import align_cuda

    return align_cuda.traceback_cuda(packed, m, n, M, Wa, dmin, L)


def prepare_batch(pairs: list[tuple[str, str]]) -> dict:
    """The reference's host preparation of the non-empty pairs: the
    padded arrays and the static shape (M, Wa, dmin, L), numpy. Keys:
    qb, tb_pad, m, n, bw, M, Wa, dmin, L, B (real pairs)."""
    ms = np.array([len(q) for q, _ in pairs], dtype=np.int32)
    ns = np.array([len(t) for _, t in pairs], dtype=np.int32)
    bws = np.array(
        [band_halfwidth(int(a), int(b)) for a, b in zip(ms, ns)],
        dtype=np.int32,
    )
    B = len(pairs)
    M = -(-int(ms.max()) // 256) * 256
    N = int(ns.max())
    dmin = int(min(0, (ns - ms).min()) - bws.max()) - 1
    dmin = -(-(-dmin) // 64) * -64  # round away from zero to 64s
    dmax = int(max(0, (ns - ms).max()) + bws.max()) + 1
    Wa = dmax - dmin + 1
    Wa = -(-Wa // 128) * 128
    Bp = next((b for b in B_LADDER if b >= B), B)
    ms = np.concatenate([ms, np.ones(Bp - B, np.int32)])
    ns = np.concatenate([ns, np.ones(Bp - B, np.int32)])
    bws = np.concatenate([bws, np.full(Bp - B, 64, np.int32)])
    qb = np.zeros((Bp, M), dtype=np.uint8)
    # Row i reads tb_pad[i : i + Wa]; t[x] sits at x + 1 - dmin.
    tb_pad = np.zeros((Bp, max(M, N + 1 - dmin) + Wa + 2), dtype=np.uint8)
    for k, (q, t) in enumerate(pairs):
        qb[k, : len(q)] = np.frombuffer(q.encode(), np.uint8)
        tb_pad[k, 1 - dmin : 1 - dmin + len(t)] = np.frombuffer(
            t.encode(), np.uint8
        )
    Np = -(-N // 256) * 256
    return {
        "qb": qb, "tb_pad": tb_pad, "m": ms, "n": ns, "bw": bws,
        "M": M, "Wa": Wa, "dmin": dmin, "L": M + Np, "B": B,
    }


def device_moves(p: dict, device) -> np.ndarray:
    """The move streams [Bp, L] of a prepared batch (`prepare_batch`):
    upload, scan and traceback on `device`, and only the ~(m + n)-byte
    move streams back to the host."""
    dev = resolve_device(device)
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    qb, tb, m, n, bw = (
        torch.from_numpy(p[k]).to(dev) for k in ("qb", "tb_pad", "m", "n", "bw")
    )
    packed = align_scan(qb, tb, m, n, bw, M, Wa, dmin)
    return traceback(packed, m, n, M, Wa, dmin, L).cpu().numpy()


def replay_moves(
    pairs: list[tuple[str, str]], moves: np.ndarray
) -> list[tuple[str, str]]:
    """Gapped (q, t) strings of the non-empty `pairs` from their move
    streams (the first len(pairs) rows of `moves`), vectorised over the
    batch: reverse each row by its own path length, cumsum-index into
    the concatenated sequences, slice per pair."""
    Bt = len(pairs)
    mv = moves[:Bt]
    has_done = (mv == 3).any(axis=1)
    plen = np.where(has_done, np.argmax(mv == 3, axis=1), mv.shape[1])
    pos = np.arange(mv.shape[1])[None, :]
    rev_idx = np.clip(plen[:, None] - 1 - pos, 0, mv.shape[1] - 1)
    fwd = np.take_along_axis(mv, rev_idx, axis=1)
    inpath = pos < plen[:, None]
    take_q = (fwd != 2) & inpath
    take_t = (fwd != 1) & inpath
    qcat = np.frombuffer("".join(q for q, _ in pairs).encode(), np.uint8)
    tcat = np.frombuffer("".join(t for _, t in pairs).encode(), np.uint8)
    ms = np.array([len(q) for q, _ in pairs], dtype=np.int64)
    ns = np.array([len(t) for _, t in pairs], dtype=np.int64)
    qoff = np.zeros(Bt, np.int64)
    toff = np.zeros(Bt, np.int64)
    np.cumsum(ms[:-1], out=qoff[1:])
    np.cumsum(ns[:-1], out=toff[1:])
    qi = np.cumsum(take_q, axis=1) - 1 + qoff[:, None]
    ti = np.cumsum(take_t, axis=1) - 1 + toff[:, None]
    gap = np.uint8(ord("-"))
    qs2 = np.where(take_q, qcat[np.clip(qi, 0, len(qcat) - 1)], gap)
    ts2 = np.where(take_t, tcat[np.clip(ti, 0, len(tcat) - 1)], gap)
    return [
        (qs2[r, :ln].tobytes().decode(), ts2[r, :ln].tobytes().decode())
        for r, ln in enumerate(plen.tolist())
    ]


def align_batch(
    pairs: list[tuple[str, str]], device="cuda"
) -> list[tuple[str, str]]:
    """Align many (q, t) pairs on `device`; byte-equal to `align_pair`."""
    if not pairs:
        return []
    out: list[tuple[str, str] | None] = [None] * len(pairs)
    todo: list[int] = []
    for k, (q, t) in enumerate(pairs):
        if not q:
            out[k] = ("-" * len(t), t)
        elif not t:
            out[k] = (q, "-" * len(q))
        else:
            todo.append(k)
    if todo:
        real = [pairs[k] for k in todo]
        moves = device_moves(prepare_batch(real), device)
        for k, gapped in zip(todo, replay_moves(real, moves)):
            out[k] = gapped
    return out  # type: ignore[return-value]
