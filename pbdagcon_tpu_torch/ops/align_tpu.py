"""Batched pairwise alignment on the device (port of
`pbdagcon_tpu/ops/align_tpu.py`, the SimpleAligner of the `-a` device
path and of dazcon).

`align_batch(pairs, device)` is byte-equal to `aligner.align_pair` for
every pair. The host prepares the padded batch exactly as the reference
does (M to 256s, dmin to 64s, Wa to 128s, B on the 32...2048 ladder), the
device runs the row scan (`align_scan`: 2-bit traceback pointers), the
pointer walk (`traceback`: one move per step) and the replay of the
moves into gapped rows (`replay`), and one copy brings the rows and
their path lengths to the host, which cuts and decodes them.

The formulation is the reference's: lane k of row i holds column
j = i + dmin + k, so the diagonal predecessor is the same lane of the
previous row and the up predecessor lane k + 1; the in-row left chain
`H[i][j] = max(cand[j], H[i][j-1] - 3)` is a running max of
`cand + 3 * lane` minus `3 * lane` (integer, exact); lanes outside a
pair's band are masked to NEG each row; pointers take the priority
diag > up > left.

On a CUDA tensor `align_scan`, `traceback` and `replay` launch kernel
X1 (`csrc/align_scan.cu`, through `ops/align_cuda.py`) or raise; on a
CPU tensor they run the plain PyTorch versions `align_scan_plain` (a
row loop with `torch.cummax`), `traceback_plain` and `replay_plain`,
which the tests hold against the reference's XLA programs and its
numpy replay.

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


# The warp route of kernel X1's scan (`csrc/align_scan.cu`,
# `align_scan_warp_kernel`) gives each pair one warp of 32 threads, each
# thread CPL consecutive lanes: CPL is a multiple of 4 (whole pointer
# bytes a thread), at most WARP_MAX_CPL.
WARP_MAX_CPL = 32


def scan_windows(m, n, bw, Wa: int, dmin: int):
    """Each pair's lane span on the warp route of X1's scan: (ks, cpl),
    int64 arrays. The warp computes lanes [ks, ks + 32 * cpl) of rows
    1..min(m + 1, M) (row 1 over all Wa lanes); every other pointer has
    a closed form (`scan_closed_form`).

    The span holds every band lane of rows 1..m, one lane to each side
    and ks rounded down to 4. Lane k of row i is column
    j = i + dmin + k, so the band of row i is lanes
    [lo - i - dmin, hi - i - dmin] with lo - i = max(1 - i, g(i)) and
    hi - i = min(n - i, g(i) + 2 bw), g(i) = i * n // m - i - bw =
    (i * (n - m)) // m - bw, monotone in i: the bounds
    max(1 - m, min(g(1), g(m))) and min(n - 1, max(g(1), g(m)) + 2 bw)
    hold every row's band. Pointers outside a band can differ from
    "left" only where the previous row's band is read (the diagonal or
    the up term), which is one lane left of the band at most: hence the
    margin. Row 1 reads row 0, which is not masked to the band, so the
    kernel computes it whole. Takes numpy arrays or ints (m, n >= 1);
    the kernel's `pair_window` is the same arithmetic."""
    m64, n64, bw64 = (np.asarray(x, dtype=np.int64) for x in (m, n, bw))
    g1 = n64 // m64 - 1 - bw64
    gm = n64 - m64 - bw64
    lo = np.maximum(1 - m64, np.minimum(g1, gm)) - dmin
    hi = np.minimum(n64 - 1, np.maximum(g1, gm) + 2 * bw64) - dmin
    ks = np.maximum(0, lo - 1) // 4 * 4
    need = np.maximum(np.minimum(Wa, hi + 2) - ks, 1)
    cpl = -(-(-(-need // 32)) // 4) * 4
    return ks, cpl


def scan_closed_form(B: int, M: int, Wa: int, dmin: int) -> torch.Tensor:
    """The pointers X1's warp route writes outside the lanes it
    computes: 2 ("left", byte 0xAA) everywhere but the j == 0 lane
    k0 = -i - dmin of each row, whose pointer is 1 (its tmp is forced to
    GAP * i and the up term from row i - 1's j == 0 cell ties). [B, M,
    Wa // 4] uint8."""
    out = torch.full((B, M, Wa // 4), 0xAA, dtype=torch.uint8)
    rows = torch.arange(1, M + 1)
    k0 = -rows - dmin
    ok = (k0 >= 0) & (k0 < Wa)
    r, k = rows[ok] - 1, k0[ok]
    out[:, r, k // 4] ^= (3 << (2 * (k % 4))).to(torch.uint8)
    return out


def align_scan_window_model(
    qb: torch.Tensor,  # [B, M] uint8
    tb_pad: torch.Tensor,  # [B, T] uint8
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    bw: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
) -> torch.Tensor:
    """X1's warp route as a CPU model, array-equal to `align_scan_plain`
    where `scan_windows` holds the band (m, n >= 1, bw at least
    `band_halfwidth`, the warp route's condition): the closed form
    everywhere, row 1 over all Wa lanes, then rows 2..min(m + 1, M) over
    each pair's span only, with NEG outside it and the running max
    seeded with the lanes left of it (NEG, or the j == 0 lane's
    GAP * i)."""
    B, T = qb.shape[0], tb_pad.shape[1]
    i64 = torch.int64
    ks_np, cpl_np = scan_windows(m.numpy(), n.numpy(), bw.numpy(), Wa, dmin)
    ks = torch.from_numpy(ks_np)[:, None]
    width = torch.from_numpy(32 * cpl_np)[:, None]
    m64, n64, bw64 = m.long(), n.long(), bw.long()
    n_col = n64[:, None]
    out = scan_closed_form(B, M, Wa, dmin)

    def row(H, up_edge, i, k, inw, seed):
        """Row i over lanes k ([B, S]; H the previous row there)."""
        j = i + dmin + k
        trow = tb_pad.gather(1, torch.clamp(i + k, 0, T - 1)).long()
        sub = torch.where(trow == qb[:, i - 1 : i].long(), MATCH, MISMATCH)
        diag = H + sub
        up = torch.cat([H[:, 1:], up_edge], dim=1) + GAP
        c = band_centre(torch.full_like(m64, i), n64, m64)[:, None]
        valid = (inw & (j >= 1) & (j <= n_col) & (j >= c - bw64[:, None])
                 & (j <= c + bw64[:, None]) & (i <= m64)[:, None])
        z = inw & (j == 0)
        tmp = torch.where(valid, torch.maximum(diag, up), NEG)
        tmp = torch.where(z, GAP * i, tmp)
        v = torch.where(inw, tmp - GAP * k, torch.iinfo(i64).min)
        cm = torch.cummax(torch.cat([seed, v], dim=1), dim=1).values[:, 1:]
        h = cm + GAP * k
        ptr = torch.where(h == diag, 0, torch.where(h == up, 1, 2))
        return ptr, torch.where(inw & (valid | z), h, NEG)

    def pack(ptr):
        w = ptr.shape[1] // 4
        return (ptr.view(B, w, 4) << torch.tensor([0, 2, 4, 6])).sum(
            dim=2).to(torch.uint8)

    # Row 1 over every lane: row 0 is GAP * j for 0 <= j <= n.
    lanes = torch.arange(Wa, dtype=i64)[None].expand(B, Wa)
    j0 = dmin + lanes
    H0 = torch.where((j0 >= 0) & (j0 <= n_col), GAP * j0, NEG)
    none = torch.full((B, 1), torch.iinfo(i64).min, dtype=i64)
    ptr, H1 = row(H0, torch.full((B, 1), NEG, dtype=i64), 1, lanes,
                  torch.ones_like(lanes, dtype=torch.bool), none)
    out[:, 0] = pack(ptr)
    # Rows 2..R over the span.
    S = int(width.max())
    x = torch.arange(S, dtype=i64)[None]
    k = ks + x
    inw = (x < width) & (k < Wa)
    H = torch.where(inw, H1.gather(1, torch.clamp(k, 0, Wa - 1)), NEG)
    edge = torch.full((B, 1), NEG, dtype=i64)
    R = torch.clamp(m64 + 1, max=M)
    nb = torch.clamp(width // 4, max=(Wa - ks) // 4)  # bytes a pair writes
    for i in range(2, int(R.max()) + 1):
        k0 = -i - dmin
        seed = torch.where(ks > 0, NEG - GAP * (ks - 1), torch.iinfo(i64).min)
        if k0 >= 0:
            seed = torch.where(k0 < ks, torch.maximum(
                seed, torch.tensor(GAP * i - GAP * k0)), seed)
        ptr, H = row(H, edge, i, k, inw, seed)
        byte = pack(ptr)
        xb = torch.arange(S // 4)[None]
        put = (xb < nb) & (i <= R)[:, None]
        bidx = torch.arange(B)[:, None].expand_as(put)
        out[bidx[put], i - 1, (ks // 4 + xb).expand_as(put)[put]] = byte[put]
    return out


def warp_edge_pairs(seed: int = 5) -> list[tuple[str, str]]:
    """Test pairs for X1's warp route: spans on both sides of every CPL
    class edge (m = 48 and m = 300, n from 1 to past m, so the band
    drifts both ways in lane space), with the extremes that fix the
    batch's dmin and Wa."""
    import random

    from pbdagcon_tpu_torch.simulate import random_seq

    rng = random.Random(seed)
    fams = []
    for m, top in ((48, 200), (300, 600)):
        q, t = random_seq(rng, m), random_seq(rng, top)
        fams.append([(q, t[:k]) for k in range(1, top + 1)])
    cand = [pr for fam in fams for pr in fam]
    p = prepare_batch(cand)
    B = len(cand)
    _, cpl = scan_windows(p["m"][:B], p["n"][:B], p["bw"][:B], p["Wa"],
                          p["dmin"])
    pick, at = set(), 0
    for fam in fams:
        pick |= {at, at + len(fam) - 1}
        for k in range(at + 1, at + len(fam)):
            if cpl[k] != cpl[k - 1]:
                pick |= {k - 1, k}
        at += len(fam)
    return [cand[k] for k in sorted(pick)]


def short_pairs(seed: int = 6) -> list[tuple[str, str]]:
    """Test pairs for X1's warp route: length-1 pairs and pairs short
    enough that the j == 0 lane stays in the lane range past row m."""
    import random

    from pbdagcon_tpu_torch.simulate import random_seq

    rng = random.Random(seed)
    pairs = [("A", "A"), ("A", "C"), ("G", random_seq(rng, 9)),
             (random_seq(rng, 9), "T")]
    for k in (2, 5, 17, 40):
        s = random_seq(rng, k)
        pairs.append((s, s[: max(1, k - 3)]))
    return pairs


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


# The warp route of kernel X1's traceback (`csrc/align_scan.cu`,
# `align_traceback_warp_kernel`): a warp per pair walks its pointers in
# stages of TB_ROWS rows over TB_WINDOW bytes a row, staged in shared
# memory two at a time, and buffers its moves in a ring of TB_RING bytes.
TB_ROWS = 128
TB_WINDOW = 64
TB_RING = 512


def traceback_window_model(
    packed: torch.Tensor,  # [B, M, Wa // 4] uint8
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
    L: int,
    rows: int = TB_ROWS,
    window: int = TB_WINDOW,
) -> tuple[torch.Tensor, dict]:
    """X1's warp-route traceback as a CPU model, event for event: the
    stages of `rows` rows from row m down, each a window of `window`
    bytes (halved while wider than a row's Wa // 4) from a 16-byte
    boundary placed when the
    walk enters the stage before it (from `window` lanes left of the
    lane there: the walk drifts right, one lane an up step), copied
    out of `packed` with pointer 1 written on each row's j == 0 lane.
    In a window the walk goes as the kernel's warp takes it: an event
    reads 32 rows at once (the rows past the stage's end clamped to its
    last and masked), takes the diagonal run up to the first other
    pointer or the stage's end, then that pointer's step; events stop
    at the window's edge, the stage's end, or once within 33 moves of
    the ring's room or of L (so a run may go up to 32 steps past that
    mark). Any other step reads `packed` by the reference's rules (row
    0, j == 0, the byte index clamped). The moves pass through a ring of TB_RING
    bytes, whose whole 16-byte blocks go out once fewer than 33 places
    (an event's) are free, and out only as the kernel writes them: whole
    16-byte blocks of the flat [B * L] output, the partial blocks at a
    row's ends byte by byte; the model checks that no store crosses its
    row and that each byte is written once.
    Array-equal to `traceback_plain` on any packed tensor. Returns the
    moves [B, L] uint8 and per-pair counts (numpy int64): "steps"
    walked, "fast" (steps in a window), "slow" (pointer reads from
    `packed`) and "events": the counts of the kernel's -D X1_PROF=1
    build."""
    B = packed.shape[0]
    Wa4 = Wa // 4
    if Wa % 64 or window not in (16, 32, 64, 128, 256):
        raise ValueError(f"no warp-route window for Wa={Wa}, rows={rows}, "
                         f"window={window}")
    WBe = window
    while WBe > Wa4:
        WBe //= 2
    XW = 4 * WBe
    margin = window
    pk = packed.reshape(B, M * Wa4).numpy()
    out = np.zeros(B * L, dtype=np.uint8)
    wrote = np.zeros(B * L, dtype=np.int8)
    counts = {k: np.zeros(B, dtype=np.int64)
              for k in ("steps", "fast", "slow", "events")}
    lanes32 = np.arange(32)
    le4 = np.array([1, 1 << 8, 1 << 16, 1 << 24], dtype=np.uint64)
    for b in range(B):
        flat = pk[b]
        g0 = b * L
        ring = np.zeros(TB_RING, dtype=np.uint8)

        def put(g, gt, src):
            """Bytes [g, gt) out as the kernel's tb_put stores them."""
            if gt <= g:
                return
            ha = min(gt, (g + 15) & ~15)
            ta = max(ha, gt & ~15)
            spans = [(g, ha), *((x, x + 16) for x in range(ha, ta, 16)),
                     (ta, gt)]
            for lo, hi in spans:
                if hi <= lo:
                    continue
                assert g0 <= lo and hi <= g0 + L, "a store crosses its row"
                assert hi - lo == 16 or lo // 16 == (hi - 1) // 16
                idx = np.arange(lo, hi)
                out[lo:hi] = ring[idx % TB_RING] if src else 3
                wrote[lo:hi] += 1

        slots = [None, None]  # (top row, rows, first byte, the copy)

        def issue(c, lam):
            hi = int(m[b]) - c * rows
            lo = max(1, hi - rows + 1)
            cb = min(max(((lam - margin) >> 2) & ~15, 0), Wa4 - WBe)
            copy = np.zeros((rows, window), dtype=np.uint8)
            for r in range(max(0, hi - lo + 1)):
                copy[r, :WBe] = flat[(hi - r - 1) * Wa4 + cb:][:WBe]
            slots[c & 1] = (hi, max(0, hi - lo + 1), cb, copy)

        i, j, s, gf = int(m[b]), int(n[b]), 0, g0
        if i >= 1:
            issue(0, j - i - dmin)
            issue(1, j - i - dmin)
        cur = -1
        while True:
            sl = min(L, gf - g0 + TB_RING - 16)
            if s >= L:
                break
            if s + 33 > gf - g0 + TB_RING - 16 and (g0 + s) & ~15 > gf:
                gt = (g0 + s) & ~15
                put(gf, gt, True)
                gf = gt
                continue
            if i == 0 and j == 0:
                break
            if i >= 1:
                c = (int(m[b]) - i) // rows
                if c != cur:
                    cur = c
                    if c >= 1:
                        issue(c + 1, j - i - dmin)
                    hi, nr, cb, copy = slots[c & 1]
                    for r in range(nr):
                        x0 = -(hi - r) - dmin - 4 * cb
                        if 0 <= x0 < XW:
                            sh = 2 * (x0 & 3)
                            copy[r, x0 >> 2] = (int(copy[r, x0 >> 2])
                                                & (255 ^ 3 << sh)) | 1 << sh
                hi, nr, cb, copy = slots[c & 1]
                x = j - i - dmin - 4 * cb
                if 0 <= x < XW and s + 33 <= sl:
                    r, q = hi - i, s
                    dead = False
                    while True:
                        # An event: lane t reads row min(r + t, nr - 1)
                        # as a 4-byte word from a 4-byte boundary,
                        # rotated right by 2x bits; rows from the
                        # stage's end on stop the run untaken. The first
                        # stop is at k (32 where none); lanes 0..k - 1
                        # write diagonal moves, lane k its pointer.
                        rws = np.minimum(r + lanes32, nr - 1)
                        o = (x >> 2) & ~3
                        wv = copy[rws, o:o + 4].astype(np.uint64) @ le4
                        rot = (2 * x) & 31
                        wv = (wv >> rot) | (wv << (32 - rot) & 0xFFFFFFFF)
                        fl = (wv & 3).astype(np.int64)
                        past = lanes32 >= nr - r
                        stop = (fl != 0) | past
                        k = int(np.argmax(stop)) if stop.any() else 32
                        take = k < 32 and not past[k]
                        ring[(g0 + q + np.arange(k)) % TB_RING] = 0
                        if k < 32:
                            ring[(g0 + q + k) % TB_RING] = fl[k]
                        f = int(fl[k]) if take else 0
                        q += k + take
                        counts["events"][b] += 1
                        if f == 3:
                            dead = True
                            break
                        r += k + (f == 1)
                        x += (f == 1) - (f == 2)
                        if r >= nr or not 0 <= x < XW or q > sl - 33:
                            break
                    counts["fast"][b] += q - s
                    s = q
                    i = hi - r
                    j = x + 4 * cb + i + dmin
                    if dead:
                        break
                    continue
            if i == 0:
                p = 2
            elif j == 0:
                p = 1
            else:
                lane = j - i - dmin
                byte = flat[(i - 1) * Wa4 + min(max(lane >> 2, 0), Wa4 - 1)]
                p = (int(byte) >> (2 * (lane & 3))) & 3
                counts["slow"][b] += 1
            ring[(g0 + s) % TB_RING] = p
            s += 1
            if p == 3:
                break
            i -= p <= 1
            j -= p in (0, 2)
        counts["steps"][b] = s
        ge = g0 + s
        ga = min(g0 + L, (ge + 15) & ~15)
        ring[np.arange(ge, ga) % TB_RING] = 3
        put(gf, ga, True)
        put(ga, g0 + L, False)
    assert (wrote == 1).all(), "a move byte written other than once"
    return torch.from_numpy(out.reshape(B, L)), counts


def align_scan(qb, tb_pad, m, n, bw, M: int, Wa: int, dmin: int,
               plan: dict | None = None):
    """Kernel X1's scan on a CUDA tensor (on the route of `plan`,
    `align_cuda.scan_plan`), its plain version on the CPU."""
    if qb.device.type == "cpu":
        return align_scan_plain(qb, tb_pad, m, n, bw, M, Wa, dmin)
    from pbdagcon_tpu_torch.ops import align_cuda

    return align_cuda.align_scan_cuda(qb, tb_pad, m, n, bw, M, Wa, dmin,
                                      plan)


def traceback(packed, m, n, M: int, Wa: int, dmin: int, L: int,
              plan: dict | None = None):
    """Kernel X1's traceback on a CUDA tensor (on the route of `plan`,
    `align_cuda.traceback_plan`), its plain version on the CPU."""
    if packed.device.type == "cpu":
        return traceback_plain(packed, m, n, M, Wa, dmin, L)
    from pbdagcon_tpu_torch.ops import align_cuda

    return align_cuda.traceback_cuda(packed, m, n, M, Wa, dmin, L, plan)


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


# The replay's gap byte, and the 32-position steps of a chunk of the
# replay kernel's forward walk (`REPLAY_SUB` in `csrc/align_scan.cu`).
GAP_BYTE = ord("-")
REPLAY_SUB = 4


def replay_plain(
    moves: torch.Tensor,  # [B, L] uint8: 0 diag, 1 up, 2 left, 3 done
    qb: torch.Tensor,  # [B, M] uint8 query bytes (0 pad)
    tb_pad: torch.Tensor,  # [B, T] uint8: t[x] at x + 1 - dmin, 0 pad
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    dmin: int,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gapped rows of the move streams: the plain version of kernel
    X1's replay. A row's path is its moves before the first 3 (all L
    where there is none), in reverse order: forward position p reads
    move plen - 1 - p, takes a query base unless the move is 2 (left)
    and a target base unless it is 1 (up). Returns gq, gt [B, L] uint8
    (the base taken, b"-" where none is, 0 past the path) and plen [B]
    int32 (the path's length, or -1 where it does not take exactly m
    query and n target bases: a fault upstream). A base index past the
    row reads the row's last byte. The three are views of one buffer
    (`replay_views`): `out` where given."""
    B, L = moves.shape
    M, T = qb.shape[1], tb_pad.shape[1]
    if out is None:
        out = torch.empty(replay_bytes(B, L), dtype=torch.uint8,
                          device=moves.device)
    gq, gt, plen = replay_views(out, B, L)
    done = moves == 3
    first = torch.where(done.any(dim=1), done.to(torch.uint8).argmax(dim=1),
                        L)
    pos = torch.arange(L, device=moves.device)[None]
    fwd = moves.long().gather(1, torch.clamp(first[:, None] - 1 - pos, 0,
                                             L - 1))
    inpath = pos < first[:, None]
    take_q = (fwd != 2) & inpath
    take_t = (fwd != 1) & inpath
    qi = torch.clamp(take_q.long().cumsum(dim=1) - 1, 0, M - 1)
    ti = torch.clamp(take_t.long().cumsum(dim=1) - dmin, 0, T - 1)
    gap = torch.where(inpath, GAP_BYTE, 0).to(torch.uint8)
    gq.copy_(torch.where(take_q, qb.gather(1, qi), gap))
    gt.copy_(torch.where(take_t, tb_pad.gather(1, ti), gap))
    whole = (take_q.sum(dim=1) == m.long()) & (take_t.sum(dim=1) == n.long())
    plen.copy_(torch.where(whole, first, -1))
    return gq, gt, plen


def replay_bytes(B: int, L: int) -> int:
    """Bytes of the one buffer that holds a replay's outputs: gq, gt
    ([B, L] uint8 each), then plen ([B] int32) from a 4-byte boundary."""
    return -(-2 * B * L // 4) * 4 + 4 * B


def replay_views(flat: torch.Tensor, B: int, L: int):
    """gq, gt and plen as views of `flat` (`replay_bytes(B, L)` uint8),
    so that one copy moves all three."""
    at = replay_bytes(B, L) - 4 * B
    return (flat[: B * L].view(B, L), flat[B * L: 2 * B * L].view(B, L),
            flat[at:].view(torch.int32))


def replay_warp_model(moves, qb, tb_pad, m, n, dmin: int):
    """X1's replay kernel (`align_replay_kernel`) as a CPU model, lane by
    lane: a warp per pair finds plen from 16-byte chunks of the row, one
    a lane, the first 3 of a chunk by the word test for a zero byte of
    `w ^ 0x03030303` and the first lane that has one by ballot; then it
    walks forward positions in chunks of REPLAY_SUB x 32, one position a
    lane a step, each lane's base index the popcount of the lower lanes'
    ballot plus the counts so far. Array-equal to `replay_plain`."""
    mv = moves.numpy()
    B, L = mv.shape
    M, T = qb.shape[1], tb_pad.shape[1]
    q_np, t_np, m_np, n_np = (x.numpy() for x in (qb, tb_pad, m, n))
    gq = np.zeros((B, L), np.uint8)
    gt = np.zeros((B, L), np.uint8)
    plen = np.zeros(B, np.int32)
    lanes = np.arange(32)
    lower = (1 << lanes) - 1
    popc = np.vectorize(lambda x: bin(int(x)).count("1"))
    for b in range(B):
        row = mv[b]
        first = L
        for base in range(0, L, 32 * 16):
            hit = np.full(32, 16)
            for lane in range(32):
                c0 = base + 16 * lane
                chunk = row[c0: min(c0 + 16, L)]
                if len(chunk) == 16:  # four words, as the kernel's uint4
                    for k in range(3, -1, -1):
                        w = int(chunk[4 * k: 4 * k + 4].view("<u4")[0])
                        x = w ^ 0x03030303
                        z = (x - 0x01010101) & ~x & 0x80808080
                        if z:
                            hit[lane] = 4 * k + ((z & -z).bit_length() - 1) // 8
                else:
                    for k in range(len(chunk) - 1, -1, -1):
                        if chunk[k] == 3:
                            hit[lane] = k
            ballot = hit < 16
            if ballot.any():
                src = int(np.argmax(ballot))
                first = base + 16 * src + int(hit[src])
                break
        cq = ct = 0
        for p0 in range(0, L, 32 * REPLAY_SUB):
            for s in range(REPLAY_SUB):
                p = p0 + 32 * s + lanes
                inpath = p < first
                mvs = np.where(inpath, row[np.clip(first - 1 - p, 0, L - 1)],
                               3)
                tq, tt = inpath & (mvs != 2), inpath & (mvs != 1)
                bq = int((tq.astype(np.int64) << lanes).sum())
                bt = int((tt.astype(np.int64) << lanes).sum())
                qx = np.minimum(cq + popc(bq & lower), M - 1)
                tx = np.clip(ct + popc(bt & lower) + 1 - dmin, 0, T - 1)
                cq += bin(bq).count("1")
                ct += bin(bt).count("1")
                gap = np.where(inpath, GAP_BYTE, 0)
                a = np.where(tq, q_np[b, qx], gap)
                c = np.where(tt, t_np[b, tx], gap)
                keep = p < L
                gq[b, p[keep]] = a[keep]
                gt[b, p[keep]] = c[keep]
        plen[b] = first if (cq == m_np[b] and ct == n_np[b]) else -1
    return (torch.from_numpy(gq), torch.from_numpy(gt),
            torch.from_numpy(plen))


def replay(moves, qb, tb_pad, m, n, dmin: int, out=None):
    """Kernel X1's replay on a CUDA tensor, its plain version on the
    CPU: (gq, gt, plen), views of `out` where it is given."""
    if moves.device.type == "cpu":
        return replay_plain(moves, qb, tb_pad, m, n, dmin, out)
    from pbdagcon_tpu_torch.ops import align_cuda

    return align_cuda.replay_cuda(moves, qb, tb_pad, m, n, dmin, out)


def device_replay(p: dict, device) -> torch.Tensor:
    """A prepared batch (`prepare_batch`) aligned on `device`: upload,
    scan, traceback and replay there, the moves never leaving it.
    Returns the one buffer of the gapped rows and path lengths
    (`replay_views`), on `device`."""
    dev = resolve_device(device)
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    qb, tb, m, n, bw = (
        torch.from_numpy(p[k]).to(dev) for k in ("qb", "tb_pad", "m", "n", "bw")
    )
    plan = tb_plan = None
    if dev.type == "cuda":
        from pbdagcon_tpu_torch.ops import align_cuda

        plan = align_cuda.scan_plan(p["m"], p["n"], p["bw"], M, Wa, dmin)
        tb_plan = align_cuda.traceback_plan(p["m"], p["n"], M, Wa, L)
    packed = align_scan(qb, tb, m, n, bw, M, Wa, dmin, plan)
    moves = traceback(packed, m, n, M, Wa, dmin, L, tb_plan)
    flat = torch.empty(replay_bytes(len(p["m"]), L), dtype=torch.uint8,
                       device=dev)
    replay(moves, qb, tb, m, n, dmin, flat)
    return flat


def fetch_gapped(flat: torch.Tensor, p: dict) -> list[tuple[str, str]]:
    """The gapped (q, t) strings of the batch's real pairs from
    `device_replay`'s buffer: one copy to the host, each row cut to its
    path length and decoded. Raises where a path did not take exactly
    its pair's bases."""
    B, Bp, L = p["B"], len(p["m"]), p["L"]
    host = flat.cpu()
    plen = replay_views(host, Bp, L)[2][:B].tolist()
    if min(plen) < 0:
        raise RuntimeError(f"align_batch: the path of pair "
                           f"{plen.index(-1)} does not take its pair's "
                           f"bases (a traceback fault)")
    raw = host.numpy().tobytes()
    return [(raw[r * L: r * L + ln].decode(),
             raw[(Bp + r) * L: (Bp + r) * L + ln].decode())
            for r, ln in enumerate(plen)]


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
        p = prepare_batch([pairs[k] for k in todo])
        for k, gapped in zip(todo, fetch_gapped(device_replay(p, device), p)):
            out[k] = gapped
    return out  # type: ignore[return-value]
