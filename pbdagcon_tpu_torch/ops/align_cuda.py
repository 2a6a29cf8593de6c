"""Wrappers of kernel X1, the hand-written Hopper aligner
(`csrc/align_scan.cu`).

`align_scan_cuda` replaces the XLA program
`pbdagcon_tpu/ops/align_tpu.py::_align_scan`, `traceback_cuda`
replaces `_traceback_scan` and `replay_cuda` the numpy replay of the
moves into gapped rows inside its `align_batch`; the contracts are those
of the plain PyTorch versions `ops/align_tpu.py::align_scan_plain`,
`traceback_plain` and `replay_plain`, array-equal. No wrapper falls
back to the plain version: each checks what it is given, raises on
anything the kernel does not take, and raises if the build or the
launch fails. Each launches on the current stream without
synchronising; outputs are `torch.empty` (every byte is written).

The scan has two routes, chosen per batch by `scan_plan`: "warp" (a
warp per pair over the pair's own lane span, `align_scan_warp_kernel`)
where every pair's span fits 32 x WARP_MAX_CPL lanes, else "cta" (a CTA
per pair over all Wa lanes, `align_scan_kernel`). The traceback has two,
chosen by `traceback_plan`: "warp" (a warp per pair walking a staged
window of its pointer rows, `align_traceback_warp_kernel`) for every
batch, and "thread" (a thread per pair over device memory,
`align_traceback_kernel`) only where a plan forces it. Each C entry
checks its plan and refuses one it does not take.

`launches` counts each kernel's launches by name ("align_scan",
"align_traceback", "align_replay"), and `traceback_routes` the
traceback's by route.
"""

from __future__ import annotations

import numpy as np
import torch

from pbdagcon_tpu_torch.ops import _build, align_tpu

launches = {"align_scan": 0, "align_traceback": 0, "align_replay": 0}
# The traceback's launches by route.
traceback_routes = {"thread": 0, "warp": 0}

# The scan's CTA holds two rows of Wa + 1 int32 and 8 warp totals in
# shared memory: at most 227 KB on Hopper.
MAX_SMEM = 232_448


def scan_smem(Wa: int) -> int:
    """Dynamic shared memory of the "cta" route's CTA (the kernel file's
    `scan_smem`)."""
    return (2 * (Wa + 1) + 8) * 4


ROUTES = {"cta": 0, "warp": 1}
# Pairs (warps) a CTA holds on the "warp" route: enough CTAs for the
# card's 132 SMs, at most 8 warps each (the warps w and w + 4 of a CTA
# share a scheduler, and the plan gives them a heavy and a light pair).
SMS = 132
MAX_WARPS_PER_CTA = 8
# The warp route's lanes a thread.
CPL_CLASSES = tuple(range(4, align_tpu.WARP_MAX_CPL + 1, 4))


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def warp_slot(M: int) -> int:
    """Shared memory of one warp on the "warp" route (the kernel file's
    `warp_slot`): the query bytes and the target bytes its rows read
    (M - 1 + 32 x WARP_MAX_CPL at most)."""
    return _r16(M) + _r16(M + 32 * align_tpu.WARP_MAX_CPL)


def _snake_order(work: np.ndarray, warps: int) -> np.ndarray:
    """The pair of each warp slot (CTA g, warp w at g * warps + w; -1
    for none): the pairs by work, heaviest first, dealt to the CTAs in a
    snake, one pass of G pairs a warp slot. With 8 warps a CTA, warps w
    and w + 4 share a scheduler: passes 0-3 take slots 0-3 and passes
    7-4 slots 4-7, so the heaviest pairs share theirs with the
    lightest."""
    B = len(work)
    G = max(1, -(-B // warps))
    rank = np.argsort(-np.asarray(work), kind="stable")
    r = np.arange(B)
    p, g = r // G, r % G
    g = np.where(p % 2 == 0, g, G - 1 - g)
    slot = np.where(p < 4, p, 11 - p) if warps == 8 else p
    order = np.full(G * warps, -1, dtype=np.int32)
    order[g * warps + slot] = rank
    return order


def scan_plan(m, n, bw, M: int, Wa: int, dmin: int,
              route: str | None = None, warps: int | None = None) -> dict:
    """The scan's launch plan for a batch (m, n, bw: numpy arrays or
    tensors of the real and padded pairs). "warp" where every pair has
    1 <= m, n >= 1, a band at least `band_halfwidth(m, n)` wide (the
    closed form outside the spans rests on a connected band) and a span
    (`align_tpu.scan_windows`) within WARP_MAX_CPL lanes a thread, with
    its warp's slot in one CTA's shared memory; else "cta". `route`
    forces one route and raises ValueError where it does not fit;
    `warps` forces the warps a CTA on "warp" (1..8).
    Keys: route, smem (bytes a CTA), and on "warp": warps (pairs a
    CTA), cpl_max, cpl_counts (pairs per CPL class) and order (int32,
    the pair of each warp slot, -1 for none: the pairs by work, rows x
    CPL, dealt to the CTAs in a snake, so each CTA holds heavy and light
    ones)."""
    m, n, bw = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                           dtype=np.int64) for x in (m, n, bw))
    if route not in (None, *ROUTES):
        raise ValueError(f"unknown scan route {route!r}")
    why = None
    if Wa <= 0 or Wa % 128:
        raise ValueError(f"Wa must be a positive multiple of 128, got {Wa}")
    if len(m) and (m.min() < 1 or n.min() < 1):
        why = "a pair has m or n below 1"
    elif len(m) and max(m.max(), n.max(), bw.max()) >= 1 << 28:
        why = "a length or band past 2**28 (the kernel's int32 centre)"
    elif len(m) and (bw < np.maximum(64, np.abs(m - n) + 32)).any():
        # aligner.band_halfwidth, over the batch
        why = "a pair's band is narrower than band_halfwidth(m, n)"
    else:
        _, cpl = (align_tpu.scan_windows(m, n, bw, Wa, dmin) if len(m)
                  else (None, np.full(0, 4, np.int64)))
        cpl_max = int(cpl.max()) if len(cpl) else 4
        if cpl_max > align_tpu.WARP_MAX_CPL:
            why = (f"a pair's span needs {cpl_max} lanes a thread, past "
                   f"{align_tpu.WARP_MAX_CPL}")
        elif warp_slot(M) > MAX_SMEM:
            why = f"M = {M} outgrows one warp's shared memory"
    if why is None and route in (None, "warp"):
        fit = max(1, min(MAX_WARPS_PER_CTA, -(-len(m) // SMS),
                         MAX_SMEM // warp_slot(M)))
        if warps is None:
            warps = fit
        elif not 1 <= warps <= min(MAX_WARPS_PER_CTA,
                                   MAX_SMEM // warp_slot(M)):
            raise ValueError(f"{warps} warps a CTA do not fit")
        classes, counts = np.unique(cpl, return_counts=True)
        work = np.minimum(m + 1, M) * cpl
        return {"route": "warp", "warps": warps, "cpl_max": cpl_max,
                "smem": warps * warp_slot(M),
                "cpl_counts": dict(zip(classes.tolist(), counts.tolist())),
                "order": _snake_order(work, warps)}
    if route == "warp":
        raise ValueError(f"the warp route does not take this batch: {why}")
    if scan_smem(Wa) > MAX_SMEM:
        raise ValueError(f"Wa = {Wa} outgrows one CTA's shared memory")
    return {"route": "cta", "smem": scan_smem(Wa)}


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def align_scan_cuda(
    qb: torch.Tensor,  # [B, M] uint8
    tb_pad: torch.Tensor,  # [B, T] uint8, T >= M + Wa
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    bw: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
    plan: dict | None = None,
) -> torch.Tensor:
    """Packed traceback pointers [B, M, Wa // 4] uint8 by the kernel,
    on the route of `plan` (`scan_plan`; made here from m, n and bw,
    which costs a copy to the host, when None)."""
    device = qb.device
    if device.type != "cuda":
        raise ValueError(f"align_scan_cuda needs CUDA tensors, got {device}")
    if qb.dim() != 2 or tb_pad.dim() != 2:
        raise ValueError("qb and tb_pad must be [B, M] and [B, T]")
    B, T = qb.shape[0], tb_pad.shape[1]
    _check(qb, "qb", torch.uint8, (B, M), device)
    _check(tb_pad, "tb_pad", torch.uint8, (B, T), device)
    for name, t in (("m", m), ("n", n), ("bw", bw)):
        _check(t, name, torch.int32, (B,), device)
    if Wa <= 0 or Wa % 128:
        raise ValueError(f"Wa must be a positive multiple of 128, got {Wa}")
    if T < M + Wa:
        raise ValueError(f"tb_pad rows must hold M + Wa = {M + Wa} bytes, got {T}")
    if plan is None:
        plan = scan_plan(m, n, bw, M, Wa, dmin)
    if plan.get("route") not in ROUTES:
        raise ValueError(f"not a scan plan: {plan}")
    order = None
    if plan["route"] == "warp":
        if len(plan["order"]) != -(-B // plan["warps"]) * plan["warps"]:
            raise ValueError(f"the plan's order is not of B = {B} pairs")
        order = torch.from_numpy(plan["order"]).to(device)
    lib = _build.load("align_scan")
    packed = torch.empty((B, M, Wa // 4), dtype=torch.uint8, device=device)
    if B == 0 or M == 0:
        return packed
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_align_scan(
            qb.data_ptr(), tb_pad.data_ptr(), m.data_ptr(), n.data_ptr(),
            bw.data_ptr(), packed.data_ptr(),
            None if order is None else order.data_ptr(), B, M, T, Wa, dmin,
            ROUTES[plan["route"]], plan.get("warps", 0),
            plan.get("cpl_max", 0), plan["smem"], stream,
        )
    _build.check(lib, rc, "align_scan launch")
    launches["align_scan"] += 1
    return packed


TB_ROUTES = {"thread": 0, "warp": 1}
TB_STAGES = 2


def tb_slot(rows: int, window: int) -> int:
    """Shared memory of one warp on the traceback's "warp" route (the
    kernel file's `tb_slot`): two stage slots of `rows` rows, each row
    the window and 16 bytes of padding, and the ring of moves."""
    return TB_STAGES * rows * (window + 16) + align_tpu.TB_RING


def traceback_plan(m, n, M: int, Wa: int, L: int, route: str | None = None,
                   warps: int | None = None, rows: int | None = None,
                   window: int | None = None) -> dict:
    """The traceback's launch plan for a batch (m, n: numpy arrays or
    tensors of the real and padded pairs). Raises ValueError on a pair
    whose walk would read past the pointer tensor (m outside 0..M, n
    below 0), as the kernels do not check. The route is "warp", which
    needs Wa a multiple of 64 (the window's rows on 16-byte boundaries;
    `prepare_batch` pads Wa to 128s) and raises on any other; only
    `route="thread"` takes the first design, for the tests and
    `tools/align_ablate.py` to time both. Keys: route, warps (pairs a
    CTA on "warp"; 4, i.e. 128 threads of a pair each, on "thread"),
    smem, and on "warp": rows (a stage's rows, `align_tpu.TB_ROWS`),
    window (bytes a row, `TB_WINDOW`; a power of two, 16..256) and order
    (int32, the pair of each warp slot, -1 for none: the pairs by m + n,
    a bound of their paths, longest first, dealt to the CTAs as the
    scan's are). `warps`, `rows` and `window` override the defaults for
    the tests (small windows, B not a multiple of the warps) and the
    ablation tool; no path of the program sets them."""
    m, n = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                       dtype=np.int64) for x in (m, n))
    if route not in (None, *TB_ROUTES):
        raise ValueError(f"unknown traceback route {route!r}")
    if Wa <= 0 or Wa % 4:
        raise ValueError(f"Wa must be a positive multiple of 4, got {Wa}")
    if L < 0:
        raise ValueError(f"L must be >= 0, got {L}")
    if len(m) and (m.min() < 0 or m.max() > M or n.min() < 0):
        raise ValueError("a pair has m outside 0..M or n below 0")
    if route == "thread":
        return {"route": "thread", "warps": 4, "smem": 0}
    if Wa % 64:
        raise ValueError(f"the warp route needs Wa a multiple of 64, got {Wa}")
    rows = align_tpu.TB_ROWS if rows is None else rows
    window = align_tpu.TB_WINDOW if window is None else window
    if not (1 <= rows <= 256 and window in (16, 32, 64, 128, 256)):
        raise ValueError(f"no warp-route window of {window} bytes for "
                         f"{rows} rows a stage")
    slot = tb_slot(rows, window)
    fit = max(1, min(MAX_WARPS_PER_CTA, -(-len(m) // SMS), MAX_SMEM // slot))
    if warps is None:
        warps = fit
    elif not 1 <= warps <= min(MAX_WARPS_PER_CTA, MAX_SMEM // slot):
        raise ValueError(f"{warps} warps a CTA do not fit")
    return {"route": "warp", "warps": warps, "rows": rows, "window": window,
            "smem": warps * slot, "order": _snake_order(m + n, warps)}


def traceback_cuda(
    packed: torch.Tensor,  # [B, M, Wa // 4] uint8
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    M: int,
    Wa: int,
    dmin: int,
    L: int,
    plan: dict | None = None,
) -> torch.Tensor:
    """Move streams [B, L] uint8 (0 diag, 1 up, 2 left, 3 done), on the
    route of `plan` (`traceback_plan`; made here from m and n, which
    costs a copy to the host, when None). The plan's order may be a
    numpy array or a tensor already on the card."""
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"traceback_cuda needs CUDA tensors, got {device}")
    if packed.dim() != 3:
        raise ValueError(f"packed must be [B, M, Wa // 4], got {packed.shape}")
    B = packed.shape[0]
    if Wa <= 0 or Wa % 4:
        raise ValueError(f"Wa must be a positive multiple of 4, got {Wa}")
    _check(packed, "packed", torch.uint8, (B, M, Wa // 4), device)
    for name, t in (("m", m), ("n", n)):
        _check(t, name, torch.int32, (B,), device)
    if L < 0:
        raise ValueError(f"L must be >= 0, got {L}")
    if plan is None:
        plan = traceback_plan(m, n, M, Wa, L)
    if plan.get("route") not in TB_ROUTES:
        raise ValueError(f"not a traceback plan: {plan}")
    order = None
    if plan["route"] == "warp":
        if len(plan["order"]) != -(-B // plan["warps"]) * plan["warps"]:
            raise ValueError(f"the plan's order is not of B = {B} pairs")
        order = torch.as_tensor(plan["order"], device=device)
    lib = _build.load("align_scan")
    moves = torch.empty((B, L), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_align_traceback(
            packed.data_ptr(), m.data_ptr(), n.data_ptr(), moves.data_ptr(),
            None if order is None else order.data_ptr(), B, M, Wa, dmin, L,
            TB_ROUTES[plan["route"]], plan["warps"], plan.get("rows", 0),
            plan.get("window", 0), plan["smem"], stream,
        )
    _build.check(lib, rc, "align_traceback launch")
    if B and L:
        launches["align_traceback"] += 1
        traceback_routes[plan["route"]] += 1
    return moves


def replay_cuda(
    moves: torch.Tensor,  # [B, L] uint8
    qb: torch.Tensor,  # [B, M] uint8
    tb_pad: torch.Tensor,  # [B, T] uint8
    m: torch.Tensor,  # [B] int32
    n: torch.Tensor,  # [B] int32
    dmin: int,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gapped rows gq, gt [B, L] uint8 and path lengths plen [B]
    int32 of the move streams, by the kernel: views of one buffer of
    `align_tpu.replay_bytes(B, L)` bytes (`out` where given), so that
    one copy brings all three to the host."""
    device = moves.device
    if device.type != "cuda":
        raise ValueError(f"replay_cuda needs CUDA tensors, got {device}")
    if moves.dim() != 2 or qb.dim() != 2 or tb_pad.dim() != 2:
        raise ValueError("moves, qb and tb_pad must be [B, L], [B, M] and "
                         "[B, T]")
    (B, L), M, T = moves.shape, qb.shape[1], tb_pad.shape[1]
    if min(L, M, T) < 1:
        raise ValueError(f"L, M and T must be >= 1, got {L}, {M}, {T}")
    _check(moves, "moves", torch.uint8, (B, L), device)
    _check(qb, "qb", torch.uint8, (B, M), device)
    _check(tb_pad, "tb_pad", torch.uint8, (B, T), device)
    for name, t in (("m", m), ("n", n)):
        _check(t, name, torch.int32, (B,), device)
    if out is None:
        out = torch.empty(align_tpu.replay_bytes(B, L), dtype=torch.uint8,
                          device=device)
    _check(out, "out", torch.uint8, (align_tpu.replay_bytes(B, L),), device)
    gq, gt, plen = align_tpu.replay_views(out, B, L)
    lib = _build.load("align_scan")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_align_replay(
            moves.data_ptr(), qb.data_ptr(), tb_pad.data_ptr(), m.data_ptr(),
            n.data_ptr(), gq.data_ptr(), gt.data_ptr(), plen.data_ptr(), B, M,
            T, L, dmin, stream,
        )
    _build.check(lib, rc, "align_replay launch")
    if B:
        launches["align_replay"] += 1
    return gq, gt, plen
