"""Wrappers of kernel X2, the hand-written Hopper blocked max-plus solve
(`csrc/dp_blocked.cu`).

`compose_cuda`, `propagate_cuda` and `fill_cuda` replace the three
scans of `pbdagcon_tpu/ops/dp_blocked.py::_solve_band` (and the
shard-local compose and fill of `pbdagcon_tpu/parallel/colshard.py`);
`solve_band_cuda` runs the three in order. The contract is the plain
PyTorch version `ops/dp_blocked.py::_solve_band`, integer-equal. No
wrapper falls back to it: each checks what it is given, raises on
anything the kernels do not take, and raises if the build or the launch
fails. They launch on the current stream without synchronising; every
output is `torch.empty` (every element is written).

The compose has two routes, chosen by `compose_plan`: "column" (a thread
per column of one block's M, the column in registers; W in
COLUMN_WIDTHS, L a multiple of W) wherever it fits, else "cta" (a CTA
per block, the first design). The propagate has two, chosen by
`propagate_plan`: "warp" (a producer and a consumer warp per target, M
streamed through a ring of shared-memory slots of `chunk` matrices) for
every W, and "cta" (a CTA per target) only where a plan forces it. The
fill has two, chosen by `fill_plan`: "lane" (a lane per pending row, the
newest score passed by one shuffle; `blocks` blocks a warp at W <= 16)
for every W, and "reduce" (a warp per block, a warp reduction a step)
only where a plan forces it. Each C entry checks its plan and refuses
one it does not take.

`launches` counts each kernel's launches by name ("blocked_compose",
"blocked_propagate", "blocked_fill"); `compose_routes`,
`propagate_routes` and `fill_routes` count the three kernels' launches
by route, and `route_widths` by (kernel, route, W).
"""

from __future__ import annotations

import functools

import torch

from pbdagcon_tpu_torch.ops import _build

launches = {"blocked_compose": 0, "blocked_propagate": 0, "blocked_fill": 0}
# Each kernel's launches by route, and all three by (kernel, route, W).
compose_routes = {"cta": 0, "column": 0}
propagate_routes = {"cta": 0, "warp": 0}
fill_routes = {"reduce": 0, "lane": 0}
route_widths: dict[tuple[str, str, int], int] = {}

MAX_W = 128
MAX_L = 128
# One CTA's shared memory on Hopper.
MAX_SMEM = 232_448
SMS = 132

COMPOSE_ROUTES = {"cta": 0, "column": 1}
PROPAGATE_ROUTES = {"cta": 0, "warp": 1}
FILL_ROUTES = {"reduce": 0, "lane": 1}
# The column route's widths (the kernel's template instances) and its
# limits: threads a CTA, blocks a CTA, and the shared memory an unforced
# plan gives a CTA: small CTAs, many an SM, so that one CTA's copies
# overlap the others' steps (on an H100, 1-3 blocks a CTA ran the bench
# batch ~9% faster than 9 with more lanes busy; `tools/blocked_ablate.py`).
COLUMN_WIDTHS = (16, 32, 64)
COLUMN_MAX_THREADS = 512
COLUMN_MAX_BLOCKS = 32
COLUMN_SMEM_TARGET = 24 * 1024
# The warp route's limits: targets a CTA, two warps each (an unforced
# plan takes at most PROP_WARPS), matrices a ring slot (PROP_CHUNK, fewer
# where two slots would not fit) and slots a target (PROP_DEPTH).
PROP_MAX_WARPS = 8
PROP_WARPS = 4
PROP_MAX_CHUNK = 32
PROP_CHUNK = 8
PROP_MAX_DEPTH = 64
PROP_DEPTH = 4
# The fill's routes: warps a CTA of "reduce" (the kernel file's
# FILL_WARPS); of "lane", at most LANE_WARPS in an unforced plan (the
# kernel takes 8), each with at most LANE_WARP_TARGET bytes of shared
# memory where it packs several blocks.
FILL_WARPS = 4
LANE_WARPS = 4
LANE_WARP_TARGET = 32 * 1024


def _staged_bytes(W: int, L: int) -> int:
    """One block's raw inputs staged in shared memory (the kernel file's
    `staged_bytes`)."""
    return L * 4 + (L * W + L + W) * 2 + -(-(L + W) // 16) * 16


def compose_smem(W: int, L: int) -> int:
    """Dynamic shared memory of the compose's CTA: the block's L rows of
    a, W + 2 rows of M and the staged block (the kernel file's
    `dagcon_blocked_compose_smem`)."""
    return (L * (W + 1) + (W + 2) * (W + 1)) * 4 + _staged_bytes(W, L)


def fill_smem(W: int, L: int) -> int:
    """Four warps' window rings, scores and staged blocks: the "reduce"
    route's CTA (`dagcon_blocked_fill_smem`)."""
    return FILL_WARPS * _r16((W + L) * 4 + _staged_bytes(W, L))


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def lane_rows(W: int) -> int:
    """Slots (pending rows) a lane of the fill's lane route: the kernel's
    template R."""
    return 1 if W <= 32 else (2 if W <= 64 else 4)


def lane_max_blocks(W: int) -> int:
    """Blocks a warp of the lane route can hold: groups of W lanes up to
    32, one block past it."""
    return 32 // W if W <= 32 else 1


def lane_warp_bytes(W: int, L: int, blocks: int) -> int:
    """Shared memory of one warp of the lane route (the kernel file's
    `lane_warp_bytes`): its blocks' band run (+ up to 14 bytes of
    misalignment), node words (L + W int2 a block, + 4 of padding),
    exits (+ W + 4 to W + 7 ints of padding), x_in and scores (+ 12
    bytes of misalignment), each part whole 16-byte words."""
    nb = blocks
    ex_pad = (W + 7) // 4 * 4
    return (_r16(nb * L * W * 2 + 14) + _r16((nb * (L + W) + 4) * 8)
            + _r16((nb * L + ex_pad) * 4) + _r16(nb * W * 4)
            + _r16(nb * L * 4 + 12))


def _r32(n: int) -> int:
    return -(-n // 32) * 32


def column_smem(W: int, L: int, blocks: int) -> int:
    """Shared memory of a CTA of the column route (the kernel file's
    `col_smem`): each block's a rows (L rows of whole int4, + 16 bytes),
    its raw exit half-units and band, its cov and unsup (L + W each)."""
    a_ints = L * ((W + 4) // 4 * 4) + 4
    return blocks * (a_ints * 4 + L * 4 + L * W * 2 + (L + W) * 3)


def propagate_smem(W: int) -> int:
    """Dynamic shared memory of the propagate's "cta" route: two M_g
    buffers and x (`dagcon_blocked_propagate_smem`)."""
    return (2 * (W + 1) * (W + 1) + (W + 1)) * 4


def prop_slot_ints(W: int, chunk: int) -> int:
    """Ints of one ring slot of the warp route (the kernel file's
    `prop_slot_ints`): the 16-byte-aligned superset of a chunk of
    `chunk` consecutive (W+1)^2-int32 matrices, which starts 0-3 ints
    before it and ends at most 3 past it."""
    return (chunk * (W + 1) ** 2 + 6) // 4 * 4


def prop_warp_bytes(W: int, depth: int, chunk: int) -> int:
    """Shared memory of one target of the warp route (`prop_warp_bytes`):
    `depth` slots, the history of x (depth x chunk vectors of whole
    int4s), an mbarrier a slot and the consumer's step count."""
    xp = (W + 4) // 4 * 4
    return -(-((depth * prop_slot_ints(W, chunk) + depth * chunk * xp) * 4
               + depth * 8 + 16) // 16) * 16


def _column_blocks(B: int, G: int, W: int, L: int) -> int:
    """The blocks a CTA of the column route: the most lanes busy (ties
    to fewer blocks) within COLUMN_SMEM_TARGET and COLUMN_MAX_THREADS,
    and few enough that B * G blocks still make 2 x SMS CTAs where they
    can; 1 where even one block passes the target."""
    cap = max(1, B * G // (2 * SMS))
    best, best_use = 1, 0.0
    for nb in range(1, min(cap, COLUMN_MAX_BLOCKS) + 1):
        threads = _r32(nb * (W + 1))
        if threads > COLUMN_MAX_THREADS or column_smem(W, L, nb) > COLUMN_SMEM_TARGET:
            break
        use = nb * (W + 1) / threads
        if use > best_use:
            best, best_use = nb, use
    return best


def compose_plan(B: int, G: int, W: int, L: int, route: str | None = None,
                 blocks: int | None = None) -> dict:
    """The compose's launch plan (`_compose_plan`, cached: the solve
    asks for it every launch)."""
    return dict(_compose_plan(B, G, W, L, route, blocks))


@functools.lru_cache(maxsize=256)
def _compose_plan(B: int, G: int, W: int, L: int, route: str | None,
                  blocks: int | None) -> dict:
    """The compose's launch plan for B targets of G blocks of L rows at
    band width W. "column" where W is in COLUMN_WIDTHS and L a multiple
    of W, else "cta". `route` forces one and raises ValueError where it
    does not fit; `blocks` forces the blocks a CTA of the column route
    (the tests and `tools/blocked_ablate.py`). Keys: route, blocks (1 on
    "cta"), threads, smem."""
    if route not in (None, *COMPOSE_ROUTES):
        raise ValueError(f"unknown compose route {route!r}")
    if not (1 <= W <= MAX_W and 1 <= L <= MAX_L and G >= 1 and B >= 0):
        raise ValueError(f"no compose for B={B}, G={G}, W={W}, L={L}")
    fits = W in COLUMN_WIDTHS and L % W == 0
    if route == "column" and not fits:
        raise ValueError(f"the column route takes W in {COLUMN_WIDTHS} with L "
                         f"a multiple of W, got W={W}, L={L}")
    if route == "cta" or not fits:
        if blocks not in (None, 1):
            raise ValueError("the cta route takes one block a CTA")
        if compose_smem(W, L) > MAX_SMEM:
            raise ValueError(f"W={W}, L={L} outgrow one CTA's shared memory")
        return {"route": "cta", "blocks": 1, "threads": _r32(W + 1),
                "smem": compose_smem(W, L)}
    if blocks is None:
        blocks = _column_blocks(B, G, W, L)
    threads = _r32(blocks * (W + 1))
    smem = column_smem(W, L, blocks)
    if not (1 <= blocks <= COLUMN_MAX_BLOCKS and threads <= COLUMN_MAX_THREADS
            and smem <= MAX_SMEM):
        raise ValueError(f"{blocks} blocks a CTA do not fit the column route "
                         f"at W={W}, L={L}")
    return {"route": "column", "blocks": blocks, "threads": threads,
            "smem": smem}


def propagate_plan(B: int, G: int, W: int, route: str | None = None,
                   warps: int | None = None, depth: int | None = None,
                   chunk: int | None = None) -> dict:
    """The propagate's launch plan (`_propagate_plan`, cached)."""
    return dict(_propagate_plan(B, G, W, route, warps, depth, chunk))


@functools.lru_cache(maxsize=256)
def _propagate_plan(B: int, G: int, W: int, route: str | None,
                    warps: int | None, depth: int | None,
                    chunk: int | None) -> dict:
    """The propagate's launch plan for B targets of G blocks at band
    width W: "warp" unless `route="cta"` forces the first design.
    `warps` (targets a CTA, a consumer and a producer warp each),
    `chunk` (matrices a ring slot, one bulk copy) and `depth` (slots a
    target; at least 2 where there are two chunks or more, as the
    consumer waits on the next chunk before it releases its own)
    override the defaults, for the tests and `tools/blocked_ablate.py`,
    and raise ValueError where they do not fit. Keys: route, warps,
    depth and chunk (0 on "cta"), smem."""
    if route not in (None, *PROPAGATE_ROUTES):
        raise ValueError(f"unknown propagate route {route!r}")
    if not (1 <= W <= MAX_W and G >= 1 and B >= 0):
        raise ValueError(f"no propagate for B={B}, G={G}, W={W}")
    if route == "cta":
        if any(v not in (None, 0) for v in (warps, depth, chunk)):
            raise ValueError("the cta route takes no warps, depth or chunk")
        return {"route": "cta", "warps": 0, "depth": 0, "chunk": 0,
                "smem": propagate_smem(W)}

    def least(n: int, k: int) -> int:  # bytes of n targets at the least depth
        return n * prop_warp_bytes(W, min(-(-G // k), 2), k)

    if warps is None:
        warps = max(1, min(PROP_WARPS, -(-B // SMS)))
        while warps > 1 and least(warps, 1) > MAX_SMEM:
            warps -= 1
    if chunk is None:
        chunk = max(1, min(PROP_CHUNK, G))
        while chunk > 1 and least(warps, chunk) > MAX_SMEM:
            chunk -= 1
    if not 1 <= chunk <= min(G, PROP_MAX_CHUNK):
        raise ValueError(f"chunks of {chunk} matrices do not fit G={G}")
    nc = -(-G // chunk)
    if depth is None:
        depth = min(nc, 2)
        while (depth < min(nc, PROP_DEPTH)
               and warps * prop_warp_bytes(W, depth + 1, chunk) <= MAX_SMEM):
            depth += 1
    smem = warps * prop_warp_bytes(W, depth, chunk)
    if not (1 <= warps <= PROP_MAX_WARPS
            and min(nc, 2) <= depth <= min(nc, PROP_MAX_DEPTH)
            and smem <= MAX_SMEM):
        raise ValueError(f"{warps} targets of {depth} slots of {chunk} "
                         f"matrices do not fit the warp route at W={W}, G={G}")
    return {"route": "warp", "warps": warps, "depth": depth, "chunk": chunk,
            "smem": smem}


def fill_plan(B: int, G: int, W: int, L: int, route: str | None = None,
              blocks: int | None = None) -> dict:
    """The fill's launch plan (`_fill_plan`, cached)."""
    return dict(_fill_plan(B, G, W, L, route, blocks))


@functools.lru_cache(maxsize=256)
def _fill_plan(B: int, G: int, W: int, L: int, route: str | None,
               blocks: int | None) -> dict:
    """The fill's launch plan for B targets of G blocks of L rows at band
    width W: "lane" unless `route="reduce"` forces the first design.
    `blocks` (blocks a warp of the lane route: up to 32 // W at W <= 32,
    else 1) overrides the packing, for the tests and
    `tools/blocked_ablate.py`, and raises ValueError where it does not
    fit. An unforced plan packs as many blocks a warp as fit
    LANE_WARP_TARGET, and takes up to LANE_WARPS warps a CTA where the
    warps still make two CTAs an SM. Keys: route, blocks (1 on
    "reduce"), warps (a CTA), smem."""
    if route not in (None, *FILL_ROUTES):
        raise ValueError(f"unknown fill route {route!r}")
    if not (1 <= W <= MAX_W and 1 <= L <= MAX_L and G >= 1 and B >= 0):
        raise ValueError(f"no fill for B={B}, G={G}, W={W}, L={L}")
    if route == "reduce":
        if blocks not in (None, 1):
            raise ValueError("the reduce route takes one block a warp")
        if fill_smem(W, L) > MAX_SMEM:
            raise ValueError(f"W={W}, L={L} outgrow one CTA's shared memory")
        return {"route": "reduce", "blocks": 1, "warps": FILL_WARPS,
                "smem": fill_smem(W, L)}
    top = lane_max_blocks(W)
    if blocks is None:
        blocks = top
        while blocks > 1 and lane_warp_bytes(W, L, blocks) > LANE_WARP_TARGET:
            blocks -= 1
    if not 1 <= blocks <= top:
        raise ValueError(f"{blocks} blocks a warp do not fit the lane route "
                         f"at W={W} (1 to {top})")
    nwarps = -(-B * G // blocks)
    warps = max(1, min(LANE_WARPS, nwarps // (2 * SMS)))
    while warps > 1 and warps * lane_warp_bytes(W, L, blocks) > MAX_SMEM:
        warps -= 1
    smem = warps * lane_warp_bytes(W, L, blocks)
    if smem > MAX_SMEM:
        raise ValueError(f"{blocks} blocks a warp outgrow one CTA's shared "
                         f"memory at W={W}, L={L}")
    return {"route": "lane", "blocks": blocks, "warps": warps, "smem": smem}


def _count(kernel: str, routes: dict, route: str, W: int) -> None:
    launches[kernel] += 1
    routes[route] += 1
    key = (kernel, route, W)
    route_widths[key] = route_widths.get(key, 0) + 1


def _check(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(win_count, cov, unsup, e_ex2, L) -> tuple[int, int, int]:
    device = win_count.device
    if device.type != "cuda":
        raise ValueError(f"the blocked solve's kernels need CUDA tensors, got {device}")
    if win_count.dim() != 3:
        raise ValueError(f"win_count must be [B, V, W], got {win_count.shape}")
    B, V, W = win_count.shape
    _check(win_count, "win_count", (torch.int16,), (B, V, W), device)
    _check(cov, "cov", (torch.int16,), (B, V), device)
    _check(unsup, "unsup", (torch.bool, torch.uint8), (B, V), device)
    _check(e_ex2, "e_ex2", (torch.int32,), (B, V), device)
    if not 1 <= W <= MAX_W:
        raise ValueError(f"kernels take 1 <= W <= {MAX_W}, got {W}")
    if not 1 <= L <= MAX_L or V == 0 or V % L:
        raise ValueError(f"kernels take 1 <= L <= {MAX_L} dividing V > 0, got "
                         f"L={L}, V={V}")
    if fill_smem(W, L) > MAX_SMEM:
        raise ValueError(f"W={W}, L={L} outgrow one CTA's shared memory")
    return B, V, W


def compose_cuda(win_count, cov, unsup, e_ex2, L: int,
                 plan: dict | None = None) -> torch.Tensor:
    """Block transfer matrices M [B, V // L, W + 1, W + 1] int32, on the
    route of `plan` (`compose_plan`; made here when None)."""
    B, V, W = _check_band(win_count, cov, unsup, e_ex2, L)
    device = win_count.device
    if plan is None:
        plan = compose_plan(B, V // L, W, L)
    if plan.get("route") not in COMPOSE_ROUTES:
        raise ValueError(f"not a compose plan: {plan}")
    lib = _build.load("dp_blocked")
    M = torch.empty((B, V // L, W + 1, W + 1), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_blocked_compose(
            win_count.data_ptr(), cov.data_ptr(), unsup.data_ptr(),
            e_ex2.data_ptr(), M.data_ptr(), B, V, W, L,
            COMPOSE_ROUTES[plan["route"]], plan["blocks"], plan["threads"],
            plan["smem"], stream,
        )
    _build.check(lib, rc, "blocked_compose launch")
    if B:
        _count("blocked_compose", compose_routes, plan["route"], W)
    return M


def propagate_cuda(M: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """Incoming boundary vectors x_in [B, G, W + 1] int32 of every block
    from the transfer matrices M [B, G, W + 1, W + 1], on the route of
    `plan` (`propagate_plan`; made here when None)."""
    device = M.device
    if device.type != "cuda":
        raise ValueError(f"propagate_cuda needs CUDA tensors, got {device}")
    if M.dim() != 4 or M.shape[2] != M.shape[3]:
        raise ValueError(f"M must be [B, G, W + 1, W + 1], got {M.shape}")
    B, G, Wp, _ = M.shape
    _check(M, "M", (torch.int32,), (B, G, Wp, Wp), device)
    if not 2 <= Wp <= MAX_W + 1 or G == 0:
        raise ValueError(f"kernel takes 1 <= W <= {MAX_W} and G > 0, got "
                         f"W={Wp - 1}, G={G}")
    if plan is None:
        plan = propagate_plan(B, G, Wp - 1)
    if plan.get("route") not in PROPAGATE_ROUTES:
        raise ValueError(f"not a propagate plan: {plan}")
    lib = _build.load("dp_blocked")
    x_in = torch.empty((B, G, Wp), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_blocked_propagate(
            M.data_ptr(), x_in.data_ptr(), B, G, Wp - 1,
            PROPAGATE_ROUTES[plan["route"]], plan["warps"], plan["depth"],
            plan["chunk"], plan["smem"], stream,
        )
    _build.check(lib, rc, "blocked_propagate launch")
    if B:
        _count("blocked_propagate", propagate_routes, plan["route"], Wp - 1)
    return x_in


def fill_cuda(win_count, cov, unsup, e_ex2, x_in, L: int,
              plan: dict | None = None) -> torch.Tensor:
    """Half-unit scores s2 [B, V] int32 of every block's interior from
    its incoming boundary x_in [B, V // L, W + 1], on the route of `plan`
    (`fill_plan`; made here when None)."""
    B, V, W = _check_band(win_count, cov, unsup, e_ex2, L)
    device = win_count.device
    _check(x_in, "x_in", (torch.int32,), (B, V // L, W + 1), device)
    if plan is None:
        plan = fill_plan(B, V // L, W, L)
    if plan.get("route") not in FILL_ROUTES:
        raise ValueError(f"not a fill plan: {plan}")
    lib = _build.load("dp_blocked")
    s2 = torch.empty((B, V), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dagcon_blocked_fill(
            win_count.data_ptr(), cov.data_ptr(), unsup.data_ptr(),
            e_ex2.data_ptr(), x_in.data_ptr(), s2.data_ptr(), B, V, W, L,
            FILL_ROUTES[plan["route"]], plan["blocks"], plan["warps"],
            plan["smem"], stream,
        )
    _build.check(lib, rc, "blocked_fill launch")
    if B:
        _count("blocked_fill", fill_routes, plan["route"], W)
    return s2


def solve_band_cuda(
    win_count: torch.Tensor,  # [B, V, W] int16, -1 = no edge
    cov: torch.Tensor,  # [B, V] int16
    unsup: torch.Tensor,  # [B, V] bool or uint8
    e_ex2: torch.Tensor,  # [B, V] int32 half-units
    L: int,
) -> torch.Tensor:
    """Half-unit scores [B, V] int32 of one banded solve: compose,
    propagate, fill, each on its unforced plan."""
    M = compose_cuda(win_count, cov, unsup, e_ex2, L)
    x_in = propagate_cuda(M)
    return fill_cuda(win_count, cov, unsup, e_ex2, x_in, L)
