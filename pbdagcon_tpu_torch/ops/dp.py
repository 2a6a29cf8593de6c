"""Batched consensus DP: reverse banded max-plus scan + long-edge
register file (port of `pbdagcon_tpu/ops/dp.py`).

Same contract as the JAX package's `dp.dp_scores`: edges of span <= W
sit in the dense band `win_count[B, V, W]`, edges into the exit in
`exit_count[B, V]`, and up to K longer edges per target in `(u, w, esc)`
registers. The reverse scan latches `esc + score[w]` when it emits
`score[w]` and folds the register when it reaches `u`. Every candidate
is the same float32 sum as the host DP's and f32 max is exact, so the
scores are bitwise equal to the host engine's (SPEC.md §3.1).

`dp_scores` is the dispatcher: a CUDA tensor goes to the hand-written
kernel (`ops/dp_cuda.py`), which raises if it cannot run; a CPU tensor
goes to the plain PyTorch version `dp_scores_reference`. There is no
fallback from one to the other.

The numpy helpers (`choose_layout`, `pad_batch`, `arena_layout`) are
ports of the JAX package's, without jax. The TPU-link workarounds
(score compression, the edge-CSR arena, the int8 squeeze, the `xla`
backend's routing of narrow-band batches through the blocked solve) are
left out: on a directly attached card the arena is one pinned-memory
copy. The `blocked` backend's routing is `submit_arena_scores(...,
blocked=True)` (`ops/dp_blocked.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from pbdagcon_tpu_torch.convert import batch_to_torch
from pbdagcon_tpu_torch.ops.linearize import LinearGraph, edge_escores

NEG_INF = float("-inf")
_PENALTY = -10.0
# Names of `dp_scores`'s arguments in a packed batch, in call order.
DP_ARGS = (
    "win_count", "exit_count", "cov", "unsup", "long_u", "long_w", "long_esc",
)


class LongEdgeOverflow(ValueError):
    """Raised when a target has more than K long edges (host fallback)."""


def _edge_spans(lin: LinearGraph) -> np.ndarray:
    """Spans (w - u) of interior CSR edges (exit edges excluded)."""
    u_of_edge = np.repeat(
        np.arange(lin.n, dtype=np.int32), np.diff(lin.edge_off)
    )
    interior = lin.edge_tgt < lin.n
    return (lin.edge_tgt - u_of_edge)[interior]


def choose_layout(
    lins: list[LinearGraph],
    w_ladder: tuple[int, ...] = (16, 32, 64, 128),
    k_ladder: tuple[int, ...] = (8, 32, 128),
) -> tuple[int, int]:
    """Pick the (W, K) bucket minimizing the per-node cost `2W + K/2`;
    K is the smallest ladder entry covering the worst per-target
    long-edge count at that W."""
    spans = [_edge_spans(lin) for lin in lins]
    best: tuple[int, int] | None = None
    best_cost = None
    for W in w_ladder:
        worst = max((int((s > W).sum()) for s in spans), default=0)
        K = next((k for k in k_ladder if k >= worst), None)
        if K is None:
            continue
        cost = 2 * W + K / 2
        if best_cost is None or cost < best_cost:
            best, best_cost = (W, K), cost
    if best is None:
        raise LongEdgeOverflow(
            "no (W, K) bucket fits; host fallback required"
        )
    return best


def pad_batch(
    lins: list[LinearGraph], V: int, W: int, K: int
) -> dict[str, np.ndarray]:
    """Pack linear graphs into padded batch arrays for `dp_scores`.

    Edges with span <= W go to the dense band; the rest become long-edge
    triples with host-precomputed esc. Raises `LongEdgeOverflow` if a
    target has more than K long edges or counts beyond int16, and
    `ValueError` if n > V.
    """
    B = len(lins)
    win = np.full((B, V, W), -1, dtype=np.int16)
    exit_c = np.full((B, V), -1, dtype=np.int16)
    cov = np.zeros((B, V), dtype=np.int16)
    uns = np.zeros((B, V), dtype=bool)
    lu = np.full((B, K), -1, dtype=np.int32)
    lw = np.full((B, K), -1, dtype=np.int32)
    lesc = np.full((B, K), NEG_INF, dtype=np.float32)
    n = np.zeros(B, dtype=np.int32)
    for b, lin in enumerate(lins):
        if lin.n > V:
            raise ValueError(f"target {lin.sid}: n={lin.n} > bucket V={V}")
        if (
            int(lin.cov.max(initial=0)) > 32000
            or int(lin.exit_count.max(initial=0)) > 32000
            or int(lin.edge_cnt.max(initial=0)) > 32000
        ):
            raise LongEdgeOverflow(
                f"target {lin.sid}: counts exceed int16 wire format"
            )
        interior = lin.edge_tgt < lin.n
        u_all = np.repeat(
            np.arange(lin.n, dtype=np.int32), np.diff(lin.edge_off)
        )
        u_e = u_all[interior]
        w_e = lin.edge_tgt[interior]
        c_e = lin.edge_cnt[interior]
        d = w_e - u_e - 1
        band = d < W
        win[b, u_e[band], d[band]] = c_e[band]
        nlong = int((~band).sum())
        if nlong > K:
            raise LongEdgeOverflow(
                f"target {lin.sid}: {nlong} > {K} long edges at W={W}"
            )
        if nlong:
            lu[b, :nlong] = u_e[~band]
            lw[b, :nlong] = w_e[~band]
            lesc[b, :nlong] = edge_escores(lin, w_e[~band], c_e[~band])
        exit_c[b, : lin.n] = lin.exit_count
        cov[b, : lin.n] = lin.cov
        uns[b, : lin.n] = lin.unsup
        n[b] = lin.n
    return {
        "win_count": win,
        "exit_count": exit_c,
        "cov": cov,
        "unsup": uns,
        "long_u": lu,
        "long_w": lw,
        "long_esc": lesc,
        "n": n,
    }


def random_batch(rng, B: int, V: int, W: int, K: int) -> dict:
    """Random DP inputs in the packer's layout, from a numpy Generator:
    ~45% band slots set, -1 gaps, unsup nodes, rows past each target's
    n empty, and up to K long edges (u < w, span > W) with half-integer
    esc. For holding the DP's forms against each other."""
    n = rng.integers(V // 2, V + 1, size=B)
    win = np.where(
        rng.random((B, V, W)) < 0.45,
        rng.integers(0, 60, size=(B, V, W)), -1,
    ).astype(np.int16)
    exit_c = np.where(
        rng.random((B, V)) < 0.1, rng.integers(0, 40, size=(B, V)), -1
    ).astype(np.int16)
    cov = rng.integers(0, 80, size=(B, V)).astype(np.int16)
    unsup = rng.random((B, V)) < 0.15
    lu = np.full((B, K), -1, np.int32)
    lw = np.full((B, K), -1, np.int32)
    lesc = np.full((B, K), -np.inf, np.float32)
    for b in range(B):
        nb = int(n[b])
        win[b, nb:] = -1
        exit_c[b, nb:] = -1
        cov[b, nb:] = 0
        unsup[b, nb:] = False
        nl = int(rng.integers(0, K + 1))
        if nb > W + 2:
            u = rng.integers(0, nb - W - 1, size=nl)
            w = np.minimum(u + W + 1 + rng.integers(0, 3 * W, size=nl), nb - 1)
            lu[b, :nl] = u
            lw[b, :nl] = w
            lesc[b, :nl] = rng.integers(-60, 60, size=nl) / 2.0
    return {
        "win_count": win, "exit_count": exit_c, "cov": cov,
        "unsup": unsup, "long_u": lu, "long_w": lw, "long_esc": lesc,
    }


def edge_batches(rng, B: int, V: int, W: int, K: int) -> dict[str, dict]:
    """Named DP batches (the `random_batch` layout) at the edges of the
    kernel's scan order: targets whose last candidate lies far below V
    or on row V-1, targets whose only candidates below the top are long
    edges, long edges of span exactly W + 1 and short registers (lw <=
    lu + 8, which no packer makes), unsup on every node (so every d = 0
    term is the penalty), all-empty targets, and equal counts
    everywhere (ties between near and far terms)."""
    out = {}
    b = random_batch(rng, B, V, W, K)
    n = rng.integers(1, max(2, V // 8), size=B)
    for t in range(B):
        b["win_count"][t, n[t]:] = -1
        b["exit_count"][t, n[t]:] = -1
        keep = (b["long_u"][t] < n[t]) & (b["long_w"][t] < n[t])
        b["long_u"][t, ~keep] = -1
        b["long_w"][t, ~keep] = -1
        b["long_esc"][t, ~keep] = -np.inf
    out["far_below"] = b
    b = random_batch(rng, B, V, W, K)
    b["win_count"][:, -1, :] = rng.integers(0, 9, size=(B, W))
    b["exit_count"][:, -1] = 3
    out["last_row"] = b
    b = random_batch(rng, B, V, W, K)
    b["win_count"][:] = -1
    b["exit_count"][:] = -1
    b["exit_count"][:, V - 1] = 7
    if K and V > W + 1:
        u = rng.integers(0, V - W - 1, size=(B, K))
        b["long_u"][:] = u
        b["long_w"][:] = np.minimum(u + W + 1 + rng.integers(0, 4, (B, K)), V - 1)
        b["long_esc"][:] = rng.integers(-20, 20, size=(B, K)) / 2.0
    out["long_only"] = b
    b = random_batch(rng, B, V, W, K)
    if K and V > W + 1:
        u = rng.integers(0, V - W - 1, size=(B, K))
        b["long_u"][:] = u
        b["long_w"][:] = u + W + 1
        b["long_esc"][:] = rng.integers(-20, 20, size=(B, K)) / 2.0
    out["span_w_plus_1"] = b
    b = random_batch(rng, B, V, W, K)
    if K and V > 9:
        u = rng.integers(0, V - 9, size=(B, K))
        b["long_u"][:] = u
        b["long_w"][:] = u + rng.integers(-2, 10, size=(B, K))
        b["long_esc"][:] = rng.integers(-20, 20, size=(B, K)) / 2.0
    out["short_registers"] = b
    b = random_batch(rng, B, V, W, K)
    b["unsup"][:] = True
    out["unsup_all"] = b
    b = random_batch(rng, B, V, W, K)
    b["win_count"][:] = -1
    b["exit_count"][:] = -1
    b["long_u"][:] = -1
    b["long_w"][:] = -1
    b["long_esc"][:] = -np.inf
    b["win_count"][B // 2, V // 3, :] = 4  # one target with candidates
    out["empty"] = b
    b = random_batch(rng, B, V, W, K)
    b["win_count"][:] = np.where(b["win_count"] >= 0, 5, -1)
    b["exit_count"][:] = np.where(b["exit_count"] >= 0, 5, -1)
    b["cov"][:] = 0
    b["unsup"][:] = False
    b["long_esc"][:] = np.where(b["long_u"] >= 0, 5.0, -np.inf)
    out["ties"] = b
    return out


def arena_layout(B: int, V: int, W: int, K: int) -> dict:
    """Byte offsets of the single-buffer batch arena: one host->device
    copy per dispatch. All offsets 4-byte aligned."""
    off = {}
    o = 0

    def take(name, nbytes):
        nonlocal o
        off[name] = (o, o + nbytes)
        o += -(-nbytes // 4) * 4  # keep 4-byte alignment

    take("win_count", B * V * W * 2)
    take("exit_count", B * V * 2)
    take("cov", B * V * 2)
    take("unsup", B * V)
    take("long_u", B * K * 4)
    take("long_w", B * K * 4)
    take("long_esc", B * K * 4)
    off["_total"] = o
    return off


_ARENA_DTYPES = (
    np.int16, np.int16, np.int16, np.uint8, np.int32, np.int32, np.float32,
)


def to_arena(batch: dict) -> np.ndarray:
    """The seven DP arrays of a packed batch (`pad_batch`,
    `random_batch`) in one uint8 arena laid out by `arena_layout`, as the
    native packer writes it."""
    B, V, W = batch["win_count"].shape
    K = batch["long_u"].shape[1]
    off = arena_layout(B, V, W, K)
    arena = np.zeros(off["_total"], np.uint8)
    for k, dt in zip(DP_ARGS, _ARENA_DTYPES):
        a, b = off[k]
        arena[a:b] = np.ascontiguousarray(batch[k]).astype(dt).view(np.uint8).ravel()
    return arena


def unpack_arena(
    arena: torch.Tensor, B: int, V: int, W: int, K: int
) -> tuple[torch.Tensor, ...]:
    """The seven `dp_scores` arguments as views of a uint8 arena (on any
    device) laid out by `arena_layout`; `unsup` stays uint8."""
    off = arena_layout(B, V, W, K)

    def view(name, dtype, shape):
        a, b = off[name]
        return arena[a:b].view(dtype).view(shape)

    return (
        view("win_count", torch.int16, (B, V, W)),
        view("exit_count", torch.int16, (B, V)),
        view("cov", torch.int16, (B, V)),
        view("unsup", torch.uint8, (B, V)),
        view("long_u", torch.int32, (B, K)),
        view("long_w", torch.int32, (B, K)),
        view("long_esc", torch.float32, (B, K)),
    )


def dp_scores_reference(
    win_count: torch.Tensor,  # [B, V, W] int16/int32, -1 = no edge
    exit_count: torch.Tensor,  # [B, V] int16/int32, -1 = no edge
    cov: torch.Tensor,  # [B, V] int16/int32
    unsup: torch.Tensor,  # [B, V] bool/uint8
    long_u: torch.Tensor,  # [B, K] int32, -1 = unused slot
    long_w: torch.Tensor,  # [B, K] int32
    long_esc: torch.Tensor,  # [B, K] float32
) -> torch.Tensor:
    """Plain PyTorch version of the DP: a reverse loop over V with
    [B, W] tensor ops. Returns scores [B, V] f32 on the inputs' device.

    The score, cov and unsup windows are views into [B, V + W] buffers
    whose tail past V holds the scan's initial values (-inf, 0, False),
    so window d of node i is node i + 1 + d."""
    B, V, W = win_count.shape
    dev = win_count.device
    wc_all = win_count.to(torch.int32)
    esc_exit = torch.where(
        exit_count >= 0,
        exit_count.to(torch.float32),
        torch.full((), NEG_INF, device=dev),
    )
    score = torch.full((B, V + W), NEG_INF, dtype=torch.float32, device=dev)
    covf = torch.zeros((B, V + W), dtype=torch.float32, device=dev)
    covf[:, :V] = cov.to(torch.float32)
    uns = torch.zeros((B, V + W), dtype=torch.bool, device=dev)
    uns[:, :V] = unsup.to(torch.bool)
    pend = torch.full(long_u.shape, NEG_INF, dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    pen = torch.full((), _PENALTY, dtype=torch.float32, device=dev)
    has_long = long_u.shape[1] > 0
    for i in range(V - 1, -1, -1):
        wc = wc_all[:, i, :]
        esc = torch.where(
            wc >= 0,
            torch.where(
                uns[:, i + 1 : i + 1 + W],
                pen,
                wc.to(torch.float32) - 0.5 * covf[:, i + 1 : i + 1 + W],
            ),
            neg,
        )
        s = torch.amax(esc + score[:, i + 1 : i + 1 + W], dim=1)
        s = torch.maximum(s, esc_exit[:, i])
        if has_long:
            # Fold long edges leaving i, then latch those arriving at i.
            s = torch.maximum(
                s, torch.amax(torch.where(long_u == i, pend, neg), dim=1)
            )
            pend = torch.where(long_w == i, long_esc + s[:, None], pend)
        score[:, i] = s
    return score[:, :V].contiguous()


def start_rows(
    win_count: torch.Tensor,
    exit_count: torch.Tensor,
    long_u: torch.Tensor,
) -> torch.Tensor:
    """[B] int64: each target's last row with a candidate (a band slot
    >= 0, an exit >= 0, or a long edge leaving it), -1 if it has none.
    Every row above it scores -inf. `csrc/dp_scan.cu` finds it with a
    backward sweep over the band and exit before its scan."""
    B, V, _ = win_count.shape
    rows = torch.arange(V, device=win_count.device)
    has = (win_count >= 0).any(dim=2) | (exit_count >= 0)
    top = torch.where(has, rows, -1).amax(dim=1) if V else rows.new_full((B,), -1)
    lu = long_u.to(torch.int64)
    lu = torch.where((lu >= 0) & (lu < V), lu, -1)
    if lu.shape[1]:
        top = torch.maximum(top, lu.amax(dim=1))
    return top


def kernel_d0(W: int) -> int:
    """The near/far split that `csrc/dp_scan.cu` runs at band width W:
    every band term near at W = 16 (the bench batch's band), else the
    first 8."""
    return 16 if W == 16 else 8


def dp_scores_split_model(
    win_count: torch.Tensor,
    exit_count: torch.Tensor,
    cov: torch.Tensor,
    unsup: torch.Tensor,
    long_u: torch.Tensor,
    long_w: torch.Tensor,
    long_esc: torch.Tensor,
    d0: int = 4,
) -> torch.Tensor:
    """Plain PyTorch model of the order in which `csrc/dp_scan.cu`
    computes the scores (CPU, for the tests): bitwise the same function
    as `dp_scores_reference`, regrouped.

    - Each target starts at `start_rows`, rounded up to a group of `d0`
      rows (rows at or past V read as empty); rows above score -inf.
    - s[i] = max(near(i), far(i)). near(i) holds the band terms d < d0,
      from a window of the last d0 scores; only d = 0 waits on s[i+1].
    - far(i) holds the exit, the band terms d >= d0 and the long edges
      leaving i. It is computed d0 rows early, at row i + d0, from the
      scores and latches of that moment. (The kernel, at `kernel_d0(W)`
      >= 8, computes it a group of 4 rows early, so that its warp
      reduction has a group to land; the latches it sees beyond the
      model's are short registers', whose terms near holds too.)
    - A "short" long edge (lu < lw <= lu + d0) is not latched in time
      for that, so its esc joins band term d = lw - lu - 1 of near(lu)
      instead: max(a + s, b + s) == max(a, b) + s in round-to-nearest.
    """
    B, V, W = win_count.shape
    dev = win_count.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    pen = torch.full((), _PENALTY, dtype=torch.float32, device=dev)
    if not 1 <= d0 <= W:
        raise ValueError(f"d0={d0} must be in [1, W={W}]")
    top = start_rows(win_count, exit_count, long_u)
    # rows 0 .. Vp-1 with Vp a multiple of d0; rows >= V are empty.
    Vp = -(-max(V, 1) // d0) * d0
    wc = torch.full((B, Vp, W), -1, dtype=torch.int32, device=dev)
    wc[:, :V] = win_count.to(torch.int32)
    ex = torch.full((B, Vp), NEG_INF, dtype=torch.float32, device=dev)
    ex[:, :V] = torch.where(exit_count >= 0, exit_count.to(torch.float32), neg)
    covf = torch.zeros((B, Vp + W), dtype=torch.float32, device=dev)
    covf[:, :V] = cov.to(torch.float32)
    uns = torch.zeros((B, Vp + W), dtype=torch.bool, device=dev)
    uns[:, :V] = unsup.to(torch.bool)
    # esc of every band slot, -inf where there is no edge
    idx = (torch.arange(Vp, device=dev)[:, None] + 1
           + torch.arange(W, device=dev)[None, :])
    h = covf[:, idx]
    esc = torch.where(
        wc >= 0, torch.where(uns[:, idx], pen, wc.to(torch.float32) - 0.5 * h),
        neg,
    )
    lu = long_u.to(torch.int64)
    lw = long_w.to(torch.int64)
    K = lu.shape[1]
    short = (lu >= 0) & (lu < V) & (lw > lu) & (lw <= lu + d0)
    for b, k in short.nonzero().tolist():
        u, d = int(lu[b, k]), int(lw[b, k] - lu[b, k] - 1)
        esc[b, u, d] = torch.maximum(esc[b, u, d], long_esc[b, k])
    # first processed row: the start row rounded up to a group end
    first = torch.where(top >= 0, (top // d0 + 1) * d0 - 1, -1)
    score = torch.full((B, Vp + W), NEG_INF, dtype=torch.float32, device=dev)
    pend = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    far = {}

    def far_of(k: int) -> torch.Tensor:
        """far(k) from the scores and latches as they are now."""
        f = ex[:, k]
        if W > d0:
            f = torch.maximum(
                f, torch.amax(esc[:, k, d0:] + score[:, k + 1 + d0: k + 1 + W], 1)
            )
        if K:
            f = torch.maximum(f, torch.amax(torch.where(lu == k, pend, neg), 1))
        return f

    for i in range(Vp - 1, -1, -1):
        active = i <= first
        # the far terms of the rows d0 below start now; a group's top
        # rows (at a target's first row) start theirs at the group start
        if i + d0 >= Vp:
            far[i] = far_of(i)
        if i - d0 >= 0:
            far[i - d0] = far_of(i - d0)
        m = far.pop(i)
        for d in range(d0 - 1, 0, -1):
            m = torch.maximum(m, esc[:, i, d] + score[:, i + 1 + d])
        s = torch.maximum(m, esc[:, i, 0] + score[:, i + 1])
        s = torch.where(active, s, neg)
        if K:
            pend = torch.where(lw == i, long_esc + s[:, None], pend)
        score[:, i] = s
    return score[:, :V].contiguous()


def dp_scores(
    win_count: torch.Tensor,
    exit_count: torch.Tensor,
    cov: torch.Tensor,
    unsup: torch.Tensor,
    long_u: torch.Tensor,
    long_w: torch.Tensor,
    long_esc: torch.Tensor,
) -> torch.Tensor:
    """Scores [B, V] f32: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Raises for any other device."""
    args = (win_count, exit_count, cov, unsup, long_u, long_w, long_esc)
    kind = win_count.device.type
    if kind == "cuda":
        from pbdagcon_tpu_torch.ops.dp_cuda import dp_scores_cuda

        return dp_scores_cuda(*args)
    if kind == "cpu":
        return dp_scores_reference(*args)
    raise ValueError(f"no DP for device {win_count.device}")


def batch_scores(
    lins: list[LinearGraph], V: int, W: int, K: int, device
) -> np.ndarray:
    """Pack + run the DP for one bucket; returns [B, V] f32 on the host."""
    t = batch_to_torch(pad_batch(lins, V, W, K), device)
    return dp_scores(*(t[k] for k in DP_ARGS)).cpu().numpy()


class ScoresFuture:
    """Scores of one dispatched batch. `result()` waits for the batch's
    CUDA event (if any) and returns [B, V] f32 as numpy. `reruns`: the
    rows that the blocked solve flagged and the scan re-ran."""

    def __init__(self, host: torch.Tensor, event=None, reruns: int = 0):
        self._host = host
        self._event = event
        self.reruns = reruns

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _submit(args, device: torch.device, blocked: bool) -> ScoresFuture:
    """Run the DP on `args` (on `device`) and start the copy of the
    scores back. With `blocked` (the caller checked
    `dp_blocked.blocked_eligible`), the blocked solve takes the batch and
    its flagged rows re-run through `dp_scores`; it waits on the device
    after each of its solves."""
    if blocked:
        from pbdagcon_tpu_torch.ops.dp_blocked import _blocked_L, blocked_scores

        s, reruns = blocked_scores(*args, L=_blocked_L(args[0].shape[1]))
    else:
        s, reruns = dp_scores(*args), 0
    if device.type != "cuda":
        return ScoresFuture(s, reruns=reruns)
    host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
    host.copy_(s, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ScoresFuture(host, ev, reruns)


def submit_arena_scores(
    arena: torch.Tensor, dims: tuple[int, int, int, int], device,
    blocked: bool = False,
) -> ScoresFuture:
    """Upload a packed arena (pinned host memory for CUDA), run the DP
    and start the copy of the scores back, all on the current stream.
    Nothing waits here (but the blocked solve, see `_submit`); the
    future's `result()` does."""
    B, V, W, K = dims
    device = torch.device(device)
    if device.type == "cuda":
        arena = arena.to(device, non_blocking=True)
    return _submit(unpack_arena(arena, B, V, W, K), device, blocked)


def submit_batch_scores(
    batch: dict[str, np.ndarray], device, blocked: bool = False
) -> ScoresFuture:
    """`submit_arena_scores` for a packed batch of numpy arrays
    (`pad_batch`)."""
    device = torch.device(device)
    t = batch_to_torch(batch, device)
    return _submit([t[k] for k in DP_ARGS], device, blocked)
