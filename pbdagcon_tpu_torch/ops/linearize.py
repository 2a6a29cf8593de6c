"""Graph linearization (SPEC.md §3.1) + exact host backtrack/emission.

Converts a merged `AlnGraph` into fixed-shape banded arrays the device DP
consumes, and provides the bit-parity-critical host-side steps around the
device DP:

- `linearize(graph)`  -> `LinearGraph`: per-node arrays + creation-order
  CSR out-edge lists (numpy; zero-copy compatible with the native C++
  loader's export).
- `backtrack(lin, scores)` -> best path by the reference's tie-break rule
  (first strict max in edge creation order, SPEC.md §2.6), using device
  scores. Because float32 `max` is exact, device scores are bitwise equal
  to the oracle's, so replaying creation-order first-max on the host
  reproduces the oracle path exactly — no tie-flagging machinery needed.
- `consensus_from_path(lin, path, ...)` -> fragments (SPEC.md §2.7).

Re-architects `AlnGraphBoost::consensus()` (reference
`src/cpp/AlnGraphBoost.cpp`, SURVEY.md §3.4 — reconstructed, mount empty):
same math, tensor-first layout.

The port's copy of `pbdagcon_tpu/ops/linearize.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from pbdagcon_tpu_torch.alignment import Alignment, normalize_gaps, trim_aln
from pbdagcon_tpu_torch.oracle.graph import AlnGraph, CnsResult

_F32 = np.float32
_HALF = _F32(0.5)
_PENALTY = _F32(-10.0)
_NEG_MAX = _F32(np.finfo(np.float32).min)

NO_EDGE = -1  # sentinel in count arrays


@dataclasses.dataclass
class LinearGraph:
    """Banded linearization of one merged alignment graph.

    Interior nodes (alive, non-sentinel) are indexed `0..n-1` in a
    topological order that keeps every interior edge's span `w - u`
    small. Enter and exit are virtual: enter's out-edges live in
    `enter_tgt`/`enter_cnt` (host only); edges into exit appear both in
    `exit_count` (dense device lane) and in the CSR lists with target
    `n`. CSR edge order within a node is creation order — parity-
    critical for the backtrack tie-break.
    """

    sid: str
    backbone_len: int
    n: int
    span: int  # max over interior edges of (w - u)
    # Per-node arrays, length n.
    base: np.ndarray  # uint8
    weight: np.ndarray  # int32
    bb: np.ndarray  # int32: backbone position 1..L, 0 for insertions
    cov: np.ndarray  # int32: coverage(anchor(node))
    unsup: np.ndarray  # bool: backbone and weight == 1
    exit_count: np.ndarray  # int32: count of edge node->exit, NO_EDGE if none
    # Creation-order CSR out-edges; target == n denotes the virtual exit.
    edge_off: np.ndarray  # int32 [n+1]
    edge_tgt: np.ndarray  # int32 [E]
    edge_cnt: np.ndarray  # int32 [E]
    enter_tgt: np.ndarray  # int32 [E0]: enter's out-edges, creation order
    enter_cnt: np.ndarray  # int32 [E0]

    @property
    def n_edges(self) -> int:
        return int(self.edge_tgt.shape[0])


def graph_from_group(
    backbone: str,
    alns: list[Alignment],
    trim: int = 0,
    normalized: bool = False,
) -> AlnGraph:
    """Build + merge the alignment graph for one target's pileup
    (the reference consensus-worker preamble, SURVEY.md §3.1)."""
    g = AlnGraph(backbone)
    for aln in alns:
        if trim > 0:
            aln = trim_aln(aln, trim)
        if not normalized:
            aln = normalize_gaps(aln)
        if not aln.empty:
            g.add_aln(aln)
    g.merge_nodes()
    return g


def linearize(g: AlnGraph, sid: str = "") -> LinearGraph:
    """Topologically order interior nodes and emit banded CSR arrays.

    Order: Kahn's algorithm with a min-heap keyed
    `(anchor, is_insertion, creation_id)` — backbone nodes ascending,
    each gap's merged insertion trie placed between its flanking
    backbone nodes in predecessor-before-successor order. Every interior
    edge then points forward with a small span (SPEC.md §3.1).
    """
    n_all = len(g.base)
    alive = sum(1 for v in range(n_all) if not g.deleted[v])
    indeg = {v: len(g.in_e[v]) for v in range(n_all) if not g.deleted[v]}

    def key(v: int) -> tuple[int, int, int]:
        return (g.anchor[v], 0 if g.backbone_f[v] else 1, v)

    heap: list[tuple[tuple[int, int, int], int]] = [(key(g.enter), g.enter)]
    order: list[int] = []
    while heap:
        _, u = heapq.heappop(heap)
        order.append(u)
        for w in g.out_e[u]:
            indeg[w] -= 1
            if indeg[w] == 0:
                heapq.heappush(heap, (key(w), w))
    if len(order) != alive:
        raise RuntimeError(
            f"graph not a DAG or has unreachable nodes: "
            f"{len(order)} != {alive}"
        )

    interior = [v for v in order if v != g.enter and v != g.exit]
    n = len(interior)
    lin_of = np.full(n_all, -1, dtype=np.int32)
    for i, v in enumerate(interior):
        lin_of[v] = i

    base = np.zeros(n, dtype=np.uint8)
    weight = np.zeros(n, dtype=np.int32)
    bb = np.zeros(n, dtype=np.int32)
    cov = np.zeros(n, dtype=np.int32)
    unsup = np.zeros(n, dtype=bool)
    exit_count = np.full(n, NO_EDGE, dtype=np.int32)
    edge_off = np.zeros(n + 1, dtype=np.int32)
    tgt_list: list[int] = []
    cnt_list: list[int] = []

    span = 0
    for i, v in enumerate(interior):
        base[i] = g.base[v]
        weight[i] = g.weight[v]
        bb[i] = v if g.backbone_f[v] else 0
        cov[i] = g.coverage[g.anchor[v]]
        unsup[i] = g.backbone_f[v] and g.weight[v] == 1
        for w, c in g.out_e[v].items():
            if w == g.exit:
                exit_count[i] = c
                tgt_list.append(n)
                cnt_list.append(c)
            else:
                j = int(lin_of[w])
                if j <= i:
                    raise RuntimeError("non-forward interior edge")
                span = max(span, j - i)
                tgt_list.append(j)
                cnt_list.append(c)
        edge_off[i + 1] = len(tgt_list)

    # Keep a direct enter->exit edge (all-deletion records create one) as
    # a virtual candidate with target n: escore = count, score 0. When it
    # is the strict best, the path terminates immediately — matching the
    # oracle's best_path, which scores this edge like any other.
    enter_tgt = np.array(
        [n if w == g.exit else lin_of[w] for w in g.out_e[g.enter]],
        dtype=np.int32,
    )
    enter_cnt = np.array(
        list(g.out_e[g.enter].values()), dtype=np.int32
    )

    return LinearGraph(
        sid=sid,
        backbone_len=g.L,
        n=n,
        span=span,
        base=base,
        weight=weight,
        bb=bb,
        cov=cov,
        unsup=unsup,
        exit_count=exit_count,
        edge_off=edge_off,
        edge_tgt=np.array(tgt_list, dtype=np.int32),
        edge_cnt=np.array(cnt_list, dtype=np.int32),
        enter_tgt=enter_tgt,
        enter_cnt=enter_cnt,
    )


def edge_escores(lin: LinearGraph, tgt: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Vectorized float32 edge scores into nodes `tgt` (n = exit). SPEC §2.6."""
    is_exit = tgt == lin.n
    w = np.where(is_exit, 0, tgt)
    esc = cnt.astype(np.float32) - _HALF * lin.cov[w].astype(np.float32)
    esc = np.where(lin.unsup[w], _PENALTY, esc)
    esc = np.where(is_exit, cnt.astype(np.float32), esc)
    return esc.astype(np.float32)


def host_scores(lin: LinearGraph) -> np.ndarray:
    """Reference-exact float32 DP on the CSR arrays (host path / oracle
    for the device DP). Returns scores[n] float32."""
    score = np.full(lin.n + 1, _NEG_MAX, dtype=np.float32)
    score[lin.n] = _F32(0.0)
    esc = edge_escores(lin, lin.edge_tgt, lin.edge_cnt)
    off = lin.edge_off
    tgt = lin.edge_tgt
    for u in range(lin.n - 1, -1, -1):
        lo, hi = off[u], off[u + 1]
        best = _NEG_MAX
        for e in range(lo, hi):
            cand = _F32(esc[e] + score[tgt[e]])
            if cand > best:
                best = cand
        score[u] = best
    return score[: lin.n]


def backtrack(lin: LinearGraph, scores: np.ndarray) -> list[int]:
    """Walk the best path from enter using creation-order first-strict-max
    (the reference rule, SPEC §2.6). `scores` are per-interior-node DP
    scores (device- or host-computed; bitwise identical either way).
    Returns interior linear indices; the terminating exit is implicit.
    """
    full = np.empty(lin.n + 1, dtype=np.float32)
    full[: lin.n] = scores
    full[lin.n] = _F32(0.0)
    esc = edge_escores(lin, lin.edge_tgt, lin.edge_cnt)
    enter_esc = edge_escores(lin, lin.enter_tgt, lin.enter_cnt)

    def pick(tgt: np.ndarray, e_esc: np.ndarray) -> int:
        best = _NEG_MAX
        best_w = -1
        for k in range(len(tgt)):
            cand = _F32(e_esc[k] + full[tgt[k]])
            if cand > best:
                best = cand
                best_w = int(tgt[k])
        return best_w

    path: list[int] = []
    u = pick(lin.enter_tgt, enter_esc)
    off = lin.edge_off
    while u >= 0 and u != lin.n:
        path.append(u)
        lo, hi = off[u], off[u + 1]
        u = pick(lin.edge_tgt[lo:hi], esc[lo:hi])
    return path


def consensus_from_path(
    lin: LinearGraph,
    path: list[int],
    min_weight: int = 8,
    min_length: int = 500,
) -> list[CnsResult]:
    """Fragment emission along the path (SPEC §2.7), on linear arrays."""
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

    for v in path:
        is_bb = lin.bb[v] != 0
        if is_bb:
            bb_pos = int(lin.bb[v])
        if lin.weight[v] >= min_weight:
            if not frag:
                range_start = bb_pos - 1 if is_bb else bb_pos
            frag.append(int(lin.base[v]))
            kept_end = bb_pos
        else:
            close()
    close()
    return results


def consensus_one_from_path(lin: LinearGraph, path: list[int], min_weight: int = 0) -> str:
    """Single-string longest-kept-run consensus (SPEC §2.7, dazcon-style)."""
    cns = bytearray()
    offs = best_offs = length = idx = 0
    met = False
    for v in path:
        cns.append(int(lin.base[v]))
        kept = lin.weight[v] >= min_weight
        if not met and kept:
            offs = idx
            met = True
        elif met and not kept:
            if idx - offs > length:
                best_offs, length = offs, idx - offs
            met = False
        idx += 1
    if met and idx - offs > length:
        best_offs, length = offs, idx - offs
    return cns[best_offs : best_offs + length].decode()
