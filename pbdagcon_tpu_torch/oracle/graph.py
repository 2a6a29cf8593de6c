"""Exact alignment-graph consensus engine — the bit-parity oracle.

Implements SPEC.md §2: the backbone-seeded POA DAG of the reference's
`AlnGraphBoost` (reconstructed from `src/cpp/AlnGraphBoost.{hpp,cpp}`,
SURVEY.md §2 C4, §3.3–3.4; reference mount empty — SPEC.md is normative).

This is deliberately a readable, dependency-free Python implementation.
It is NOT the production path (that is `native/` + the TPU kernels); it is
the ground truth that the C++ engine and the tensor path are differentially
tested against, bit for bit.

Determinism notes (parity-critical, SPEC.md §2.1):
- adjacency dicts preserve edge creation order (Python dict ordering);
- merge groups are visited in ascending base order, survivors are the
  first group member in in-edge order;
- best-path scoring is float32 with strict-greater first-max tie-breaks
  in out-edge creation order.

The port's copy of `pbdagcon_tpu/oracle/graph.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

import numpy as np

from pbdagcon_tpu_torch.alignment import Alignment

_F32 = np.float32
_NEG_MAX = _F32(np.finfo(np.float32).min)  # -FLT_MAX
_HALF = _F32(0.5)
_PENALTY = _F32(-10.0)

ENTER_BASE = ord("^")
EXIT_BASE = ord("$")


@dataclasses.dataclass
class CnsResult:
    """One consensus fragment: half-open backbone range + sequence."""

    range: tuple[int, int]
    seq: str


class AlnGraph:
    """Backbone-seeded partial-order alignment graph (SPEC.md §2)."""

    def __init__(self, backbone: str):
        bb = backbone.encode()
        L = len(bb)
        self.L = L
        self.enter = 0
        self.exit = L + 1
        n = L + 2
        # Node arrays (grow for insertion nodes).
        self.base = bytearray([ENTER_BASE]) + bytearray(bb) + bytearray([EXIT_BASE])
        self.weight = [0] + [1] * L + [0]
        self.coverage = [0] * n
        self.backbone_f = [True] * n
        self.anchor = list(range(n))
        self.deleted = [False] * n
        # Adjacency: creation-ordered dicts node -> {other: count}.
        self.out_e: list[dict[int, int]] = [dict() for _ in range(n)]
        self.in_e: list[dict[int, int]] = [dict() for _ in range(n)]
        for p in range(L + 1):
            self.out_e[p][p + 1] = 0
            self.in_e[p + 1][p] = 0
        self._merged = False

    # ------------------------------------------------------------------
    def _new_node(self, base: int, anchor: int) -> int:
        v = len(self.base)
        self.base.append(base)
        self.weight.append(1)
        self.coverage.append(0)
        self.backbone_f.append(False)
        self.anchor.append(anchor)
        self.deleted.append(False)
        self.out_e.append(dict())
        self.in_e.append(dict())
        return v

    def add_edge(self, u: int, v: int) -> None:
        """Increment edge count, creating the edge at list tails if new."""
        if v in self.out_e[u]:
            self.out_e[u][v] += 1
            self.in_e[v][u] += 1
        else:
            self.out_e[u][v] = 1
            self.in_e[v][u] = 1

    def add_aln(self, aln: Alignment) -> None:
        """Thread one *normalized* alignment through the graph (SPEC §2.4)."""
        if aln.empty:
            return
        assert not self._merged, "add_aln after merge_nodes"
        tpos = aln.start - 1
        prev = self.enter
        q = aln.qstr.encode()
        t = aln.tstr.encode()
        gap = ord("-")
        for qb, tb in zip(q, t):
            if qb != gap and tb != gap:  # match column
                tpos += 1
                self.coverage[tpos] += 1
                self.weight[tpos] += 1
                self.add_edge(prev, tpos)
                prev = tpos
            elif qb == gap:  # deletion: consume target only
                tpos += 1
                self.coverage[tpos] += 1
            else:  # insertion: new branch node anchored at tpos
                v = self._new_node(qb, tpos)
                self.add_edge(prev, v)
                prev = v
        if tpos > self.L:
            raise ValueError(f"alignment {aln.id} overruns backbone")
        self.add_edge(prev, self.exit)

    # ------------------------------------------------------------------
    def merge_nodes(self) -> None:
        """Merge equivalent sibling nodes (SPEC §2.5)."""
        remaining = {v: len(self.in_e[v]) for v in self._alive()}
        q: deque[int] = deque([self.enter])
        while q:
            u = q.popleft()
            self._merge_in_nodes(u)
            for v in self.out_e[u]:
                remaining[v] -= 1
                if remaining[v] == 0:
                    q.append(v)
        self._merged = True

    def _merge_in_nodes(self, n0: int) -> None:
        # Iterative depth-first merge (explicit frame stack): deep merge
        # chains in 100-500x-coverage pileups must not hit Python's
        # recursion limit. Order is identical to the recursive form: per
        # node, groups are snapshotted up front and processed in
        # ascending-base order; after a group merges into its survivor
        # `a`, a's own groups are fully processed before this node's
        # next group (mirrors native/dagcon.cpp merge_in_nodes).
        def groups_of(n: int) -> list[list[int]]:
            groups: dict[int, list[int]] = {}
            for s in self.in_e[n]:
                if len(self.out_e[s]) == 1:
                    groups.setdefault(self.base[s], []).append(s)
            return [groups[b] for b in sorted(groups) if len(groups[b]) >= 2]

        stack: list[list] = [[n0, groups_of(n0), 0]]
        while stack:
            top = stack[-1]
            n, groups, gi = top
            if gi >= len(groups):
                stack.pop()
                continue
            top[2] = gi + 1
            nodes = groups[gi]
            a = nodes[0]
            for x in nodes[1:]:
                self.weight[a] += self.weight[x]
                cx = self.out_e[x][n]
                self.out_e[a][n] += cx
                self.in_e[n][a] += cx
                for s, c in list(self.in_e[x].items()):
                    if a in self.out_e[s]:
                        self.out_e[s][a] += c
                        self.in_e[a][s] += c
                    else:
                        self.out_e[s][a] = c
                        self.in_e[a][s] = c
                    del self.out_e[s][x]
                # disconnect & delete x
                del self.out_e[x][n]
                del self.in_e[n][x]
                self.in_e[x].clear()
                self.deleted[x] = True
            # Descend into the survivor before this node's next group.
            stack.append([a, groups_of(a), 0])

    # ------------------------------------------------------------------
    def _alive(self) -> Iterable[int]:
        return (v for v in range(len(self.base)) if not self.deleted[v])

    def dangling_nodes(self) -> set[int]:
        """Alive non-sentinel nodes with a missing side (sanity check)."""
        out = set()
        for v in self._alive():
            if v in (self.enter, self.exit):
                continue
            if not self.in_e[v] or not self.out_e[v]:
                out.add(v)
        return out

    def best_path(self) -> list[int]:
        """Backward float32 max-path DP, forward walk (SPEC §2.6)."""
        score: dict[int, np.float32] = {self.exit: _F32(0.0)}
        best_out: dict[int, int] = {}
        remaining = {v: len(self.out_e[v]) for v in self._alive()}
        q: deque[int] = deque([self.exit])
        while q:
            n = q.popleft()
            if self.out_e[n]:
                best = _NEG_MAX
                best_w = -1
                for w, c in self.out_e[n].items():
                    if self.backbone_f[w] and self.weight[w] == 1:
                        e = _PENALTY
                    else:
                        e = _F32(c) - _HALF * _F32(self.coverage[self.anchor[w]])
                    cand = _F32(e + score[w])
                    if cand > best:
                        best = cand
                        best_w = w
                if best_w >= 0:
                    score[n] = best
                    best_out[n] = best_w
            for s in self.in_e[n]:
                remaining[s] -= 1
                if remaining[s] == 0:
                    q.append(s)
        path = [self.enter]
        n = self.enter
        while n in best_out:
            n = best_out[n]
            path.append(n)
        return path

    # ------------------------------------------------------------------
    def consensus(self, min_weight: int = 8, min_length: int = 500) -> list[CnsResult]:
        """Multi-fragment consensus along the best path (SPEC §2.7)."""
        return self.consensus_from_path(self.best_path(), min_weight, min_length)

    def consensus_from_path(
        self, path: list[int], min_weight: int, min_length: int
    ) -> list[CnsResult]:
        results: list[CnsResult] = []
        bb_pos = 0
        kept_end = 0
        frag = bytearray()
        range_start = 0

        def close() -> None:
            nonlocal frag
            if len(frag) >= min_length and len(frag) > 0:
                results.append(CnsResult((range_start, kept_end), frag.decode()))
            frag = bytearray()

        for v in path:
            sentinel = v == self.enter or v == self.exit
            if self.backbone_f[v] and not sentinel:
                bb_pos = v
            kept = (not sentinel) and self.weight[v] >= min_weight
            if kept:
                if not frag:
                    range_start = bb_pos - 1 if self.backbone_f[v] else bb_pos
                frag.append(self.base[v])
                kept_end = bb_pos
            else:
                close()
        close()
        return results

    def consensus_one(self, min_weight: int = 0) -> str:
        """Single-string consensus: longest kept run (SPEC §2.7, dazcon-style)."""
        path = self.best_path()
        cns = bytearray()
        offs = best_offs = length = idx = 0
        met = False
        for v in path:
            if v == self.enter or v == self.exit:
                continue
            cns.append(self.base[v])
            kept = self.weight[v] >= min_weight
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
