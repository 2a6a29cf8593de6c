"""Exact (bit-parity oracle) consensus engine. See SPEC.md and graph.py.

The port's copy of `pbdagcon_tpu/oracle/__init__.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

from typing import Iterable

from pbdagcon_tpu_torch.alignment import Alignment, normalize_gaps, trim_aln
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.oracle.graph import AlnGraph, CnsResult

__all__ = ["AlnGraph", "CnsResult", "build_graph", "consensus_for_group"]


def build_graph(
    backbone: str, alns: Iterable[Alignment], trim: int = 0, merge: bool = True
) -> AlnGraph:
    """normalize -> trim -> add_aln for a per-target pileup (SURVEY.md §3.1)."""
    g = AlnGraph(backbone)
    for aln in alns:
        a = trim_aln(aln, trim)
        if a.empty:
            continue
        a = normalize_gaps(a)
        if a.empty:
            continue
        g.add_aln(a)
    if merge:
        g.merge_nodes()
    return g


def consensus_for_group(
    backbone: str, alns: Iterable[Alignment], cfg: DagconConfig
) -> list[CnsResult]:
    """Full reference pipeline for one target group (oracle path)."""
    g = build_graph(backbone, alns, trim=cfg.trim)
    return g.consensus(cfg.min_weight, cfg.min_length)
