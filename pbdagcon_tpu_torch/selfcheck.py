"""Debug self-check: graph invariants + oracle/linear agreement.

Exposes the reference's `danglingNodes()` sanity capability
(`AlnGraphBoost::danglingNodes`, SURVEY.md §2 C4 — reconstructed; mount
empty) as a CLI mode, and additionally verifies that the linearized
tensor path reproduces the graph-walk consensus for every target —
the end-to-end invariant the whole framework rests on.

The port's copy of `pbdagcon_tpu/selfcheck.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import sys
from typing import Iterable, TextIO

from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import read_groups
from pbdagcon_tpu_torch.oracle.graph import AlnGraph
from pbdagcon_tpu_torch.alignment import normalize_gaps, trim_aln
from pbdagcon_tpu_torch.ops.linearize import (
    backtrack,
    consensus_from_path,
    host_scores,
    linearize,
)


def run_selfcheck(
    stream: TextIO | Iterable[str], cfg: DagconConfig
) -> int:
    """Returns 0 if every target passes; prints findings to stderr."""
    bad = 0
    targets = 0
    for grp in read_groups(stream, cfg.fmt):
        targets += 1
        g = AlnGraph(grp.backbone)
        for a in grp.alns:
            if cfg.align:
                from pbdagcon_tpu_torch.aligner import align_record

                a = align_record(a, cfg.align_scorer, cfg.affine_params)
            if cfg.trim:
                a = trim_aln(a, cfg.trim)
            a = normalize_gaps(a)
            if not a.empty:
                g.add_aln(a)
        g.merge_nodes()
        dangling = g.dangling_nodes()
        if dangling:
            print(
                f"selfcheck: {grp.sid}: {len(dangling)} dangling nodes",
                file=sys.stderr,
            )
            bad += 1
            continue
        oracle = g.consensus(cfg.min_weight, cfg.min_length)
        lin = linearize(g, sid=grp.sid)
        path = backtrack(lin, host_scores(lin))
        linear = consensus_from_path(
            lin, path, cfg.min_weight, cfg.min_length
        )
        if [(c.range, c.seq) for c in oracle] != [
            (c.range, c.seq) for c in linear
        ]:
            print(
                f"selfcheck: {grp.sid}: linear path != graph walk",
                file=sys.stderr,
            )
            bad += 1
    print(
        f"selfcheck: {targets - bad}/{targets} targets OK",
        file=sys.stderr,
    )
    return 1 if bad else 0
