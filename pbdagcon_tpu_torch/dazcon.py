"""dazcon-equivalent frontend of the port: raw overlaps -> re-align ->
consensus_one (port of `pbdagcon_tpu/dazcon.py`).

The reference `dazcon` reads a DAZZ_DB database plus a `.las` overlap
file, re-aligns each overlapping B-read to the target A-read, and runs
the same graph consensus, emitting one sequence per target. This
frontend takes either those containers (`dazzio.py`, through the native
reader) or reads FASTA + blasr M4 overlaps.

On the port every hit is re-aligned by `ops/align_tpu.py::align_batch`
on the run's device (kernel X1 on a card, its plain version on the
CPU); hits carrying trace guides take `align_pair(..., guide=)` on the
host, as in the reference. The DP runs batched through
`ops/dp.py::batch_scores` on the device; only targets past the V ladder
and batches that overflow the long-edge register file take the host DP,
and each such target is counted in `PipelineStats.fallback_reasons`
("oversize", "long_edges"). A failure of the device raises: nothing
falls back to the host in silence.

Flags mirror dazcon's semantics: `-c` min coverage, `-m` min consensus
length, `-x` max hits per target; `--device` picks the device (default
cuda; "cpu" runs the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterable, TextIO

from pbdagcon_tpu_torch.alignment import Alignment, parse_pre
from pbdagcon_tpu_torch.hgap import (
    M4Record,
    m4_to_pre,
    parse_m4_stream,
    read_fasta,
)
from pbdagcon_tpu_torch.ops.linearize import (
    backtrack,
    consensus_one_from_path,
    graph_from_group,
    host_scores,
    linearize,
)

V_LADDER = (256, 512, 1024, 2048, 4096, 8192, 16384)


def select_hits(
    records: Iterable[M4Record], max_hits: int = 85,
    policy: str = "score",
) -> dict[str, list[M4Record]]:
    """Per-target hit selection (dazcon `TargetHit` semantics): group by
    target, order, cap at `max_hits`. The policies are the reference's:
      score   — ascending blasr score (lower = better; ties keep input
                order). The default.
      length  — longest aligned target span first.
      input   — input order, capped (no sort).
      span    — greedy per-position coverage cap: a hit is kept only if
                some position of its target span is still below
                max_hits-equivalent coverage (approximated on eighths
                of the target).
    """
    per_target: dict[str, list[tuple[int, int, M4Record]]] = {}
    for i, r in enumerate(records):
        if r.qname == r.tname:
            continue
        per_target.setdefault(r.tname, []).append((r.score, i, r))
    out: dict[str, list[M4Record]] = {}
    for tname, hits in per_target.items():
        if policy == "score":
            hits.sort(key=lambda t: (t[0], t[1]))
            out[tname] = [r for _s, _i, r in hits[:max_hits]]
        elif policy == "length":
            hits.sort(key=lambda t: (-(t[2].tend - t[2].tstart), t[1]))
            out[tname] = [r for _s, _i, r in hits[:max_hits]]
        elif policy == "input":
            out[tname] = [r for _s, _i, r in hits[:max_hits]]
        elif policy == "span":
            hits.sort(key=lambda t: (t[0], t[1]))
            tlen = max(1, hits[0][2].tlen)
            nbin = 8
            covb = [0] * nbin
            cap = max(1, max_hits)
            kept = []
            for _s, _i, r in hits:
                b0 = min(nbin - 1, r.tstart * nbin // tlen)
                b1 = min(nbin - 1, max(r.tstart, r.tend - 1) * nbin // tlen)
                if any(covb[b] < cap for b in range(b0, b1 + 1)):
                    kept.append(r)
                    for b in range(b0, b1 + 1):
                        covb[b] += 1
            out[tname] = kept
        else:
            raise ValueError(f"unknown hit policy {policy!r}")
    return out


def _realign(raw: list[Alignment], device) -> list[Alignment]:
    """Gapped records from raw ones, by the device aligner."""
    from pbdagcon_tpu_torch.ops.align_tpu import align_batch

    gapped = align_batch([(a.qstr, a.tstr) for a in raw], device)
    alns: list[Alignment] = []
    for a, (gq, gt) in zip(raw, gapped):
        a.qstr, a.tstr = gq, gt
        alns.append(a.recompute_end())
    return alns


def consensus_one_target(
    tname: str,
    tseq: str,
    hits: list[M4Record],
    reads: dict[str, str],
    min_weight: int = 8,
    device="cuda",
) -> str:
    """Re-align hits to the target and emit the dazcon-style single
    consensus string (longest kept run)."""
    raw = [parse_pre(line) for line in m4_to_pre(hits, reads)]
    g = graph_from_group(tseq, _realign(raw, device))
    lin = linearize(g, sid=tname)
    path = backtrack(lin, host_scores(lin))
    return consensus_one_from_path(lin, path, min_weight)


def run_dazcon(
    m4_stream: TextIO | Iterable[str],
    reads: dict[str, str],
    out: TextIO,
    min_weight: int = 8,
    min_length: int = 500,
    max_hits: int = 85,
    min_coverage_hits: int = 2,
    batch_targets: int = 64,
    hit_policy: str = "score",
    device="cuda",
    stats=None,
) -> int:
    """Full dazcon-equivalent flow; returns number of sequences emitted.

    Targets are batched through the device DP (`ops.dp.batch_scores`)
    like the dagcon pipeline; scores are bitwise equal to the host DP,
    so output is unchanged. Targets past the V ladder and batches with
    too many long edges run the host DP and are counted in `stats`
    (a `pipeline.PipelineStats`) when given."""
    from pbdagcon_tpu_torch.ops.dp import (
        LongEdgeOverflow,
        batch_scores,
        choose_layout,
    )
    from pbdagcon_tpu_torch.config import resolve_device
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    stats = stats if stats is not None else PipelineStats()
    dev = resolve_device(device)
    per_target = select_hits(
        parse_m4_stream(m4_stream), max_hits=max_hits, policy=hit_policy
    )
    emitted = 0
    names = [
        t for t in sorted(per_target)
        if reads.get(t) is not None
        and len(per_target[t]) >= min_coverage_hits
    ]

    def emit(tname: str, lin, scores) -> None:
        nonlocal emitted
        path = backtrack(lin, scores)
        cns = consensus_one_from_path(lin, path, min_weight)
        if len(cns) >= min_length:
            out.write(f">{tname}\n{cns}\n")
            emitted += 1

    for lo in range(0, len(names), batch_targets):
        part = names[lo : lo + batch_targets]
        lins = [
            _target_lin(t, reads[t], per_target[t], reads, dev) for t in part
        ]
        stats.targets += len(part)
        buckets: dict[int, list[int]] = {}
        for i, lin in enumerate(lins):
            V = next((v for v in V_LADDER if lin.n <= v), None)
            buckets.setdefault(V if V is not None else -1, []).append(i)
        results: dict[int, object] = {}
        for V, idxs in buckets.items():
            blins = [lins[i] for i in idxs]
            scores = None
            if V < 0:
                stats.fallback("oversize", len(idxs))
            else:
                try:
                    W, K = choose_layout(blins)
                    scores = batch_scores(blins, V, W, K, dev)
                    stats.batches += 1
                except LongEdgeOverflow:
                    stats.fallback("long_edges", len(idxs))
            for j, i in enumerate(idxs):
                results[i] = (
                    scores[j, : lins[i].n]
                    if scores is not None
                    else host_scores(lins[i])
                )
        for i, tname in enumerate(part):
            emit(tname, lins[i], results[i])
    return emitted


def _target_lin(tname, tseq, hits, reads, device):
    """Re-align hits and build the linearized merged graph for one
    target (the dazcon consensus-worker preamble). Hits carrying trace
    guides (container frontend with --trace-guided) take the guided
    banded DP on the host; everything else batches through the device
    aligner."""
    raw = [parse_pre(line) for line in m4_to_pre(hits, reads)]
    guides = [h.guide for h in hits]
    if len(raw) == len(hits) and any(g is not None for g in guides):
        from pbdagcon_tpu_torch.aligner import align_pair

        alns = []
        for a, g in zip(raw, guides):
            a.qstr, a.tstr = align_pair(a.qstr, a.tstr, guide=g)
            alns.append(a.recompute_end())
    else:
        alns = _realign(raw, device)
    g = graph_from_group(tseq, alns)
    return linearize(g, sid=tname)


def trace_guide(o, tspace: int, slack: int = 24):
    """Banding checkpoints for `align_pair(q, t, guide=...)` from an
    overlap's DALIGNER trace points (a copy of the reference's).

    Trace pairs (d_k, y_k) describe the alignment per tspace-aligned
    A-segment: d_k diffs, y_k B bases consumed; per-segment halfwidth
    = 2*d_k + slack. COMP overlaps return None (align unguided):
    m4_to_pre re-aligns them in a window-flipped frame the trace
    coordinates do not map into. Returns None likewise when traces are
    absent or inconsistent."""
    import numpy as np

    tr = o.trace
    if not tr or o.comp:
        return None
    n = o.aepos - o.abpos
    m = o.bepos - o.bbpos
    q_ck = [0]
    t_ck = [0]
    w = []
    a = o.abpos
    b = 0
    for k, (d, y) in enumerate(tr):
        nxt = min((a // tspace + 1) * tspace, o.aepos)
        if k == len(tr) - 1:
            nxt = o.aepos  # last segment runs to the overlap end
        b += y
        t_ck.append(nxt - o.abpos)
        q_ck.append(b)
        w.append(max(32, 2 * int(d) + slack))
        a = nxt
    if q_ck[-1] != m or t_ck[-1] != n:
        return None  # inconsistent traces: fall back to unguided
    return (
        np.asarray(q_ck, dtype=np.int64),
        np.asarray(t_ck, dtype=np.int64),
        np.asarray(w, dtype=np.int64),
    )


def dazz_inputs_to_m4(
    db_path: str, las_path: str, with_guides: bool = False
) -> tuple[Iterable, dict[str, str]]:
    """Native-container frontend: DAZZ_DB + .las -> (M4 records, reads).

    Read ids become their 0-based DB indices; the COMP flag maps to the
    M4 query strand. With `with_guides`, each overlap's decoded trace
    points become banding checkpoints on the record (`M4Record.guide`)
    for the guided re-aligner."""
    from pbdagcon_tpu_torch.dazzio import DazzDb, las_tspace, read_las
    from pbdagcon_tpu_torch.hgap import parse_m4

    with DazzDb(db_path) as db:
        reads = {str(i): db.read(i) for i in range(len(db))}
    recs = []
    tspace = las_tspace(las_path) if with_guides else 0
    for o in read_las(las_path, with_traces=with_guides):
        alen = len(reads[str(o.aread)])
        blen = len(reads[str(o.bread)])
        # M4: qname tname score pctsim qstrand qstart qend qlen
        #     tstrand tstart tend tlen  (B = query, A = target).
        span = max(1, o.aepos - o.abpos)
        pct = max(0.0, 100.0 * (1.0 - o.diffs / span))
        rec = parse_m4(
            f"{o.bread} {o.aread} {o.diffs} {pct:.2f} "
            f"{1 if o.comp else 0} {o.bbpos} {o.bepos} {blen} "
            f"0 {o.abpos} {o.aepos} {alen}"
        )
        if with_guides:
            rec.guide = trace_guide(o, tspace)
        recs.append(rec)
    return recs, reads


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pbdagcon_tpu_torch.dazcon",
        description="dazcon-equivalent consensus on PyTorch + CUDA: "
        "DAZZ_DB + .las overlaps OR reads FASTA + M4 overlaps in; one "
        "consensus FASTA record per target out",
    )
    p.add_argument(
        "overlaps",
        help="'.las' overlap file (with a '.db' database) or blasr -m 4 "
        "text ('-' = stdin)",
    )
    p.add_argument(
        "reads", help="DAZZ_DB '<root>.db' or reads FASTA (A- and B-reads)"
    )
    p.add_argument("-c", "--min-coverage", type=int, default=8)
    p.add_argument("-m", "--min-length", type=int, default=500)
    p.add_argument("-x", "--max-hits", type=int, default=85)
    p.add_argument(
        "--hit-policy", choices=("score", "length", "input", "span"),
        default="score",
        help="per-target hit ordering/selection policy",
    )
    p.add_argument(
        "--trace-guided", action="store_true",
        help="band the re-aligner around the .las trace points "
        "(container inputs only)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="device of the aligner and the DP (cuda, cuda:N, or cpu for "
        "the kernels' plain PyTorch versions)",
    )
    args = p.parse_args(argv)
    if args.reads.endswith(".db"):
        stream, reads = dazz_inputs_to_m4(
            args.reads, args.overlaps, with_guides=args.trace_guided
        )
    else:
        with open(args.reads) as f:
            reads = read_fasta(f)
        stream = sys.stdin if args.overlaps == "-" else open(args.overlaps)
    run_dazcon(
        stream, reads, sys.stdout,
        min_weight=args.min_coverage,
        min_length=args.min_length,
        max_hits=args.max_hits,
        hit_policy=args.hit_policy,
        device=args.device,
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
