"""HGAP preassembly glue: M4 overlap filtering and 'pre' record emission.

Equivalents of the reference workflow scripts (`src/filterm4.py`,
`src/m4topre.py`, `src/pbdagcon_wf.sh` — SURVEY.md §2 C11, §3.5;
reconstructed, mount empty): the pipeline

    blasr -m 4 -> filter_m4 -> m4_to_pre -> consensus (fmt='pre', -a)

turns raw overlap hits plus the reads FASTA into target-sorted raw
sequence pairs that the consensus engine re-aligns (SPEC §1.5) and
folds into per-target graphs. `run_hgap` drives the whole flow
in-process; the `python -m pbdagcon_tpu_torch.hgap` CLI emits 'pre' text
for piping into `python -m pbdagcon_tpu_torch --fmt pre -a -` (the
streaming preassembly mode).

M4 record (blasr -m 4, 12+ whitespace fields):
    qname tname score pctsimilarity qstrand qstart qend qlen
    tstrand tstart tend tlen [mapqv]
Coordinates are 0-based half-open in each sequence's own strand frame;
`tstrand == 1` means the hit is on the reverse strand of the target —
SPEC choice: orient by reverse-complementing the query substring and
mapping target coords to the forward frame (`tstart' = tlen - tend`).

The port's copy of `pbdagcon_tpu/hgap.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, Iterator, TextIO

from pbdagcon_tpu_torch.alignment import revcomp


@dataclasses.dataclass
class M4Record:
    qname: str
    tname: str
    score: int
    pctsimilarity: float
    qstrand: int
    qstart: int
    qend: int
    qlen: int
    tstrand: int
    tstart: int
    tend: int
    tlen: int
    # Optional trace-guided banding checkpoints for the re-aligner
    # (dazcon container frontend; see dazcon.trace_guide). Not part of
    # the M4 text format — attached programmatically.
    guide: object = None


def parse_m4(line: str) -> M4Record:
    f = line.split()
    if len(f) < 12:
        raise ValueError(f"M4 record has {len(f)} fields, expected >= 12")
    return M4Record(
        qname=f[0], tname=f[1], score=int(f[2]),
        pctsimilarity=float(f[3]),
        qstrand=int(f[4]), qstart=int(f[5]), qend=int(f[6]),
        qlen=int(f[7]),
        tstrand=int(f[8]), tstart=int(f[9]), tend=int(f[10]),
        tlen=int(f[11]),
    )


def parse_m4_stream(
    stream: TextIO | Iterable[str] | Iterable[M4Record],
) -> Iterator[M4Record]:
    for line in stream:
        if isinstance(line, M4Record):  # pre-parsed (dazcon containers)
            yield line
        elif line.strip():
            yield parse_m4(line)


def filter_m4(
    records: Iterable[M4Record], bestn: int = 1
) -> list[M4Record]:
    """Keep the `bestn` best hits per query (the reference filterm4.py
    best-hit semantics): lower blasr score is better; ties keep input
    order. Self-hits (qname == tname) are dropped. Output preserves the
    original input order of the surviving records."""
    per_query: dict[str, list[tuple[int, int, M4Record]]] = {}
    for i, r in enumerate(records):
        if r.qname == r.tname:
            continue
        per_query.setdefault(r.qname, []).append((r.score, i, r))
    keep: set[int] = set()
    for hits in per_query.values():
        hits.sort(key=lambda t: (t[0], t[1]))
        for _s, i, _r in hits[:bestn]:
            keep.add(i)
    out: list[tuple[int, M4Record]] = []
    for q in per_query.values():
        for _s, i, r in q:
            if i in keep:
                out.append((i, r))
    out.sort(key=lambda t: t[0])
    return [r for _i, r in out]


def read_fasta(stream: TextIO | Iterable[str]) -> dict[str, str]:
    """Minimal FASTA reader: id (first token of header) -> sequence."""
    seqs: dict[str, str] = {}
    name: str | None = None
    parts: list[str] = []
    for line in stream:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(parts)
            name = line[1:].split()[0]
            parts = []
        else:
            parts.append(line)
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


def m4_to_pre(
    records: Iterable[M4Record], reads: dict[str, str]
) -> list[str]:
    """Join overlaps with read sequences into raw 'pre' records,
    target-sorted (stable within a target) — m4topre.py equivalent.
    Records whose reads are missing are skipped."""
    rows: list[tuple[str, int, str]] = []
    for i, r in enumerate(records):
        qseq = reads.get(r.qname)
        tseq = reads.get(r.tname)
        if qseq is None or tseq is None:
            continue
        q = qseq[r.qstart : r.qend]
        if r.tstrand != r.qstrand:
            q = revcomp(q)
            tstart = r.tlen - r.tend
            tend = r.tlen - r.tstart
        else:
            tstart = r.tstart
            tend = r.tend
        t = tseq[tstart:tend]
        if not q or not t:
            continue
        rows.append(
            (
                r.tname,
                i,
                f"{r.qname} {r.tname} {tstart + 1} {tend} {r.tlen} {q} {t}",
            )
        )
    rows.sort(key=lambda x: (x[0], x[1]))
    return [line for _t, _i, line in rows]


def run_hgap(
    m4_stream: TextIO | Iterable[str],
    reads: dict[str, str],
    bestn: int = 4,
) -> str:
    """filter -> join -> target-sorted 'pre' text (feed with fmt='pre',
    align=True into the consensus pipeline)."""
    filtered = filter_m4(parse_m4_stream(m4_stream), bestn=bestn)
    return "\n".join(m4_to_pre(filtered, reads)) + "\n"


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m pbdagcon_tpu_torch.hgap",
        description="M4 overlaps + reads FASTA -> target-sorted raw 'pre' "
        "records on stdout (pipe into: python -m pbdagcon_tpu_torch --fmt "
        "pre -a -)",
    )
    p.add_argument("m4", help="blasr -m 4 overlap file ('-' = stdin)")
    p.add_argument("reads", help="reads FASTA (queries and targets)")
    p.add_argument("--bestn", type=int, default=4,
                   help="best hits kept per query (filterm4 semantics)")
    args = p.parse_args(argv)
    with open(args.reads) as f:
        reads = read_fasta(f)
    stream = sys.stdin if args.m4 == "-" else open(args.m4)
    sys.stdout.write(run_hgap(stream, reads, bestn=args.bestn))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
