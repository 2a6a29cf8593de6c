"""Alignment record model, M5/"pre" parsing, gap normalization, trimming.

Python spec implementation of SPEC.md §1; mirrors the reference's
`dagcon::Alignment`, `parseM5`/`parsePre`, `normalizeGaps`, `trimAln`
(reconstructed from `src/cpp/Alignment.{hpp,cpp}`, SURVEY.md §2 C1–C3 —
reference mount empty, see SPEC.md provenance note). The C++ production
loader in `native/` implements the same spec; differential tests keep the
two bit-identical.

Everything here is host-side preprocessing. Hot-path production ingestion
goes through the native loader; this module is the readable normative
version and the fallback.

The port's copy of `pbdagcon_tpu/alignment.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, TextIO

GAP = ord("-")

_COMPLEMENT = bytes.maketrans(
    b"ACGTacgt",
    b"TGCAtgca",
)


def revcomp(s: str) -> str:
    """Reverse complement; gaps and unknown bytes map to themselves."""
    return s.encode()[::-1].translate(_COMPLEMENT).decode()


@dataclasses.dataclass
class Alignment:
    """One pairwise alignment of a query read against a (forward) target.

    SPEC.md §1. `start` is the 1-based forward-target position of the
    first aligned target base; `qstr`/`tstr` are equal-length gapped
    strings.
    """

    id: str = ""
    sid: str = ""
    tlen: int = 0
    start: int = 1
    end: int = 0
    qstr: str = ""
    tstr: str = ""

    def recompute_end(self) -> "Alignment":
        self.end = self.start - 1 + sum(1 for c in self.tstr if c != "-")
        return self

    @property
    def empty(self) -> bool:
        return not self.qstr


def parse_m5(line: str) -> Alignment:
    """Parse one blasr `-m 5` record (19 whitespace fields). SPEC.md §1.1."""
    f = line.split()
    if len(f) != 19:
        raise ValueError(f"M5 record has {len(f)} fields, expected 19")
    (qname, _qlen, _qs, _qe, qstrand,
     tname, tlen_s, tstart, tend, tstrand,
     _score, _nm, _nmm, _ni, _nd, _mq,
     qstr, _pat, tstr) = f
    tlen = int(tlen_s)
    aln = Alignment(id=qname, sid=tname, tlen=tlen, qstr=qstr, tstr=tstr)
    if qstrand != tstrand:
        aln.qstr = revcomp(aln.qstr)
        aln.tstr = revcomp(aln.tstr)
        aln.start = tlen - int(tend) + 1
    else:
        aln.start = int(tstart) + 1
    if len(aln.qstr) != len(aln.tstr):
        raise ValueError(f"gapped string length mismatch in record {qname}")
    return aln.recompute_end()


def parse_pre(line: str) -> Alignment:
    """Parse one 'pre' record: qname tname start end tlen qstr tstr
    (SPEC.md §1.2). Lengths may differ when the record carries RAW
    (ungapped) pairs for the `-a` re-alignment path (SPEC §1.5);
    equal-length is enforced downstream where gapped strings are
    required."""
    f = line.split()
    if len(f) != 7:
        raise ValueError(f"pre record has {len(f)} fields, expected 7")
    qname, tname, start, end, tlen, qstr, tstr = f
    return Alignment(
        id=qname, sid=tname, tlen=int(tlen), start=int(start),
        end=int(end), qstr=qstr, tstr=tstr,
    )


def parse_records(stream: TextIO | Iterable[str], fmt: str = "m5") -> Iterator[Alignment]:
    """Stream alignments from a text stream, skipping blank lines."""
    parse = parse_m5 if fmt == "m5" else parse_pre
    for line in stream:
        if line.strip():
            yield parse(line)


def normalize_gaps(aln: Alignment) -> Alignment:
    """Canonical gap normalization. SPEC.md §1.3 (parity-critical).

    1. Expand each mismatch column into (query-gap, target-base) followed
       by (query-base, target-gap).
    2. One in-place left-to-right pass pushing gaps right across equal
       bases (target gaps first, then query gaps, for each column i).
    3. Drop '-/-' columns.
    """
    q = aln.qstr.encode()
    t = aln.tstr.encode()
    if len(q) != len(t):
        raise ValueError(
            f"record {aln.id}: gapped string length mismatch "
            "(raw pairs need the -a re-alignment path)"
        )

    qn = bytearray()
    tn = bytearray()
    for qb, tb in zip(q, t):
        if qb != tb and qb != GAP and tb != GAP:
            qn.append(GAP)
            qn.append(qb)
            tn.append(tb)
            tn.append(GAP)
        else:
            qn.append(qb)
            tn.append(tb)

    n = len(qn)
    for i in range(n - 1):
        if tn[i] == GAP:
            j = i + 1
            while j < n:
                c = tn[j]
                if c != GAP:
                    if c == qn[i]:
                        tn[i] = c
                        tn[j] = GAP
                    break
                j += 1
        if qn[i] == GAP:
            j = i + 1
            while j < n:
                c = qn[j]
                if c != GAP:
                    if c == tn[i]:
                        qn[i] = c
                        qn[j] = GAP
                    break
                j += 1

    out_q = bytearray()
    out_t = bytearray()
    for i in range(n):
        if qn[i] != GAP or tn[i] != GAP:
            out_q.append(qn[i])
            out_t.append(tn[i])

    out = Alignment(
        id=aln.id, sid=aln.sid, tlen=aln.tlen, start=aln.start,
        qstr=out_q.decode(), tstr=out_t.decode(),
    )
    return out.recompute_end()


def trim_aln(aln: Alignment, n: int) -> Alignment:
    """Trim `n` aligned query bases off each end. SPEC.md §1.4."""
    if n <= 0:
        return aln
    q = aln.qstr
    t = aln.tstr
    length = len(q)

    i = 0
    removed_q = 0
    start_shift = 0
    while i < length and removed_q < n:
        if q[i] != "-":
            removed_q += 1
        if t[i] != "-":
            start_shift += 1
        i += 1

    j = length
    removed_q = 0
    while j > i and removed_q < n:
        j -= 1
        if q[j] != "-":
            removed_q += 1

    out = Alignment(
        id=aln.id, sid=aln.sid, tlen=aln.tlen,
        start=aln.start + start_shift,
        qstr=q[i:j], tstr=t[i:j],
    )
    return out.recompute_end()


def group_by_target(
    alns: Iterable[Alignment],
) -> Iterator[tuple[str, list[Alignment]]]:
    """Group consecutive records sharing `sid` (reference reader-thread
    semantics: input is target-sorted; SURVEY.md §3.1)."""
    current: str | None = None
    group: list[Alignment] = []
    for aln in alns:
        if current is None or aln.sid != current:
            if group:
                yield current, group  # type: ignore[misc]
            current = aln.sid
            group = [aln]
        else:
            group.append(aln)
    if group:
        yield current, group  # type: ignore[misc]


def backbone_from_group(group: list[Alignment]) -> str:
    """Recover the backbone (target) sequence from a per-target group.

    The reference recovers the target sequence from the alignment records
    themselves (SURVEY.md §3.1, low-confidence detail): each record's
    ungapped `tstr` is the forward target subsequence starting at `start`.
    We paint all records into a length-`tlen` buffer; positions never
    covered by any record stay 'N'.
    """
    if not group:
        return ""
    tlen = group[0].tlen
    buf = bytearray(b"N" * tlen)
    for aln in group:
        p = aln.start - 1
        for ch in aln.tstr.encode():
            if ch != GAP:
                if p >= tlen:
                    raise ValueError(
                        f"alignment {aln.id} overruns target {aln.sid}"
                    )
                buf[p] = ch
                p += 1
    return buf.decode()
