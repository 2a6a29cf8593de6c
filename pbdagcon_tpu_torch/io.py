"""Streaming alignment IO: target-grouped reader and FASTA writer.

TPU-native replacement for the reference's reader/writer threads
(`src/cpp/main.cpp` Reader/Writer functors + `BoundedBuffer.hpp`,
SURVEY.md §2 C5–C6, §3.1 — reconstructed; mount empty). Instead of a
pthread pipeline, the reader is a generator that yields per-target groups
from a target-sorted stream (the reference's semantics: consecutive
records sharing `sid` form one group) and the writer emits the
reference's FASTA format: header `>{sid}/{start}_{end}` per consensus
fragment (SPEC.md §2.7).

The port's copy of `pbdagcon_tpu/io.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import sys
from typing import IO, Iterable, Iterator, TextIO

from pbdagcon_tpu_torch.alignment import (
    Alignment,
    backbone_from_group,
    group_by_target,
    parse_records,
)
from pbdagcon_tpu_torch.oracle.graph import CnsResult


class TargetGroup:
    """One target's pileup: id, recovered backbone, raw alignments."""

    __slots__ = ("sid", "backbone", "alns")

    def __init__(self, sid: str, backbone: str, alns: list[Alignment]):
        self.sid = sid
        self.backbone = backbone
        self.alns = alns

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"TargetGroup({self.sid!r}, L={len(self.backbone)}, "
            f"n={len(self.alns)})"
        )


def read_groups(
    stream: TextIO | Iterable[str], fmt: str = "m5"
) -> Iterator[TargetGroup]:
    """Stream per-target groups from a target-sorted M5/'pre' stream."""
    for sid, group in group_by_target(parse_records(stream, fmt)):
        yield TargetGroup(sid, backbone_from_group(group), group)


def open_input(path: str) -> IO[str]:
    """Open an input path; '-' means stdin (reference stdin-pipe mode)."""
    if path == "-":
        return sys.stdin
    return open(path)


def format_fasta(
    sid: str, results: Iterable[CnsResult], width: int = 0
) -> str:
    """Render consensus fragments as FASTA text.

    Header `>{sid}/{start}_{end}` with the fragment's half-open backbone
    range (SPEC.md §2.7); unwrapped sequence lines by default, matching
    the reference writer.
    """
    out: list[str] = []
    for r in results:
        out.append(f">{sid}/{r.range[0]}_{r.range[1]}\n")
        seq = r.seq
        if width > 0:
            for i in range(0, len(seq), width):
                out.append(seq[i : i + width] + "\n")
        else:
            out.append(seq + "\n")
    return "".join(out)


def sid_of_line(line: str, fmt: str = "m5") -> str:
    """Target id of one record line without full parsing (field 6 for
    M5, field 2 for 'pre')."""
    idx = 5 if fmt == "m5" else 1
    return line.split(None, idx + 1)[idx]


def _line_start_before(f, pos: int) -> int:
    """Offset of the line containing byte `pos` (binary file handle):
    backward scan for the previous newline in growing windows."""
    step = 1 << 16
    hi = pos
    while hi > 0:
        lo = max(0, hi - step)
        f.seek(lo)
        buf = f.read(hi - lo)
        nl = buf.rfind(b"\n")
        if nl >= 0:
            return lo + nl + 1
        hi = lo
        step *= 2
    return 0


def shard_stream_bytes(
    path: str, fmt: str, shard_i: int, shard_n: int
) -> Iterator[str]:
    """Byte-range input sharding WITHOUT parse replication: rank i of n
    reads only ~size/n bytes of the file (real multi-host HGAP
    deployments pre-split inputs per host, SURVEY.md §3.5; this builds
    the split into the reader so `--distributed` scales parse too).

    Ownership rule: a group "cut point" is the byte offset of the first
    line of a group; the group belongs to the rank whose range
    satisfies start < cut <= end (rank 0 owns the file-leading group).
    Each rank locates the full line containing its start byte (backward
    newline scan), tracks sid changes from there, and emits from its
    first owned cut until the first cut past `end` — boundary groups
    are neither lost nor duplicated, whatever the boundary lands on."""
    import os as _os

    size = _os.path.getsize(path)
    start = shard_i * size // shard_n
    end = (shard_i + 1) * size // shard_n
    with open(path, "rb") as f:
        prev: str | None = None
        if shard_i > 0:
            if start >= size:
                return
            ls = _line_start_before(f, start)
            f.seek(ls)
            raw = f.readline()  # full line containing byte `start`
            while raw and not raw.strip():
                raw = f.readline()
            if not raw:
                return
            prev = sid_of_line(raw.decode(), fmt)
            # skip to the first cut strictly past `start` (a tiny shard
            # may find its first cut already past `end`: owns nothing)
            while True:
                pos = f.tell()
                raw = f.readline()
                if not raw:
                    return
                if not raw.strip():
                    continue
                sid = sid_of_line(raw.decode(), fmt)
                if sid != prev:
                    if pos > end:
                        return
                    prev = sid
                    yield raw.decode()
                    break
        # emit until the first cut past `end`
        while True:
            pos = f.tell()
            raw = f.readline()
            if not raw:
                return
            if not raw.strip():
                continue
            sid = sid_of_line(raw.decode(), fmt)
            if prev is None:
                prev = sid
            elif sid != prev:
                if pos > end:
                    return
                prev = sid
            yield raw.decode()


def filter_groups_text(
    stream: TextIO | Iterable[str],
    fmt: str,
    keep,  # callable (sid, group_index) -> bool
) -> Iterator[str]:
    """Pass through only the target-groups `keep` accepts (text level:
    no record parsing) — manifest sharding and journal-resume filtering
    for the streaming pipeline (SURVEY.md §5)."""
    current: str | None = None
    gidx = -1
    keeping = False
    for line in stream:
        if not line.strip():
            continue
        sid = sid_of_line(line, fmt)
        if sid != current:
            current = sid
            gidx += 1
            keeping = bool(keep(sid, gidx))
        if keeping:
            yield line


class FastaWriter:
    """Ordered FASTA emission (the reference writer preserves input
    target order even with `-j` workers; callers hand results back in
    submission order)."""

    def __init__(self, stream: TextIO | None = None, width: int = 0):
        self.stream = stream if stream is not None else sys.stdout
        self.width = width
        self.n_fragments = 0
        self.n_bases = 0

    def write_target(self, sid: str, results: list[CnsResult]) -> None:
        text = format_fasta(sid, results, self.width)
        if text:
            self.stream.write(text)
        self.n_fragments += len(results)
        self.n_bases += sum(len(r.seq) for r in results)
