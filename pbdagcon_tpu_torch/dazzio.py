"""DAZZ_DB / .las container IO: ctypes bindings over the native reader
(`native/dazzdb.cpp`) plus a fixture writer.

The reference dazcon consumes Gene Myers' binary containers via bundled
C (`src/cpp/DB.{h,c}`, `align.{h,c}`, SURVEY.md §2 C9 — reconstructed;
mount empty). This module exposes the same capability: open a database,
extract read sequences (2-bit unpacked), iterate `.las` overlaps. The
writer emits the same byte layout the reader documents, giving
round-trip tests and a way to generate fixtures; byte-layout notes live
in dazzdb.cpp. Re-verify against real DAZZ_DB files when available.

The port's copy of `pbdagcon_tpu/dazzio.py`: the same code, reading
through the port's native loader.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np

from pbdagcon_tpu_torch import native as _native

_IDX_HEADER = 112  # sizeof(HITS_DB), LP64
_READ_REC = 40
_LAS_HEADER = 12  # int64 novl + int tspace, no padding
_OVL_REC = 40
_COMP_FLAG = 0x1

_B2 = {"A": 0, "C": 1, "G": 2, "T": 3}


@dataclasses.dataclass(frozen=True)
class Overlap:
    """One .las overlap: A-read is the target, B-read the query;
    `comp` set means B aligns reverse-complemented. `trace`, when
    decoded, is the DALIGNER trace-point sequence: one (diffs,
    b-advance) pair per tspace-wide A segment."""

    aread: int
    bread: int
    comp: bool
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    diffs: int
    trace: tuple[tuple[int, int], ...] | None = None


def _lib():
    lib = _native._load()
    if lib is None:
        raise RuntimeError("native library unavailable (make -C native)")
    if not hasattr(lib.dazz_open, "_configured"):
        lib.dazz_open.restype = ctypes.c_void_p
        lib.dazz_open.argtypes = [ctypes.c_char_p]
        lib.dazz_close.argtypes = [ctypes.c_void_p]
        lib.dazz_nreads.restype = ctypes.c_int
        lib.dazz_nreads.argtypes = [ctypes.c_void_p]
        lib.dazz_read_len.restype = ctypes.c_int
        lib.dazz_read_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dazz_read_seq.restype = ctypes.c_int
        lib.dazz_read_seq.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.las_open.restype = ctypes.c_void_p
        lib.las_open.argtypes = [ctypes.c_char_p]
        lib.las_close.argtypes = [ctypes.c_void_p]
        lib.las_novl.restype = ctypes.c_long
        lib.las_novl.argtypes = [ctypes.c_void_p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.las_overlaps.restype = ctypes.c_int
        lib.las_overlaps.argtypes = [ctypes.c_void_p] + [i32p] * 8
        lib.las_tspace.restype = ctypes.c_int
        lib.las_tspace.argtypes = [ctypes.c_void_p]
        lib.las_trace_len.restype = ctypes.c_int
        lib.las_trace_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.las_trace.restype = ctypes.c_int
        lib.las_trace.argtypes = [ctypes.c_void_p, ctypes.c_long, i32p]
        lib.dazz_open._configured = True
    return lib


class DazzDb:
    """Read access to a DAZZ_DB database (<root>.db + hidden files)."""

    def __init__(self, path: str):
        lib = _lib()
        self._lib = lib
        self._h = lib.dazz_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open DAZZ_DB {path!r}")

    def close(self) -> None:
        if self._h:
            self._lib.dazz_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return int(self._lib.dazz_nreads(self._h))

    def read(self, i: int) -> str:
        n = int(self._lib.dazz_read_len(self._h, i))
        if n < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(n + 1)
        rc = self._lib.dazz_read_seq(self._h, i, buf)
        if rc < 0:
            raise IndexError(i)
        return buf.raw[:n].decode()


QV_TRACKS = ("delQV", "delTag", "insQV", "mergeQV", "subQV")


class DazzQv:
    """Access to the compressed QV streams of a database (the QV.{h,c}
    capability of SURVEY.md §2 C9): five Huffman-coded per-read tracks.
    Layout notes in native/dazzdb.cpp; round-trip pinned against
    `write_dazz_qvs`."""

    def __init__(self, path: str):
        lib = _lib()
        if not hasattr(lib, "_qv_configured"):
            lib.dazz_qv_open.restype = ctypes.c_void_p
            lib.dazz_qv_open.argtypes = [ctypes.c_char_p]
            lib.dazz_qv_close.argtypes = [ctypes.c_void_p]
            lib.dazz_qv_ntracks.restype = ctypes.c_int
            lib.dazz_qv_ntracks.argtypes = [ctypes.c_void_p]
            lib.dazz_qv_load.restype = ctypes.c_int
            lib.dazz_qv_load.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib._qv_configured = True
        self._lib = lib
        self._h = lib.dazz_qv_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open QV streams of {path!r}")

    def close(self) -> None:
        if self._h:
            self._lib.dazz_qv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def load(self, i: int, rlen: int) -> dict[str, bytes]:
        """Decode all five tracks of read i (rlen from the database)."""
        out = {}
        buf = (ctypes.c_uint8 * max(1, rlen))()
        for t, name in enumerate(QV_TRACKS):
            rc = self._lib.dazz_qv_load(self._h, i, t, buf)
            if rc < 0:
                raise OSError(f"QV decode failed (read {i}, track {name})")
            out[name] = bytes(buf[:rc])
        return out


def read_las(path: str, with_traces: bool = False) -> list[Overlap]:
    """All overlaps of a .las file. With `with_traces`, each overlap
    carries its decoded (diffs, b-advance) trace-point pairs (u8 for
    tspace <= 125, u16 otherwise — the align.c decoding, SURVEY.md §2
    C9); dazcon itself re-aligns from raw sequences and does not need
    them."""
    lib = _lib()
    h = lib.las_open(path.encode())
    if not h:
        raise OSError(f"cannot open .las {path!r}")
    try:
        n = int(lib.las_novl(h))
        arrs = [np.zeros(max(1, n), dtype=np.int32) for _ in range(8)]
        lib.las_overlaps(
            h, *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
                 for a in arrs]
        )
        out = []
        for i in range(n):
            trace = None
            if with_traces:
                npairs = int(lib.las_trace_len(h, i))
                buf = np.zeros(max(1, 2 * npairs), dtype=np.int32)
                lib.las_trace(
                    h, i,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                )
                trace = tuple(
                    (int(buf[2 * k]), int(buf[2 * k + 1]))
                    for k in range(npairs)
                )
            out.append(
                Overlap(
                    int(arrs[0][i]), int(arrs[1][i]), bool(arrs[2][i]),
                    int(arrs[3][i]), int(arrs[4][i]), int(arrs[5][i]),
                    int(arrs[6][i]), int(arrs[7][i]), trace,
                )
            )
        return out
    finally:
        lib.las_close(h)


def las_tspace(path: str) -> int:
    """Trace-point spacing of a .las file."""
    lib = _lib()
    h = lib.las_open(path.encode())
    if not h:
        raise OSError(f"cannot open .las {path!r}")
    try:
        return int(lib.las_tspace(h))
    finally:
        lib.las_close(h)


# ---------------------------------------------------------------- writer


def write_dazz_db(path: str, seqs: list[str]) -> None:
    """Write <root>.db + hidden .idx/.bps in the documented layout."""
    import os

    d, root = os.path.split(path)
    if root.endswith(".db"):
        root = root[:-3]
    with open(path, "w") as f:
        f.write(f"files = 1\n  {len(seqs)} fixture fixture\n")
    bps = bytearray()
    idx = bytearray()
    idx += struct.pack("<i", len(seqs))  # ureads
    idx += b"\0" * (_IDX_HEADER - 4)
    for s in seqs:
        boff = len(bps)
        packed = bytearray((len(s) + 3) // 4)
        for k, ch in enumerate(s):
            packed[k // 4] |= _B2[ch] << (6 - 2 * (k % 4))
        bps += packed
        rec = bytearray(_READ_REC)
        struct.pack_into("<i", rec, 0, 0)  # origin
        struct.pack_into("<i", rec, 4, len(s))  # rlen
        struct.pack_into("<i", rec, 8, 0)  # fpulse
        struct.pack_into("<q", rec, 16, boff)
        struct.pack_into("<q", rec, 24, 0)  # coff
        struct.pack_into("<i", rec, 32, 0)  # flags
        idx += rec
    with open(os.path.join(d, f".{root}.idx"), "wb") as f:
        f.write(idx)
    with open(os.path.join(d, f".{root}.bps"), "wb") as f:
        f.write(bps)


def _huffman_lengths(hist: dict[int, int]) -> dict[int, int]:
    """Code length per symbol (canonical Huffman over the histogram).
    Single-symbol alphabets get length 1."""
    import heapq
    import itertools

    if not hist:
        return {}
    if len(hist) == 1:
        return {next(iter(hist)): 1}
    cnt = itertools.count()
    heap = [(n, next(cnt), {s: 0}) for s, n in hist.items()]
    heapq.heapify(heap)
    while len(heap) > 1:
        na, _, da = heapq.heappop(heap)
        nb, _, db = heapq.heappop(heap)
        merged = {s: l + 1 for s, l in da.items()}
        merged.update({s: l + 1 for s, l in db.items()})
        heapq.heappush(heap, (na + nb, next(cnt), merged))
    return heap[0][2]


def _canonical_codes(lengths: dict[int, int]) -> dict[int, tuple[int, int]]:
    """symbol -> (code, len), canonical order (len asc, symbol asc) —
    the assignment dazz_qv_open's decode tables reconstruct."""
    out: dict[int, tuple[int, int]] = {}
    code = 0
    prev_len = 0
    for sym, ln in sorted(lengths.items(), key=lambda kv: (kv[1], kv[0])):
        code <<= ln - prev_len
        out[sym] = (code, ln)
        code += 1
        prev_len = ln
    return out


def write_dazz_qvs(
    dbpath: str, tracks_per_read: list[tuple[bytes, ...]]
) -> None:
    """Write hidden .qvs QV streams for an existing database (layout in
    native/dazzdb.cpp) and stamp each read's block offset into the
    .idx `coff` field. `tracks_per_read[i]` is the 5-tuple
    (delQV, delTag, insQV, mergeQV, subQV) for read i."""
    import os

    d, root = os.path.split(dbpath)
    if root.endswith(".db"):
        root = root[:-3]
    ntracks = len(QV_TRACKS)
    hists: list[dict[int, int]] = [{} for _ in range(ntracks)]
    for tr in tracks_per_read:
        assert len(tr) == ntracks
        for t, s in enumerate(tr):
            for b in s:
                hists[t][b] = hists[t].get(b, 0) + 1
    codes = [_canonical_codes(_huffman_lengths(h)) for h in hists]
    for c in codes:
        assert all(ln <= 32 for _, ln in c.values()), (
            "Huffman code exceeds the 32-bit decoder limit "
            "(pathologically skewed histogram)"
        )

    out = bytearray()
    out += struct.pack("<i", ntracks)
    for t in range(ntracks):
        tbl = sorted(codes[t].items(), key=lambda kv: (kv[1][1], kv[0]))
        out += struct.pack("<i", len(tbl))
        for sym, (_c, ln) in tbl:
            out += struct.pack("<BB", sym, ln)
    payload_start = len(out)

    coffs = []
    for tr in tracks_per_read:
        coffs.append(len(out) - payload_start)
        for t, s in enumerate(tr):
            acc = 0
            nbits = 0
            buf = bytearray()
            for b in s:
                c, ln = codes[t][b]
                acc = (acc << ln) | c
                nbits += ln
                while nbits >= 8:
                    buf.append((acc >> (nbits - 8)) & 0xFF)
                    nbits -= 8
            if nbits:
                buf.append((acc << (8 - nbits)) & 0xFF)
            out += buf
    with open(os.path.join(d, f".{root}.qvs"), "wb") as f:
        f.write(out)

    idx_path = os.path.join(d, f".{root}.idx")
    with open(idx_path, "r+b") as f:
        data = bytearray(f.read())
        (ureads,) = struct.unpack_from("<i", data, 0)
        assert ureads == len(tracks_per_read), "read count mismatch"
        for i, coff in enumerate(coffs):
            struct.pack_into("<q", data, _IDX_HEADER + i * _READ_REC + 24,
                             coff)
        f.seek(0)
        f.write(data)


def write_las(path: str, overlaps: list[Overlap], tspace: int = 100) -> None:
    """Write a .las file in the documented layout, including each
    overlap's trace block (u8 values for tspace <= 125, else u16)."""
    tbytes = 1 if tspace <= 125 else 2
    out = bytearray()
    out += struct.pack("<q", len(overlaps))
    out += struct.pack("<i", tspace)
    out += b"\0" * (_LAS_HEADER - 12)
    for o in overlaps:
        trace = o.trace or ()
        rec = bytearray(_OVL_REC)
        struct.pack_into("<i", rec, 0, 2 * len(trace))  # tlen = #values
        struct.pack_into("<i", rec, 4, o.diffs)
        # Path order on disk: begin pair (abpos, bbpos) then end
        # pair (aepos, bepos) — align.h's Path struct.
        struct.pack_into("<i", rec, 8, o.abpos)
        struct.pack_into("<i", rec, 12, o.bbpos)
        struct.pack_into("<i", rec, 16, o.aepos)
        struct.pack_into("<i", rec, 20, o.bepos)
        struct.pack_into("<I", rec, 24, _COMP_FLAG if o.comp else 0)
        struct.pack_into("<i", rec, 28, o.aread)
        struct.pack_into("<i", rec, 32, o.bread)
        out += rec
        for d, y in trace:
            if tbytes == 1:
                out += struct.pack("<B", d)
                out += struct.pack("<B", y)
            else:
                out += struct.pack("<H", d)
                out += struct.pack("<H", y)
    with open(path, "wb") as f:
        f.write(out)


def traces_from_alignment(
    qstr: str, tstr: str, abpos: int, tspace: int
) -> tuple[tuple[int, int], ...]:
    """(d, y) trace pairs for a gapped alignment of the oriented query
    against the target window starting at `abpos` — DALIGNER-style
    per-tspace-segment diff counts and B advances (`align.c` trace
    semantics, SURVEY.md §2 C9; reconstructed and self-consistent with
    `dazcon.trace_guide` — re-verify against real files when a
    reference mount exists). Used for fixture generation and tests."""
    pairs: list[tuple[int, int]] = []
    a = abpos
    nxt = (abpos // tspace + 1) * tspace
    d = y = 0
    for qc, tc in zip(qstr, tstr):
        if qc != tc:
            d += 1
        if qc != "-":
            y += 1
        if tc != "-":
            a += 1
            if a == nxt:
                pairs.append((d, y))
                d = y = 0
                nxt += tspace
    if d or y or not pairs or a % tspace != 0:
        pairs.append((d, y))
    return tuple(pairs)
