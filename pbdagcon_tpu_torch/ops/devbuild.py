"""The device build's wire format and constants: the host-side encoder
(`encode_group`, `EncodedGroup`), the column ops, the absorption-round
cap and the creation-key bits.

The port's copy of the parts of `pbdagcon_tpu/ops/devbuild.py` that the
port uses (the reference module also holds the NumPy oracle of the
build, which the port's tests take from there): the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbdagcon_tpu_torch.alignment import Alignment, normalize_gaps, trim_aln

# Ops in the encoded column stream (normalized alignment columns).
OP_PAD = 0
OP_MATCH = 1
OP_DEL = 2
OP_INS = 3

# Absorption cascades are handled exactly up to this many rounds; the
# cap exists because the device build packs the strip phase into 2 bits
# of its int32 sort keys (phases 0..3). Deeper cascades flag the target.
MAX_ABSORB_ROUNDS = 3

# Creation keys are 32-bit (device-friendly; JAX x64 is off):
#   (phase:2b << 28) | (gpre:14b << 14) | (read:14b)
# phase 0 = ctor, 1 = threaded, 2 = merge-redirected; gpre = GLOBAL
# preorder rank of the merged node (nodes sorted by (termination, DFS
# preorder)) — order-isomorphic to the (Kahn time, in-trie preorder)
# event pair; read = creating/first-victim read index. Bit 30 marks
# ambiguous keys (absorption-strip interactions): compare with
# KEY_MASK; a score tie involving an uncertain key flags the target.
KEY_UNCERTAIN = 1 << 30
KEY_MASK = KEY_UNCERTAIN - 1


@dataclasses.dataclass
class EncodedGroup:
    """Host-encoded pileup: the device-build wire format.

    One target's normalized alignments as per-read column streams:
    `ops[r, c]` in {PAD, MATCH, DEL, INS}; inserted bases appear in
    `ins_base` in (read-major, column) order. This is the only thing
    uploaded — ~5x smaller than the banded graph arrays it replaces.
    """

    sid: str
    backbone: np.ndarray  # uint8 [L]
    starts: np.ndarray  # int32 [R], 1-based first consumed target pos
    ops: np.ndarray  # uint8 [R, C] column ops (padded)
    ncols: np.ndarray  # int32 [R]
    ins_base: np.ndarray  # uint8 [NI] inserted bases, stream order
    ins_off: np.ndarray  # int32 [R+1] per-read offsets into ins_base


def encode_group(
    backbone: str,
    alns: list[Alignment],
    trim: int = 0,
    sid: str = "",
    normalized: bool = False,
) -> EncodedGroup:
    """Normalize/trim and encode one pileup (host side, oracle version).

    Mirrors the graph-build preamble of the reference consensus worker
    (SURVEY.md §3.1) up to — but not including — `addAln`.
    """
    streams: list[tuple[int, np.ndarray, np.ndarray]] = []
    for aln in alns:
        if trim > 0:
            aln = trim_aln(aln, trim)
        if not normalized:
            aln = normalize_gaps(aln)
        if aln.empty:
            continue
        q = np.frombuffer(aln.qstr.encode(), dtype=np.uint8)
        t = np.frombuffer(aln.tstr.encode(), dtype=np.uint8)
        gap = ord("-")
        ops = np.where(
            (q != gap) & (t != gap),
            OP_MATCH,
            np.where(q == gap, OP_DEL, OP_INS),
        ).astype(np.uint8)
        streams.append((aln.start, ops, q[ops == OP_INS]))
    R = len(streams)
    C = max((len(o) for _, o, _ in streams), default=0)
    ops_arr = np.zeros((R, C), dtype=np.uint8)
    starts = np.zeros(R, dtype=np.int32)
    ncols = np.zeros(R, dtype=np.int32)
    ins_parts: list[np.ndarray] = []
    ins_off = np.zeros(R + 1, dtype=np.int32)
    for r, (start, ops, ib) in enumerate(streams):
        starts[r] = start
        ncols[r] = len(ops)
        ops_arr[r, : len(ops)] = ops
        ins_parts.append(ib)
        ins_off[r + 1] = ins_off[r] + len(ib)
    return EncodedGroup(
        sid=sid,
        backbone=np.frombuffer(backbone.encode(), dtype=np.uint8).copy(),
        starts=starts,
        ops=ops_arr,
        ncols=ncols,
        ins_base=(
            np.concatenate(ins_parts)
            if ins_parts
            else np.zeros(0, dtype=np.uint8)
        ),
        ins_off=ins_off,
    )
