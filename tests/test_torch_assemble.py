"""The port's batch fragment assembly (`ops/devemit.py::assemble_batch`)
held row by row against the port's per-target `assemble_fragments` and
the JAX package's, on seeded random batches that reach every edge of the
path semantics (SPEC §2.7); and the devbuild pipeline, which assembles
through it, on a stream of several windows with targets flagged to the
host: its FASTA is the single-thread native engine's and its counts are
those of that FASTA."""

import io
import random

import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import devemit as jde
from pbdagcon_tpu.simulate import simulate_targets, to_m5
from pbdagcon_tpu_torch import devpipe
from pbdagcon_tpu_torch import native as tnative
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.ops import devemit
from pbdagcon_tpu_torch.pipeline import run_stream

P = 96


def _random_row(rng: np.random.Generator, P: int):
    """A plausible emitted path: backbone steps with rising positions and
    insertion steps (bbpos 0) between them, kept steps in runs of random
    lengths, and random bits past the path's end."""
    path_len = int(rng.integers(0, P + 1))
    on_bb = rng.random(P) < rng.uniform(0.3, 0.95)
    on_bb[: rng.integers(0, 4)] = False  # steps before the first backbone node
    bbpos = np.where(on_bb, np.cumsum(on_bb) + rng.integers(0, 50), 0)
    kept = np.zeros(P, dtype=bool)
    i, state = 0, rng.random() < 0.5
    while i < P:
        n = int(rng.geometric(rng.uniform(0.05, 0.6)))
        kept[i : i + n] = state
        i, state = i + n, not state
    kept[path_len:] = rng.random(P - path_len) < 0.5  # stale bits
    bbpos[path_len:] = rng.integers(0, 3, P - path_len)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), P)
    return bases, kept, bbpos.astype(np.int16), path_len


def _edge_rows(rng: np.random.Generator, P: int):
    """One row for each edge: path_len 0 under kept bits; every step kept
    and none kept at path_len P; runs at the first and the last live step
    with stale bits past the end; a run that starts on an insertion node,
    one that starts on a backbone node; kept steps before the first
    backbone node."""
    rows = []

    def row(kept, bbpos, path_len):
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), P)
        rows.append((bases, np.asarray(kept, bool),
                     np.asarray(bbpos, np.int16), path_len))

    ramp = np.arange(1, P + 1)
    row(np.ones(P), ramp, 0)
    row(np.ones(P), ramp, P)
    row(np.zeros(P), ramp, P)
    k = np.ones(P, bool)
    k[5:9] = False
    row(k, ramp, 40)  # runs at the first and last live steps, stale after
    ins_start = np.where(np.arange(P) % 3 == 0, 0, ramp)
    k = np.zeros(P, bool)
    k[3:20] = True  # step 3 is an insertion node
    k[22:30] = True  # step 22 is a backbone node
    row(k, ins_start, P)
    bb_late = np.where(np.arange(P) < 10, 0, ramp)
    k = np.zeros(P, bool)
    k[2:15] = True  # kept from before the first backbone node
    row(k, bb_late, 60)
    return rows


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    rows = _edge_rows(rng, P) + [_random_row(rng, P) for _ in range(40)]
    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.stack([r[2] for r in rows]),
            np.array([r[3] for r in rows], np.int32))


def _as_tuples(results):
    return [(r.range, r.seq) for r in results]


@pytest.mark.parametrize("min_length", [1, 5, 40, P + 1])
@pytest.mark.parametrize("seed", range(6))
def test_assemble_batch_equals_assemble_fragments(seed, min_length):
    bases, kept, bbpos, path_len = _batch(seed)
    got = devemit.assemble_batch(bases, kept, bbpos, path_len, min_length)
    assert len(got) == len(bases)
    n_frags = 0
    for j in range(len(bases)):
        args = (bases[j], kept[j], bbpos[j], int(path_len[j]), min_length)
        want = devemit.assemble_fragments(*args)
        assert _as_tuples(got[j]) == _as_tuples(want), j
        assert _as_tuples(want) == _as_tuples(jde.assemble_fragments(*args))
        assert all(type(x) is int for r in got[j] for x in r.range)
        n_frags += len(want)
    assert (n_frags == 0) == (min_length > P)


def test_assemble_batch_of_no_rows():
    e = np.zeros((0, P))
    assert devemit.assemble_batch(
        e.astype(np.uint8), e.astype(bool), e.astype(np.int16),
        np.zeros(0, np.int32), 1,
    ) == []


# Rows of the first batch that the wrapped `run_batch` flags, each with
# the reason the host counts for it: flag bits 2 and 5 (the lowest,
# "cascade"), ambiguous and overflow together ("ambiguous"), overflow
# alone, and flag bit 7 with ambiguous ("dp_range").
_INJECT = {0: ("cascade", 0b100100, False, False),
           1: ("ambiguous", 0, True, True),
           2: ("overflow", 0, False, True),
           3: ("dp_range", 0x80, True, False)}


def _stream_text() -> str:
    rng = random.Random(9)
    return "\n".join(
        to_m5(a, flip=rng.random() < 0.3)
        for _t, _b, alns in simulate_targets(2024, 40, 200, 8)
        for a in alns
    ) + "\n"


@pytest.fixture
def one_torch_thread():
    """Small CPU tensors gain nothing from torch's intra-op threads, and
    beside other test workers those threads wait on each other (~10x
    slower on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("use_native", [True, False])
def test_devbuild_with_flagged_rows_equals_single_thread_engine(
        use_native, monkeypatch, one_torch_thread):
    """40 targets at 8 a batch (two windows on the native path): rows
    flagged on the first batch take the host path, with their reason; the
    FASTA is the single-thread engine's, and the fragments and bases the
    stats count are that FASTA's."""
    if not tnative.available():
        pytest.skip("native library not built")
    real_run_batch = devpipe.run_batch
    calls = [0]

    def run_batch(*a, **k):
        res = real_run_batch(*a, **k)
        if calls[0] == 0:
            for j, (_why, bits, amb, ovf) in _INJECT.items():
                res["flags"][j] |= bits
                res["ambiguous"][j] = torch.tensor(amb) | res["ambiguous"][j]
                res["overflow"][j] = torch.tensor(ovf) | res["overflow"][j]
        calls[0] += 1
        return res

    monkeypatch.setattr(devpipe, "run_batch", run_batch)
    text = _stream_text()
    buf = io.StringIO()
    cfg = DagconConfig(backend="devbuild", device="cpu", batch_targets=8,
                       min_weight=3, min_length=50, use_native=use_native)
    stats = run_stream(io.StringIO(text), FastaWriter(buf), cfg)
    dev = buf.getvalue()
    with tnative.NativeEngine(min_weight=3, min_length=50, threads=1) as eng:
        single = eng.consensus_text(text.encode())
    assert dev == single
    assert stats.targets == 40 and calls[0] >= 2
    assert stats.fallback_reasons == {why: 1 for why, *_ in _INJECT.values()}
    assert stats.host_fallbacks == sum(stats.fallback_reasons.values())
    lines = dev.splitlines()
    assert stats.fragments == sum(l.startswith(">") for l in lines) >= 40
    assert stats.consensus_bases == sum(
        len(l) for l in lines if not l.startswith(">"))
