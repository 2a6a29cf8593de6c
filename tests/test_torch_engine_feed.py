"""How the port feeds the native engine: the `cuda` producer linearizes
slices of `cfg.chunk_bytes()` (the `host` backend's call size), and the
hybrid's host worker makes one engine call over a run of queued chunks,
splitting its FASTA back per chunk (`hybrid.group_ids`,
`hybrid.split_fasta`). Every FASTA is held against `--backend host` and
the 1-thread engine; `PipelineStats.engine_calls` counts the calls."""

import io as _io
import logging
import os
import random
import threading
import time

import pytest

from pbdagcon_tpu_torch import devpipe, hybrid, native, pipeline
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.hybrid import (
    group_ids,
    iter_group_chunks_blocks,
    run_stream_hybrid,
    split_fasta,
)
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.pipeline import PipelineStats, run_stream
from pbdagcon_tpu_torch.simulate import simulate_targets, to_m5

CPU = "cpu"
MIN_WEIGHT, MIN_LENGTH = 3, 50

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def _group(sid: str, seed: int, length=240, cov=10) -> list[str]:
    """One target's M5 records under the id `sid`."""
    rng = random.Random(seed)
    (_tid, _bb, alns), = simulate_targets(seed, 1, length, cov)
    lines = []
    for a in alns:
        f = to_m5(a, flip=rng.random() < 0.3).split()
        f[5] = sid
        lines.append(" ".join(f) + "\n")
    return lines


def _workload(n_targets: int, seed: int = 5, length=240, cov=10) -> str:
    return "".join(
        "".join(_group(f"t{seed}_{i}", seed * 1000 + i, length, cov))
        for i in range(n_targets)
    )


def _tricky() -> str:
    """Groups that emit nothing (coverage 2 under -c 3) between ones
    that do, and target ids that recur in later, non-adjacent groups."""
    order = ["a", "e1", "b", "a", "c", "e2", "d", "e1", "b", "f", "g", "a"]
    return "".join(
        "".join(_group(sid, 100 + k, cov=2 if sid.startswith("e") else 10))
        for k, sid in enumerate(order)
    )


def _engine_fasta(data: bytes, threads: int = 1) -> str:
    with native.NativeEngine(min_weight=MIN_WEIGHT, min_length=MIN_LENGTH,
                             threads=threads) as eng:
        return eng.consensus_text(data, fmt="m5")


def _run(text: str, backend: str, **kw) -> tuple[str, PipelineStats]:
    buf = _io.StringIO()
    cfg = DagconConfig(backend=backend, min_weight=MIN_WEIGHT,
                       min_length=MIN_LENGTH, device=CPU, **kw)
    stats = run_stream(_io.StringIO(text), FastaWriter(buf), cfg)
    return buf.getvalue(), stats


# ---- the cuda producer's slices ----


class _SliceRecorder:
    """Engine stand-in for the producer: records each slice's size and
    linearizes nothing."""

    def __init__(self):
        self.sizes: list[int] = []

    def linearize_text(self, data, fmt="m5", flush=True):
        self.sizes.append(len(data))
        return 0

    def status(self):
        return (False, 0, 0)

    def close(self):
        pass


@pytest.mark.parametrize("env_mb,cfg_mb,total_mb,want", [
    ("8", 16, 9, [8, 1, 0]),     # DAGCON_CHUNK_MB sets the slice
    (None, 16, 20, [16, 4, 0]),  # else --chunk-mb (16 MiB by default)
    (None, 5, 12, [5, 5, 2, 0]),
])
def test_cuda_producer_slices_at_chunk_bytes(monkeypatch, env_mb, cfg_mb,
                                             total_mb, want):
    """The producer's slices are `chunk_bytes` whatever its size (each
    case past 4 MiB), ending with the flush call; one call a slice."""
    if env_mb is None:
        monkeypatch.delenv("DAGCON_CHUNK_MB", raising=False)
    else:
        monkeypatch.setenv("DAGCON_CHUNK_MB", env_mb)
    rec = _SliceRecorder()
    monkeypatch.setattr(pipeline, "_native_engine", lambda cfg: rec)
    stats = PipelineStats()
    cfg = DagconConfig(backend="cuda", device=CPU, chunk_mb=cfg_mb)
    pipeline._run_stream_native(
        _io.BytesIO(b"x" * (total_mb << 20)), FastaWriter(_io.StringIO()),
        cfg, "cuda", stats,
    )
    assert rec.sizes == [mb << 20 for mb in want]
    assert stats.engine_calls == len(want)


@needs_native
def test_cuda_producer_small_chunk_stream(monkeypatch, caplog):
    """A stream of several 1 MiB slices on `cuda --device cpu`: as many
    linearize calls as slices (plus the flush), each at most 1 MiB, the
    FASTA byte-equal to `host` and the 1-thread engine; the stats line
    names the calls."""
    monkeypatch.setenv("DAGCON_CHUNK_MB", "1")
    text = _workload(40, seed=7, length=600, cov=40)
    assert len(text) > 2 << 20
    sizes: list[int] = []

    class Recording(native.NativeEngine):
        def linearize_text(self, data, fmt="m5", flush=True):
            sizes.append(len(data))
            return super().linearize_text(data, fmt=fmt, flush=flush)

    monkeypatch.setattr(native, "NativeEngine", Recording)
    with caplog.at_level(logging.INFO, logger="pbdagcon_tpu_torch"):
        got, stats = _run(text, "cuda", batch_targets=16)
    host, hstats = _run(text, "host")
    assert got == host == _engine_fasta(text.encode())
    assert stats.targets == hstats.targets == 40
    assert len(sizes) == -(-len(text) // (1 << 20)) + 1
    assert max(sizes) == 1 << 20 and sizes[-1] == 0
    assert stats.engine_calls == len(sizes) == hstats.engine_calls
    assert f"engine_calls={stats.engine_calls}" in caplog.text


# ---- the hybrid's split ----


def test_group_ids_order_recurrence_and_long_lines():
    text = _tricky()
    ids = group_ids(text.encode(), "m5")
    assert ids == ["a", "e1", "b", "a", "c", "e2", "d", "e1", "b", "f",
                   "g", "a"]
    # Blank lines are skipped; an id past the first 256 bytes is read
    # from the whole line; 'pre' takes the second field.
    long_q = "q" * 300
    m5 = (f"{long_q} 1 0 1 + x 1 0 1 + 0 0 0 0 0 A | A\n\n"
          f"{long_q} 1 0 1 + y 1 0 1 + 0 0 0 0 0 A | A\n")
    assert group_ids(m5.encode(), "m5") == ["x", "y"]
    pre = "r1 s1 0 4 4 ACGT ACGT\nr2 s1 0 4 4 ACGT ACGT\nr3 s2 0 4 4 A A\n"
    assert group_ids(pre.encode(), "pre") == ["s1", "s2"]


@needs_native
def test_split_fasta_equals_per_chunk_calls():
    """One engine call over group-aligned chunks whose ids are disjoint,
    split by `split_fasta`, gives each chunk the FASTA of its own call:
    with groups that emit nothing at either end of a chunk and an id
    that recurs inside one chunk."""
    groups = [("a", 10), ("e1", 2), ("b", 10), ("a", 10), ("e2", 2),
              ("c", 10), ("e3", 2), ("e4", 2), ("d", 10), ("e5", 2)]
    recs = ["".join(_group(sid, 200 + k, cov=cov))
            for k, (sid, cov) in enumerate(groups)]
    chunks = [(recs[0] + recs[1] + recs[2] + recs[3]).encode(),  # a e1 b a
              (recs[4] + recs[5]).encode(),                      # e2 c
              (recs[6] + recs[7]).encode(),                      # e3 e4
              (recs[8] + recs[9]).encode()]                      # d e5
    ids = [group_ids(c, "m5") for c in chunks]
    assert ids[0] == ["a", "e1", "b", "a"]
    whole = _engine_fasta(b"".join(chunks), threads=4)
    per_chunk = [_engine_fasta(c) for c in chunks]
    assert per_chunk[2] == ""  # a chunk that emits nothing at all
    assert split_fasta(whole, ids) == per_chunk
    assert "".join(split_fasta(whole, ids)) == whole


def test_split_fasta_keeps_the_order_of_unknown_ids():
    text = ">a/0_4\nACGT\n>zz/0_4\nAC\nGT\n>b/1_3\nAG\n>a/0_2\nAA\n"
    parts = split_fasta(text, [["a"], ["b"], ["c"]])
    # "zz" stays with "a"'s chunk; "a" after "b" never steps back.
    assert parts == [">a/0_4\nACGT\n>zz/0_4\nAC\nGT\n",
                     ">b/1_3\nAG\n>a/0_2\nAA\n", ""]
    assert "".join(parts) == text


# ---- the hybrid's host worker ----


def _hybrid(text: str, chunk_kb: int, stats: PipelineStats) -> str:
    buf = _io.StringIO()
    cfg = DagconConfig(backend="hybrid", min_weight=MIN_WEIGHT,
                       min_length=MIN_LENGTH, device=CPU, batch_targets=4)
    run_stream_hybrid(_io.StringIO(text), FastaWriter(buf), cfg, stats,
                      pipeline.resolve_device(CPU),
                      chunk_bytes=chunk_kb << 10)
    return buf.getvalue()


def _slow_device(monkeypatch, seconds: float) -> list[bytes]:
    """A stub device worker that takes `seconds` a chunk and writes the
    1-thread engine's FASTA; returns the list of chunks it took. The
    host engine's first call waits (up to 30 s) until the device has
    pulled a chunk, so that a forced device gets one whatever the
    thread timing."""
    took: list[bytes] = []
    pulled = threading.Event()

    class HostEngine(native.NativeEngine):
        def consensus_text(self, data, fmt="m5", flush=True):
            if os.environ.get("DAGCON_HYBRID_FORCE_DEV") == "1":
                pulled.wait(30)
            return super().consensus_text(data, fmt=fmt, flush=flush)

    def slow_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        took.append(data)
        pulled.set()
        time.sleep(seconds)
        writer.stream.write(_engine_fasta(data))
        st.targets = len(group_ids(data, "m5"))
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", slow_devbuild)
    monkeypatch.setattr(native, "NativeEngine", HostEngine)
    return took


@needs_native
@pytest.mark.parametrize("force_dev", [False, True])
def test_hybrid_host_batches_queued_chunks(monkeypatch, force_dev):
    """With 4 KB chunks and a slow stub device, the host worker makes
    fewer engine calls than it takes chunks, and the FASTA is byte-equal
    to `host` and the 1-thread engine. Unforced, the probe deferral
    keeps the device off this short stream."""
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "4")
    monkeypatch.setenv("DAGCON_HYBRID_HEDGE", "0")
    if force_dev:
        monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    else:
        monkeypatch.delenv("DAGCON_HYBRID_FORCE_DEV", raising=False)
        monkeypatch.delenv("DAGCON_HYBRID_PROBE_DEFER_S", raising=False)
    took = _slow_device(monkeypatch, 0.3)
    text = _workload(48, seed=9)
    got, stats = _run(text, "hybrid")
    host, _ = _run(text, "host")
    assert got == host == _engine_fasta(text.encode())
    assert stats.targets == 48
    assert stats.hybrid_dev_chunks == len(took)
    assert (stats.hybrid_dev_chunks >= 1) == force_dev
    assert stats.hybrid_host_chunks >= 8
    assert 1 <= stats.engine_calls < stats.hybrid_host_chunks
    assert (stats.hybrid_host_bytes + stats.hybrid_dev_bytes
            == len(text.encode()))
    assert (stats.hybrid_host_bases + stats.hybrid_dev_bases
            == stats.consensus_bases)


@needs_native
def test_hybrid_split_with_empty_groups_and_recurring_ids(monkeypatch):
    """A stream whose groups emit nothing between others and whose ids
    recur in later chunks: byte-equal to `host` and the 1-thread engine;
    every batched call's chunks hold disjoint ids (a chunk that repeats
    an id starts the next call), and some call holds several chunks."""
    monkeypatch.delenv("DAGCON_HYBRID_FORCE_DEV", raising=False)
    monkeypatch.delenv("DAGCON_HYBRID_PROBE_DEFER_S", raising=False)
    calls: list[list[list[str]]] = []
    split = hybrid.split_fasta

    def recording_split(text, ids):
        calls.append(ids)
        return split(text, ids)

    monkeypatch.setattr(hybrid, "split_fasta", recording_split)
    text = _tricky() * 2
    stats = PipelineStats()
    got = _hybrid(text, 4, stats)
    host, hstats = _run(text, "host")
    assert got == host == _engine_fasta(text.encode())
    # The copies meet at two "a" groups, which make one: 23 groups.
    assert stats.targets == hstats.targets == len(
        group_ids(text.encode(), "m5")) == 23
    assert stats.fragments == host.count(">")
    assert calls and max(len(c) for c in calls) >= 2
    for ids in calls:
        seen: set[str] = set()
        for chunk in ids:
            assert seen.isdisjoint(chunk)
            seen.update(chunk)
    chunks = list(iter_group_chunks_blocks(_io.StringIO(text), "m5", 4096))
    assert stats.hybrid_host_chunks == len(chunks)
    assert stats.engine_calls < len(chunks)


class _ChunkCountingHost:
    """Host-engine stand-in that writes one record a group and records,
    for each call, the indices of the chunks it was fed. Each call waits
    (up to 30 s) until `pulled` is set."""

    chunks: list[bytes] = []
    calls: list[list[int]] = []
    pulled = threading.Event()

    def __init__(self, **kw):
        self.targets_done = 0

    def consensus_text(self, data, fmt="m5", flush=True):
        self.pulled.wait(30)
        type(self).calls.append(self._covered(data))
        ids = group_ids(data, "m5")
        self.targets_done += len(ids)
        return "".join(f">{s}/0_4\nACGT\n" for s in ids)

    def _covered(self, data) -> list[int]:
        """The run of consecutive chunks that `data` joins."""
        chunks = self.chunks
        for k in range(len(chunks)):
            j, n = k, 0
            while (n < len(data) and j < len(chunks)
                   and data.startswith(chunks[j], n)):
                n += len(chunks[j])
                j += 1
            if n == len(data):
                return list(range(k, j))
        raise AssertionError("a call was not a run of consecutive chunks")

    def status(self):
        return (0, 0, 0)

    def close(self):
        pass


def test_hybrid_reorder_window_holds_in_chunks(monkeypatch):
    """While the device stalls on chunk k, the host's batched calls
    finish no chunk past k + cap (the reorder window counted in chunks,
    not calls), and the run completes byte-equal once it resumes."""
    cap = 3
    monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    monkeypatch.setenv("DAGCON_HYBRID_HEDGE", "0")
    monkeypatch.setenv("DAGCON_HYBRID_REORDER_CAP", str(cap))
    text = _workload(64, seed=25, length=60, cov=3)
    chunks = list(iter_group_chunks_blocks(_io.StringIO(text), "m5", 1024))
    assert len(chunks) >= 15 and len(set(chunks)) == len(chunks)
    _ChunkCountingHost.chunks = chunks
    _ChunkCountingHost.calls = []
    _ChunkCountingHost.pulled = threading.Event()
    monkeypatch.setattr(native, "NativeEngine", _ChunkCountingHost)
    stalled: list[tuple[int, int]] = []

    def host_done() -> int:
        return max((k for c in _ChunkCountingHost.calls for k in c),
                   default=-1)

    def stalling_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        _ChunkCountingHost.pulled.set()  # the device holds a chunk
        if not stalled:
            k = chunks.index(data)
            last, t_last = None, time.monotonic()
            t_end = t_last + 30.0
            while time.monotonic() < t_end:
                now = (len(_ChunkCountingHost.calls), host_done())
                if now != last:
                    last, t_last = now, time.monotonic()
                elif time.monotonic() - t_last > 0.5:
                    break  # the host can get no further
                time.sleep(0.01)
            stalled.append((k, host_done()))
        ids = group_ids(data, "m5")
        writer.stream.write("".join(f">{s}/0_4\nACGT\n" for s in ids))
        st.targets = len(ids)
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", stalling_devbuild)
    stats = PipelineStats()
    got = _hybrid(text, 1, stats)
    want = "".join(f">{s}/0_4\nACGT\n"
                   for s in group_ids(text.encode(), "m5"))
    assert got == want
    assert stats.targets == 64
    assert stats.hybrid_dev_chunks + stats.hybrid_host_chunks == len(chunks)
    (k, done), = stalled
    assert done <= k + cap, (
        f"host finished chunk {done} while the device held chunk {k} "
        f"with a reorder window of {cap}")
    assert stats.engine_calls == len(_ChunkCountingHost.calls)
    assert any(len(c) > 1 for c in _ChunkCountingHost.calls)


class _OneRecordAGroup:
    """Host-engine stand-in: one record a group, no sleep."""

    def __init__(self, **kw):
        self.targets_done = 0

    def consensus_text(self, data, fmt="m5", flush=True):
        ids = group_ids(data, "m5")
        self.targets_done += len(ids)
        return "".join(f">{s}/0_4\nACGT\n" for s in ids)

    def status(self):
        return (0, 0, 0)

    def close(self):
        pass


def test_hybrid_batching_under_thread_stress(monkeypatch):
    """Twelve hybrid runs at once (more threads than cores) with a
    switch interval of a microsecond, forced device pulls and hedging on:
    every run writes each group once, in order, and counts each chunk
    once, whichever worker took it."""
    import sys

    monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    monkeypatch.setenv("DAGCON_HYBRID_HEDGE", "1")
    monkeypatch.setattr(native, "NativeEngine", _OneRecordAGroup)

    def fast_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        writer.stream.write(_OneRecordAGroup().consensus_text(data))
        st.targets = len(group_ids(data, "m5"))
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", fast_devbuild)
    texts = [_workload(24, seed=40 + i, length=60, cov=3) for i in range(12)]
    results: list = [None] * len(texts)

    def one(i: int) -> None:
        stats = PipelineStats()
        results[i] = (_hybrid(texts[i], 1, stats), stats)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for text, (got, stats) in zip(texts, results):
        ids = group_ids(text.encode(), "m5")
        assert got == "".join(f">{s}/0_4\nACGT\n" for s in ids)
        n = len(list(iter_group_chunks_blocks(_io.StringIO(text), "m5",
                                              1024)))
        assert stats.hybrid_host_chunks + stats.hybrid_dev_chunks == n
        assert stats.targets == len(ids) == 24
