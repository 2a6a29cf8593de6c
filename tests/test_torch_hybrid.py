"""The port's hybrid scheduler (`hybrid.py`, backend "hybrid"): the
reference's cases of tests/test_hybrid.py with the stubs patched into
the port's `native` and `devpipe` (group-aligned chunking, byte parity
with the host engine, the steal rule, the probe deferral, hedging, the
reorder window, attribution), the golden FASTA through
`backend="hybrid"` with `device="cpu"`, and the degrade rules."""

import io as _io
import os
import random

import pytest
import torch

from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.hybrid import iter_group_chunks
from pbdagcon_tpu_torch.io import FastaWriter, sid_of_line
from pbdagcon_tpu_torch.pipeline import run_stream
from pbdagcon_tpu_torch.simulate import simulate_targets, to_m5

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def _device_pulls_first(monkeypatch) -> None:
    """Hold the host worker's first chunk until the device worker has
    pulled one (up to 30 s), so that a run with forced pulls gives the
    device a chunk whatever the thread timing (with two chunks or more
    in the stream). Both workers still run the real engines."""
    import threading

    from pbdagcon_tpu_torch import devpipe

    pulled = threading.Event()
    run_devbuild = devpipe.run_devbuild_native

    def device_worker(*args, **kw):
        pulled.set()
        return run_devbuild(*args, **kw)

    class HostEngine(native.NativeEngine):
        def consensus_text(self, data, fmt="m5", flush=True):
            pulled.wait(30)
            return super().consensus_text(data, fmt=fmt, flush=flush)

    monkeypatch.setattr(devpipe, "run_devbuild_native", device_worker)
    monkeypatch.setattr(native, "NativeEngine", HostEngine)


def _workload(n_targets=10, length=240, cov=10, seed=5):
    lines = []
    rng = random.Random(seed)
    for _tid, _bb, alns in simulate_targets(seed, n_targets, length, cov):
        for a in alns:
            lines.append(to_m5(a, flip=rng.random() < 0.3))
    return "\n".join(lines) + "\n"


def test_iter_group_chunks_boundaries_and_reassembly():
    text = _workload(n_targets=9)
    chunks = list(iter_group_chunks(_io.StringIO(text), "m5", 2))
    # Re-assembly reproduces the input exactly (no blank lines here).
    assert b"".join(c for c, _ in chunks).decode() == text
    # Cuts are at group boundaries: last sid of chunk k != first of k+1.
    for (a, _na), (b, _nb) in zip(chunks, chunks[1:]):
        last = a.decode().splitlines()[-1]
        first = b.decode().splitlines()[0]
        assert sid_of_line(last, "m5") != sid_of_line(first, "m5")
    # Group counts sum to the total and respect the minimum.
    assert sum(n for _, n in chunks) == 9
    assert all(n >= 2 for _, n in chunks[:-1])


def test_block_chunker_group_aligned_reassembly():
    from pbdagcon_tpu_torch.hybrid import iter_group_chunks_blocks

    text = _workload(n_targets=9)
    for cb in (1 << 10, 4 << 10, 1 << 20):
        chunks = list(
            iter_group_chunks_blocks(_io.StringIO(text), "m5", cb)
        )
        assert b"".join(chunks).decode() == text
        for a, b in zip(chunks, chunks[1:]):
            last = a.decode().splitlines()[-1]
            first = b.decode().splitlines()[0]
            assert sid_of_line(last, "m5") != sid_of_line(first, "m5")


def test_block_chunker_single_group_and_no_trailing_newline():
    from pbdagcon_tpu_torch.hybrid import iter_group_chunks_blocks

    text = _workload(n_targets=1)
    chunks = list(
        iter_group_chunks_blocks(_io.StringIO(text.rstrip("\n")), "m5", 512)
    )
    assert len(chunks) == 1
    assert chunks[0].decode() == text


def test_iter_group_chunks_drops_blank_lines():
    text = _workload(n_targets=3)
    noisy = text.replace("\n", "\n\n", 4)
    chunks = list(iter_group_chunks(_io.StringIO(noisy), "m5", 1))
    assert b"".join(c for c, _ in chunks).decode() == text


def _run(text: str, backend: str, **kw):
    buf = _io.StringIO()
    cfg = DagconConfig(
        backend=backend, min_weight=3, min_length=50, **{"device": "cpu", **kw}
    )
    stats = run_stream(_io.StringIO(text), FastaWriter(buf), cfg)
    return buf.getvalue(), stats


@needs_native
def test_hybrid_matches_host(monkeypatch):
    # Force the device worker to participate (the rate rule would keep
    # a cold device idle on a tiny input), then require byte parity and
    # that BOTH workers actually processed chunks.
    monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "8")
    # Hedging off: with it on, the fast host would duplicate the forced
    # device's chunks and win, deduping the device's results to zero.
    monkeypatch.setenv("DAGCON_HYBRID_HEDGE", "0")
    text = _workload(n_targets=12, cov=8)
    host, _ = _run(text, "host")
    _device_pulls_first(monkeypatch)
    hyb, stats = _run(text, "hybrid", batch_targets=4)
    assert hyb == host
    assert stats.targets == 12
    assert stats.hybrid_dev_chunks >= 1
    assert stats.hybrid_host_chunks + stats.hybrid_dev_chunks >= 2


@needs_native
def test_hybrid_unforced_parity(monkeypatch):
    # Without forcing, the rate rule may route everything to the host;
    # output must still be byte-identical and complete.
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "8")
    text = _workload(n_targets=8, cov=8, seed=11)
    host, _ = _run(text, "host")
    hyb, stats = _run(text, "hybrid", batch_targets=4)
    assert hyb == host
    assert stats.targets == 8


@needs_native
def test_hybrid_journal(tmp_path, monkeypatch):
    monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "8")
    from pbdagcon_tpu_torch.parallel.journal import TargetJournal

    text = _workload(n_targets=6, cov=8, seed=7)
    buf = _io.StringIO()
    cfg = DagconConfig(
        backend="hybrid", min_weight=3, min_length=50, batch_targets=4,
        device="cpu",
    )
    j = TargetJournal(str(tmp_path / "j.log"))
    run_stream(_io.StringIO(text), FastaWriter(buf), cfg, journal=j)
    for line in buf.getvalue().splitlines():
        if line.startswith(">"):
            assert line[1:].rsplit("/", 1)[0] in j


def test_dev_should_pull_rule():
    """The steal rule as a pure function (VERDICT r2 #5): share follows
    the measured rate ratio, taper protects the tail."""
    from pbdagcon_tpu_torch.hybrid import dev_should_pull

    # Chunker still reading: device helps iff >= 2 chunks queued.
    assert not dev_should_pull([100], None, None, False)
    assert dev_should_pull([100, 100], None, None, False)
    # EOF, unmeasured host rate: host leads.
    assert not dev_should_pull([100, 100], None, None, True)
    # EOF, device 10x faster: pulls even with a short tail.
    assert dev_should_pull([100, 100], 1e-5, 1e-6, True)
    # EOF, device 10x slower: pulling the head (d*n = 1e-4*100 = 10ms)
    # is longer than the host's drain of the rest (1e-5*100 = 1ms) —
    # the device must NOT become the critical-path tail.
    assert not dev_should_pull([100, 100], 1e-5, 1e-4, True)
    # Profitability gate: a measured device slower than beta x host is
    # net-negative (its host-side stages cost ~1/beta of the cores), so
    # it retires even with a deep backlog or mid-stream...
    assert not dev_should_pull([100] + [100] * 50, 1e-5, 1e-4, True)
    assert not dev_should_pull([100, 100, 100], 1e-5, 1e-4, False)
    # ...unless beta says its host-stage cost is negligible.
    assert dev_should_pull([100] + [100] * 50, 1e-5, 1e-4, True, beta=20)
    # Unmeasured device rate mid-stream: one probe pull is allowed.
    assert dev_should_pull([100, 100, 100], 1e-5, None, False)
    # A profitable device (d < beta * h) keeps pulling mid-stream.
    assert dev_should_pull([100, 100], 1e-5, 2e-5, False)
    # Empty queue: nothing to pull.
    assert not dev_should_pull([], 1e-5, 1e-6, True)


class _FakeHostEngine:
    """NativeEngine stand-in with a controlled seconds/byte rate and a
    deterministic per-group FASTA output (parity between workers holds
    by construction)."""

    spb = 1e-6  # class attr: tests set before constructing

    def __init__(self, **kw):
        self.targets_done = 0

    @staticmethod
    def fasta_for(data: bytes) -> tuple[str, int]:
        sids: list[str] = []
        for line in data.decode().splitlines():
            if line.strip():
                sid = sid_of_line(line, "m5")
                if not sids or sids[-1] != sid:
                    sids.append(sid)
        return "".join(f">{s}/0_4\nACGT\n" for s in sids), len(sids)

    def consensus_text(self, data, fmt="m5", flush=True):
        import time

        time.sleep(type(self).spb * len(data))
        text, n = self.fasta_for(data)
        self.targets_done += n
        return text

    def status(self):
        return (0, 0, 0)

    def close(self):
        pass


def _run_stub_hybrid(monkeypatch, text: str, host_spb: float,
                     dev_spb: float, chunk_kb: int = 1):
    """run_stream_hybrid with BOTH workers stubbed to controlled
    per-byte rates; returns (fasta, stats)."""
    import time

    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.hybrid import run_stream_hybrid
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", str(chunk_kb))
    monkeypatch.delenv("DAGCON_HYBRID_FORCE_DEV", raising=False)
    # These tests exercise the steal rule, not the probe deferral —
    # the stub device has no warmup cost to amortize.
    monkeypatch.setenv("DAGCON_HYBRID_PROBE_DEFER_S", "0")
    _FakeHostEngine.spb = host_spb
    monkeypatch.setattr(native, "NativeEngine", _FakeHostEngine)

    def fake_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        time.sleep(dev_spb * len(data))
        fasta, n = _FakeHostEngine.fasta_for(data)
        writer.stream.write(fasta)
        st.targets = n
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", fake_devbuild)
    buf = _io.StringIO()
    cfg = DagconConfig(backend="hybrid", min_weight=3, min_length=50)
    stats = PipelineStats()
    run_stream_hybrid(_io.StringIO(text), FastaWriter(buf), cfg, stats, CPU)
    return buf.getvalue(), stats


@pytest.mark.parametrize("ratio,lo,hi", [
    (10.0, 0.45, 1.0),   # device 10x faster: takes the clear majority
    (1.0, 0.15, 0.85),   # equal rates: both contribute materially
    (0.1, 0.0, 0.40),    # device 10x slower: host dominates
])
def test_hybrid_share_converges_to_rate_ratio(monkeypatch, ratio, lo, hi):
    """Chunk shares track the device:host rate ratio (VERDICT r2 #5).
    Bounds are deliberately loose — EMAs need a few chunks to converge
    and scheduling noise is real — but they separate the three regimes."""
    text = _workload(n_targets=64, length=60, cov=3, seed=21)
    host_spb = 6e-6  # ~6ms per 1KB chunk
    fasta, stats = _run_stub_hybrid(
        monkeypatch, text, host_spb, host_spb / ratio
    )
    total = stats.hybrid_dev_chunks + stats.hybrid_host_chunks
    assert stats.targets == 64
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert fasta == expect
    share = stats.hybrid_dev_chunks / total
    assert lo <= share <= hi, (
        f"dev share {share:.2f} outside [{lo}, {hi}] at ratio {ratio} "
        f"(dev={stats.hybrid_dev_chunks}/{total})"
    )


def test_hybrid_taper_keeps_slow_device_off_tail(monkeypatch):
    """A device 50x slower than the host must take (almost) nothing:
    the end-of-stream taper refuses steals whose chunk would outlive
    the host's drain of the remaining queue."""
    text = _workload(n_targets=48, length=60, cov=3, seed=22)
    host_spb = 4e-6
    fasta, stats = _run_stub_hybrid(
        monkeypatch, text, host_spb, host_spb * 50
    )
    total = stats.hybrid_dev_chunks + stats.hybrid_host_chunks
    assert stats.targets == 48
    assert stats.hybrid_dev_chunks <= max(2, total // 5), (
        f"slow device took {stats.hybrid_dev_chunks}/{total} chunks"
    )


def test_hybrid_probe_deferred_on_short_stream(monkeypatch):
    """The never-worse floor, by construction (VERDICT r4 #4): on a
    stream shorter than the probe-deferral window, the device must take
    ZERO chunks — its first pull would trigger warmup whose host-side
    CPU cost is exactly how BENCH_r04's hybrid landed 12% below
    host-only. Output parity is unchanged (host processes everything)."""
    import time

    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.hybrid import run_stream_hybrid
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    text = _workload(n_targets=48, length=60, cov=3, seed=31)
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "1")
    monkeypatch.delenv("DAGCON_HYBRID_FORCE_DEV", raising=False)
    monkeypatch.setenv("DAGCON_HYBRID_PROBE_DEFER_S", "3600")
    _FakeHostEngine.spb = 2e-6
    monkeypatch.setattr(native, "NativeEngine", _FakeHostEngine)
    pulled = [0]

    def fake_devbuild(stream, writer, dcfg, st, device):
        pulled[0] += 1
        data = stream.read()
        fasta, n = _FakeHostEngine.fasta_for(data)
        writer.stream.write(fasta)
        st.targets = n
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", fake_devbuild)
    buf = _io.StringIO()
    cfg = DagconConfig(backend="hybrid", min_weight=3, min_length=50)
    stats = PipelineStats()
    run_stream_hybrid(_io.StringIO(text), FastaWriter(buf), cfg, stats, CPU)
    assert pulled[0] == 0, "device probed inside the deferral window"
    assert stats.hybrid_dev_chunks == 0
    assert stats.targets == 48
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert buf.getvalue() == expect


def test_hybrid_probe_allowed_when_host_drowns(monkeypatch):
    """The deferral yields early when the queue saturates: a host that
    cannot keep up releases the probe at defer/4 instead of stalling
    the stream for the full window."""
    import time

    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.hybrid import run_stream_hybrid
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    text = _workload(n_targets=64, length=60, cov=3, seed=32)
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "1")
    monkeypatch.delenv("DAGCON_HYBRID_FORCE_DEV", raising=False)
    # defer = 2s -> saturated queue releases the probe after 0.5s.
    monkeypatch.setenv("DAGCON_HYBRID_PROBE_DEFER_S", "2")
    _FakeHostEngine.spb = 3e-4  # slow host: queue saturates
    monkeypatch.setattr(native, "NativeEngine", _FakeHostEngine)

    def fake_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        fasta, n = _FakeHostEngine.fasta_for(data)
        writer.stream.write(fasta)
        st.targets = n
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", fake_devbuild)
    buf = _io.StringIO()
    cfg = DagconConfig(backend="hybrid", min_weight=3, min_length=50)
    stats = PipelineStats()
    t0 = time.monotonic()
    run_stream_hybrid(_io.StringIO(text), FastaWriter(buf), cfg, stats, CPU)
    assert stats.hybrid_dev_chunks >= 1, (
        "drowning host never released the probe"
    )
    assert stats.targets == 64
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert buf.getvalue() == expect


def test_hybrid_attribution_stats(monkeypatch):
    """Per-worker bytes/bases/busy-seconds add up to the totals."""
    text = _workload(n_targets=32, length=60, cov=3, seed=23)
    fasta, stats = _run_stub_hybrid(monkeypatch, text, 5e-6, 5e-6)
    assert stats.hybrid_dev_bytes + stats.hybrid_host_bytes == len(
        text.encode()
    )
    assert (
        stats.hybrid_dev_bases + stats.hybrid_host_bases
        == stats.consensus_bases
    )
    if stats.hybrid_dev_chunks:
        assert stats.hybrid_dev_busy_s > 0
    assert stats.hybrid_host_busy_s > 0


def test_hybrid_malformed_record_raises_valueerror():
    """Chunker paths surface malformed records as the engines'
    ValueError policy, not a bare IndexError (ADVICE r2)."""
    from pbdagcon_tpu_torch.hybrid import _last_group_cut, iter_group_chunks

    with pytest.raises(ValueError, match="malformed alignment record"):
        list(iter_group_chunks(iter(["bad record\n"]), "m5", 1))
    good = _workload(n_targets=2, length=60, cov=3, seed=24)
    with pytest.raises(ValueError, match="malformed alignment record"):
        _last_group_cut(good.encode() + b"bad record\n", "m5")


def test_hybrid_reorder_window_capped(monkeypatch):
    """While the device holds chunk k, the host may finish at most the
    chunks below k and the reorder window above it: k + cap chunks. The
    bound uses the stalled chunk's own index (whichever chunk the device
    happens to take first), and the stall ends when the host has stopped
    (it reached k + cap and made no progress for a while), not after a
    fixed sleep. Hedging is off: it would legitimately finish chunk k on
    the host once nothing else is left."""
    import time as _time

    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.hybrid import (
        iter_group_chunks_blocks,
        run_stream_hybrid,
    )
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    cap = 3
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "1")
    monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    monkeypatch.setenv("DAGCON_HYBRID_HEDGE", "0")
    monkeypatch.setenv("DAGCON_HYBRID_REORDER_CAP", str(cap))
    text = _workload(n_targets=64, length=60, cov=3, seed=25)
    chunks = list(iter_group_chunks_blocks(_io.StringIO(text), "m5", 1024))
    assert len(chunks) >= 15 and len(set(chunks)) == len(chunks)

    class _CountingHost(_FakeHostEngine):
        spb = 0.0
        done = [0]

        def consensus_text(self, data, fmt="m5", flush=True):
            out = super().consensus_text(data, fmt=fmt, flush=flush)
            type(self).done[0] += 1
            return out

    _CountingHost.done[0] = 0
    monkeypatch.setattr(native, "NativeEngine", _CountingHost)
    stalled = []  # (k, host chunks done when the stall ended)

    def stalling_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        if not stalled:
            k = chunks.index(data)
            # Wait until the host reached k + cap chunks or can get no
            # further (no progress for 0.5 s), at most 30 s.
            t_end = _time.monotonic() + 30.0
            last, t_last = -1, _time.monotonic()
            while _time.monotonic() < t_end:
                now = _CountingHost.done[0]
                if now != last:
                    last, t_last = now, _time.monotonic()
                elif _time.monotonic() - t_last > 0.5 and (
                    now >= min(k + cap, len(chunks) - 1)
                ):
                    break
                _time.sleep(0.01)
            stalled.append((k, _CountingHost.done[0]))
        fasta, n = _FakeHostEngine.fasta_for(data)
        writer.stream.write(fasta)
        st.targets = n
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", stalling_devbuild)
    buf = _io.StringIO()
    cfg = DagconConfig(backend="hybrid", min_weight=3, min_length=50)
    stats = PipelineStats()
    run_stream_hybrid(_io.StringIO(text), FastaWriter(buf), cfg, stats, CPU)
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert buf.getvalue() == expect
    assert stats.targets == 64
    assert stats.hybrid_dev_chunks + stats.hybrid_host_chunks == len(chunks)
    (k, host_done), = stalled
    assert host_done <= k + cap, (
        f"host ran {host_done} chunks past the device's stalled chunk "
        f"{k} with a reorder window of {cap}"
    )


def test_hybrid_degrades_without_native():
    # use_native=False: backend=hybrid must degrade to a working
    # single-worker path, not crash.
    text = _workload(n_targets=4, cov=8, seed=3)
    host, _ = _run(text, "host", use_native=False)
    hyb, _ = _run(text, "hybrid", use_native=False)
    assert hyb == host


def test_hybrid_host_hedges_stalled_device(monkeypatch):
    """A device that stalls for a long time on its chunk (e.g. a cold
    jit compile) must not block the output pipeline: the idle host
    re-processes (hedges) the in-flight chunk, the writer takes the
    first byte-identical result, and the run's wall time tracks the
    HOST, not the stalled device."""
    import time as _time

    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.hybrid import run_stream_hybrid
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "1")
    monkeypatch.delenv("DAGCON_HYBRID_FORCE_DEV", raising=False)
    _FakeHostEngine.spb = 1e-6
    monkeypatch.setattr(native, "NativeEngine", _FakeHostEngine)
    stall_s = 8.0

    def stalled_devbuild(stream, writer, dcfg, st, device):
        data = stream.read()
        _time.sleep(stall_s)  # cold compile stand-in
        fasta, n = _FakeHostEngine.fasta_for(data)
        writer.stream.write(fasta)
        st.targets = n
        return st

    monkeypatch.setattr(devpipe, "run_devbuild_native", stalled_devbuild)
    text = _workload(n_targets=64, length=60, cov=3, seed=31)
    buf = _io.StringIO()
    cfg = DagconConfig(backend="hybrid", min_weight=3, min_length=50)
    stats = PipelineStats()
    t0 = _time.time()
    run_stream_hybrid(_io.StringIO(text), FastaWriter(buf), cfg, stats, CPU)
    wall = _time.time() - t0
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert buf.getvalue() == expect
    assert stats.targets == 64
    # The run must wait for the one stalled device chunk (the worker is
    # joined) but NOT serialize the rest of the stream behind it; with
    # hedging the host finishes everything else during the stall.
    assert wall < stall_s + 3.0, f"hedging failed: wall {wall:.1f}s"
    # The duplicate (hedged) result must not double-count bases.
    assert stats.consensus_bases == sum(
        len(l) for l in expect.splitlines() if not l.startswith(">")
    )


def test_hybrid_fast_device_takes_stream_and_beats_host(monkeypatch):
    """The 'real TPU host' claim, pinned by its simulation (VERDICT r3
    #7): with the device 10x faster per byte, the scheduler must (a)
    hand the device the clear majority of chunks and (b) finish the
    stream well under the host-only wall time — i.e. aggregate
    throughput approaches the device rate instead of being dragged to
    the host's."""
    import time as _time

    text = _workload(n_targets=96, length=60, cov=3, seed=23)
    host_spb = 8e-6
    t0 = _time.time()
    fasta, stats = _run_stub_hybrid(
        monkeypatch, text, host_spb, host_spb / 10.0
    )
    wall = _time.time() - t0
    host_only_wall = host_spb * len(text.encode())
    total = stats.hybrid_dev_chunks + stats.hybrid_host_chunks
    share = stats.hybrid_dev_chunks / total
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert fasta == expect
    assert share >= 0.5, f"fast device only took {share:.2f} of chunks"
    # Host-only would take ~host_spb * bytes of pure processing; the
    # hybrid with a 10x device must land clearly below that even with
    # scheduling overhead (loose 0.75 bound: the invariant is 'never
    # dragged to host-only', not an exact rate).
    assert wall <= 0.75 * host_only_wall + 0.25, (
        f"hybrid wall {wall:.2f}s vs host-only ~{host_only_wall:.2f}s"
    )


def test_hybrid_never_worse_guard_stub(monkeypatch):
    """Floor under hybrid (VERDICT r3 #7): at EQUAL stub rates the
    aggregate must not regress materially below host-only — the
    profitability gate + hedging may only cost bounded overhead."""
    import time as _time

    text = _workload(n_targets=96, length=60, cov=3, seed=24)
    host_spb = 8e-6
    t0 = _time.time()
    fasta, stats = _run_stub_hybrid(monkeypatch, text, host_spb, host_spb)
    wall = _time.time() - t0
    host_only_wall = host_spb * len(text.encode())
    expect, _ = _FakeHostEngine.fasta_for(text.encode())
    assert fasta == expect
    # two equal workers should be FASTER than one; never >10% slower
    # (plus a fixed 0.3s slack for thread spin-up on loaded CI boxes).
    assert wall <= 1.1 * host_only_wall + 0.3, (
        f"hybrid wall {wall:.2f}s vs host-only ~{host_only_wall:.2f}s"
    )


@needs_native
@pytest.mark.parametrize("name,fmt,kw", [
    ("golden1", "m5", dict(min_weight=6, min_length=100)),
    ("golden2", "pre", dict(min_weight=5, min_length=80, align=True)),
])
def test_golden_through_hybrid(monkeypatch, name, fmt, kw):
    """Both workers on the golden files (the device's chunks on the
    devbuild path's plain versions): byte-equal to the expected FASTA."""
    monkeypatch.setenv("DAGCON_HYBRID_FORCE_DEV", "1")
    monkeypatch.setenv("DAGCON_HYBRID_HEDGE", "0")
    monkeypatch.setenv("DAGCON_HYBRID_CHUNK_KB", "4")
    _device_pulls_first(monkeypatch)
    buf = _io.StringIO()
    with open(os.path.join(DATA, f"{name}.{fmt}")) as f:
        stats = run_stream(f, FastaWriter(buf), DagconConfig(
            backend="hybrid", fmt=fmt, device="cpu", batch_targets=2, **kw))
    assert buf.getvalue() == open(os.path.join(DATA, f"{name}.fa")).read()
    assert stats.hybrid_dev_chunks >= 1
    assert stats.hybrid_dev_first_s > 0


@needs_native
def test_hybrid_refuses_an_absent_card():
    """A missing card raises; it never becomes a host-only run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(_workload(n_targets=2), "hybrid", device="cuda")


@needs_native
def test_cli_takes_the_hybrid_backend(capsys):
    from pbdagcon_tpu_torch import cli

    assert cli.main([os.path.join(DATA, "golden1.m5"), "--backend", "hybrid",
                     "-c", "6", "-m", "100", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == open(
        os.path.join(DATA, "golden1.fa")).read()
