"""The port's devbuild path end to end on the CPU (`device="cpu"`: the
kernels' plain PyTorch versions): FASTA byte-equal to `--backend host`
on the cases of tests/test_devpipe.py, through the pure-Python and the
native streaming entries, and the caps choice equal to the JAX
package's. The same path on the card is in tests/test_torch_cuda.py."""

import functools
import io
import random
import threading

import numpy as np
import pytest

from pbdagcon_tpu import devpipe as jdevpipe
from pbdagcon_tpu import native
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream as jax_run_stream
from pbdagcon_tpu.simulate import (
    NoiseProfile,
    simulate_targets,
    to_m5,
    to_pre,
    to_pre_raw,
)
from pbdagcon_tpu_torch import devpipe
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.parallel.journal import TargetJournal
from pbdagcon_tpu_torch.pipeline import run_stream


def _run(text: str, backend: str, journal=None, **kw):
    buf = io.StringIO()
    cfg = DagconConfig(backend=backend, device="cpu", **kw)
    stats = run_stream(io.StringIO(text), FastaWriter(buf), cfg, journal=journal)
    return buf.getvalue(), stats


def _skip_without_native(use_native):
    if use_native and not native.available():
        pytest.skip("native library not built")


def _m5_text(seed, n, length, cov, flip_seed=31337, flip=0.3):
    rng = random.Random(flip_seed)
    lines = [
        to_m5(a, flip=rng.random() < flip)
        for _t, _b, alns in simulate_targets(seed, n, length, cov)
        for a in alns
    ]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("use_native", [False, True])
def test_devbuild_matches_host_m5(use_native):
    _skip_without_native(use_native)
    text = _m5_text(77, 6, 300, 12)
    kw = dict(min_weight=3, min_length=50, use_native=use_native)
    host, _ = _run(text, "host", **kw)
    dev, stats = _run(text, "devbuild", **kw)
    assert dev == host
    assert host.count(">") >= 6
    assert stats.targets == 6 and stats.batches >= 1
    # every target emitted by the device path, none by the host
    assert stats.host_fallbacks == 0 and not stats.fallback_reasons


@pytest.mark.parametrize("use_native", [False, True])
def test_devbuild_matches_host_pre_gappy(use_native):
    _skip_without_native(use_native)
    lines = [
        to_pre(a)
        for _t, _b, alns in simulate_targets(
            55, 4, 150, 8, NoiseProfile(sub=0.05, ins=0.2, dele=0.1)
        )
        for a in alns
    ]
    text = "\n".join(lines) + "\n"
    kw = dict(fmt="pre", min_weight=2, min_length=20, use_native=use_native)
    host, _ = _run(text, "host", **kw)
    dev, _ = _run(text, "devbuild", **kw)
    assert dev == host


def test_devbuild_with_trim_and_fallbacks():
    text = _m5_text(91, 3, 500, 25, flip=0.0)
    kw = dict(min_weight=4, min_length=100, trim=2, use_native=False)
    host, _ = _run(text, "host", **kw)
    dev, _ = _run(text, "devbuild", **kw)
    assert dev == host


def test_devbuild_native_streaming_matches_host(tmp_path):
    _skip_without_native(True)
    text = _m5_text(42, 5, 400, 18, flip_seed=11, flip=0.25)
    kw = dict(min_weight=3, min_length=60)
    host, _ = _run(text, "host", **kw)
    with TargetJournal(str(tmp_path / "j")) as j:
        dev, stats = _run(text, "devbuild", journal=j, **kw)
        assert all(
            l[1:].rsplit("/", 1)[0] in j
            for l in host.splitlines() if l.startswith(">")
        )
    assert dev == host
    assert stats.targets == 5
    assert {"encode", "fill", "build", "dp", "emit", "fetch"} <= set(stats.stage_s)


def test_devbuild_native_align_mode():
    _skip_without_native(True)
    lines = [
        to_pre_raw(a)
        for _t, _b, alns in simulate_targets(17, 3, 250, 10)
        for a in alns
    ]
    text = "\n".join(lines) + "\n"
    kw = dict(fmt="pre", align=True, min_weight=2, min_length=50)
    host, _ = _run(text, "host", **kw)
    dev, _ = _run(text, "devbuild", **kw)
    assert dev == host


def test_devbuild_native_multi_window_streaming():
    """Engine indices stay aligned across windows (of at least 32
    targets), in input order, with a repeated non-consecutive sid."""
    _skip_without_native(True)
    groups = list(simulate_targets(77, 69, 200, 8))
    groups.append(groups[3])
    rng = random.Random(5)
    lines = [
        to_m5(a, flip=rng.random() < 0.3)
        for _t, _b, alns in groups
        for a in alns
    ]
    text = "\n".join(lines) + "\n"
    kw = dict(min_weight=3, min_length=50)
    host, _ = _run(text, "host", **kw)
    dev, stats = _run(text, "devbuild", batch_targets=8, **kw)
    assert dev == host
    assert stats.targets == 70 and stats.batches >= 3
    assert stats.host_fallbacks == 0


def test_caps_for_equals_jax():
    for L in (256, 1024, 2048, 16384):
        for prof in (jdevpipe.DevCapsConfig.compact(),
                     jdevpipe.DevCapsConfig.heavy()):
            for kw in (
                {}, dict(nd_need=4608, v_need=1900),
                dict(ch_need=70, sm_need=9, nd_need=16383, dq_need=5,
                     se_need=13, w_need=40),
                dict(ch_need=1000, sm_need=40, dq_need=30, se_need=30,
                     w_need=200, v_need=100),
            ):
                want = jdevpipe.caps_for(128, 32, max(64, L + L // 4), L,
                                         prof, **kw)
                got = devpipe.caps_for(128, 32, max(64, L + L // 4), L,
                                       prof, **kw)
                assert got.__dict__ == want.__dict__


def test_choose_window_caps_equals_jax():
    rng = np.random.default_rng(77)
    states = ({}, {}, {}), ({}, {}, {})
    prof = jdevpipe.DevCapsConfig.heavy()
    for step in range(12):
        n = int(rng.integers(8, 129))
        m = np.zeros((n, 9), dtype=np.int64)
        m[:, 3] = rng.integers(100, 2000, n)
        m[:, 5:9] = rng.integers(1, 40, (n, 4))
        bkey = (32, 1280, 1024, prof.W)
        for st in states:
            st[0][bkey] = 48 + 16 * (step % 3)  # w_state
            st[1][bkey] = 1400 + 100 * step  # v_state
        want = jdevpipe.choose_window_caps(bkey, m, prof, *states[0])
        got = devpipe.choose_window_caps(bkey, m, prof, *states[1])
        assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("golden", ["golden1", "golden2"])
def test_devbuild_golden_files(golden, use_native):
    """The golden FASTA files byte for byte through the devbuild path
    (golden2: raw 'pre' records re-aligned with -a)."""
    import os

    _skip_without_native(use_native)
    data = os.path.join(os.path.dirname(__file__), "data")
    if golden == "golden1":
        path, kw = "golden1.m5", dict(min_weight=6, min_length=100)
    else:
        path, kw = "golden2.pre", dict(min_weight=5, min_length=80, fmt="pre",
                                       align=True, batch_targets=2)
    with open(os.path.join(data, path)) as f:
        text = f.read()
    got, stats = _run(text, "devbuild", use_native=use_native, **kw)
    assert got == open(os.path.join(data, golden + ".fa")).read()
    assert stats.batches >= 1


# A gap-heavy pileup whose six targets have 687-853 inserted bases; an
# insertion-stream cap of 750 sends four of them to the host before the
# device ("ins_cap"), and the other two through the device build.
INS_CAP = 750


@functools.lru_cache(maxsize=None)
def _ins_cap_text() -> str:
    rng = random.Random(31337)
    return "\n".join(
        to_m5(a, flip=rng.random() < 0.3)
        for _t, _b, alns in simulate_targets(
            77, 6, 300, 12, NoiseProfile(sub=0.03, ins=0.15, dele=0.06))
        for a in alns
    ) + "\n"


@functools.lru_cache(maxsize=None)
def _jax_ins_cap_fallbacks() -> int:
    """host_fallbacks of the JAX package's devbuild path under the same
    cap (it counts no reasons)."""
    real = jdevpipe.ins_cap
    jdevpipe.ins_cap = lambda caps: INS_CAP
    try:
        stats = jax_run_stream(
            io.StringIO(_ins_cap_text()), FastaWriter(io.StringIO()),
            JaxConfig(backend="devbuild", min_weight=3, min_length=50),
        )
    finally:
        jdevpipe.ins_cap = real
    return stats.host_fallbacks


@pytest.mark.parametrize("use_native", [True, False])
def test_devbuild_ins_cap_fallbacks_have_their_own_reason(use_native,
                                                         monkeypatch):
    """Targets past the insertion-stream cap count as "ins_cap", not
    "oversize"; the total and the FASTA are those of the host path and
    the JAX package's total."""
    _skip_without_native(use_native)
    text = _ins_cap_text()
    kw = dict(min_weight=3, min_length=50, use_native=use_native)
    host, _ = _run(text, "host", **kw)
    monkeypatch.setattr(devpipe, "ins_cap", lambda caps: INS_CAP)
    dev, stats = _run(text, "devbuild", **kw)
    assert dev == host
    assert stats.fallback_reasons == {"ins_cap": 4}
    assert stats.host_fallbacks == 4 == _jax_ins_cap_fallbacks()
    assert stats.batches >= 1  # the other two went through the device


def _multi_window_text() -> str:
    rng = random.Random(9)
    return "\n".join(
        to_m5(a, flip=rng.random() < 0.3)
        for _t, _b, alns in simulate_targets(2024, 100, 200, 8)
        for a in alns
    ) + "\n"


def test_devbuild_native_several_windows_equal_single_thread_engine():
    """Four windows of 32 targets (batch_targets 8, windows of at least
    32), the last one short: the FASTA is byte-equal to the host path
    and to the single-thread native engine's."""
    _skip_without_native(True)
    from pbdagcon_tpu_torch import native as tnative

    text = _multi_window_text()
    kw = dict(min_weight=3, min_length=50)
    host, _ = _run(text, "host", **kw)
    dev, stats = _run(text, "devbuild", batch_targets=8, **kw)
    with tnative.NativeEngine(min_weight=3, min_length=50, threads=1) as eng:
        single = eng.consensus_text(text.encode())
    assert dev == host == single
    assert stats.targets == 100 and stats.batches >= 4
    assert stats.host_fallbacks == 0


def test_devbuild_native_enqueues_outside_the_index_lock(monkeypatch):
    """Each window's batches are uploaded and enqueued while the emitter
    may write the previous window: `run_batch` of window k waits (at most
    20 s) until the emitter has cleared window k - 1, which it does under
    the index lock. A submitter that held the lock through its enqueue
    would time out here."""
    _skip_without_native(True)
    from pbdagcon_tpu_torch import native as tnative

    seen = {"windows": 0, "clears": 0}
    cleared = threading.Condition()
    real_metas = tnative.NativeEngine.enc_metas
    real_clear = tnative.NativeEngine.enc_clear
    real_run_batch = devpipe.run_batch

    def enc_metas(self, count, offset=0):
        seen["windows"] += 1  # once per window, under the lock
        return real_metas(self, count, offset=offset)

    def enc_clear(self, upto):
        real_clear(self, upto)
        with cleared:
            seen["clears"] += 1
            cleared.notify_all()

    def run_batch(*a, **k):
        previous = seen["windows"] - 1
        with cleared:
            if not cleared.wait_for(lambda: seen["clears"] >= previous,
                                    timeout=20):
                raise TimeoutError("the emitter never wrote the previous "
                                   "window while a batch was enqueued")
        return real_run_batch(*a, **k)

    monkeypatch.setattr(tnative.NativeEngine, "enc_metas", enc_metas)
    monkeypatch.setattr(tnative.NativeEngine, "enc_clear", enc_clear)
    monkeypatch.setattr(devpipe, "run_batch", run_batch)
    text = _multi_window_text()
    kw = dict(min_weight=3, min_length=50)
    host, _ = _run(text, "host", **kw)
    dev, stats = _run(text, "devbuild", batch_targets=8, **kw)
    assert dev == host
    assert seen["windows"] == 4 and seen["clears"] == 4
