"""The port's pipeline end to end on the CPU (`device="cpu"`: the DP's
plain PyTorch version): the golden FASTA files byte for byte, the JAX
package's `xla` output on a simulated pileup, and the counted host
fallbacks. The same path with the DP on the card is in
tests/test_torch_cuda.py."""

import io
import os
import sys

import pytest
import torch

from pbdagcon_tpu import native
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream as jax_run_stream
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_m5
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.convert import config_from_jax
from pbdagcon_tpu_torch.parallel.journal import TargetJournal
from pbdagcon_tpu_torch.pipeline import run_stream

DATA = os.path.join(os.path.dirname(__file__), "data")
M5 = os.path.join(DATA, "golden1.m5")
EXPECTED = open(os.path.join(DATA, "golden1.fa")).read()
PRE = os.path.join(DATA, "golden2.pre")
EXPECTED2 = open(os.path.join(DATA, "golden2.fa")).read()


def _run(path, cfg, journal=None):
    out = io.StringIO()
    with open(path) as f:
        stats = run_stream(f, FastaWriter(out), cfg, journal=journal)
    return out.getvalue(), stats


def _skip_without_native(use_native):
    if use_native and not native.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("backend", ["cuda", "host", "auto"])
@pytest.mark.parametrize("use_native", [True, False])
def test_golden1(backend, use_native):
    _skip_without_native(use_native)
    fa, stats = _run(M5, DagconConfig(
        backend=backend, use_native=use_native, device="cpu",
        min_weight=6, min_length=100,
    ))
    assert fa == EXPECTED
    assert stats.targets == 4 and stats.host_fallbacks == 0
    assert stats.batches == (0 if backend == "host" else 1)


@pytest.mark.parametrize("backend,use_native", [
    ("cuda", True), ("cuda", False), ("host", True),
])
def test_golden2_align_mode(backend, use_native):
    _skip_without_native(use_native)
    fa, _ = _run(PRE, DagconConfig(
        min_weight=5, min_length=80, fmt="pre", align=True,
        backend=backend, use_native=use_native, device="cpu",
    ))
    assert fa == EXPECTED2


@pytest.mark.parametrize("batch_targets", [1, 3])
def test_golden1_small_batches(batch_targets):
    """Several dispatches: exercises the retained-index bookkeeping."""
    _skip_without_native(True)
    fa, stats = _run(M5, DagconConfig(
        device="cpu", min_weight=6, min_length=100,
        batch_targets=batch_targets,
    ))
    assert fa == EXPECTED
    assert stats.batches == -(-4 // batch_targets)


@pytest.mark.parametrize("use_native", [True, False])
def test_oversize_targets_take_counted_host_dp(use_native):
    _skip_without_native(use_native)
    fa, stats = _run(M5, DagconConfig(
        device="cpu", min_weight=6, min_length=100, use_native=use_native,
        v_buckets=(1200,),
    ))
    assert fa == EXPECTED
    # Past the V ladder, the native-loader path runs the column-sharded
    # DP where the reference does (every such target of golden1), the
    # Python path the counted host DP.
    oversize = stats.host_fallbacks + stats.colshard
    assert 0 < oversize < 4
    if use_native:
        assert stats.colshard == oversize and stats.fallback_reasons == {}
    else:
        assert stats.colshard == 0
        assert stats.fallback_reasons == {"oversize": stats.host_fallbacks}


def _pileup_text() -> str:
    lines = [
        to_m5(a)
        for _t, _b, alns in simulate_targets(4242, 8, 300, 20, NoiseProfile())
        for a in alns
    ]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("use_native", [True, False])
def test_simulated_pileup_matches_jax_xla(use_native):
    _skip_without_native(use_native)
    text = _pileup_text()
    jcfg = JaxConfig(
        backend="xla", use_native=use_native, min_weight=5, min_length=50,
        v_buckets=(256, 512, 1024),
    )
    want = io.StringIO()
    jax_run_stream(io.StringIO(text), FastaWriter(want), jcfg)
    got = io.StringIO()
    stats = run_stream(
        io.StringIO(text), FastaWriter(got), config_from_jax(jcfg, "cpu")
    )
    assert want.getvalue().count(">") >= 8
    assert got.getvalue() == want.getvalue()
    assert stats.targets == 8


def test_threads_under_fast_switching_keep_order():
    """Producer, submitter and emitter share the engine's retained
    targets under `idx_lock`; with one target per dispatch and a tiny
    switch interval, a lost update would reorder or corrupt the FASTA."""
    _skip_without_native(True)
    text = _pileup_text()
    want = io.StringIO()
    run_stream(io.StringIO(text), FastaWriter(want), DagconConfig(
        backend="host", min_weight=5, min_length=50))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got = io.StringIO()
            stats = run_stream(
                io.StringIO(text).readlines(), FastaWriter(got),
                DagconConfig(device="cpu", min_weight=5, min_length=50,
                             batch_targets=1, threads=8),
            )
            assert got.getvalue() == want.getvalue()
            assert stats.batches == 8 and stats.targets == 8
    finally:
        sys.setswitchinterval(old)


def test_journal_marks_every_target(tmp_path):
    _skip_without_native(True)
    with TargetJournal(str(tmp_path / "j")) as j:
        _run(M5, DagconConfig(device="cpu", min_weight=6, min_length=100),
             journal=j)
        sids = {l[1:].rsplit("/", 1)[0] for l in EXPECTED.splitlines()
                if l.startswith(">")}
        assert all(s in j for s in sids)


def test_missing_cuda_raises_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for use_native in (True, False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run(M5, DagconConfig(min_weight=6, min_length=100,
                                  use_native=use_native))
