"""`--backend auto` in the port's `run_stream` against the reference's:
the hybrid scheduler on a card with the native engine present unless
DAGCON_AUTO_HYBRID=0, the batched DP ("cuda", the reference's "xla")
otherwise. Both entry points run on the same tiny M5 text with the
branch each takes patched by `monkeypatch` (the JAX package is not
edited): a stub of `jax.devices` and of `pbdagcon_tpu.native.available`
on the reference's side, a stub of the card check
(`torch.cuda.is_available`) and of the port's `native.available` on the
port's side, and recorders in place of the paths each may take."""

import io
import os
import types

import jax
import pytest
import torch

import pbdagcon_tpu.devpipe as j_devpipe
import pbdagcon_tpu.hybrid as j_hybrid
import pbdagcon_tpu.native as j_native
import pbdagcon_tpu.pipeline as j_pipeline
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.io import FastaWriter as JaxWriter
from pbdagcon_tpu_torch import devpipe, hybrid, native, pipeline
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter

DATA = os.path.join(os.path.dirname(__file__), "data")
M5 = os.path.join(DATA, "golden1.m5")
EXPECTED = open(os.path.join(DATA, "golden1.fa")).read()
KNOBS = dict(min_weight=6, min_length=100)


def _record_jax(monkeypatch, platform: str, engine: bool) -> list:
    """Patch the reference's branches; returns the list each taken path
    appends its name to ("hybrid", or the batch backend of the native or
    pure-Python path, or "devbuild")."""
    taken: list = []
    monkeypatch.setenv("DAGCON_JAX_CACHE", "0")
    monkeypatch.setattr(
        jax, "devices",
        lambda *a, **k: [types.SimpleNamespace(platform=platform)])
    monkeypatch.setattr(j_native, "available", lambda *a, **k: engine)
    monkeypatch.setattr(j_hybrid, "run_stream_hybrid",
                        lambda *a, **k: taken.append("hybrid"))
    monkeypatch.setattr(j_pipeline, "_run_stream_native",
                        lambda s, o, cfg, backend, *a, **k:
                        taken.append(backend))

    def run_pipeline(groups, cfg, stats=None):
        taken.append(j_pipeline.resolve_backend(cfg))
        return iter(())

    monkeypatch.setattr(j_pipeline, "run_pipeline", run_pipeline)
    monkeypatch.setattr(j_devpipe, "run_devbuild_native",
                        lambda *a, **k: taken.append("devbuild"))
    return taken


def _record_port(monkeypatch, card: bool, engine: bool) -> list:
    """Patch the port's branches as `_record_jax` patches the
    reference's; "hybrid" is recorded with the device and journal it
    was given."""
    taken: list = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(native, "available", lambda *a, **k: engine)
    monkeypatch.setattr(
        hybrid, "run_stream_hybrid",
        lambda s, o, cfg, stats, device, journal=None:
        taken.append(("hybrid", device, journal)))
    monkeypatch.setattr(pipeline, "_run_stream_native",
                        lambda s, o, cfg, backend, *a, **k:
                        taken.append(backend))

    def run_pipeline(groups, cfg, stats=None):
        taken.append(pipeline.resolve_backend(cfg))
        return iter(())

    monkeypatch.setattr(pipeline, "run_pipeline", run_pipeline)
    monkeypatch.setattr(devpipe, "run_devbuild_native",
                        lambda *a, **k: taken.append("devbuild"))
    return taken


def _jax_choice(monkeypatch, backend, platform, engine) -> str:
    taken = _record_jax(monkeypatch, platform, engine)
    with open(M5) as f:
        j_pipeline.run_stream(f, JaxWriter(io.StringIO()),
                              JaxConfig(backend=backend, **KNOBS))
    (choice,) = taken
    return {"xla": "cuda"}.get(choice, choice)


def _port_choice(monkeypatch, backend, card, engine, device="cuda",
                 journal=None):
    taken = _record_port(monkeypatch, card, engine)
    with open(M5) as f:
        pipeline.run_stream(
            f, FastaWriter(io.StringIO()),
            DagconConfig(backend=backend,
                         device=device if card else "cpu", **KNOBS),
            journal=journal)
    (choice,) = taken
    return choice


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("card", [True, False])
def test_auto_resolves_as_the_reference(monkeypatch, card, engine, env):
    """{card, CPU} x {engine, no engine} x {DAGCON_AUTO_HYBRID unset,
    "0", "1"}: the same choice on both sides."""
    if env is None:
        monkeypatch.delenv("DAGCON_AUTO_HYBRID", raising=False)
    else:
        monkeypatch.setenv("DAGCON_AUTO_HYBRID", env)
    want = _jax_choice(monkeypatch, "auto", "gpu" if card else "cpu", engine)
    got = _port_choice(monkeypatch, "auto", card, engine)
    got = got[0] if isinstance(got, tuple) else got
    assert got == want
    assert want == ("hybrid" if card and engine and env != "0" else "cuda")


def test_auto_hybrid_gets_the_runs_device_and_journal(monkeypatch, caplog):
    monkeypatch.delenv("DAGCON_AUTO_HYBRID", raising=False)
    journal = object()
    with caplog.at_level("WARNING", logger="pbdagcon_tpu_torch"):
        got = _port_choice(monkeypatch, "auto", True, True, device="cuda:1",
                           journal=journal)
    assert got == ("hybrid", torch.device("cuda:1"), journal)
    assert "backend=auto resolved to the hybrid scheduler" in caplog.text
    # resolve_backend, which the batch paths ask, still reads "cuda".
    assert pipeline.resolve_backend(DagconConfig()) == "cuda"


@pytest.mark.parametrize("backend,jax_backend", [
    ("cuda", "xla"), ("blocked", "blocked"), ("devbuild", "devbuild"),
    ("hybrid", "hybrid"), ("host", "host"),
])
def test_explicit_backend_is_not_re_resolved(monkeypatch, backend,
                                             jax_backend):
    """On a card with the engine and DAGCON_AUTO_HYBRID=1 an explicit
    backend runs as named, on both sides."""
    monkeypatch.setenv("DAGCON_AUTO_HYBRID", "1")
    want = _jax_choice(monkeypatch, jax_backend, "gpu", True)
    got = _port_choice(monkeypatch, backend, True, True)
    got = got[0] if isinstance(got, tuple) else got
    assert got == want == backend


def test_auto_on_cpu_runs_cuda_not_hybrid(monkeypatch):
    """`device="cpu"` keeps "auto" on the batched DP's plain version even
    with DAGCON_AUTO_HYBRID=1: the golden FASTA, one batch, no hybrid
    chunk."""
    if not native.available():
        pytest.skip("native library not built")
    monkeypatch.setenv("DAGCON_AUTO_HYBRID", "1")
    out = io.StringIO()
    with open(M5) as f:
        st = pipeline.run_stream(f, FastaWriter(out),
                                 DagconConfig(device="cpu", **KNOBS))
    assert out.getvalue() == EXPECTED
    assert st.batches == 1
    assert st.hybrid_host_chunks == st.hybrid_dev_chunks == 0


def test_auto_without_a_card_raises(monkeypatch):
    """A requested card that is absent raises before any path runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with open(M5) as f:
            pipeline.run_stream(f, FastaWriter(io.StringIO()),
                                DagconConfig(**KNOBS))


def test_cli_help_states_the_auto_rule():
    from pbdagcon_tpu_torch import cli

    text = " ".join(cli.build_parser().format_help().split())
    assert "auto = cuda" not in text
    assert ("auto = hybrid on a card with the native engine "
            "(DAGCON_AUTO_HYBRID=0 opts out), else cuda") in text
