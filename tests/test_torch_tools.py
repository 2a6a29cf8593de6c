"""The port's high-depth and soak tools (`pbdagcon_tpu_torch/tools/`:
`bench_highdepth`, `soak_stream`, `soak_devbuild`, `soak_multirank`,
`scaling_bench`) at tiny sizes on the CPU, each through the port's own
entry points with `--device cpu`. The high-depth workload's FASTA is
held against the JAX package's devbuild run on the same records."""

import io
import json

import pytest

from pbdagcon_tpu import devpipe as jax_devpipe
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.io import FastaWriter as JaxWriter
from pbdagcon_tpu.pipeline import run_stream as jax_run_stream
from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.tools import (
    bench_highdepth,
    scaling_bench,
    soak_devbuild,
    soak_multirank,
    soak_stream,
)


@pytest.fixture(autouse=True)
def _native():
    if not native.ensure_built():
        pytest.skip("native engine not built")


def _report(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_bench_highdepth_parity_at_a_deep_rung(monkeypatch):
    """4 targets x 200 bp x 100x: `cuda` and devbuild byte-equal to the
    1-core host run and to the JAX package's devbuild run on the same
    records, with the same host fallbacks; both packages' devbuild
    batches take an R rung above 64."""
    rep = bench_highdepth.bench(100, 4, 200, device="cpu",
                                backends=("cuda", "devbuild"), reps=1,
                                log=lambda *a: None)
    assert rep["parity"]
    assert all(b["parity"] for b in rep["backends"].values())
    dev = rep["backends"]["devbuild"]
    assert max(r["R"] for r in dev["rungs"]) > 64, dev["rungs"]
    assert sum(dev["fallback_reasons"].values()) == dev["host_fallbacks"]

    ref_rs = []
    choose = jax_devpipe.choose_window_caps

    def recording(*args, **kw):
        caps = choose(*args, **kw)
        ref_rs.append(caps.R)
        return caps

    monkeypatch.setattr(jax_devpipe, "choose_window_caps", recording)
    text = bench_highdepth.highdepth_text(100, 4, 200)
    ref = io.StringIO()
    ref_st = jax_run_stream(io.BytesIO(text), JaxWriter(ref), JaxConfig(
        fmt="m5", align=False, min_weight=25, min_length=100,
        backend="devbuild", use_native=True, threads=1))
    assert ref_rs and max(ref_rs) > 64, ref_rs
    assert ref_st.host_fallbacks == dev["host_fallbacks"]
    for backend in ("cuda", "devbuild"):
        port = bench_highdepth.run_backend(text, backend, 100, "cpu",
                                           threads=1)
        assert port["fasta"] == ref.getvalue(), backend


def test_bench_highdepth_counts_the_node_cap_fallback():
    """At 200x a 1000 bp target inserts more bases than the 14-bit node
    cap holds: devbuild sends it to the host, counted as "ins_cap", and
    the FASTA stays byte-equal."""
    rep = bench_highdepth.bench(200, 1, 1000, device="cpu",
                                backends=("devbuild",), reps=1,
                                log=lambda *a: None)
    dev = rep["backends"]["devbuild"]
    assert rep["parity"] and dev["fallback_reasons"] == {"ins_cap": 1}


def test_exec_only_at_depth():
    rep = bench_highdepth.exec_only(100, 4, 200, device="cpu", steps=1,
                                    log=lambda *a: None)
    assert rep["R"] > 64 and rep["targets"] == 4 and rep["bases_per_s"] > 0
    assert 0 <= rep["flagged"] <= 4


def test_soak_stream_killed_and_resumed(tmp_path, capsys):
    """Killed and resumed: complete, exactly once, and the merged output
    equal to an uninterrupted run's (`--verify-full`); 300 targets are
    too few for a steady window, so the RSS bound is not judged."""
    assert soak_stream.main([
        "300", "--backend", "host", "--device", "cpu", "--chunk-mb", "1",
        "--poll", "0.05", "--threads", "2", "--exactly-once-only",
        "--verify-full", "--workdir", str(tmp_path)]) == 0
    rep = _report(capsys)
    assert 0 < rep["journaled_at_kill"] < 300 and rep["verify_full"]
    assert rep["emitted_targets"] == 300 and rep["bases"] > 0
    assert rep["rss_last_q_mb"] is None


def _samples(journaled, rss):
    return [(0.5 * i, r, j) for i, (j, r) in enumerate(zip(journaled, rss))]


def test_soak_stream_steady_window():
    """The window runs from the journal's first growth to the sample
    that first sees its last line: start-up and exit are left out."""
    s = _samples([0, 0, 5, 9, 12, 12, 12], [900] * 7)
    assert [x[2] for x in soak_stream.steady(s)] == [5, 9, 12]


@pytest.mark.parametrize("journaled, rss, ok", [
    (range(10, 90, 10), [1000] * 8, True),
    (range(10, 90, 10), [1000] * 6 + [1400, 1400], False),
    ([10, 20, 30, 40, 50, 60, 60, 60], [1000] * 8, False),
    (range(10, 70, 10), [1000] * 6, False),
])
def test_soak_stream_judges_memory_only_in_a_steady_state(journaled, rss,
                                                          ok):
    """The RSS bound holds over 8+ samples whose every quarter journals
    targets; RSS growth, a quarter that journals nothing (the stream
    ended or stalled) and too few samples each fail the soak."""
    s = _samples(list(journaled), rss)
    if ok:
        rep = soak_stream.judge_memory(s)
        assert all(r > 0 for r in rep["targets_per_s_quarters"])
    else:
        with pytest.raises(SystemExit):
            soak_stream.judge_memory(s)


def test_soak_stream_fails_without_a_kill(tmp_path):
    """A run that ends before the kill point fails the soak."""
    with pytest.raises(SystemExit) as e:
        soak_stream.main([
            "12", "--backend", "host", "--device", "cpu", "--kill-at", "2",
            "--poll", "0.05", "--workdir", str(tmp_path)])
    assert e.value.code not in (0, None)


def test_soak_multirank_device_ranks_killed_and_resumed(tmp_path, capsys):
    """Two `--backend cuda --device cpu` ranks (they stay in the gloo
    group until they exit), rank 1 SIGKILLed: the survivor exits 0, the
    victim resumes alone, and every target comes out once, byte-equal to
    one uninterrupted process."""
    assert soak_multirank.main([
        "200", "--backend", "cuda", "--device", "cpu", "--batch-targets",
        "32", "--threads", "1", "--poll", "0.05", "--timeout", "300",
        "--workdir", str(tmp_path)]) == 0
    rep = _report(capsys)
    assert rep["survivor_rcs"] == [0] and rep["resumed_ranks"] == [1]
    assert rep["emitted"] == 200 and 0 < rep["killed_at"] < 100


def test_soak_devbuild_two_trials():
    res = soak_devbuild.soak(2, 0, "cpu", log=lambda *a: None)
    assert res == {**res, "trials": 2, "fails": 0} and res["targets"] > 0


def test_scaling_bench_one_against_two_ranks(capsys):
    assert scaling_bench.main(["16", "300", "10", "2", "1", "--device",
                               "cpu", "--reps", "1"]) == 0
    rep = _report(capsys)
    assert rep["n_processes"] == 2 and len(rep["per_rank"]) == 2
    assert rep["t_1proc_s"] > 0 and rep["t_2proc_s"] > 0
