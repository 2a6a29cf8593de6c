"""`tools/auto_turns.py` on the CPU: the long stream's replay (copies of
a configuration's records with fresh target ids, made a copy at a time)
reads back as the copies joined, its expected FASTA (one copy's
single-thread engine FASTA with each copy's ids) is the single-thread
engine's on the replayed records, and the tool runs its turns at the
test size with the kernels' plain versions."""

import json

import pytest

from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.bench import cells as C
from pbdagcon_tpu_torch.tools import auto_turns as T

CONFIGS = sorted(C.CONFIGS)


def _tiny_text(name):
    cfg = C.tiny(C.CONFIGS[name])
    return cfg, C.config_text(cfg, 1234)


@pytest.mark.parametrize("name", CONFIGS)
def test_replay_stream_reads_back_the_copies(name):
    cfg, text = _tiny_text(name)
    segs = T.sid_segments(text, cfg.fmt)
    assert b"".join(segs) == text
    assert T.ReplayStream(segs, 1).read() == text  # copy 0: the own stream
    want = b"".join(T.tag(k).encode().join(segs) for k in range(3))
    stream, got = T.ReplayStream(segs, 3), []
    for n in (1, 7, 4096, 333, 1 << 20):
        got.append(stream.read(n))
    got.append(stream.read())
    assert b"".join(got) == want and stream.read(5) == b""
    # Each copy renames every target, and only its target ids.
    sids = {line.split()[5 if cfg.fmt == "m5" else 1]
            for line in want.splitlines()}
    assert len(sids) == 3 * cfg.targets
    assert want.count(b"\n") == 3 * text.count(b"\n")


@pytest.mark.parametrize("name", CONFIGS)
def test_replayed_fasta_is_the_engines(name):
    if not native.available():
        pytest.skip("native library not built")
    cfg, text = _tiny_text(name)
    segs = T.sid_segments(text, cfg.fmt)
    with native.NativeEngine(min_weight=cfg.min_weight,
                             min_length=cfg.min_length, threads=1,
                             align=cfg.align) as eng:
        one = eng.consensus_text(text, fmt=cfg.fmt)
        three = eng.consensus_text(T.ReplayStream(segs, 3).read(),
                                   fmt=cfg.fmt)
    assert one.count(">") > 0
    assert T.check_replayed(three, T.fasta_segments(one), 3)
    assert not T.check_replayed(three, T.fasta_segments(one), 2)
    assert not T.check_replayed(one, T.fasta_segments(one), 3)


def test_sid_segments_refuses_a_record_without_a_target_id():
    with pytest.raises(ValueError, match="target id"):
        T.sid_segments(b"r1 t1 0 10 100 ACGT ACGT\nr2\n", "pre")


def test_tool_runs_its_turns_on_the_cpu(capsys):
    if not native.available():
        pytest.skip("native library not built")
    assert T.main(["--tiny", "--device", "cpu", "--rounds", "1",
                   "--copies", "2", "--config", "cfg2-batched",
                   "--config", "cfg3-highdepth"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    runs = [l for l in lines if "backend" in l]
    # (a) one round of auto, cuda, host; (b) host, auto, auto, host.
    assert [r["backend"] for r in runs] == (
        ["auto", "cuda", "host", "host", "auto", "auto", "host"] * 2)
    assert all(r["fasta_ok"] for r in runs)
    assert {r["copies"] for r in runs if r["stream"] == "long"} == {2}
    # On the CPU "auto" runs "cuda": no hybrid chunk.
    assert all(r["hybrid_host_chunks"] == 0 for r in runs)
    report = lines[-1]
    assert report["ok"] and report["card"]["platform"] == "cpu"
    assert [(s["config"], s["stream"]) for s in report["summaries"]] == [
        ("cfg2-batched", "own"), ("cfg2-batched", "long"),
        ("cfg3-highdepth", "own"), ("cfg3-highdepth", "long")]
    assert all(s["guard"] == 0.9 and not s["guard_applies"]
               for s in report["summaries"])


def test_tool_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T.main(["--tiny"]) == 2
