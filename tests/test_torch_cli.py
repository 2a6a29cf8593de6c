"""The port's CLI (`python -m pbdagcon_tpu_torch`) on the golden input:
a subprocess run (mirroring test_golden.py::test_golden_cli_subprocess),
--shard partition, --journal skip, --selfcheck and --profile-dir. The DP
runs on the CPU (`--device cpu`)."""

import os
import subprocess
import sys

import pytest

from pbdagcon_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
M5 = os.path.join(DATA, "golden1.m5")
EXPECTED = open(os.path.join(DATA, "golden1.fa")).read()
ARGS = [M5, "-c", "6", "-m", "100", "--device", "cpu"]


def _headers(text: str) -> list[str]:
    return sorted(l for l in text.splitlines() if l.startswith(">"))


@pytest.mark.parametrize("backend", ["cuda", "host", "devbuild"])
def test_golden_cli_subprocess(backend):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu_torch", *ARGS,
         "--backend", backend],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == EXPECTED
    assert "proc_time=" in res.stderr


@pytest.mark.parametrize("shard_bytes", [False, True])
def test_shard_partition(capsys, shard_bytes):
    outs = []
    for shard in ("0/2", "1/2"):
        extra = ["--shard-bytes"] if shard_bytes else []
        assert main([*ARGS, "--shard", shard, *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert all(outs)
    assert _headers(outs[0] + outs[1]) == _headers(EXPECTED)
    assert not set(_headers(outs[0])) & set(_headers(outs[1]))


def test_journal_skips_done_targets(tmp_path, capsys):
    j = str(tmp_path / "done.journal")
    assert main([*ARGS, "--journal", j]) == 0
    assert capsys.readouterr().out == EXPECTED
    assert main([*ARGS, "--journal", j]) == 0
    assert capsys.readouterr().out == ""  # everything journaled


def test_selfcheck(capsys):
    assert main([*ARGS, "--selfcheck"]) == 0
    assert "4/4 targets OK" in capsys.readouterr().err


def test_profile_dir_writes_trace(tmp_path, capsys):
    d = tmp_path / "prof"
    assert main([*ARGS, "--profile-dir", str(d)]) == 0
    assert capsys.readouterr().out == EXPECTED
    assert (d / "trace.json").stat().st_size > 0


def test_rejects_tpu_backends():
    with pytest.raises(SystemExit):
        main([*ARGS, "--backend", "xla"])
