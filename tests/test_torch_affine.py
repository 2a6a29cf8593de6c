"""The -a scorer and aligner knobs through the port (mirroring
tests/test_affine.py): the CLI's `--align-scorer`, `--affine-params` and
`--align-backend` with the reference CLI's names, choices and defaults;
the affine scorer's consensus equal between the native engine and the
pure-Python host path; and the port's CLI FASTA under the affine scorer
byte-equal to the reference CLI's on both device backends (`--device
cpu`: the kernels' plain versions)."""

import io as _io
import os
import subprocess
import sys

import pytest

from pbdagcon_tpu.cli import build_parser as reference_parser
from pbdagcon_tpu_torch import cli, native
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.pipeline import run_stream
from pbdagcon_tpu_torch.simulate import NoiseProfile, simulate_targets, to_pre_raw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AFFINE = ["-a", "--align-scorer", "affine", "--affine-params", "2,-3,-5,-2"]


def _pileup_text(n_targets=6, length=300, cov=12, seed=5,
                 noise=NoiseProfile()):
    lines = []
    for _t, _bb, alns in simulate_targets(seed, n_targets, length, cov, noise):
        lines.extend(to_pre_raw(a) for a in alns)
    return "\n".join(lines) + "\n"


def _skip_without_native():
    if not native.available():
        pytest.skip("native library not built")


def _cli(module, args, text):
    res = subprocess.run(
        [sys.executable, "-m", module, "-", "--fmt", "pre", "-c", "2", "-m",
         "50", *args],
        input=text.encode(), capture_output=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT),
    )
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    return res.stdout.decode()


def test_affine_consensus_native_vs_python_parity():
    # The -a pipeline under the affine scorer: native engine and pure-
    # Python path must emit identical FASTA.
    _skip_without_native()
    text = _pileup_text()
    outs = []
    for use_native in (True, False):
        buf = _io.StringIO()
        run_stream(_io.StringIO(text), FastaWriter(buf), DagconConfig(
            fmt="pre", align=True, align_scorer="affine", min_weight=2,
            min_length=50, backend="host", use_native=use_native,
        ))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count(">") >= 1


def test_cli_align_scorer_flag():
    _skip_without_native()
    out = _cli("pbdagcon_tpu_torch.cli",
               ["-a", "--align-scorer", "affine", "--affine-params",
                "1,-2,-4,-1", "--backend", "host"],
               _pileup_text(n_targets=2))
    assert out.count(">") >= 1


@pytest.mark.parametrize("backend", ["cuda", "devbuild"])
def test_cli_affine_equals_reference_cli(backend):
    """Byte-equal to `python -m pbdagcon_tpu` with the same flags, and
    not the simple scorer's FASTA (the flags reach the aligner: on this
    gap-heavy pileup the two scorers' consensus differ)."""
    _skip_without_native()
    text = _pileup_text(n_targets=4, noise=NoiseProfile(sub=0.05, ins=0.15,
                                                        dele=0.1))
    want = _cli("pbdagcon_tpu", [*AFFINE, "--backend", "host"], text)
    got = _cli("pbdagcon_tpu_torch",
               [*AFFINE, "--backend", backend, "--device", "cpu"], text)
    assert got == want and want.count(">") >= 1
    simple = _cli("pbdagcon_tpu_torch",
                  ["-a", "--backend", backend, "--device", "cpu"], text)
    assert simple != got


def test_cli_flags_reach_the_config(monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "run_stream",
                        lambda stream, writer, cfg, journal=None: seen.append(cfg))
    assert cli.main([os.path.join(ROOT, "tests", "data", "golden2.pre"),
                     "--fmt", "pre", *AFFINE, "--device", "cpu"]) == 0
    (cfg,) = seen
    assert cfg.align and cfg.align_scorer == "affine"
    assert cfg.affine_params == (2, -3, -5, -2) and cfg.align_backend == "host"


@pytest.mark.parametrize("flag", ["align_backend", "align_scorer",
                                  "affine_params"])
def test_cli_flags_mirror_the_reference(flag):
    """Same option strings, choices and defaults as the reference CLI."""
    ours = {a.dest: a for a in cli.build_parser()._actions}[flag]
    ref = {a.dest: a for a in reference_parser()._actions}[flag]
    assert ours.option_strings == ref.option_strings
    assert ours.choices == ref.choices and ours.default == ref.default


def test_cli_align_backend_device_raises():
    """The device aligner implements the simple scorer only: with the
    affine scorer the flag raises, as in the reference, and never
    re-aligns on the host in silence."""
    with pytest.raises(ValueError, match="simple scorer"):
        cli.main([os.path.join(ROOT, "tests", "data", "golden2.pre"),
                  "--fmt", "pre", "-a", "--align-backend", "device",
                  "--align-scorer", "affine", "--device", "cpu"])


def test_cli_rejects_bad_affine_params():
    with pytest.raises(ValueError):  # open must be <= extend
        cli.main([os.path.join(ROOT, "tests", "data", "golden2.pre"),
                  "--fmt", "pre", "-a", "--align-scorer", "affine",
                  "--affine-params", "1,-2,-1,-4", "--device", "cpu"])
