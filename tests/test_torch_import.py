"""The port imports without jax, builds nothing at import, and refuses
what it does not run. The jax-free import runs in a subprocess because
tests/conftest.py imports jax into this process."""

import os
import re
import subprocess
import sys

import pytest

from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.convert import config_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pbdagcon_tpu_torch")

_IMPORT_ALL = r"""
import pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import pbdagcon_tpu_torch
names = sorted(
    m.name for m in pkgutil.walk_packages(
        pbdagcon_tpu_torch.__path__, "pbdagcon_tpu_torch."
    )
    if not m.name.endswith("__main__")
)
for name in names:
    __import__(name)
from pbdagcon_tpu_torch.ops import _build
assert not _build._libs and not _build.build_logs, "built at import"
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules
               if sys.modules[k] is not None)
print(" ".join(names))
"""


def test_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(res.stdout.split())
    for mod in ("cli", "config", "convert", "native", "pipeline", "devpipe",
                "ops.dp", "ops.dp_cuda", "ops._build", "ops.mxu",
                "ops.mxu_cuda", "ops.devbuild_torch", "ops.devemit",
                "ops.pk", "ops.pk_cuda", "tools.prof_pk", "parallel.journal"):
        assert f"pbdagcon_tpu_torch.{mod}" in names


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(PKG)
        for f in fs if f.endswith(".py")
    ]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


@pytest.mark.parametrize("backend", ["xla", "blocked", "pallas", "hybrid"])
def test_tpu_backends_not_ported(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DagconConfig(backend=backend)


def test_devbuild_backend_is_ported():
    cfg = DagconConfig(backend="devbuild", device="cpu")
    assert (cfg.backend, cfg.device) == ("devbuild", "cpu")


def test_config_rejects_and_defaults():
    with pytest.raises(NotImplementedError, match="A12"):
        DagconConfig(align_backend="device")
    with pytest.raises(ValueError):
        DagconConfig(backend="tpu")
    with pytest.raises(ValueError):
        DagconConfig(fmt="sam")
    with pytest.raises(ValueError):
        DagconConfig(chunk_mb=0)  # would read nothing from the stream
    cfg = DagconConfig()
    assert (cfg.backend, cfg.device) == ("auto", "cuda")


def test_config_from_jax():
    j = JaxConfig(backend="pallas", min_weight=3, min_length=77, fmt="pre",
                  align=True, v_buckets=(512,), batch_targets=9, threads=2)
    p = config_from_jax(j, device="cpu")
    assert (p.backend, p.device) == ("cuda", "cpu")
    assert (p.min_weight, p.min_length, p.fmt, p.align, p.v_buckets,
            p.batch_targets, p.threads) == (3, 77, "pre", True, (512,), 9, 2)
    assert config_from_jax(JaxConfig(backend="host")).backend == "host"
    assert config_from_jax(JaxConfig(backend="devbuild")).backend == "devbuild"
    with pytest.raises(NotImplementedError):
        config_from_jax(JaxConfig(backend="hybrid"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from pbdagcon_tpu_torch.ops import _build

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    for name in ("dp_scan", "hist_scatter", "pk_variants"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)
