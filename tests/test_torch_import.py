"""The port imports without jax and without the JAX package, builds
nothing at import, and refuses what it does not run. The imports run in
a subprocess because tests/conftest.py imports jax into this process."""

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


# Any `import pbdagcon_tpu...` now raises ImportError.
_NO_JAX_PACKAGE = r"""
import sys
sys.modules["pbdagcon_tpu"] = None
"""
_ASSERT_NO_JAX_PACKAGE = r"""
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None and (
    k == "pbdagcon_tpu" or k.startswith("pbdagcon_tpu.")))
assert not loaded, loaded
"""
_PORT_MODULES = (
    "cli", "config", "convert", "native", "pipeline", "devpipe",
    "ops.dp", "ops.dp_cuda", "ops._build", "ops.mxu", "ops.mxu_cuda",
    "ops.devbuild_torch", "ops.devemit", "ops.pk", "ops.pk_cuda",
    "tools.prof_pk", "tools.dp_ablate", "parallel.journal",
    "ops.align_tpu", "ops.align_cuda", "hybrid", "dazcon",
    "ops.dp_blocked", "ops.dp_blocked_cuda", "parallel.colshard",
    "parallel.mesh", "parallel.scheduler",
    # the high-depth, soak and multi-process tools
    "tools.bench_highdepth", "tools.soak_stream", "tools.soak_devbuild",
    "tools.soak_multirank", "tools.scaling_bench", "tools.oversize_cpu",
    # the copies of the JAX package's framework-free modules
    "alignment", "io", "oracle", "oracle.graph", "ops.linearize", "aligner",
    "simulate", "selfcheck", "ops.devbuild", "hgap", "dazzio",
)


def _import_all(prelude: str = "", epilogue: str = "") -> set[str]:
    res = subprocess.run(
        [sys.executable, "-c", prelude + _IMPORT_ALL + epilogue],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(res.stdout.split())
    for mod in _PORT_MODULES:
        assert f"pbdagcon_tpu_torch.{mod}" in names
    return names


def test_imports_without_jax():
    _import_all()


def test_imports_without_jax_package():
    _import_all(_NO_JAX_PACKAGE, _ASSERT_NO_JAX_PACKAGE)


def _sources() -> list[str]:
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(PKG)
        for f in fs if f.endswith(".py")
    ]
    assert len(files) > 10
    return files


def _grep(pattern: str) -> list[str]:
    pat = re.compile(pattern, re.M)
    hits = []
    for path in _sources():
        with open(path) as f:
            hits += [path] if pat.search(f.read()) else []
    return hits


# The reference may be named in comments and strings, never imported.
_JAX_PACKAGE_IMPORT = r"^\s*(from|import)\s+pbdagcon_tpu(\.|\s|$)"


def test_no_jax_import_in_port_sources():
    assert _grep(r"^\s*(import jax|from jax)") == []


def test_no_jax_package_import_in_port_sources():
    pat = re.compile(_JAX_PACKAGE_IMPORT, re.M)
    for line in ("from pbdagcon_tpu.io import x", "  import pbdagcon_tpu",
                 "import pbdagcon_tpu as p", "from pbdagcon_tpu import io"):
        assert pat.search(line), line
    for line in ("from pbdagcon_tpu_torch.io import x",
                 "# from `pbdagcon_tpu.io`"):
        assert not pat.search(line), line
    assert _grep(_JAX_PACKAGE_IMPORT) == []


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tpu_backends_not_ported(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DagconConfig(backend=backend)


def test_blocked_backend_is_ported():
    cfg = DagconConfig(backend="blocked", device="cpu")
    assert (cfg.backend, cfg.device) == ("blocked", "cpu")
    assert config_from_jax(JaxConfig(backend="blocked")).backend == "blocked"


def test_devbuild_backend_is_ported():
    cfg = DagconConfig(backend="devbuild", device="cpu")
    assert (cfg.backend, cfg.device) == ("devbuild", "cpu")


def test_hybrid_backend_and_device_aligner_are_ported():
    cfg = DagconConfig(backend="hybrid", align_backend="device", device="cpu")
    assert (cfg.backend, cfg.align_backend) == ("hybrid", "device")


def test_config_rejects_and_defaults():
    with pytest.raises(ValueError, match="simple scorer"):
        DagconConfig(align_backend="device", align_scorer="affine")
    with pytest.raises(ValueError):
        DagconConfig(align_backend="gpu")
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
    assert config_from_jax(JaxConfig(backend="hybrid")).backend == "hybrid"
    p = config_from_jax(JaxConfig(fmt="pre", align=True, align_backend="device"))
    assert p.align_backend == "device"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from pbdagcon_tpu_torch.ops import _build

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    for name in ("dp_scan", "hist_scatter", "pk_variants", "align_scan",
                 "dp_blocked"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)


def test_ablation_builds_and_tool_need_nvcc_and_a_card(monkeypatch, tmp_path):
    """`tools/dp_ablate.py` builds `dp_scan` with -D DP_ABLATE=... (and
    DP_W16_D0=8), each build its own library; without a card the tool
    exits 2."""
    from pbdagcon_tpu_torch.ops import _build
    from pbdagcon_tpu_torch.tools import dp_ablate

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("dp_scan", ("DP_ABLATE=1",))
    assert not _build._libs
    assert set(dp_ablate.BUILDS) >= {
        *(f"DP_ABLATE={k}" for k in (0, 1, 2, 4, 8)), "DP_W16_D0=8"}
    assert dp_ablate.main([]) == 2
