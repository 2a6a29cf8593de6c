"""The port's native loader (`pbdagcon_tpu_torch.native`) builds and
loads `libdagcon.so` safely from many processes at once: each build runs
under an flock into a temporary name that is moved into place, so no
process loads a half-written library.

Six concurrent subprocesses point the loader at a copy of `native/`
(sources and Makefile, no library) in a temporary directory; every one
must load it."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS = 6
# An unoptimised build (the Makefile's CXXFLAGS yield to the
# environment): the tests are about the race, and keep the run's CPUs
# for the other workers.
ENV = dict(os.environ, PYTHONPATH=ROOT,
           CXXFLAGS="-O0 -std=c++17 -fPIC -pthread")
LOADER = (
    "import sys; from pbdagcon_tpu_torch import native; "
    "lib = native._load(sys.argv[1]); "
    "sys.exit(0 if lib is not None and native.available(sys.argv[1]) else 1)"
)


def _native_copy(tmp_path) -> str:
    d = tmp_path / "native"
    d.mkdir()
    for name in ("Makefile", "dagcon.cpp", "dazzdb.cpp"):
        shutil.copy(os.path.join(ROOT, "native", name), d / name)
    return str(d)


def _spawn(native_dir: str) -> list[subprocess.Popen]:
    return [
        subprocess.Popen([sys.executable, "-c", LOADER, native_dir], env=ENV,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for _ in range(PROCS)
    ]


def test_concurrent_loaders_all_load(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++ to build the native engine")
    native_dir = _native_copy(tmp_path)
    procs = _spawn(native_dir)
    rcs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        rcs.append((p.returncode, err.decode()[-500:]))
    assert all(rc == 0 for rc, _ in rcs), rcs
    names = sorted(os.listdir(native_dir))
    assert "libdagcon.so" in names
    assert not [n for n in names if n.endswith(".tmp")]  # none left behind


def test_loader_rebuilds_a_library_that_does_not_open(tmp_path):
    """A truncated library (as another build leaves it mid-write) is
    rebuilt under the lock and loaded."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++ to build the native engine")
    native_dir = _native_copy(tmp_path)
    with open(os.path.join(native_dir, "libdagcon.so"), "wb") as f:
        f.write(b"\x7fELF")
    res = subprocess.run([sys.executable, "-c", LOADER, native_dir],
                         env=ENV,
                         capture_output=True, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-1000:]
    assert os.path.getsize(os.path.join(native_dir, "libdagcon.so")) > 4
