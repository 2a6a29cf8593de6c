"""Build the native engine (`native/libdagcon.so`) once, before any test
is collected.

Under pytest-xdist this hook runs in the controller before it starts
the workers, so every worker finds the library in place. Without it,
each worker's first native test may build the library itself, and the
JAX package's loader (`make -C native`, which links in place) can let
another worker open a half-written file and skip its native tests. The
port's `native.ensure_built` builds under a lock into a temporary file
that is moved into place. Runs with `--noconftest` skip this hook and
load the library as before."""


def pytest_configure(config):
    from pbdagcon_tpu_torch import native

    native.ensure_built()
