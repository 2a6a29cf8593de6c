"""The kernel-variant microbench's histograms and scatter (`ops/pk.py`)
on the CPU, held against the JAX tool's Pallas kernels
(`tools/prof_pk.py`: `hist_v0`, `hist_v1`, `hist_v2`, `pallas_scatter`),
run in interpret mode on the JAX CPU backend, with exact integer
equality; and the port's microbench entry point at its small size. The
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu_torch.ops import mxu, pk, pk_cuda
from pbdagcon_tpu_torch.tools import prof_pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """`tools/prof_pk.py` (not a package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "prof_pk_jax", os.path.join(ROOT, "tools", "prof_pk.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jpk(jax_tool, monkeypatch):
    """The JAX tool with every `pl.pallas_call` in interpret mode (the
    tool calls it without `interpret`, which only a TPU runs)."""
    orig = jax_tool.pl.pallas_call
    monkeypatch.setattr(jax_tool.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    return jax_tool


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


# (seed, B, N, D, nc): B not a multiple of 8; N not a multiple of nc; D
# not a multiple of 128 (and one that is); values below 0, in the padded
# bins [D, 128 * ceil(D / 128)) and past them.
HIST_CASES = [
    (0, 5, 3000, 700, 512), (1, 3, 1000, 257, 256), (2, 9, 777, 8, 128),
    (3, 1, 2048, 1026, 512), (4, 2, 1500, 384, 1024),
]


@pytest.mark.parametrize("variant", ["hist_v1", "hist_v2"])
@pytest.mark.parametrize("seed,B,N,D,nc", HIST_CASES)
def test_hist_variants_equal_jax_pallas(jpk, variant, seed, B, N, D, nc):
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, D + 300, (B, N)).astype(np.int32)
    v[:, ::13] = -1
    v[:, 1::29] = D - 1  # the last bin, beside the padded ones
    want = getattr(jpk, variant)(jnp.asarray(v), D, nc=nc)
    before = dict(pk_cuda.launches)
    _eq(getattr(pk, variant)(torch.from_numpy(v), D, nc=nc), want)
    assert pk_cuda.launches == before  # a CPU tensor takes the plain version


def test_hist_v1_plan_covers_every_hi_row_once():
    """P1's launch plan for every D up to 245000: a legal s8 wgmma width
    no wider than the cap, the fewest tiles, tile k holding hi rows
    [k * width, (k + 1) * width) so that the tiles cover the ceil(D / 128)
    rows with none empty (every row in exactly one tile), the smallest
    legal width for that, and a sentinel byte that is no row."""
    cap = pk_cuda.HIST_V1_MAX_WIDTH
    widths = pk_cuda.WGMMA_S8_WIDTHS
    assert widths == (8, 16, 24) + tuple(range(32, 257, 16))
    assert cap in widths and cap < 255
    seen = set()
    for D in range(1, 245001):
        width, tiles, sentinel = pk_cuda.hist_v1_plan(D)
        rows = -(-D // 128)
        assert width in widths and width <= cap
        assert width <= sentinel <= 255
        assert tiles == -(-rows // cap)
        assert (tiles - 1) * width < rows <= tiles * width
        assert width == min(w for w in widths if w >= -(-rows // tiles))
        seen.add(width)
    assert seen == {w for w in widths if w <= cap}


def _hist_wgmma_model(v: np.ndarray, D: int) -> np.ndarray:
    """numpy model of `hist_wgmma_kernel` under `hist_v1_plan(D)`: per
    (row, hi tile), each value split into a hi byte (hi - hbase where it
    counts in the tile, else the sentinel) and a lo byte (v & 127); per
    32-value step, the [128 lo x 32] one-hot times the [32 x width]
    one-hot, summed in int32; then only the tile's real hi rows below D
    stored, into an output that starts as garbage (`torch.empty`). The
    steps past N hold a value that would count (bin 0), kept out by the
    index test, as in the kernel."""
    width, tiles, sentinel = pk_cuda.hist_v1_plan(D)
    B, N = v.shape
    rows = -(-D // 128)
    steps = -(-N // 32)
    vals = np.zeros((B, steps * 32), np.int64)
    vals[:, :N] = v
    in_n = np.arange(steps * 32) < N
    out = np.full((B, D), -12345, np.int32)
    lo_rows = np.arange(128, dtype=np.uint8)
    for k in range(tiles):
        hbase = k * width
        hcount = min(width, rows - hbase)
        dh = (vals >> 7) - hbase
        ok = in_n & (vals >= 0) & (vals < D) & (dh >= 0) & (dh < hcount)
        hib = np.where(ok, dh, sentinel).astype(np.uint8)
        lob = (vals & 127).astype(np.uint8)
        a = (lob.reshape(B, steps, 1, 32) == lo_rows[:, None]).astype(np.int32)
        b = (hib.reshape(B, steps, 32, 1)
             == np.arange(width, dtype=np.uint8)).astype(np.int32)
        acc = np.einsum("bslk,bskn->bln", a, b)  # [B, 128 lo, width hi]
        d = (hbase + np.arange(width))[None, :] * 128 + np.arange(128)[:, None]
        keep = (np.arange(width)[None, :] < hcount) & (d < D)
        out[:, d[keep]] = acc[:, keep]
    return out


# D at P1's padding edges (wgmma widths 8 filled and spilled, one full
# tile and one bin past it, three tiles) and the microbench's D = 1026;
# N not a multiple of 4 or 32, and N = 0.
@pytest.mark.parametrize("D", [
    1, 128, 129, 1024, 1025, 1026, 9234,
    pk_cuda.HIST_V1_MAX_WIDTH * 128, pk_cuda.HIST_V1_MAX_WIDTH * 128 + 1,
    70001,
])
@pytest.mark.parametrize("N", [0, 1001])
def test_hist_wgmma_model_equals_reference(D, N):
    """Values below 0, in the padded bins [D, 128 * ceil(D / 128)), past
    them and in every tile; one bin holding a count past int8."""
    rng = np.random.default_rng(D + N)
    rows = -(-D // 128)
    v = rng.integers(-3, 128 * rows + 300, (3, N)).astype(np.int32)
    v[:, ::13] = -1
    v[:, 1::29] = D - 1
    v[:, 2::31] = rng.integers(D, 128 * rows + 1, (3, len(range(2, N, 31))))
    v[2, : N // 2] = D // 2
    want = mxu.hist_reference(torch.from_numpy(v), None, D).numpy()
    assert np.array_equal(_hist_wgmma_model(v, D), want)


def test_hist_v0_equals_jax_pallas(jpk):
    rng = np.random.default_rng(7)
    v = rng.integers(-3, 1000, (5, 3000)).astype(np.int32)
    _eq(pk.hist_v0(torch.from_numpy(v), 700),
        jpk.hist_v0(jnp.asarray(v), 700, nc=512))


# (seed, B, N, D, nbytes, NP, repeat): D > 96 * 128 gives the Pallas
# kernel two or more D chunks; repeated ranks sum, unique ones transport.
SCATTER_CASES = [
    (0, 3, 1024, 13000, 2, 2, True), (1, 5, 3000, 4000, 1, 1, True),
    (2, 3, 1024, 13000, 4, 3, False), (3, 9, 600, 700, 4, 1, True),
    (4, 2, 1500, 25000, 1, 3, False), (5, 4, 900, 300, 2, 2, True),
]


@pytest.mark.parametrize("seed,B,N,D,nbytes,NP,repeat", SCATTER_CASES)
def test_pallas_scatter_equals_jax_pallas(jpk, seed, B, N, D, nbytes, NP,
                                          repeat):
    """Negative and over-wide payloads; ranks below 0, in the padded tail
    and past it."""
    rng = np.random.default_rng(seed)
    if repeat:
        r = rng.integers(-3, D + 300, (B, N))
    else:
        r = np.stack([rng.permutation(D + 200)[:N] for _ in range(B)]) - 2
    r = r.astype(np.int32)
    ps = [rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
          for _ in range(NP)]
    want = jpk.pallas_scatter(jnp.asarray(r), tuple(jnp.asarray(p) for p in ps),
                              D, nbytes, nc=512)
    before = dict(pk_cuda.launches)
    got = pk.pallas_scatter(torch.from_numpy(r),
                            tuple(torch.from_numpy(p) for p in ps), D, nbytes)
    assert pk_cuda.launches == before
    assert len(got) == len(want) == NP
    for g, w in zip(got, want):
        _eq(g, w)


def test_pallas_scatter_matches_numpy():
    rng = np.random.default_rng(11)
    B, N, D = 3, 400, 90
    r = rng.integers(-2, D + 5, (B, N)).astype(np.int32)
    p = rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
    for nbytes in (1, 2, 3, 4):
        acc = np.zeros((B, D), np.int64)
        for b in range(B):
            ok = (r[b] >= 0) & (r[b] < D)
            np.add.at(acc[b], r[b][ok],
                      p[b][ok].astype(np.int64) & ((1 << (8 * nbytes)) - 1))
        (got,) = pk.pallas_scatter(torch.from_numpy(r), (torch.from_numpy(p),),
                                   D, nbytes)
        _eq(got, (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32))


def test_variants_refuse_other_devices_and_widths():
    v = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    for f in (pk.hist_v1, pk.hist_v2):
        with pytest.raises(ValueError, match="device"):
            f(v, 4)
    with pytest.raises(ValueError, match="device"):
        pk.pallas_scatter(v, (v,), 4, 2)
    c = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="nbytes"):
        pk.pallas_scatter(c, (c,), 4, 5)


def test_kernel_wrappers_refuse_cpu_tensors():
    v = torch.zeros((2, 3), dtype=torch.int32)
    for f in (pk_cuda.hist_v1_cuda, pk_cuda.hist_v2_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            f(v, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pk_cuda.scatter_tile_cuda(v, (v,), 4, 0xFF)


def test_prof_pk_entry_point_small_cpu(capsys):
    """The port's microbench runs to its end on the CPU (plain versions
    at its small size), every line of a shape agreeing."""
    assert prof_pk.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("floor:")
    assert sum("ms/op" in line for line in out) == 3 * 4 + 3 * 3 + 1
    assert "DISAGREE" not in "\n".join(out)
    assert out[-1].startswith("sort[")
