"""The port's histogram, scatter and gather wrappers (`ops/mxu.py`) on
the CPU, held against the JAX package's `ops/mxu.py` on the JAX CPU
backend (the XLA forms of the Pallas kernels' contract) with exact
equality, and the plain versions of the kernels against numpy. The
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import mxu as jmxu
from pbdagcon_tpu_torch.ops import mxu


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


# (seed, B, N, D): B not a multiple of 8; D on both sides of the JAX
# form's 2048 compare-reduce split; values run past D and below 0.
HIST_CASES = [
    (0, 3, 700, 257), (1, 5, 4096, 1026), (2, 1, 129, 8208),
    (3, 9, 1000, 300), (4, 2, 3000, 15000),
]


@pytest.mark.parametrize("seed,B,N,D", HIST_CASES)
def test_hist_and_lohi_equal_jax(seed, B, N, D):
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, D + 200, (B, N)).astype(np.int32)
    v[:, ::17] = -1
    m = rng.random((B, N)) < 0.7
    _eq(mxu.mxu_hist(_t(v), _t(m), D), jmxu.mxu_hist(jnp.asarray(v), jnp.asarray(m), D))
    for got, want in zip(
        mxu.hist_lohi(_t(v), _t(m), D),
        jmxu.hist_lohi(jnp.asarray(v), jnp.asarray(m), D),
    ):
        _eq(got, want)
    _eq(
        mxu.mxu_scatter_presence(_t(v), _t(m), D),
        jmxu.mxu_scatter_presence(jnp.asarray(v), jnp.asarray(m), D),
    )


def test_hist_reference_matches_numpy():
    rng = np.random.default_rng(5)
    v = rng.integers(-5, 70, (4, 500)).astype(np.int32)
    want = np.stack([
        np.bincount(r[(r >= 0) & (r < 64)], minlength=64) for r in v
    ])
    _eq(mxu.hist_reference(_t(v), None, 64), want)


@pytest.mark.parametrize("max_payload", [1 << 8, 1 << 16, 1 << 24, 1 << 31])
def test_scatter_permutation_cut_payloads_equal_jax(max_payload):
    """Unique ranks (a transport) with negative and over-wide payloads:
    each is cut to the bytes that max_payload needs."""
    rng = np.random.default_rng(max_payload.bit_length())
    B, N = 3, 1500
    perm = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    p1 = rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
    p2 = rng.integers(0, max_payload, (B, N)).astype(np.int32)
    valid = rng.random((B, N)) < 0.9
    got = mxu.mxu_scatter(_t(perm), _t(valid), (_t(p1), _t(p2)), N,
                          max_payload=max_payload)
    want = jmxu.mxu_scatter(jnp.asarray(perm), jnp.asarray(valid),
                            (jnp.asarray(p1), jnp.asarray(p2)), N,
                            max_payload=max_payload)
    for g, w in zip(got, want):
        _eq(g, w)
    # and against numpy: the cut payload lands at its rank
    nb = -(-(max_payload - 1).bit_length() // 8)
    cut = (p2.astype(np.int64) & ((1 << (8 * nb)) - 1))
    ref = np.zeros((B, N), np.int64)
    for b in range(B):
        ref[b, perm[b][valid[b]]] = cut[b][valid[b]]
    _eq(got[1], ref.astype(np.uint32).view(np.int32))


def test_scatter_compaction_and_dropped_ranks_equal_jax():
    rng = np.random.default_rng(8)
    B, N, D = 5, 2000, 256
    fl = rng.random((B, N)) < 0.15
    rank = (np.cumsum(fl, -1) - 1).astype(np.int32)  # runs past D
    rank[:, :3] = -7  # negative ranks are dropped
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    (got,) = mxu.mxu_scatter(_t(rank), _t(fl), (_t(pos),), D)
    (want,) = jmxu.mxu_scatter(jnp.asarray(rank), jnp.asarray(fl),
                               (jnp.asarray(pos),), D)
    _eq(got, want)


@pytest.mark.parametrize("reads,D", [(32, 400), (64, 3000)])
def test_weighted_hist_read_bitmask_equal_jax(reads, D):
    """Repeated ranks sum: the transitions' read bitmask (1 << read over
    unique (key, read) pairs), in one plane (R <= 32) or two."""
    rng = np.random.default_rng(reads)
    B = 3
    keys = np.stack([
        rng.permutation(np.repeat(np.arange(D // 4), 4))[: D] for _ in range(B)
    ])
    rd = np.stack([rng.integers(0, reads, D) for _ in range(B)]).astype(np.int32)
    # make (key, read) pairs unique as in the build
    pair = keys.astype(np.int64) * reads + rd
    for b in range(B):
        _, first = np.unique(pair[b], return_index=True)
        drop = np.ones(D, bool)
        drop[first] = False
        keys[b, drop] = -1
    keys = keys.astype(np.int32)
    valid = keys >= 0
    one = np.int32(1)
    w = [np.where(rd < 32, one << (rd & 31), 0).astype(np.int32)]
    if reads > 32:
        w.append(np.where(rd >= 32, one << (rd & 31), 0).astype(np.int32))
    got = mxu.mxu_weighted_hist(_t(keys), _t(valid), tuple(_t(x) for x in w), D)
    want = jmxu.mxu_weighted_hist(jnp.asarray(keys), jnp.asarray(valid),
                                  tuple(jnp.asarray(x) for x in w), D)
    for g, x in zip(got, want):
        _eq(g, x)


def test_weighted_hist_wrapping_sums_equal_jax():
    rng = np.random.default_rng(3)
    B, N, D = 2, 3000, 50
    v = rng.integers(-2, D + 3, (B, N)).astype(np.int32)
    w = rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
    m = rng.random((B, N)) < 0.8
    for mw in (1 << 8, 1 << 31):
        (got,) = mxu.mxu_weighted_hist(_t(v), _t(m), (_t(w),), D, max_weight=mw)
        (want,) = jmxu.mxu_weighted_hist(jnp.asarray(v), jnp.asarray(m),
                                         (jnp.asarray(w),), D, max_weight=mw)
        _eq(got, want)


@pytest.mark.parametrize("T,N,max_val", [
    (300, 700, 1 << 8), (1026, 4096, 1 << 16), (513, 200, 1 << 24),
    (256, 300, 1 << 30),
])
def test_gather_clamp_and_cut_equal_jax(T, N, max_val):
    """Indices below 0, in the padded tail [T, ceil(T/128)*128) and past
    it; table values negative and wider than max_val; a valid mask."""
    rng = np.random.default_rng(T + N)
    B = 3
    tbl = rng.integers(-(1 << 31), (1 << 31) - 1, (B, T)).astype(np.int32)
    idx = rng.integers(-50, T + 300, (B, N)).astype(np.int32)
    valid = rng.random((B, N)) < 0.8
    _eq(
        mxu.mxu_gather(_t(tbl), _t(idx), max_val=max_val),
        jmxu.mxu_gather(jnp.asarray(tbl), jnp.asarray(idx), max_val=max_val),
    )
    _eq(
        mxu.mxu_gather(_t(tbl), _t(idx), max_val=max_val, valid=_t(valid)),
        jmxu.mxu_gather(jnp.asarray(tbl), jnp.asarray(idx), max_val=max_val,
                        valid=jnp.asarray(valid)),
    )


def test_gather_planes_equal_jax():
    rng = np.random.default_rng(11)
    B, T, N = 2, 300, 500
    tables = [
        (rng.integers(0, 1 << 20, (B, T)).astype(np.int32), 3),
        (rng.integers(-(1 << 31), (1 << 31) - 1, (B, T)).astype(np.int32), 4),
        (rng.integers(0, 1 << 12, (B, T)).astype(np.int32), 1),
    ]
    idx = rng.integers(-5, T + 200, (B, N)).astype(np.int32)
    got = mxu.mxu_gather_planes([(_t(a), nb) for a, nb in tables], _t(idx))
    want = jmxu.mxu_gather_planes(
        [(jnp.asarray(a), nb) for a, nb in tables], jnp.asarray(idx)
    )
    for g, w in zip(got, want):
        _eq(g, w)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """A CPU tensor takes the plain version; the kernels' launch counts
    stay where they were."""
    from pbdagcon_tpu_torch.ops import mxu_cuda

    before = dict(mxu_cuda.launches)
    v = torch.tensor([[1, 2, 2, -1, 9]], dtype=torch.int32)
    m = torch.ones_like(v, dtype=torch.bool)
    assert mxu.mxu_hist(v, m, 4).tolist() == [[0, 1, 2, 0]]
    (o,) = mxu.mxu_scatter(v, m, (v + 5,), 4, max_payload=1 << 8)
    assert o.tolist() == [[0, 6, 14, 0]]
    assert mxu_cuda.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    from pbdagcon_tpu_torch.ops import mxu_cuda

    v = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_cuda.hist_cuda(v, None, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_cuda.scatter_cuda(v, None, (v,), 4, 0xFF)
