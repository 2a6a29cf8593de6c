"""The launch plans of the histogram and scatter kernels
(`ops/mxu_cuda.py::hist_plan`, `scatter_plan`) and the plain versions'
`valid` argument, on the CPU.

- Each plan's invariants (every bin owned by exactly one CTA, every value
  read by exactly one, shared bytes within a CTA's 227 KB, at most 16
  CTAs to a cluster, one launch) over the bench window's shapes and the
  edge shapes, and the route each window shape takes.
- A numpy model of the kernels under the plan (each CTA's slice of the
  values, the owner of each bin found by the kernel's float32 product,
  the unsigned adds, each CTA's bins written out) equal to the plain
  versions: a wrong plan or owner split shows here, where no card is
  needed.
- The plain versions with `valid` (as the kernels take it) against the
  JAX package's `mxu_hist`, `mxu_scatter` and `mxu_weighted_hist` on the
  CPU, exact equality.

The kernels themselves are held against the plain versions on the card
in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import mxu as jmxu
from pbdagcon_tpu_torch.ops import mxu, mxu_cuda

# The devbuild bench window's calls at B = 128 (caps R=32, C=1280,
# L=1024, ND=4608, SE=14, V=5632): (N, D) of the 9 histograms, (N, D,
# planes) of the 8 scatters.
WINDOW_HIST = [(64, 2052), (40960, 1026), (4608, 4608), (40992, 9234),
               (6144, 1026), (6144, 8208), (4608, 1026), (6144, 2052)]
WINDOW_SCATTER = [(40992, 9234, 1), (6144, 4608, 1), (4608, 4608, 1),
                  (4608, 5632, 2), (6144, 14364, 2), (4608, 5632, 1),
                  (11306, 32, 1)]
# (B, N, D, planes) at the edges: one element, N = 0, B past the SMs,
# domains that take 2..16 CTAs, small B, the global route, D not a
# multiple of 4.
EDGE = [
    (1, 1, 1, 1), (5, 0, 300, 1), (300, 100, 50, 2), (129, 100, 8, 1),
    (3, 700, 257, 1), (7, 20000, 245000, 1), (5, 5000, 60000, 1),
    (37, 41000, 15000, 1), (2, 40000, 4000, 4), (2, 100, 1_000_000, 1),
    (128, 6144, 78848, 2), (7, 30000, 70001, 1), (6, 20000, 60000, 4),
    (3, 9000, 929_792, 1), (3, 9000, 929_793, 1), (4, 300, 4093, 1),
    (2, 257, 63, 3),
]
SHAPES = ([(128, N, D, 1) for N, D in WINDOW_HIST]
          + [(128, N, D, NP) for N, D, NP in WINDOW_SCATTER] + EDGE)


def _plan(B, N, D, NP):
    if NP == 1:
        assert mxu_cuda.hist_plan(B, N, D) == mxu_cuda.scatter_plan(B, N, D, 1)
    return mxu_cuda.scatter_plan(B, N, D, NP)


@pytest.mark.parametrize("B,N,D,NP", SHAPES)
def test_plan_invariants(B, N, D, NP):
    plan = _plan(B, N, D, NP)
    assert plan.route in mxu_cuda.ROUTES
    assert 1 <= plan.cluster <= mxu_cuda.MAX_CLUSTER
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert 0 <= plan.smem <= mxu_cuda.MAX_SMEM
    # every bin of a row owned by exactly one CTA, none left without bins
    owned = np.zeros(D, dtype=np.int64)
    for lo, hi in plan.owners(D):
        assert lo < hi or D == 0
        owned[lo:hi] += 1
    assert (owned == 1).all()
    # every value read by exactly one CTA
    read = np.zeros(N, dtype=np.int64)
    for lo, hi in plan.value_slices(N):
        read[lo:hi] += 1
    assert (read == 1).all()
    if plan.route == "cluster":
        assert plan.bins % 4 == 0 and plan.smem == NP * plan.bins * 4
        assert plan.cluster == 1 or D < 1 << 20  # the float owner split
        assert plan.cluster >= mxu_cuda.fewest_ctas(D, NP)
        assert plan == mxu_cuda.cluster_plan(N, D, NP, plan.cluster)
    else:  # only past what a 16-CTA cluster holds
        per_cta = mxu_cuda.MAX_SMEM // (4 * NP) // 4 * 4
        assert D > mxu_cuda.MAX_CLUSTER * per_cta


@pytest.mark.parametrize("N,D,NP", [(N, D, 1) for N, D in WINDOW_HIST]
                         + WINDOW_SCATTER)
def test_window_calls_take_one_cta_per_row(N, D, NP):
    """At B = 128 every window call, the N = 64 one too, has its row's
    bins in one CTA: no cluster, no global atomics, no fill."""
    plan = _plan(128, N, D, NP)
    assert plan.route == "cluster" and plan.cluster == 1
    assert plan.owners(D) == [(0, D)]


def test_clusters_follow_the_shared_memory_and_the_card():
    # D = 245,000 bins (960 KB) need 5 CTAs of <= 227 KB
    assert _plan(7, 20000, 245000, 1).cluster == 5
    # two planes of 78,848 bins need 3
    assert _plan(128, 6144, 78848, 2).cluster == 3
    # 16 CTAs hold 16 * 58,112 bins; one more takes the global route
    assert _plan(3, 9000, 929_792, 1).cluster == 16
    assert _plan(3, 9000, 929_793, 1).route == "global"
    # small B takes no more CTAs than the planes need: clusters grown to
    # fill the card measured slower on the devbuild windows of B = 8-64
    for B in (1, 2, 8, 32, 64, 128):
        assert _plan(B, 40000, 4000, 4).cluster == 1
        assert _plan(B, 40992, 9234, 1).cluster == 1
        assert _plan(B, 6144, 78848, 2).cluster == 3


# (N, D, planes, cluster size) of plans forced on small domains, as the
# card tests and `tools/bins_ablate.py` force them: most adds remote, a
# few hot bins; a size that would leave a CTA without bins shrinks.
FORCED = [(3000, 300, 1, 4), (40000, 64, 2, 8), (3001, 300, 3, 2),
          (40000, 4000, 1, 16), (5000, 9, 1, 4), (100, 8, 4, 2)]


@pytest.mark.parametrize("N,D,NP,cs", FORCED)
def test_cluster_plan_forced(N, D, NP, cs):
    plan = mxu_cuda.cluster_plan(N, D, NP, cs)
    assert plan.route == "cluster" and 1 <= plan.cluster <= cs
    assert plan.bins % 4 == 0 and plan.smem == NP * plan.bins * 4
    assert all(lo < hi for lo, hi in plan.owners(D))
    assert sum(hi - lo for lo, hi in plan.owners(D)) == D
    assert 128 <= plan.threads <= 1024
    assert mxu_cuda.cluster_plan(N, D, NP, cs, threads=512).threads == 512


def _model(plan, idx, valid, payloads, D, cut):
    """The kernels' arithmetic under `plan` in numpy: returns the planes
    and how often each output element was written."""
    B, N = idx.shape
    hist = payloads is None
    NP = 1 if hist else len(payloads)
    out = np.zeros((NP, B, D), dtype=np.int64)
    written = np.zeros((B, D), dtype=np.int64)
    ok = np.ones((B, N), bool) if valid is None else valid.astype(bool)
    ok &= (idx >= 0) & (idx < D)
    vals = [np.ones((B, N), np.int64)] if hist else [
        p.astype(np.int64) & cut for p in payloads]
    if plan.route != "cluster":
        for b in range(B):
            for k in range(NP):
                np.add.at(out[k, b], idx[b][ok[b]], vals[k][b][ok[b]])
            written[b] += 1
        return out & 0xFFFFFFFF, written
    inv = np.float32(1.0) / np.float32(plan.bins)
    for b in range(B):
        sm = np.zeros((plan.cluster, NP, plan.bins), dtype=np.int64)
        for lo, hi in plan.value_slices(N):
            sel = np.nonzero(ok[b, lo:hi])[0] + lo
            r = idx[b, sel].astype(np.int64)
            owner = np.trunc(r.astype(np.float32) * inv).astype(np.int64)
            base = owner * plan.bins
            down = base > r
            owner[down] -= 1
            up = ~down & (r - base >= plan.bins)
            owner[up] += 1
            local = r - owner * plan.bins
            assert ((owner >= 0) & (owner < plan.cluster)).all()
            assert ((local >= 0) & (local < plan.bins)).all()
            for k in range(NP):
                np.add.at(sm[:, k], (owner, local), vals[k][b, sel])
        for c, (lo, hi) in enumerate(plan.owners(D)):
            out[:, b, lo:hi] = sm[c, :, : hi - lo]
            written[b, lo:hi] += 1
    return out & 0xFFFFFFFF, written


def _as_i32(x):
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("B,N,D,NP,cs", [(*s, None) for s in SHAPES]
                         + [(2, *f) for f in FORCED])
def test_kernel_model_under_plan_equals_plain_version(B, N, D, NP, cs):
    """Two rows of each shape (the plan of the full B, or a plan forced
    to `cs` CTAs): ranks repeat and run outside [0, D), a valid mask,
    over-wide payloads, a 3-byte cut."""
    rng = np.random.default_rng(B * 31 + N + D + NP)
    plan = (_plan(B, N, D, NP) if cs is None
            else mxu_cuda.cluster_plan(N, D, NP, cs))
    rows = min(B, 2)
    n_sim = min(N, 50_000)
    if plan.route == "cluster" and n_sim < N:  # keep the plan's slices
        n_sim = N
    idx = rng.integers(-3, D + 5, (rows, n_sim)).astype(np.int32)
    idx[:, ::7] = D - 1  # a hot bin
    valid = rng.random((rows, n_sim)) < 0.8
    pays = [rng.integers(-(1 << 31), (1 << 31) - 1, (rows, n_sim)).astype(np.int32)
            for _ in range(NP)]
    cut = 0xFFFFFF
    got, written = _model(plan, idx, valid, pays, D, cut)
    assert (written == 1).all()
    want = mxu.scatter_reference(torch.from_numpy(idx), torch.from_numpy(valid),
                                 tuple(torch.from_numpy(p) for p in pays), D, cut)
    for k in range(NP):
        assert torch.equal(_as_i32(got[k]), want[k])
    got_h, _ = _model(plan, idx, valid, None, D, 0)
    assert torch.equal(_as_i32(got_h[0]),
                       mxu.hist_reference(torch.from_numpy(idx),
                                          torch.from_numpy(valid), D))


# ---- the plain versions with `valid` against the JAX package ----------


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(want).shape
    assert np.array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed,B,N,D,mask_shape", [
    (0, 3, 700, 257, "full"), (1, 5, 4096, 1026, "row"),
    (2, 2, 3000, 9234, "col"), (3, 4, 64, 2052, "full"),
])
def test_hist_reference_with_valid_equals_jax(seed, B, N, D, mask_shape):
    """`valid` full, one value per row ([B, 1]) or per column ([1, N]),
    broadcast as the JAX form's `where` broadcasts it."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, D + 9, (B, N)).astype(np.int32)
    shape = {"full": (B, N), "row": (B, 1), "col": (1, N)}[mask_shape]
    m = rng.random(shape) < 0.6
    got = mxu.hist_reference(torch.from_numpy(v), torch.from_numpy(m), D)
    _eq(got, jmxu.mxu_hist(jnp.asarray(v), jnp.asarray(m), D))
    _eq(mxu.mxu_hist(torch.from_numpy(v), torch.from_numpy(m), D), got)


@pytest.mark.parametrize("nbytes", [1, 2, 3, 4])
def test_scatter_reference_with_valid_equals_jax(nbytes):
    rng = np.random.default_rng(40 + nbytes)
    B, N, D = 3, 2000, 2500
    r = np.stack([rng.permutation(D)[:N] for _ in range(B)]).astype(np.int32) - 3
    ps = [rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
          for _ in range(2)]
    m = rng.random((B, N)) < 0.7
    mask = (1 << (8 * nbytes)) - 1
    got = mxu.scatter_reference(torch.from_numpy(r), torch.from_numpy(m),
                                tuple(torch.from_numpy(p) for p in ps), D, mask)
    want = jmxu.mxu_scatter(jnp.asarray(r), jnp.asarray(m),
                            tuple(jnp.asarray(p) for p in ps), D,
                            max_payload=1 << (8 * nbytes))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("D,max_weight", [(32, 1 << 24), (9234, 1 << 31),
                                          (300, 1 << 16)])
def test_weighted_hist_reference_with_valid_equals_jax(D, max_weight):
    """Repeated keys sum with wraparound (the weighted-hist calls)."""
    rng = np.random.default_rng(D)
    B, N = 2, 6000
    v = rng.integers(-2, D + 3, (B, N)).astype(np.int32)
    w = rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
    m = rng.random((B, N)) < 0.75
    nb = mxu._nbytes(max_weight)
    (got,) = mxu.scatter_reference(torch.from_numpy(v), torch.from_numpy(m),
                                   (torch.from_numpy(w),), D, mxu._cut_mask(nb))
    (want,) = jmxu.mxu_weighted_hist(jnp.asarray(v), jnp.asarray(m),
                                     (jnp.asarray(w),), D, max_weight=max_weight)
    _eq(got, want)
    (disp,) = mxu.mxu_weighted_hist(torch.from_numpy(v), torch.from_numpy(m),
                                    (torch.from_numpy(w),), D,
                                    max_weight=max_weight)
    _eq(disp, want)


def test_valid_none_is_every_element():
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.integers(-2, 70, (3, 500)).astype(np.int32))
    ones = torch.ones_like(v, dtype=torch.bool)
    assert torch.equal(mxu.hist_reference(v, None, 64),
                       mxu.hist_reference(v, ones, 64))
    p = (v * 7,)
    assert torch.equal(mxu.scatter_reference(v, None, p, 64, 0xFFFF)[0],
                       mxu.scatter_reference(v, ones, p, 64, 0xFFFF)[0])
