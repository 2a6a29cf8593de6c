"""The port's column-sharded DP (`pbdagcon_tpu_torch/parallel/
colshard.py`, the blocked solve at B = 1, its boundary ring over the
slots of a mesh) against the JAX package's `colsharded_scores` on the
8-device CPU mesh and on 1- and 2-device meshes, and against the host
DP, at 1, 2, 3 and 8 CPU slots, integer for integer; the ring's boundary
chain on random matrices; the oversize route of the native-loader path
(byte-equal FASTA, the same host fallbacks as the reference's run,
failures raised), on one slot and on an 8-slot mesh; and
`backend="blocked"` through the pipeline and the CLI. The device is the
CPU here (the kernels' plain versions); the same routes on the card are
in tests/test_torch_cuda.py."""

import functools
import io
import os
import random

import numpy as np
import pytest

from pbdagcon_tpu import native as jnative
from pbdagcon_tpu.alignment import normalize_gaps
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.oracle.graph import AlnGraph
from pbdagcon_tpu.ops.dp import pad_batch as jpad_batch
from pbdagcon_tpu.ops.linearize import host_scores, linearize
from pbdagcon_tpu.parallel.colshard import colsharded_scores as jcolshard
from pbdagcon_tpu.parallel.mesh import make_mesh
from pbdagcon_tpu.pipeline import run_stream as jax_run_stream
from pbdagcon_tpu.simulate import (
    NoiseProfile,
    simulate_pileup,
    simulate_targets,
    to_m5,
)
from pbdagcon_tpu_torch import native as tnative
from pbdagcon_tpu_torch import pipeline as tpipeline
from pbdagcon_tpu_torch.cli import main
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.convert import config_from_jax
from pbdagcon_tpu_torch.ops import dp_blocked as tbl
from pbdagcon_tpu_torch.parallel import colsharded_scores
from pbdagcon_tpu_torch.parallel import colshard as tcolshard
from pbdagcon_tpu_torch.parallel import make_mesh as t_make_mesh
from pbdagcon_tpu_torch.pipeline import run_stream

DATA = os.path.join(os.path.dirname(__file__), "data")
M5 = os.path.join(DATA, "golden1.m5")
EXPECTED = open(os.path.join(DATA, "golden1.fa")).read()


def _skip_without_native():
    if not tnative.available():
        pytest.skip("native library not built")


def _one_target_arrays(seed, length, cov, W):
    """A simulated target's band arrays (tests/test_colshard.py)."""
    rng = random.Random(seed)
    backbone, alns = simulate_pileup(
        rng, f"cs{seed}", length, cov, NoiseProfile()
    )
    g = AlnGraph(backbone)
    for a in alns:
        g.add_aln(normalize_gaps(a))
    g.merge_nodes()
    lin = linearize(g)
    if lin.span > W:
        return None, None  # not eligible
    u = np.repeat(np.arange(lin.n, dtype=np.int32), np.diff(lin.edge_off))
    interior = lin.edge_tgt < lin.n
    win = np.full((lin.n, W), -1, dtype=np.int32)
    d = (lin.edge_tgt - u - 1)[interior]
    win[u[interior], d] = lin.edge_cnt[interior]
    return lin, (win, lin.exit_count, lin.cov, lin.unsup)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("W,length,cov", [(64, 400, 20), (32, 700, 12)])
def test_colsharded_matches_reference_meshes_and_host(W, length, cov):
    done = 0
    for seed in range(30, 45):
        lin, arrs = _one_target_arrays(seed, length, cov, W)
        if lin is None:
            continue
        got = colsharded_scores(*arrs, device="cpu")
        np.testing.assert_array_equal(_bits(got), _bits(host_scores(lin)))
        for mesh in (make_mesh(), make_mesh(1)):
            np.testing.assert_array_equal(
                _bits(got), _bits(jcolshard(*arrs, mesh))
            )
        done += 1
        if done >= 2:
            break
    assert done >= 1, "no eligible (span <= W) targets generated"


def _overflowing_band():
    V, W = 300, 4
    win = np.full((V, W), -1, np.int32)
    win[:-1, 0] = 70000
    exit_c = np.full(V, -1, np.int32)
    exit_c[-1] = 0
    return win, exit_c, np.zeros(V, np.int32), np.zeros(V, bool)


def test_colsharded_overflow_raises_as_reference():
    """Scores past the f32-parity line raise OverflowError in both."""
    arrs = _overflowing_band()
    with pytest.raises(OverflowError):
        jcolshard(*arrs, make_mesh(1))
    with pytest.raises(OverflowError):
        colsharded_scores(*arrs, device="cpu")


def test_ring_overflow_raises_as_reference():
    """The same band over two slots: OverflowError from the ring, as
    from the JAX package's 2-device mesh."""
    arrs = _overflowing_band()
    with pytest.raises(OverflowError):
        jcolshard(*arrs, make_mesh(2))
    with pytest.raises(OverflowError):
        colsharded_scores(*arrs, t_make_mesh(2, device="cpu"))


@functools.lru_cache(maxsize=None)
def _ring_case(W, length, cov):
    """The first eligible target of seeds 30.. (its lin, band arrays),
    the JAX package's scores on its 8- and 2-device meshes, and the
    port's on one CPU slot."""
    for seed in range(30, 45):
        lin, arrs = _one_target_arrays(seed, length, cov, W)
        if lin is not None:
            break
    else:
        pytest.fail("no eligible (span <= W) target generated")
    ref = [jcolshard(*arrs, make_mesh(n)) for n in (8, 2)]
    return lin, arrs, ref, colsharded_scores(*arrs, device="cpu")


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("W,length,cov", [(64, 400, 20), (32, 700, 12)])
def test_ring_matches_one_slot_reference_meshes_and_host(D, W, length, cov):
    """The ring over D CPU slots: integer-equal to one slot, to the JAX
    package on its 8- and 2-device meshes and to the host DP, with one
    hop a slot boundary."""
    lin, arrs, ref, one = _ring_case(W, length, cov)
    hops = tcolshard.hops
    got = colsharded_scores(*arrs, t_make_mesh(D, device="cpu"))
    assert tcolshard.hops - hops == D - 1
    assert D == 1 or lin.n % (64 * D), "V happens to be a multiple of L x D"
    np.testing.assert_array_equal(_bits(got), _bits(one))
    np.testing.assert_array_equal(_bits(got), _bits(host_scores(lin)))
    for r in ref:
        np.testing.assert_array_equal(_bits(got), _bits(r))


@pytest.mark.parametrize("V,D", [(777, 3), (130, 8), (1025, 5)])
def test_ring_at_v_no_multiple_of_the_slots(V, D):
    """A band cut to V rows (edges past the cut dropped), V no multiple
    of L x D: the ring over D slots equals one slot and the JAX
    package's 8-device mesh (W = 128: a halo of two blocks a slot)."""
    lin, arrs = _one_target_arrays(31, 700, 12, 128)
    assert lin is not None and lin.n >= V
    win, ex, cov, uns = (np.array(a[:V]) for a in arrs)
    u = np.arange(V)[:, None] + 1 + np.arange(win.shape[1])[None, :]
    win[u >= V] = -1
    ex[-1] = max(int(ex[-1]), 0)
    cut = (win, ex, cov, uns)
    one = colsharded_scores(*cut, device="cpu")
    got = colsharded_scores(*cut, t_make_mesh(D, device="cpu"))
    np.testing.assert_array_equal(_bits(got), _bits(one))
    np.testing.assert_array_equal(_bits(got), _bits(jcolshard(*cut, make_mesh())))
    assert np.isfinite(got).sum() > V // 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boundary_chain_carries_x_exactly(seed):
    """[I, M_0 .. M_{g-1}, M_x] propagated from x0, on random M and x
    with SENT entries: M_x (x) x0 = x exactly, the blocks' x_in equal
    the propagation from x, and I's x_in is M_0 (x) (block 0's x_in)."""
    import torch

    rng = np.random.default_rng(seed)
    g, Wp = 5, 17
    M = rng.integers(-(1 << 20), 1 << 20, size=(1, g, Wp, Wp), dtype=np.int32)
    M[rng.random(M.shape) < 0.3] = tbl.SENT
    M[0, :, Wp - 1, :] = tbl.SENT
    M[0, :, Wp - 1, Wp - 1] = 0  # the exit row of every transfer matrix
    x = rng.integers(-(1 << 20), 1 << 20, size=Wp, dtype=np.int32)
    x[rng.random(Wp) < 0.3] = tbl.SENT
    x[Wp - 1] = 0
    M, x = torch.from_numpy(M), torch.from_numpy(x)
    x_in = tbl._propagate(tcolshard.boundary_chain(M, x))[0]
    x0 = tcolshard._start(Wp, "cpu")
    assert torch.equal(x_in[g + 1], x0)
    assert torch.equal(x_in[g], x)
    cur = x
    for i in range(g - 1, -1, -1):
        assert torch.equal(x_in[i + 1], cur)
        cur = (M[0, i] + cur[None, :]).amax(-1).clamp_min(tbl.SENT)
    assert torch.equal(x_in[0], cur)


def _m5_text(seed, n_targets, length, cov) -> str:
    lines = [to_m5(a) for _t, _b, alns in
             simulate_targets(seed, n_targets, length, cov) for a in alns]
    return "\n".join(lines) + "\n"


def test_packer_matches_reference_get_linear_and_pad_batch():
    """The oversize route packs one target at (V, W, K=1) with the
    port's native packer; the reference exports it (`get_linear`) and
    packs it with `pad_batch`. The arrays are the same."""
    _skip_without_native()
    data = _m5_text(21, 2, 500, 12).encode()
    kw = dict(min_weight=3, min_length=50, threads=1)
    with tnative.NativeEngine(**kw) as te, jnative.NativeEngine(**kw) as je:
        cnt = te.linearize_text(data, flush=True)
        assert je.linearize_text(data, flush=True) == cnt
        metas = te.metas(cnt)
        for i in range(cnt):
            lin = je.get_linear(i)
            assert (lin.n, lin.span) == tuple(metas[i, :2])
            W = 128
            if lin.span > W:
                continue
            V = -(-lin.n // 64) * 64
            want = jpad_batch([lin], V, W, K=1)
            got = tnative.pack_batch(te, [i], V, W, 1)
            for k, v in want.items():
                if k != "n":
                    np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("w_buckets", [(16, 32, 64, 128), (16,)])
def test_oversize_route_byte_equal_with_reference_fallbacks(w_buckets):
    """Every target past the V ladder (v_buckets=(256,)): the column-
    sharded DP where the reference takes it, the host DP for the rest,
    as many as the reference's run counts (tests/test_colshard.py)."""
    _skip_without_native()
    text = _m5_text(21, 4, 500, 12)
    kw = dict(use_native=True, min_weight=3, min_length=50)
    want = io.StringIO()
    run_stream(io.StringIO(text), FastaWriter(want),
               DagconConfig(backend="host", **kw))
    got = io.StringIO()
    stats = run_stream(io.StringIO(text), FastaWriter(got), DagconConfig(
        backend="cuda", device="cpu", v_buckets=(256,), w_buckets=w_buckets,
        **kw))
    assert got.getvalue() == want.getvalue()
    assert stats.targets == 4
    ref = io.StringIO()
    jstats = jax_run_stream(io.StringIO(text), FastaWriter(ref), JaxConfig(
        backend="xla", v_buckets=(256,), w_buckets=w_buckets, **kw))
    assert ref.getvalue() == want.getvalue()
    assert sum(stats.fallback_reasons.values()) == stats.host_fallbacks
    assert stats.host_fallbacks == jstats.host_fallbacks
    assert stats.fallback_reasons in ({}, {"oversize": stats.host_fallbacks})
    assert stats.colshard == 4 - stats.host_fallbacks
    assert stats.batches == stats.colshard == jstats.batches
    if w_buckets == (16, 32, 64, 128):
        assert stats.colshard >= 1, "colshard path not taken"


def test_oversize_route_on_an_eight_slot_mesh(monkeypatch):
    """The oversize route with the run's mesh replaced by 8 CPU slots
    (the reference's 8-device mesh, tests/test_colshard.py's fixture):
    V padded to 64 x 8, the ring taken, the FASTA byte-equal to the JAX
    package's run and to the host backend's."""
    _skip_without_native()
    meshes = []

    def eight(n_devices=None, device="cuda"):
        assert device == "cpu" and n_devices is None
        meshes.append(t_make_mesh(8, device="cpu"))
        return meshes[-1]

    monkeypatch.setattr(tpipeline, "make_mesh", eight)
    text = _m5_text(21, 2, 500, 12)
    kw = dict(use_native=True, min_weight=3, min_length=50)
    want = io.StringIO()
    run_stream(io.StringIO(text), FastaWriter(want),
               DagconConfig(backend="host", **kw))
    ref = io.StringIO()
    jstats = jax_run_stream(io.StringIO(text), FastaWriter(ref), JaxConfig(
        backend="xla", v_buckets=(256,), **kw))
    hops = tcolshard.hops
    got = io.StringIO()
    stats = run_stream(io.StringIO(text), FastaWriter(got), DagconConfig(
        backend="cuda", device="cpu", v_buckets=(256,), **kw))
    assert got.getvalue() == ref.getvalue() == want.getvalue()
    assert stats.colshard >= 1 and meshes
    assert tcolshard.hops - hops == 7 * stats.colshard
    assert stats.host_fallbacks == jstats.host_fallbacks


@pytest.mark.parametrize("use_native", [True, False])
def test_oversize_host_dp_is_timed(use_native):
    """The host DP of every declined target past the V ladder
    (v_buckets=(256,)) is timed under stage_s["host_dp"], on the native
    path and on the Python path, and the FASTA stays the host
    backend's."""
    if use_native:
        _skip_without_native()
    text = _m5_text(21, 4, 500, 12)
    kw = dict(use_native=use_native, min_weight=3, min_length=50)
    want = io.StringIO()
    run_stream(io.StringIO(text), FastaWriter(want),
               DagconConfig(backend="host", **kw))
    got = io.StringIO()
    stats = run_stream(io.StringIO(text), FastaWriter(got), DagconConfig(
        backend="cuda", device="cpu", v_buckets=(256,),
        w_buckets=(16,), **kw))
    assert got.getvalue() == want.getvalue()
    declined = stats.fallback_reasons.get("oversize", 0)
    assert declined >= 1, "no target took the host DP"
    assert stats.stage_s["host_dp"] > 0.0
    if use_native:
        assert declined + stats.colshard == stats.targets == 4
    else:
        assert declined == stats.targets == 4


def test_oversize_route_raises_on_solve_failure(monkeypatch):
    """A failure inside the column-sharded solve reaches the caller: no
    host DP hides it (the reference's catch-all is not carried over)."""
    _skip_without_native()

    def boom(*a, **k):
        raise RuntimeError("solve failed")

    monkeypatch.setattr(tpipeline, "colsharded_scores", boom)
    with pytest.raises(RuntimeError, match="solve failed"):
        run_stream(io.StringIO(_m5_text(21, 2, 500, 12)),
                   FastaWriter(io.StringIO()),
                   DagconConfig(device="cpu", v_buckets=(256,),
                                min_weight=3, min_length=50))


@pytest.mark.parametrize("use_native", [True, False])
def test_blocked_backend_golden(use_native):
    if use_native:
        _skip_without_native()
    out = io.StringIO()
    with open(M5) as f:
        stats = run_stream(f, FastaWriter(out), DagconConfig(
            backend="blocked", device="cpu", use_native=use_native,
            min_weight=6, min_length=100))
    assert out.getvalue() == EXPECTED
    assert stats.batches == 1 and stats.host_fallbacks == 0
    assert stats.blocked_reruns == 0


def test_blocked_backend_matches_jax_blocked():
    _skip_without_native()
    text = _m5_text(4242, 8, 300, 20)
    jcfg = JaxConfig(backend="blocked", min_weight=5, min_length=50,
                     v_buckets=(256, 512, 1024))
    want = io.StringIO()
    jax_run_stream(io.StringIO(text), FastaWriter(want), jcfg)
    got = io.StringIO()
    cfg = config_from_jax(jcfg, "cpu")
    assert cfg.backend == "blocked"
    run_stream(io.StringIO(text), FastaWriter(got), cfg)
    assert want.getvalue().count(">") >= 8
    assert got.getvalue() == want.getvalue()


def test_blocked_backend_raises_on_solve_failure(monkeypatch):
    _skip_without_native()

    def boom(*a, **k):
        raise RuntimeError("solve failed")

    monkeypatch.setattr(tbl, "solve_band", boom)
    with pytest.raises(RuntimeError, match="solve failed"):
        with open(M5) as f:
            run_stream(f, FastaWriter(io.StringIO()), DagconConfig(
                backend="blocked", device="cpu", min_weight=6,
                min_length=100))


def test_cli_takes_blocked_backend(capsys):
    assert main([M5, "-c", "6", "-m", "100", "--device", "cpu",
                 "--backend", "blocked"]) == 0
    assert capsys.readouterr().out == EXPECTED
