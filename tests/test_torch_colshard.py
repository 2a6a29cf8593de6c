"""The port's one-card column-sharded DP (`pbdagcon_tpu_torch/parallel/
colshard.py`, the blocked solve at B = 1) against the JAX package's
`colsharded_scores` on the 8-device CPU mesh and on a 1-device mesh, and
against the host DP; the oversize route of the native-loader path (byte-
equal FASTA, the same host fallbacks as the reference's run, failures
raised); and `backend="blocked"` through the pipeline and the CLI. The
device is the CPU here (the kernels' plain versions); the same routes on
the card are in tests/test_torch_cuda.py."""

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


def test_colsharded_overflow_raises_as_reference():
    """Scores past the f32-parity line raise OverflowError in both."""
    V, W = 300, 4
    win = np.full((V, W), -1, np.int32)
    win[:-1, 0] = 70000
    exit_c = np.full(V, -1, np.int32)
    exit_c[-1] = 0
    arrs = (win, exit_c, np.zeros(V, np.int32), np.zeros(V, bool))
    with pytest.raises(OverflowError):
        jcolshard(*arrs, make_mesh(1))
    with pytest.raises(OverflowError):
        colsharded_scores(*arrs, device="cpu")


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
