"""The port's mesh and scheduler (`pbdagcon_tpu_torch/parallel/mesh.py`,
`scheduler.py`) against the JAX package's (tests/test_parallel.py): the
sharded DP over 8 CPU slots bitwise equal to the JAX package's on its
8-device CPU mesh and to the host DP, the counters' all-reduce over the
slots and over a two-process gloo group, the manifest shard, the bucket
scheduler and the prefetcher. The same sharded DP on the card is in
tests/test_torch_cuda.py."""

import json
import os
import random
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from pbdagcon_tpu.alignment import normalize_gaps
from pbdagcon_tpu.oracle.graph import AlnGraph
from pbdagcon_tpu.ops.dp import choose_layout, pad_batch
from pbdagcon_tpu.ops.linearize import host_scores, linearize
from pbdagcon_tpu.parallel import dp_scores_sharded as j_sharded
from pbdagcon_tpu.parallel import make_mesh as j_make_mesh
from pbdagcon_tpu.parallel import metrics_allreduce as j_allreduce
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup
from pbdagcon_tpu_torch.parallel import (
    BucketScheduler,
    dp_scores_sharded,
    make_mesh,
    metrics_allreduce,
    shard_for_host,
)
from pbdagcon_tpu_torch.parallel.mesh import Mesh, _pad_batch_to
from pbdagcon_tpu_torch.parallel.scheduler import Prefetcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lins(seeds, length=120, cov=15):
    out = []
    for seed in seeds:
        rng = random.Random(seed)
        backbone, alns = simulate_pileup(
            rng, f"s{seed}", length, cov, NoiseProfile()
        )
        g = AlnGraph(backbone)
        for a in alns:
            g.add_aln(normalize_gaps(a))
        g.merge_nodes()
        out.append(linearize(g, sid=f"s{seed}"))
    return out


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def test_sharded_dp_matches_reference_mesh_and_host():
    assert len(jax.devices()) == 8
    lins = _lins(range(11))  # deliberately not divisible by 8
    W, K = choose_layout(lins)
    batch = pad_batch(lins, 512, W, K)
    got = dp_scores_sharded(batch, make_mesh(8, device="cpu"))
    assert got.shape == (11, 512)
    np.testing.assert_array_equal(
        _bits(got), _bits(j_sharded(batch, j_make_mesh())))
    for i, lin in enumerate(lins):
        np.testing.assert_array_equal(_bits(got[i, : lin.n]),
                                      _bits(host_scores(lin)))
    # Any slot count gives the same scores, the shards in slot order.
    for n in (1, 3):
        np.testing.assert_array_equal(
            _bits(dp_scores_sharded(batch, make_mesh(n, device="cpu"))),
            _bits(got))


def test_pad_batch_to_pads_as_reference():
    lins = _lins(range(3))
    W, K = choose_layout(lins)
    batch = pad_batch(lins, 512, W, K)
    padded, B = _pad_batch_to(batch, 8)
    assert B == 3 and padded["win_count"].shape[0] == 8
    for k in ("win_count", "exit_count", "long_u", "long_w"):
        assert (padded[k][3:] == -1).all()
    assert np.isneginf(padded["long_esc"][3:]).all()
    assert (padded["n"][3:] == 0).all()
    assert (padded["cov"][3:] == 0).all() and not padded["unsup"][3:].any()
    for k, v in batch.items():
        assert padded[k].dtype == v.dtype
        np.testing.assert_array_equal(padded[k][:3], v)
    same, B = _pad_batch_to(batch, 3)
    assert same is batch and B == 3


def test_metrics_allreduce_matches_reference():
    mesh, jmesh = make_mesh(8, device="cpu"), j_make_mesh()
    row = np.array([3, 7], dtype=np.int64)
    np.testing.assert_array_equal(metrics_allreduce(row, mesh), [3, 7])
    np.testing.assert_array_equal(metrics_allreduce(row, mesh),
                                  j_allreduce(row, jmesh))
    rows = np.arange(16, dtype=np.int64).reshape(8, 2)
    np.testing.assert_array_equal(metrics_allreduce(rows, mesh),
                                  rows.sum(axis=0))
    np.testing.assert_array_equal(metrics_allreduce(rows, mesh),
                                  j_allreduce(rows, jmesh))
    f = np.array([0.5, 2.25])
    np.testing.assert_array_equal(metrics_allreduce(f, mesh), f)
    with pytest.raises(ValueError):
        metrics_allreduce(rows[:3], mesh)


def test_make_mesh_slots_and_refusals():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis == "targets"
    assert all(d.type == "cpu" for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    assert Mesh(("cpu", "cpu")).devices == make_mesh(2, "cpu").devices
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        Mesh(())
    # No card visible: a CUDA mesh raises, it never becomes a CPU one.
    res = subprocess.run(
        [sys.executable, "-c",
         "from pbdagcon_tpu_torch.parallel import make_mesh\n"
         "try:\n    make_mesh()\nexcept RuntimeError as e:\n"
         "    print('raised', e)\n"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("raised"), res.stdout


def _two_cards(monkeypatch):
    """Make the CPU build of torch report two visible cards."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_make_mesh_of_an_indexed_card_is_one_slot(monkeypatch):
    """A card with an index (`--device cuda:1`, a rank's card) is a
    one-slot mesh on that card; a bare "cuda" keeps every visible card."""
    import torch

    _two_cards(monkeypatch)
    for dev in ("cuda:1", torch.device("cuda", 1)):
        assert make_mesh(device=dev).devices == (torch.device("cuda", 1),)
    assert make_mesh(device="cuda:0").devices == (torch.device("cuda", 0),)
    assert make_mesh(device="cuda").devices == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1, device="cuda").size == 1
    with pytest.raises(ValueError):
        make_mesh(device="cuda:2")
    with pytest.raises(ValueError):
        make_mesh(2, device="cuda:1")


@pytest.mark.parametrize("device,want", [
    ("cuda:1", ("cuda:1",)), ("cuda", ("cuda:0", "cuda:1"))])
def test_oversize_route_asks_for_the_runs_card(monkeypatch, device, want):
    """The oversize route's mesh follows the run's device: at cuda:1 one
    slot on card 1, at a bare "cuda" every visible card. The mesh that
    `make_mesh` returns is recorded, then the ring runs on as many CPU
    slots, and the scores equal one CPU slot's."""
    import torch

    from pbdagcon_tpu_torch import native as tnative
    from pbdagcon_tpu_torch import pipeline as tpipeline
    from pbdagcon_tpu_torch.config import DagconConfig
    from pbdagcon_tpu_torch.simulate import simulate_targets, to_m5

    if not tnative.ensure_built():
        pytest.skip("native engine not built")
    _two_cards(monkeypatch)
    asked = []

    def record(n_devices=None, device="cuda"):
        mesh = make_mesh(n_devices, device=device)
        asked.append(mesh.devices)
        return make_mesh(mesh.size, device="cpu")

    monkeypatch.setattr(tpipeline, "make_mesh", record)
    text = "".join(to_m5(a) + "\n" for _t, _b, alns in
                   simulate_targets(22, 1, 500, 12) for a in alns).encode()
    cfg = DagconConfig(backend="cuda", device="cpu", min_weight=3,
                       min_length=50, threads=1)
    with tnative.NativeEngine(min_weight=3, min_length=50, threads=1) as eng:
        assert eng.linearize_text(text, flush=True) == 1
        n, span = (int(x) for x in eng.metas(1)[0, :2])
        got = tpipeline._colshard_oversize(
            eng, 0, n, span, cfg, torch.device(device))
        one = tpipeline._colshard_oversize(
            eng, 0, n, span, cfg, torch.device("cpu"))
    assert asked[0] == tuple(torch.device(d) for d in want)
    assert asked[1] == (torch.device("cpu"),)
    assert got is not None
    np.testing.assert_array_equal(_bits(got), _bits(one))


def test_shard_for_host_partition():
    items = list(range(20))
    shards = [
        list(shard_for_host(items, host_id=h, n_hosts=3)) for h in range(3)
    ]
    flat = sorted(x for s in shards for x in s)
    assert flat == items
    assert all(len(s) in (6, 7) for s in shards)
    assert shards[1] == items[1::3]
    # Without a process group: rank 0 of 1.
    assert list(shard_for_host(items)) == items


def test_bucket_scheduler():
    lins = _lins(range(5), length=60, cov=8)
    sched = BucketScheduler(v_buckets=(256, 512), batch_targets=2)
    flushed = []
    for i, lin in enumerate(lins):
        out = sched.add(i, lin)
        if out:
            flushed.append(out)
    flushed.extend(sched.drain())
    got = sorted(i for _V, batch in flushed for i, _l in batch)
    assert got == [0, 1, 2, 3, 4]
    for V, batch in flushed:
        assert V == -1 or all(l.n <= V for _i, l in batch)
    assert list(sched.drain()) == []


def test_prefetcher_bounded_and_propagates():
    got = list(Prefetcher(lambda: iter(range(10)), depth=2))
    assert got == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = iter(Prefetcher(boom, depth=2))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)


_RANK = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from pbdagcon_tpu_torch.parallel import make_mesh, metrics_allreduce, shard_for_host
dist.init_process_group("gloo", init_method="env://")
rank = dist.get_rank()
mesh = make_mesh(2, device="cpu")
row = metrics_allreduce(np.array([rank + 1, 10 * (rank + 1)], np.int64), mesh)
rows = metrics_allreduce(np.full((2, 2), 0.25 * (rank + 1)), mesh)
print(json.dumps({"rank": rank, "row": row.tolist(), "rows": rows.tolist(),
                  "dtypes": [str(row.dtype), str(rows.dtype)],
                  "shard": list(shard_for_host(range(10)))}))
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_allreduce_and_shard():
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a gloo rank hung")
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for r, o in enumerate(outs):
        assert o["rank"] == r
        assert o["row"] == [3, 30]  # each rank's row, summed over ranks
        assert o["rows"] == [1.5, 1.5]  # 2 slots x (0.25 + 0.5)
        assert o["dtypes"] == ["int64", "float64"]
        assert o["shard"] == list(range(r, 10, 2))
