"""The port's device backtrack (`ops/devemit.py`) on the CPU, held
against the JAX package's `ops/devemit.py` with exact equality: from
the same JAX build and scores, and from the port's own build and DP; the
port's DP bitwise equal to the JAX DP on the device-built graph; and
the host fragment assembly. A walk cut short (small P) covers the
overflow flag."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import devbuild as dbn
from pbdagcon_tpu.ops import devbuild_jax as dbj
from pbdagcon_tpu.ops import devemit as jde
from pbdagcon_tpu.ops.dp import dp_scores as jax_dp_scores
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup
from pbdagcon_tpu_torch.convert import tree_to_torch
from pbdagcon_tpu_torch.ops import devbuild_torch as dbt
from pbdagcon_tpu_torch.ops import devemit
from pbdagcon_tpu_torch.ops.dp import dp_scores

CAPS = dbj.Caps(B=8, R=24, C=220, L=96, CH=48, SM=8, NC=1152, ND=512, SE=8,
                DQ=8, V=640, W=64)
MW = 2
P_FULL, P_SHORT = 320, 16
DP_KEYS = ("win", "exit_cnt", "cov", "unsup", "long_u", "long_w", "long_esc")


def _inputs():
    profs = [
        NoiseProfile(),
        NoiseProfile(sub=0.05, ins=0.2, dele=0.1),
        NoiseProfile(sub=0.02, ins=0.25, dele=0.12, max_ins_run=5),
    ]
    rng = random.Random(4242)
    encs = []
    for s in range(CAPS.B):
        bbs, alns = simulate_pileup(
            rng, f"t{s}", rng.randint(30, 90), rng.randint(2, 20), profs[s % 3]
        )
        encs.append(dbn.encode_group(bbs, alns, sid=f"t{s}"))
    ops = np.zeros((CAPS.B, CAPS.R, CAPS.C), np.uint8)
    starts = np.zeros((CAPS.B, CAPS.R), np.int32)
    bb = np.zeros((CAPS.B, CAPS.L), np.uint8)
    Lr = np.zeros(CAPS.B, np.int32)
    ins = np.zeros((CAPS.B, CAPS.R * CAPS.C), np.uint8)
    for b, e in enumerate(encs):
        R, C = e.ops.shape
        ops[b, :R, :C] = e.ops
        starts[b, :R] = e.starts
        bb[b, : len(e.backbone)] = e.backbone
        Lr[b] = len(e.backbone)
        ins[b, : len(e.ins_base)] = e.ins_base
    return ops, starts, bb, ins, Lr


@pytest.fixture(scope="module")
def ref():
    inputs = _inputs()
    build = dbj.device_build(*inputs, CAPS)
    scores = jax_dp_scores(*(build[k] for k in DP_KEYS))
    emits = {
        P: jax.tree_util.tree_map(
            np.asarray, jde.backtrack_emit(build, scores, jnp.int32(MW), P)
        )
        for P in (P_FULL, P_SHORT)
    }
    return {
        "inputs": inputs,
        "build": jax.tree_util.tree_map(np.asarray, build),
        "scores": np.asarray(scores),
        "emits": emits,
    }


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.array_equal(g, w), (k, np.argwhere(g != w)[:5].tolist())


def test_dp_on_the_device_build_is_bitwise_jax(ref):
    b = tree_to_torch(ref["build"], "cpu")
    got = dp_scores(*(b[k] for k in DP_KEYS))
    assert np.array_equal(got.numpy().view(np.int32), ref["scores"].view(np.int32))


@pytest.mark.parametrize("P", [P_FULL, P_SHORT])
def test_backtrack_emit_equals_jax(ref, P):
    b = tree_to_torch(ref["build"], "cpu")
    got = devemit.backtrack_emit(b, torch.from_numpy(ref["scores"]), MW, P)
    _same(got, ref["emits"][P])
    if P == P_SHORT:
        assert ref["emits"][P]["overflow"].any()
    else:
        assert not ref["emits"][P]["overflow"].any()
        assert (ref["emits"][P]["path_len"] > 0).all()


def test_port_build_dp_emit_equal_jax(ref):
    """The port end to end on device-build inputs: its build, its DP and
    its backtrack give the JAX emit."""
    a = [torch.from_numpy(x) for x in ref["inputs"]]
    build = dbt.device_build(*a, dbt.Caps(**CAPS.__dict__))
    scores = dp_scores(*(build[k] for k in DP_KEYS))
    assert np.array_equal(
        scores.numpy().view(np.int32), ref["scores"].view(np.int32)
    )
    _same(devemit.backtrack_emit(build, scores, MW, P_FULL), ref["emits"][P_FULL])


def test_assemble_fragments_equals_jax(ref):
    e = ref["emits"][P_FULL]
    flags = ref["build"]["flags"]
    emitted = 0
    for b in range(CAPS.B):
        if flags[b] or e["ambiguous"][b]:
            continue
        emitted += 1
        for min_length in (1, 5, 40):
            args = (e["bases"][b], e["kept"][b], e["bbpos"][b],
                    int(e["path_len"][b]), min_length)
            got = devemit.assemble_fragments(*args)
            want = jde.assemble_fragments(*args)
            assert [(r.range, r.seq) for r in got] == [
                (r.range, r.seq) for r in want
            ]
    assert emitted >= 5


def test_pick_equals_jax():
    """Ties: equal totals pick the minimum masked key; a tie with an
    uncertain key flags."""
    rng = np.random.default_rng(3)
    tot = rng.integers(-3, 3, (64, 9)).astype(np.float32) / 2
    keys = rng.integers(0, 6, (64, 9)).astype(np.int32)
    keys |= np.where(rng.random((64, 9)) < 0.2, 1 << 30, 0).astype(np.int32)
    valid = rng.random((64, 9)) < 0.8
    got = devemit._pick(*(torch.from_numpy(x) for x in (tot, keys, valid)))
    want = jax.jit(jde._pick)(tot, keys, valid)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
