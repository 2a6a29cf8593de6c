"""The port's device graph build (`ops/devbuild_torch.py`) on the CPU,
stage by stage and whole, held against the JAX package's
`ops/devbuild_jax.py` on the JAX CPU backend with exact equality of
every output array (flags and `flag_detail` included). Each stage gets
the JAX build's own inputs, so a difference points at one stage.

Caps: those of tests/test_devbuild_jax.py (`CAPS` and both parametrised
caps; the wide one has R = 1024 > 64, so `transitions_table` takes its
sort form there, and the read-bitmask form elsewhere), plus R = 48 for
the two-plane bitmask. The JAX outputs are computed once per caps by one
jitted program that returns every stage's outputs."""

import random

import jax
import numpy as np
import pytest
import torch

from pbdagcon_tpu.ops import devbuild as dbn
from pbdagcon_tpu.ops import devbuild_jax as dbj
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup
from pbdagcon_tpu_torch.convert import tree_to_torch
from pbdagcon_tpu_torch.ops import devbuild_torch as dbt


def _mk(seed, L=40, depth=6, noise=None):
    rng = random.Random(seed)
    bbs, alns = simulate_pileup(
        rng, "t", L, depth, noise or NoiseProfile(sub=0.05, ins=0.2, dele=0.1)
    )
    return dbn.encode_group(bbs, alns, sid="t")


def _encode(encs, caps):
    """Batched device inputs (the layout of tests/test_devbuild_jax.py)."""
    B = caps.B
    ops = np.zeros((B, caps.R, caps.C), dtype=np.uint8)
    starts = np.zeros((B, caps.R), dtype=np.int32)
    bb = np.zeros((B, caps.L), dtype=np.uint8)
    Lr = np.zeros(B, dtype=np.int32)
    ins = np.zeros((B, caps.R * caps.C), dtype=np.uint8)
    for b, e in enumerate(encs):
        R, C = e.ops.shape
        ops[b, :R, :C] = e.ops
        starts[b, :R] = e.starts
        bb[b, : len(e.backbone)] = e.backbone
        Lr[b] = len(e.backbone)
        ins[b, : len(e.ins_base)] = e.ins_base
    return ops, starts, bb, ins, Lr


def _encs_small():
    return [_mk(1), _mk(2, L=30, depth=4)]


def _encs_wide():
    return [
        _mk(101, L=50, depth=8), _mk(102, L=56, depth=10),
        _mk(103, L=20, depth=3),
        _mk(104, L=40, depth=6, noise=NoiseProfile(sub=0.02, ins=0.3, dele=0.15)),
    ]


CASES = {
    "caps": (
        dbj.Caps(B=2, R=12, C=96, L=48, CH=32, SM=8, NC=192, ND=256, SE=8,
                 DQ=8, V=256, W=16),
        _encs_small,
    ),
    "caps_w64": (
        dbj.Caps(B=4, R=12, C=120, L=56, CH=32, SM=8, NC=384, ND=256, SE=8,
                 DQ=8, V=320, W=64),
        _encs_wide,
    ),
    "caps_r1024": (
        dbj.Caps(B=4, R=1024, C=120, L=56, CH=32, SM=8, NC=8192, ND=256,
                 SE=8, DQ=8, V=320, W=64),
        _encs_wide,
    ),
}


def _fc(absb, B):
    return {
        "valid": absb["valid"].reshape(B, -1), "p": absb["p"], "t": absb["t"],
        "len": absb["len"], "rev_ba": absb["rev_ba"], "read": absb["read"],
        "phase": absb["phase"], "seq": absb["seq"],
    }


def _jax_stages(ops, starts, bb, ins, Lr, caps):
    dec = dbj.decode_columns(ops, starts, caps)
    cov, matches = dbj.coverage_and_matches(ops, starts, dec, caps)
    mtab = dbj.matched_positions(ops, dec, starts, Lr, caps)
    chains = dbj.extract_chains(ops, starts, ins, dec, mtab[0], Lr, caps)
    trans = dbj.transitions_table(dec, mtab, chains, starts, Lr, caps)
    absb = dbj.apply_absorption(chains, trans, bb, Lr, caps)
    fc = _fc(absb, caps.B)
    tri = dbj.build_tries(fc, Lr, caps)
    linz = dbj.linearize_and_band(tri, fc, absb, trans, cov, matches, bb, Lr, caps)
    out = dbj.assemble_band(linz, absb, trans, cov, matches, bb, Lr, caps)
    return dict(dec=dec, cov=cov, matches=matches, mtab=mtab, chains=chains,
                trans=trans, absb=absb, fc=fc, tri=tri, linz=linz, out=out)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jcaps, mk = CASES[request.param]
    inputs = _encode(mk(), jcaps)
    stages = jax.jit(_jax_stages, static_argnames=("caps",))(*inputs, jcaps)
    J = jax.tree_util.tree_map(np.asarray, stages)
    J["build"] = jax.tree_util.tree_map(
        np.asarray, dbj.device_build(*inputs, jcaps)
    )
    return {
        "J": J,
        "T": tree_to_torch(J, "cpu"),
        "inputs": inputs,
        "a": tree_to_torch(list(inputs), "cpu"),
        "caps": dbt.Caps(**jcaps.__dict__),
    }


def _same(got, want, path="out"):
    """Every array of `want` (a nested dict/tuple of numpy arrays) equal
    in shape and value to `got`'s; floats bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, w in enumerate(want):
            _same(got[i], w, f"{path}[{i}]")
        return
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == want.shape, (path, g.shape, want.shape)
    if want.dtype.kind == "f":
        assert g.dtype == want.dtype, path
        assert np.array_equal(g.view(np.int32), want.view(np.int32)), path
    else:
        assert g.dtype.kind in "biu" and np.array_equal(
            g.astype(np.int64), want.astype(np.int64)
        ), (path, np.argwhere(g != want)[:5].tolist())


STAGES = [
    "decode_columns", "coverage_and_matches", "matched_positions",
    "extract_chains", "transitions_table", "apply_absorption", "build_tries",
    "linearize_and_band", "assemble_band",
]


@pytest.mark.parametrize("stage", STAGES)
def test_stage_equals_jax(case, stage):
    J, T, c = case["J"], case["T"], case["caps"]
    ops, starts, bb, ins, Lr = case["a"]
    calls = {
        "decode_columns": lambda: (dbt.decode_columns(ops, starts, c), J["dec"]),
        "coverage_and_matches": lambda: (
            dbt.coverage_and_matches(ops, starts, T["dec"], c),
            (J["cov"], J["matches"]),
        ),
        "matched_positions": lambda: (
            dbt.matched_positions(ops, T["dec"], starts, Lr, c), J["mtab"]
        ),
        "extract_chains": lambda: (
            dbt.extract_chains(ops, starts, ins, T["dec"], T["mtab"][0], Lr, c),
            J["chains"],
        ),
        "transitions_table": lambda: (
            dbt.transitions_table(T["dec"], T["mtab"], T["chains"], starts, Lr, c),
            J["trans"],
        ),
        "apply_absorption": lambda: (
            dbt.apply_absorption(T["chains"], T["trans"], bb, Lr, c), J["absb"]
        ),
        "build_tries": lambda: (dbt.build_tries(T["fc"], Lr, c), J["tri"]),
        "linearize_and_band": lambda: (
            dbt.linearize_and_band(T["tri"], T["fc"], T["absb"], T["trans"],
                                   T["cov"], T["matches"], bb, Lr, c),
            J["linz"],
        ),
        "assemble_band": lambda: (
            dbt.assemble_band(T["linz"], T["absb"], T["trans"], T["cov"],
                              T["matches"], bb, Lr, c),
            J["out"],
        ),
    }
    got, want = calls[stage]()
    _same(got, want, stage)


def test_device_build_equals_jax(case):
    got = dbt.device_build(*case["a"], case["caps"])
    _same(got, case["J"]["build"])
    # the build must emit targets, not flag them all
    assert not case["J"]["build"]["flags"].all()


def test_device_build_packed_equals_unpacked(case):
    ops, starts, bb, ins, Lr = case["inputs"]
    B, R, C = ops.shape
    opsp = np.zeros((B, R, -(-C // 4)), np.uint8)
    for j in range(4):
        cols = ops[:, :, j::4]
        opsp[:, :, : cols.shape[2]] |= cols << (2 * j)
    unpacked = dbt.unpack_ops(torch.from_numpy(opsp))[:, :, :C]
    assert np.array_equal(unpacked.numpy(), ops)
    assert np.array_equal(
        unpacked.numpy(), np.asarray(dbj.unpack_ops(opsp))[:, :, :C]
    )
    if C % 4 == 0:
        got = dbt.device_build_packed(
            torch.from_numpy(opsp), *case["a"][1:], case["caps"]
        )
        _same(got, case["J"]["build"])


def test_transitions_two_plane_bitmask_equals_jax():
    """32 < R <= 64: the read bitmask rides two weighted-hist planes."""
    jcaps = dbj.Caps(B=2, R=48, C=96, L=48, CH=32, SM=8, NC=1536, ND=256,
                     SE=8, DQ=8, V=256, W=16)
    encs = [_mk(7, L=44, depth=40), _mk(8, L=36, depth=33)]
    ops, starts, bb, ins, Lr = _encode(encs, jcaps)

    def upto_trans(ops, starts, ins, Lr, caps):
        dec = dbj.decode_columns(ops, starts, caps)
        mtab = dbj.matched_positions(ops, dec, starts, Lr, caps)
        chains = dbj.extract_chains(ops, starts, ins, dec, mtab[0], Lr, caps)
        return dbj.transitions_table(dec, mtab, chains, starts, Lr, caps)

    want = jax.tree_util.tree_map(
        np.asarray,
        jax.jit(upto_trans, static_argnames=("caps",))(ops, starts, ins, Lr, jcaps),
    )
    c = dbt.Caps(**jcaps.__dict__)
    o, s, i, lr = (torch.from_numpy(x) for x in (ops, starts, ins, Lr))
    dec = dbt.decode_columns(o, s, c)
    mtab = dbt.matched_positions(o, dec, s, lr, c)
    chains = dbt.extract_chains(o, s, i, dec, mtab[0], lr, c)
    got = dbt.transitions_table(dec, mtab, chains, s, lr, c)
    _same(got, want, "trans")
    assert int(starts[:, 32:].max()) > 0  # reads past 32 took part
    assert (want["count_pq"] > 0).any()


def test_helpers_match_their_jax_forms():
    rng = np.random.default_rng(0)
    x = rng.integers(-50, 50, (3, 200)).astype(np.int32)
    f = rng.random((3, 200)) < 0.2
    got = dbt._seg_run_min(torch.from_numpy(x), torch.from_numpy(f))
    want = jax.jit(dbj._seg_run_min)(x, f)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = dbt._seg_hold_fwd(torch.from_numpy(x), torch.from_numpy(f))
    want = jax.jit(dbj._seg_hold_fwd)(x, f)
    assert np.array_equal(got.numpy(), np.asarray(want))
    m = np.array([0, 1, 8, -(1 << 31), 6, -4, 1 << 30], np.int32)
    want = [32, 0, 3, 31, 1, 2, 30]
    assert dbt._ctz32(torch.from_numpy(m)).tolist() == want
    k1 = rng.integers(0, 5, (2, 300)).astype(np.int32)
    k2 = rng.integers(0, 3, (2, 300)).astype(np.int32)
    pay = np.broadcast_to(np.arange(300, dtype=np.int32), (2, 300)).copy()
    got = dbt._sort(tuple(torch.from_numpy(a) for a in (k1, k2, pay)), 2)
    want = jax.jit(lambda *a: jax.lax.sort(a, dimension=-1, num_keys=2))(
        k1, k2, pay
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
