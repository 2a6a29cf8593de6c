"""The port's device aligner (`ops/align_tpu.py`, kernel X1's plain
versions on the CPU) against the JAX package's: the scan and the
traceback array-equal to the reference's XLA programs on the same
padded inputs, `align_batch` byte-equal to `align_pair`, the band-centre
rule past 2**31, and golden2 through `run_stream` with the device
aligner. All comparisons are exact. The same kernels on the card are in
tests/test_torch_cuda.py."""

import io
import os
import random
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbdagcon_tpu import native
from pbdagcon_tpu.aligner import align_pair as j_align_pair
from pbdagcon_tpu.ops import align_tpu as j_align
from pbdagcon_tpu.simulate import NoiseProfile, random_seq, sample_read
from pbdagcon_tpu_torch.aligner import align_pair
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.ops import align_tpu
from pbdagcon_tpu_torch.ops.align_tpu import align_batch
from pbdagcon_tpu_torch.pipeline import device_align_stream, run_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
PRE = os.path.join(DATA, "golden2.pre")
EXPECTED2 = open(os.path.join(DATA, "golden2.fa")).read()


def _noisy_pairs(seed, n, minlen=20, maxlen=250,
                 noise=NoiseProfile(sub=0.05, ins=0.12, dele=0.08)):
    rng = random.Random(seed)
    pairs = []
    for _ in range(n):
        t = random_seq(rng, rng.randint(minlen, maxlen))
        qstr, _ = sample_read(rng, t, 0, len(t), noise)
        pairs.append((qstr.replace("-", ""), t))
    return pairs


def _skewed_pairs(seed):
    rng = random.Random(seed)
    pairs = []
    for _ in range(3):
        t = random_seq(rng, 200)
        pairs.append((t[40:150], t))
        pairs.append((t, t[10:90]))
    return pairs


CASES = {
    "noisy": lambda: _noisy_pairs(1, 21),
    "mixed": lambda: _noisy_pairs(2, 6, minlen=5, maxlen=400)
    + [("A", "A"), ("A", "T"), ("AC", "ACGT")],
    "skew": lambda: _skewed_pairs(3),
    "identical": lambda: [("ACGTACGTAA", "ACGTACGTAA")] * 3,
}


def _padded(pairs):
    p = align_tpu.prepare_batch(pairs)
    return p, [p[k] for k in ("qb", "tb_pad", "m", "n", "bw")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_and_traceback_equal_the_jax_programs(case):
    p, arrs = _padded(CASES[case]())
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    want = np.asarray(j_align._align_scan(
        *(jnp.asarray(a) for a in arrs), M=M, Wa=Wa, dmin=dmin))
    got = align_tpu.align_scan_plain(
        *(torch.from_numpy(a) for a in arrs), M, Wa, dmin).numpy()
    assert got.dtype == np.uint8 and got.shape == (len(p["m"]), M, Wa // 4)
    np.testing.assert_array_equal(got, want)
    mv_want = np.asarray(j_align._traceback_scan(
        jnp.asarray(want), jnp.asarray(p["m"]), jnp.asarray(p["n"]),
        M=M, Wa=Wa, dmin=dmin, L=L))
    mv_got = align_tpu.traceback_plain(
        torch.from_numpy(got), torch.from_numpy(p["m"]),
        torch.from_numpy(p["n"]), M, Wa, dmin, L).numpy()
    np.testing.assert_array_equal(mv_got, mv_want)


def test_dispatch_runs_the_plain_versions_on_the_cpu():
    p, arrs = _padded(_noisy_pairs(4, 5))
    args = [torch.from_numpy(a) for a in arrs]
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_tpu.align_scan(*args, M, Wa, dmin)
    assert torch.equal(packed, align_tpu.align_scan_plain(*args, M, Wa, dmin))
    mv = align_tpu.traceback(packed, args[2], args[3], M, Wa, dmin, L)
    assert torch.equal(mv, align_tpu.traceback_plain(
        packed, args[2], args[3], M, Wa, dmin, L))


def test_prepare_batch_pads_as_the_reference():
    pairs = _noisy_pairs(5, 40, minlen=100, maxlen=700)
    p = align_tpu.prepare_batch(pairs)
    assert p["M"] % 256 == 0 and p["dmin"] % 64 == 0 and p["Wa"] % 128 == 0
    assert len(p["m"]) == 64 and p["B"] == 40
    assert p["tb_pad"].shape[1] >= p["M"] + p["Wa"]


def test_align_batch_matches_scalar():
    pairs = _noisy_pairs(1, 16)
    for (q, t), got in zip(pairs, align_batch(pairs, "cpu")):
        assert got == align_pair(q, t) == j_align_pair(q, t)


def test_align_batch_mixed_lengths_and_empties():
    pairs = _noisy_pairs(2, 6, minlen=5, maxlen=400)
    pairs += [("", "ACGT"), ("ACGT", ""), ("A", "A"), ("A", "T")]
    for (q, t), got in zip(pairs, align_batch(pairs, "cpu")):
        assert got == align_pair(q, t)


def test_align_batch_length_skew():
    pairs = _skewed_pairs(3)
    for (q, t), got in zip(pairs, align_batch(pairs, "cpu")):
        assert got == align_pair(q, t)


def test_align_batch_identical_sequences():
    for gq, gt in align_batch([("ACGTACGTAA", "ACGTACGTAA")] * 3, "cpu"):
        assert gq == gt == "ACGTACGTAA"


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_align_batch_fuzz_equals_the_jax_batch(seed):
    rng = random.Random(seed)
    noise = NoiseProfile(sub=rng.uniform(0, 0.1), ins=rng.uniform(0, 0.15),
                         dele=rng.uniform(0, 0.1))
    pairs = _noisy_pairs(seed, rng.randint(1, 40), 1, 300, noise)
    got = align_batch(pairs, "cpu")
    assert got == j_align.align_batch(pairs)
    assert got == [align_pair(q, t) for q, t in pairs]


def test_align_batch_no_pairs_and_only_empties():
    assert align_batch([], "cpu") == []
    assert align_batch([("", "AC"), ("G", "")], "cpu") == [
        ("--", "AC"), ("G", "-")]


def test_align_batch_refuses_an_absent_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        align_batch([("ACGT", "ACGT")], "cuda")


def test_band_centre_rule_past_2_31():
    """The port forms (i * n) // m in 64 bits, as align_pair does; the
    reference's device scan forms it in int32 and wraps there."""
    m = n = 46_341  # i * n first passes 2**31 - 1 at i = 46_341
    rows = np.array([1, 23_000, 46_340, 46_341], dtype=np.int64)
    want = (rows * n) // m  # align_pair's centres
    np.testing.assert_array_equal(align_tpu.band_centre(rows, n, m), want)
    got_t = align_tpu.band_centre(torch.from_numpy(rows), torch.tensor(n),
                                  torch.tensor(m))
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert int(want[-1]) == 46_341
    i32 = (jnp.asarray(rows, jnp.int32) * jnp.int32(n)) // jnp.int32(m)
    assert int(i32[-1]) != int(want[-1]) and int(i32[-2]) == int(want[-2])
    assert align_tpu.band_centre(5, 7, 0) == 0


def test_device_align_stream_rewrites_only_the_strings():
    with open(PRE) as f:
        lines = [l for l in f if l.strip()]
    out = list(device_align_stream(iter(lines), "pre", batch_records=7,
                                   device="cpu"))
    assert len(out) == len(lines)
    for raw, gapped in zip(lines, out):
        r, g = raw.split(), gapped.split()
        assert g[:5] == r[:5]
        assert (g[5], g[6]) == align_pair(r[5], r[6])
    with pytest.raises(ValueError):
        next(device_align_stream(iter(lines), "m5", device="cpu"))


@pytest.mark.parametrize("use_native", [True, False])
def test_golden2_with_the_device_aligner(use_native):
    if use_native and not native.available():
        pytest.skip("native library not built")
    out = io.StringIO()
    with open(PRE) as f:
        stats = run_stream(f, FastaWriter(out), DagconConfig(
            min_weight=5, min_length=80, fmt="pre", align=True,
            align_backend="device", backend="cuda", use_native=use_native,
            device="cpu",
        ))
    assert out.getvalue() == EXPECTED2
    assert stats.stage_s.get("align", 0.0) > 0.0


def test_device_aligner_needs_the_simple_scorer():
    with pytest.raises(ValueError, match="simple scorer"):
        DagconConfig(align_backend="device", align_scorer="affine")


def test_every_port_package_is_listed_in_pyproject():
    """A non-editable install ships only the listed packages."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    pkg = os.path.join(ROOT, "pbdagcon_tpu_torch")
    found = {
        os.path.relpath(d, ROOT).replace(os.sep, ".")
        for d, _, files in os.walk(pkg)
        if "__init__.py" in files
    }
    assert "pbdagcon_tpu_torch.oracle" in found
    assert found <= listed, sorted(found - listed)


def test_cli_takes_the_device_aligner(capsys):
    from pbdagcon_tpu_torch import cli

    assert cli.main([PRE, "--fmt", "pre", "-a", "--align-backend", "device",
                     "-c", "5", "-m", "80", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == EXPECTED2
