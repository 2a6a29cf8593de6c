"""The port's copies of the JAX package's framework-free modules against
their originals, on the golden inputs: the parsers and the gap
normalization, the stream reader, the simulator, the `-a` aligner, the
graph build and linearization with the host DP and backtrack, the
device build's encoder, the devbuild helpers, the self-check and the
native engine's bindings. The two packages' objects are different
classes, so each test compares fields and arrays."""

import dataclasses
import importlib
import io
import os
import random

import numpy as np
import pytest

from pbdagcon_tpu import aligner as j_aligner
from pbdagcon_tpu import alignment as j_alignment
from pbdagcon_tpu import devpipe as j_devpipe
from pbdagcon_tpu import io as j_io
from pbdagcon_tpu import native as j_native
from pbdagcon_tpu import oracle as j_oracle
from pbdagcon_tpu import selfcheck as j_selfcheck
from pbdagcon_tpu import simulate as j_simulate
from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.ops import devbuild as j_devbuild
from pbdagcon_tpu_torch import aligner as t_aligner
from pbdagcon_tpu_torch import alignment as t_alignment
from pbdagcon_tpu_torch import devpipe as t_devpipe
from pbdagcon_tpu_torch import io as t_io
from pbdagcon_tpu_torch import native as t_native
from pbdagcon_tpu_torch import oracle as t_oracle
from pbdagcon_tpu_torch import selfcheck as t_selfcheck
from pbdagcon_tpu_torch import simulate as t_simulate
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.ops import devbuild as t_devbuild

# `pbdagcon_tpu.ops` binds the name `linearize` to the function.
j_linearize = importlib.import_module("pbdagcon_tpu.ops.linearize")
t_linearize = importlib.import_module("pbdagcon_tpu_torch.ops.linearize")

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = (("golden1.m5", "m5"), ("golden2.pre", "pre"))


def _lines(name: str) -> list[str]:
    with open(os.path.join(DATA, name)) as f:
        return [line for line in f if line.strip()]


def _fields(obj) -> tuple:
    """A dataclass's fields as a tuple (arrays as bytes, dtype, shape)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            v = (v.dtype.str, v.shape, v.tobytes())
        out.append(v)
    return tuple(out)


def _groups(mod, name: str, fmt: str):
    with open(os.path.join(DATA, name)) as f:
        return [
            (g.sid, g.backbone, [_fields(a) for a in g.alns])
            for g in mod.read_groups(f, fmt)
        ]


@pytest.mark.parametrize("name,fmt", GOLDEN)
def test_parsers_and_normalize_gaps(name, fmt):
    parse_j = j_alignment.parse_m5 if fmt == "m5" else j_alignment.parse_pre
    parse_t = t_alignment.parse_m5 if fmt == "m5" else t_alignment.parse_pre
    for line in _lines(name):
        a, b = parse_j(line), parse_t(line)
        assert _fields(a) == _fields(b)
        assert a.empty == b.empty
        if len(a.qstr) == len(a.tstr):
            na, nb = j_alignment.normalize_gaps(a), t_alignment.normalize_gaps(b)
            assert _fields(na) == _fields(nb)
            for n in (0, 3, 50):
                assert _fields(j_alignment.trim_aln(a, n)) == _fields(
                    t_alignment.trim_aln(b, n)
                )


@pytest.mark.parametrize("name,fmt", GOLDEN)
def test_read_groups(name, fmt):
    assert _groups(j_io, name, fmt) == _groups(t_io, name, fmt)


@pytest.mark.parametrize("seed", [0, 7])
def test_simulate_targets_fixed_seed(seed):
    kw = dict(n_targets=3, backbone_len=300, coverage=12)
    sj = list(j_simulate.simulate_targets(seed, **kw))
    st = list(t_simulate.simulate_targets(seed, **kw))
    assert len(sj) == len(st) == 3
    for (tj, bj, aj), (tt, bt, at) in zip(sj, st):
        assert (tj, bj) == (tt, bt)
        assert [_fields(a) for a in aj] == [_fields(a) for a in at]
        rj, rt = random.Random(seed), random.Random(seed)
        assert [j_simulate.to_m5(a, flip=True, rng=rj) for a in aj] == [
            t_simulate.to_m5(a, flip=True, rng=rt) for a in at
        ]
        assert [j_simulate.to_pre_raw(a) for a in aj] == [
            t_simulate.to_pre_raw(a) for a in at
        ]


@pytest.mark.parametrize("scorer", ["simple", "affine"])
def test_align_record(scorer):
    _, _, alns = next(t_simulate.simulate_targets(5, 1, 150, 6))
    for a in alns:
        raw = t_simulate.to_pre_raw(a)
        rj = j_aligner.align_record(j_alignment.parse_pre(raw), scorer)
        rt = t_aligner.align_record(t_alignment.parse_pre(raw), scorer)
        assert _fields(rj) == _fields(rt)


def _lins(mod_io, mod_aligner, mod_lin, name, fmt):
    """Each golden target linearized by one package's modules ('pre'
    records are raw and take the `-a` aligner first)."""
    with open(os.path.join(DATA, name)) as f:
        groups = list(mod_io.read_groups(f, fmt))
    out = []
    for g in groups:
        alns = g.alns
        if fmt == "pre":
            alns = [mod_aligner.align_record(a) for a in alns]
        out.append(mod_lin.linearize(
            mod_lin.graph_from_group(g.backbone, alns), sid=g.sid
        ))
    return out


@pytest.mark.parametrize("name,fmt", GOLDEN)
def test_linearize_and_host_scores(name, fmt):
    lj = _lins(j_io, j_aligner, j_linearize, name, fmt)
    lt = _lins(t_io, t_aligner, t_linearize, name, fmt)
    assert len(lj) == len(lt) > 0
    for a, b in zip(lj, lt):
        assert _fields(a) == _fields(b)
        sa, sb = j_linearize.host_scores(a), t_linearize.host_scores(b)
        np.testing.assert_array_equal(sa.view(np.int32), sb.view(np.int32))
        pa, pb = j_linearize.backtrack(a, sa), t_linearize.backtrack(b, sb)
        assert pa == pb
        ca = j_linearize.consensus_from_path(a, pa, 6, 100)
        cb = t_linearize.consensus_from_path(b, pb, 6, 100)
        assert [_fields(c) for c in ca] == [_fields(c) for c in cb]


@pytest.mark.parametrize("name,fmt", GOLDEN)
def test_oracle_consensus_for_group(name, fmt):
    with open(os.path.join(DATA, name)) as f:
        groups = list(t_io.read_groups(f, fmt))
    for g in groups:
        alns = g.alns
        if fmt == "pre":
            alns = [t_aligner.align_record(a) for a in alns]
        cj = j_oracle.consensus_for_group(
            g.backbone, alns, JaxConfig(min_weight=6, min_length=100)
        )
        ct = t_oracle.consensus_for_group(
            g.backbone, alns, DagconConfig(min_weight=6, min_length=100)
        )
        assert [_fields(c) for c in cj] == [_fields(c) for c in ct]
        assert t_io.format_fasta(g.sid, ct) == j_io.format_fasta(g.sid, cj)


@pytest.mark.parametrize("trim", [0, 4])
def test_encode_group_and_chain_stats(trim):
    with open(os.path.join(DATA, "golden1.m5")) as f:
        groups = list(t_io.read_groups(f, "m5"))
    for g in groups:
        ej = j_devbuild.encode_group(g.backbone, g.alns, trim=trim, sid=g.sid)
        et = t_devbuild.encode_group(g.backbone, g.alns, trim=trim, sid=g.sid)
        assert _fields(ej) == _fields(et)
        assert j_devpipe.chain_stats(ej.ops, ej.starts) == (
            t_devpipe.chain_stats(et.ops, et.starts)
        )


def test_devbuild_constants_and_ladders():
    for k in ("OP_PAD", "OP_MATCH", "OP_DEL", "OP_INS", "MAX_ABSORB_ROUNDS",
              "KEY_UNCERTAIN", "KEY_MASK"):
        assert getattr(j_devbuild, k) == getattr(t_devbuild, k), k
    for k in ("_B_LADDER", "_R_LADDER", "_C_LADDER", "_L_LADDER",
              "_SM_LADDER", "_W_LADDER", "_CH_LADDER", "_ND_LADDER",
              "_DQ_LADDER", "_SE_LADDER"):
        assert getattr(j_devpipe, k) == getattr(t_devpipe, k), k
    for prof in ("compact", "heavy"):
        assert dataclasses.astuple(getattr(j_devpipe.DevCapsConfig, prof)()) == (
            dataclasses.astuple(getattr(t_devpipe.DevCapsConfig, prof)())
        )
    for x in (0, 1, 33, 128, 129, 10**6):
        assert j_devpipe._ladder(x, j_devpipe._W_LADDER) == (
            t_devpipe._ladder(x, t_devpipe._W_LADDER)
        )


def test_encode_groups_with_align():
    text = "".join(
        t_simulate.to_pre_raw(a) + "\n"
        for _, _, alns in t_simulate.simulate_targets(3, 2, 120, 5)
        for a in alns
    )
    gj = list(j_io.read_groups(io.StringIO(text), "pre"))
    gt = list(t_io.read_groups(io.StringIO(text), "pre"))
    ej = list(j_devpipe.encode_groups(gj, JaxConfig(fmt="pre", align=True)))
    et = list(t_devpipe.encode_groups(gt, DagconConfig(fmt="pre", align=True)))
    assert len(ej) == len(et) == 2
    for (_, a), (_, b) in zip(ej, et):
        assert _fields(a) == _fields(b)


@pytest.mark.parametrize("name,fmt", GOLDEN)
def test_selfcheck(name, fmt, capsys):
    with open(os.path.join(DATA, name)) as f:
        rj = j_selfcheck.run_selfcheck(
            f, JaxConfig(fmt=fmt, align=fmt == "pre", min_weight=6)
        )
    err_j = capsys.readouterr().err
    with open(os.path.join(DATA, name)) as f:
        rt = t_selfcheck.run_selfcheck(
            f, DagconConfig(fmt=fmt, align=fmt == "pre", min_weight=6)
        )
    err_t = capsys.readouterr().err
    assert (rj, err_j) == (rt, err_t)


@pytest.mark.parametrize("name,fmt", GOLDEN)
def test_native_engine_bindings(name, fmt):
    if not t_native.available():
        pytest.skip("native library not built")
    with open(os.path.join(DATA, name), "rb") as f:
        text = f.read()
    outs = []
    for mod in (j_native, t_native):
        with mod.NativeEngine(min_weight=6, min_length=100, threads=2) as e:
            cns = e.consensus_text(text, fmt=fmt)
        with mod.NativeEngine(min_weight=6, min_length=100, threads=2) as e:
            n = e.linearize_text(text, fmt=fmt)
            metas = e.metas(n)
            sids = [e.target_sid(i) for i in range(n)]
            scores = [e.target_scores(i, int(metas[i, 0])) for i in range(n)]
            longs = [e.long_counts(i, (16, 32, 64)) for i in range(n)]
            emitted = [e.target_consensus(i, s) for i, s in enumerate(scores)]
            status = e.status()
        with mod.NativeEngine(min_weight=6, min_length=100, threads=2) as e:
            ne = e.encode_text(text, fmt=fmt)
            enc = (e.enc_metas(ne), [e.enc_sid(i) for i in range(ne)],
                   [e.enc_consensus(i) for i in range(ne)])
        outs.append((
            cns, n, metas.tobytes(), sids,
            [s.tobytes() for s in scores], [x.tobytes() for x in longs],
            emitted, status, ne, enc[0].tobytes(), enc[1], enc[2],
        ))
    assert outs[0] == outs[1]


def _m4_text(seed: int) -> tuple[str, dict[str, str]]:
    rng = random.Random(seed)
    reads = {f"r{i}": t_simulate.random_seq(rng, rng.randint(50, 200))
             for i in range(12)}
    lines = []
    for _ in range(40):
        q, t = rng.sample(sorted(reads), 2)
        qs = rng.randint(0, 20)
        ts = rng.randint(0, 20)
        lines.append(
            f"{q} {t} {rng.randint(-900, -10)} 90.0 0 {qs} "
            f"{len(reads[q]) - rng.randint(0, 20)} {len(reads[q])} "
            f"{rng.randint(0, 1)} {ts} {len(reads[t]) - rng.randint(0, 20)} "
            f"{len(reads[t])} 254"
        )
    return "\n".join(lines) + "\n", reads


@pytest.mark.parametrize("seed", [0, 1])
def test_hgap_copy(seed):
    from pbdagcon_tpu import hgap as j_hgap
    from pbdagcon_tpu_torch import hgap as t_hgap

    text, reads = _m4_text(seed)
    rj = list(j_hgap.parse_m4_stream(io.StringIO(text)))
    rt = list(t_hgap.parse_m4_stream(io.StringIO(text)))
    assert [_fields(a) for a in rj] == [_fields(b) for b in rt]
    for bestn in (1, 3):
        assert [_fields(a) for a in j_hgap.filter_m4(rj, bestn)] == [
            _fields(b) for b in t_hgap.filter_m4(rt, bestn)]
    assert j_hgap.m4_to_pre(rj, reads) == t_hgap.m4_to_pre(rt, reads)
    fa = "".join(f">{k} x\n{v[:30]}\n{v[30:]}\n" for k, v in reads.items())
    assert j_hgap.read_fasta(io.StringIO(fa)) == t_hgap.read_fasta(
        io.StringIO(fa)) == reads


def test_dazzio_copy(tmp_path):
    from pbdagcon_tpu import dazzio as j_dz
    from pbdagcon_tpu_torch import dazzio as t_dz

    if not t_native.available():
        pytest.skip("native library not built")
    rng = random.Random(3)
    seqs = [t_simulate.random_seq(rng, n) for n in (1, 40, 333, 1000)]
    ovls = [t_dz.Overlap(0, 1, False, 0, 250, 3, 259, 9,
                         trace=((4, 98), (3, 101), (2, 60))),
            t_dz.Overlap(2, 3, True, 10, 90, 0, 82, 7, trace=((5, 82),))]
    for mod, tag in ((j_dz, "j"), (t_dz, "t")):
        mod.write_dazz_db(str(tmp_path / f"{tag}.db"), seqs)
        mod.write_las(str(tmp_path / f"{tag}.las"),
                      [mod.Overlap(*dataclasses.astuple(o)) for o in ovls])
    for suffix in (".db", ".las"):
        with open(tmp_path / f"j{suffix}", "rb") as a, open(
                tmp_path / f"t{suffix}", "rb") as b:
            assert a.read() == b.read()
    for d in (".j.idx", ".j.bps"):
        assert (tmp_path / d).read_bytes() == (
            tmp_path / d.replace(".j.", ".t.")).read_bytes()
    with j_dz.DazzDb(str(tmp_path / "t.db")) as dj, t_dz.DazzDb(
            str(tmp_path / "j.db")) as dt:
        assert [dj.read(i) for i in range(len(dj))] == [
            dt.read(i) for i in range(len(dt))] == seqs
    for tr in (False, True):
        got = t_dz.read_las(str(tmp_path / "j.las"), with_traces=tr)
        want = j_dz.read_las(str(tmp_path / "t.las"), with_traces=tr)
        assert [_fields(o) for o in got] == [_fields(o) for o in want]
    assert t_dz.las_tspace(str(tmp_path / "j.las")) == j_dz.las_tspace(
        str(tmp_path / "t.las"))
    qs, ts = t_aligner.align_pair(seqs[2][5:300], seqs[2])
    assert t_dz.traces_from_alignment(qs, ts, 0, 100) == (
        j_dz.traces_from_alignment(qs, ts, 0, 100))


def test_hybrid_helpers_copy():
    from pbdagcon_tpu import hybrid as j_hy
    from pbdagcon_tpu_torch import hybrid as t_hy

    lines = []
    for _, _, alns in t_simulate.simulate_targets(4, 7, 80, 4):
        lines += [t_simulate.to_m5(a) for a in alns]
    text = "\n".join(lines) + "\n"
    for n in (1, 2, 5):
        assert list(j_hy.iter_group_chunks(io.StringIO(text), "m5", n)) == (
            list(t_hy.iter_group_chunks(io.StringIO(text), "m5", n)))
    for cb, ramp in ((512, True), (2048, False), (1 << 20, True)):
        assert list(j_hy.iter_group_chunks_blocks(
            io.StringIO(text), "m5", cb, ramp)) == list(
            t_hy.iter_group_chunks_blocks(io.StringIO(text), "m5", cb, ramp))
    data = text.encode()
    assert j_hy._last_group_cut(data, "m5") == t_hy._last_group_cut(data, "m5")
    assert j_hy._sid_of_line(lines[0], "m5") == t_hy._sid_of_line(lines[0], "m5")
    rng = random.Random(9)
    for _ in range(300):
        sizes = [rng.randint(1, 500) for _ in range(rng.randint(0, 6))]
        h = rng.choice([None, 1e-6, 1e-5])
        d = rng.choice([None, 1e-7, 1e-5, 1e-4])
        done = rng.random() < 0.5
        beta = rng.choice([4.0, 20.0])
        assert j_hy.dev_should_pull(sizes, h, d, done, 1.2, beta) == (
            t_hy.dev_should_pull(sizes, h, d, done, 1.2, beta))


def test_blocked_solve_constants_copy():
    """The blocked solve's constants, block length and int32 bound are
    the reference's (`pbdagcon_tpu/ops/dp_blocked.py`, `ops/dp.py`)."""
    from pbdagcon_tpu.ops import dp as j_dp
    from pbdagcon_tpu.ops import dp_blocked as j_bl
    from pbdagcon_tpu_torch.ops import dp_blocked as t_bl

    for name in ("SENT", "_REAL_MIN", "_F32_LIMIT", "_PENALTY2"):
        assert int(getattr(j_bl, name)) == getattr(t_bl, name), name
    for v in (64, 128, 8128, 8192, 8256, 16384, 34816):
        assert j_dp._blocked_L(v) == t_bl._blocked_L(v)
        for esc in (10.0, 760.0, 8192.0, 20000.0):
            assert j_bl.blocked_safe(esc, v) == t_bl.blocked_safe(esc, v)


def test_scheduler_copy():
    """`_bucket_of`, `BucketScheduler`, `Prefetcher` and the explicit
    `shard_for_host` split are the reference's
    (`pbdagcon_tpu/parallel/scheduler.py`) on the same inputs."""
    from pbdagcon_tpu.parallel import scheduler as j_sc
    from pbdagcon_tpu_torch.parallel import scheduler as t_sc

    ladder = (256, 512, 1024)
    for x in (0, 1, 255, 256, 257, 1024, 1025):
        assert j_sc._bucket_of(x, ladder) == t_sc._bucket_of(x, ladder)
    for h, n in ((0, 1), (1, 3), (2, 3), (4, 5)):
        assert list(j_sc.shard_for_host(range(23), h, n)) == list(
            t_sc.shard_for_host(range(23), h, n))
    lins = [t_linearize.linearize(t_oracle.graph.AlnGraph(g.backbone), sid=g.sid)
            for g in t_io.read_groups(open(os.path.join(DATA, "golden1.m5")),
                                      "m5")]
    ns = [17, 300, 600, 2000, 40, 512, 513, 90]
    lins = [dataclasses.replace(lins[0], n=n) for n in ns]

    def batches(mod):
        sched = mod.BucketScheduler(v_buckets=(256, 512), batch_targets=2)
        out = [sched.add(i, lin) for i, lin in enumerate(lins)]
        out += list(sched.drain())
        return [None if o is None else (o[0], [i for i, _l in o[1]])
                for o in out]

    assert batches(j_sc) == batches(t_sc)
    for mod in (j_sc, t_sc):
        assert list(mod.Prefetcher(lambda: iter(range(7)), depth=1)) == list(
            range(7))
