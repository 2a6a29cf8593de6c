"""The port's frontends on the CPU: hgap (`hgap.py`), the DAZZ_DB/.las
reader (`dazzio.py`) and dazcon (`dazcon.py`, with `device="cpu"`: the
aligner's and the DP's plain PyTorch versions). The reference's tests of
each (tests/test_hgap.py, tests/test_dazzdb.py, tests/test_dazcon.py,
tests/test_frontend_clis.py, and the trace-guided CLI parity of
tests/test_trace_guided.py) run here against the port's modules, and
the port's outputs are held byte for byte against the JAX package's
functions on the same inputs."""

import io as _io
import os
import random
import subprocess
import sys

import pytest

from pbdagcon_tpu import dazcon as j_dazcon
from pbdagcon_tpu import hgap as j_hgap
from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.alignment import revcomp
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.dazcon import (
    consensus_one_target,
    run_dazcon,
    select_hits,
)
from pbdagcon_tpu_torch.dazzio import Overlap, traces_from_alignment
from pbdagcon_tpu_torch.hgap import (
    filter_m4,
    m4_to_pre,
    parse_m4,
    read_fasta,
    run_hgap,
)
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.pipeline import PipelineStats, run_stream
from pbdagcon_tpu_torch.simulate import (
    NoiseProfile,
    random_seq,
    sample_read,
    simulate_pileup,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {"PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def _pileup_m4(seed, n_targets=3, tlen=300, cov=12):
    """Targets, their noisy reads and the M4 hits of reads on targets
    (forward and reverse strand)."""
    rng = random.Random(seed)
    targets = {f"t{i}": random_seq(rng, tlen) for i in range(n_targets)}
    reads = dict(targets)
    lines = []
    noise = NoiseProfile(sub=0.02, ins=0.06, dele=0.04)
    for tname, tseq in targets.items():
        for j in range(cov):
            qstr, _ = sample_read(rng, tseq, 0, len(tseq), noise)
            q = qstr.replace("-", "")
            rev = j % 3 == 0
            reads[f"{tname}_r{j}"] = revcomp(q) if rev else q
            lines.append(
                f"{tname}_r{j} {tname} {-5 * len(q) + j} 90.0 "
                f"{1 if rev else 0} 0 {len(q)} {len(q)} 0 0 {len(tseq)} "
                f"{len(tseq)} 254"
            )
    return targets, reads, "\n".join(lines) + "\n"


def test_run_hgap_equals_the_jax_function():
    _t, reads, m4 = _pileup_m4(3)
    for bestn in (1, 4):
        assert run_hgap(_io.StringIO(m4), reads, bestn=bestn) == (
            j_hgap.run_hgap(_io.StringIO(m4), reads, bestn=bestn)
        )


@pytest.mark.parametrize("policy", ["score", "length", "input", "span"])
def test_dazcon_equals_the_jax_run_dazcon(policy):
    _t, reads, m4 = _pileup_m4(5)
    want = _io.StringIO()
    nj = j_dazcon.run_dazcon(_io.StringIO(m4), reads, want, min_weight=4,
                             min_length=100, max_hits=10, hit_policy=policy,
                             batch_targets=2)
    got = _io.StringIO()
    stats = PipelineStats()
    nt = run_dazcon(_io.StringIO(m4), reads, got, min_weight=4,
                    min_length=100, max_hits=10, hit_policy=policy,
                    batch_targets=2, device="cpu", stats=stats)
    assert got.getvalue() == want.getvalue() and nt == nj == 3
    assert stats.targets == 3 and stats.batches == 2
    assert stats.host_fallbacks == 0


def test_dazcon_counts_targets_past_the_v_ladder(monkeypatch):
    from pbdagcon_tpu_torch import dazcon

    _t, reads, m4 = _pileup_m4(6, n_targets=2)
    want = _io.StringIO()
    run_dazcon(_io.StringIO(m4), reads, want, min_weight=4,
               min_length=100, device="cpu")
    monkeypatch.setattr(dazcon, "V_LADDER", (8,))
    got = _io.StringIO()
    stats = PipelineStats()
    run_dazcon(_io.StringIO(m4), reads, got, min_weight=4, min_length=100,
               device="cpu", stats=stats)
    assert got.getvalue() == want.getvalue()
    assert stats.fallback_reasons == {"oversize": 2} and stats.batches == 0


def test_consensus_one_target_equals_the_jax_function():
    targets, reads, m4 = _pileup_m4(7, n_targets=1)
    hits = select_hits(j_hgap.parse_m4_stream(_io.StringIO(m4)))["t0"]
    port_hits = select_hits(parse_m4(l) for l in m4.splitlines())["t0"]
    want = j_dazcon.consensus_one_target("t0", targets["t0"], hits, reads, 4)
    got = consensus_one_target("t0", targets["t0"], port_hits, reads, 4,
                               device="cpu")
    assert got == want and len(got) > 250


def test_dazcon_refuses_an_absent_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _t, reads, m4 = _pileup_m4(8, n_targets=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_dazcon(_io.StringIO(m4), reads, _io.StringIO(), device="cuda")


def test_entry_points_run_as_modules(tmp_path):
    _t, reads, m4 = _pileup_m4(9, n_targets=2)
    (tmp_path / "ovl.m4").write_text(m4)
    (tmp_path / "reads.fa").write_text(
        "".join(f">{k}\n{v}\n" for k, v in reads.items()))
    r = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu_torch.hgap",
         str(tmp_path / "ovl.m4"), str(tmp_path / "reads.fa")],
        capture_output=True, text=True, env=_ENV, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout == j_hgap.run_hgap(_io.StringIO(m4), reads)


def _mk_m4(q, t, score, qs=0, qe=None, qlen=None, ts=0, te=None, tlen=None,
           tstrand=0):
    qlen = qlen if qlen is not None else qe
    tlen = tlen if tlen is not None else te
    return f"{q} {t} {score} 99.0 0 {qs} {qe} {qlen} {tstrand} {ts} {te} {tlen} 254"


def test_parse_m4():
    r = parse_m4(_mk_m4("q1", "t1", -900, qs=0, qe=100, ts=5, te=105,
                        tlen=200))
    assert r.qname == "q1" and r.tname == "t1"
    assert r.score == -900 and r.tstart == 5 and r.tend == 105
    assert r.tlen == 200


def test_filter_m4_best_per_query():
    recs = [
        parse_m4(_mk_m4("q1", "t1", -500, qe=100, te=100)),
        parse_m4(_mk_m4("q1", "t2", -900, qe=100, te=100)),  # better
        parse_m4(_mk_m4("q2", "q2", -999, qe=100, te=100)),  # self-hit
        parse_m4(_mk_m4("q2", "t1", -100, qe=100, te=100)),
    ]
    out = filter_m4(recs, bestn=1)
    assert [(r.qname, r.tname) for r in out] == [("q1", "t2"), ("q2", "t1")]
    out2 = filter_m4(recs, bestn=2)
    assert [(r.qname, r.tname) for r in out2] == [
        ("q1", "t1"), ("q1", "t2"), ("q2", "t1"),
    ]


def test_read_fasta():
    fa = ">r1 extra stuff\nACGT\nACGT\n>r2\nTTTT\n"
    seqs = read_fasta(_io.StringIO(fa))
    assert seqs == {"r1": "ACGTACGT", "r2": "TTTT"}


def test_m4_to_pre_orientation():
    reads = {"q": "AACCGGTT", "t": "ACGTACGTACGT"}
    fwd = parse_m4(_mk_m4("q", "t", -10, qs=0, qe=8, ts=2, te=10, tlen=12))
    (line,) = m4_to_pre([fwd], reads)
    f = line.split()
    assert f[:5] == ["q", "t", "3", "10", "12"]
    assert f[5] == "AACCGGTT"
    assert f[6] == reads["t"][2:10]
    # Reverse-strand hit: query revcomped, target coords flipped forward.
    rev = parse_m4(_mk_m4("q", "t", -10, qs=0, qe=8, ts=2, te=10, tlen=12,
                          tstrand=1))
    (line,) = m4_to_pre([rev], reads)
    f = line.split()
    assert f[5] == revcomp("AACCGGTT")
    assert f[:5] == ["q", "t", "3", "10", "12"]


def test_full_hgap_flow_produces_consensus():
    """Overlaps + reads -> pre -> -a consensus reproduces each target."""
    rng = random.Random(31)
    targets = {f"t{i}": random_seq(rng, 300) for i in range(2)}
    reads: dict[str, str] = dict(targets)
    m4_lines = []
    noise = NoiseProfile(sub=0.01, ins=0.05, dele=0.03)
    for tname, tseq in targets.items():
        for j in range(12):
            qstr, tstr = sample_read(rng, tseq, 0, len(tseq), noise)
            qseq = qstr.replace("-", "")
            qname = f"{tname}_r{j}"
            reads[qname] = qseq
            m4_lines.append(
                _mk_m4(qname, tname, -5 * len(qseq), qs=0, qe=len(qseq),
                       ts=0, te=len(tseq), tlen=len(tseq))
            )
    pre_text = run_hgap(_io.StringIO("\n".join(m4_lines) + "\n"), reads,
                        bestn=20)
    cfg = DagconConfig(
        min_weight=4, min_length=50, fmt="pre", align=True, backend="cuda",
        align_backend="device", device="cpu",
    )
    out = _io.StringIO()
    stats = run_stream(_io.StringIO(pre_text), FastaWriter(out), cfg)
    assert stats.targets == 2
    fasta = out.getvalue()
    # Low noise + -a realignment: consensus must equal each backbone.
    seqs = {}
    cur = None
    for line in fasta.splitlines():
        if line.startswith(">"):
            cur = line[1:].split("/")[0]
        else:
            seqs[cur] = seqs.get(cur, "") + line
    for tname, tseq in targets.items():
        assert seqs[tname] == tseq, f"consensus != backbone for {tname}"


def _mk_db(tmp_path, seqs):
    from pbdagcon_tpu_torch.dazzio import write_dazz_db

    path = str(tmp_path / "fix.db")
    write_dazz_db(path, seqs)
    return path


@needs_native
def test_db_roundtrip(tmp_path):
    from pbdagcon_tpu_torch.dazzio import DazzDb

    rng = random.Random(5)
    seqs = [random_seq(rng, n) for n in (1, 3, 4, 5, 77, 1003)]
    path = _mk_db(tmp_path, seqs)
    with DazzDb(path) as db:
        assert len(db) == len(seqs)
        for i, s in enumerate(seqs):
            assert db.read(i) == s


@needs_native
def test_las_roundtrip(tmp_path):
    from pbdagcon_tpu_torch.dazzio import Overlap, read_las, write_las

    ovls = [
        Overlap(0, 1, False, 10, 90, 0, 82, 7),
        Overlap(0, 2, True, 0, 100, 5, 103, 11),
        Overlap(3, 1, False, 40, 70, 12, 41, 2),
    ]
    path = str(tmp_path / "fix.las")
    write_las(path, ovls)
    assert read_las(path) == ovls


@needs_native
def test_dazcon_container_frontend(tmp_path):
    """tpu-dazcon db.db ovl.las == the FASTA+M4 path on the same data."""
    from pbdagcon_tpu_torch.dazzio import Overlap, write_las
    from pbdagcon_tpu_torch.simulate import NoiseProfile, simulate_pileup

    rng = random.Random(99)
    bb, alns = simulate_pileup(rng, "0", 400, 12, NoiseProfile())
    seqs = [bb]
    ovls = []
    m4_lines = []
    for i, a in enumerate(alns, start=1):
        q = a.qstr.replace("-", "")
        comp = i % 3 == 0
        seqs.append(revcomp(q) if comp else q)
        ovls.append(
            Overlap(0, i, comp, a.start - 1, a.end, 0, len(q), 5)
        )
        m4_lines.append(
            f"{i} 0 5 90.0 {1 if comp else 0} 0 {len(q)} {len(q)} "
            f"0 {a.start - 1} {a.end} {len(bb)}"
        )
    db = _mk_db(tmp_path, seqs)
    las = str(tmp_path / "ovl.las")
    write_las(las, ovls)
    fasta = tmp_path / "reads.fa"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{i}\n{s}\n")
    m4 = tmp_path / "ovl.m4"
    with open(m4, "w") as f:
        f.write("\n".join(m4_lines) + "\n")

    env = _ENV
    r1 = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu_torch.dazcon", las, db,
         "-c", "2", "-m", "50", "--device", "cpu"],
        capture_output=True, text=True, env=env,
    )
    assert r1.returncode == 0, r1.stderr
    r2 = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu_torch.dazcon", str(m4),
         str(fasta), "-c", "2", "-m", "50", "--device", "cpu"],
        capture_output=True, text=True, env=env,
    )
    assert r2.returncode == 0, r2.stderr
    assert r1.stdout == r2.stdout
    assert r1.stdout.startswith(">0\n")


@needs_native
def test_las_trace_roundtrip_u8(tmp_path):
    """Trace-point decoding (align.c capability): u8 traces round-trip
    through write_las/read_las at tspace <= 125."""
    from pbdagcon_tpu_torch.dazzio import Overlap, las_tspace, read_las, write_las

    ovls = [
        Overlap(0, 1, False, 0, 250, 3, 259, 9,
                trace=((4, 98), (3, 101), (2, 55))),
        Overlap(0, 2, True, 100, 180, 0, 83, 4, trace=((4, 83),)),
        Overlap(1, 2, False, 5, 20, 1, 17, 0, trace=()),
    ]
    path = str(tmp_path / "t8.las")
    write_las(path, ovls, tspace=100)
    assert las_tspace(path) == 100
    got = read_las(path, with_traces=True)
    assert [o.trace for o in got] == [o.trace for o in ovls]
    assert [(o.aread, o.bread, o.diffs) for o in got] == [
        (o.aread, o.bread, o.diffs) for o in ovls
    ]
    # default read skips traces but must still parse records correctly
    plain = read_las(path)
    assert [(o.abpos, o.aepos) for o in plain] == [
        (o.abpos, o.aepos) for o in ovls
    ]


@needs_native
def test_las_trace_roundtrip_u16(tmp_path):
    """u16 traces (tspace > 125) with values beyond the u8 range."""
    from pbdagcon_tpu_torch.dazzio import Overlap, las_tspace, read_las, write_las

    ovls = [
        Overlap(2, 7, True, 0, 3000, 0, 3100, 40,
                trace=((30, 1020), (17, 995), (25, 1085))),
    ]
    path = str(tmp_path / "t16.las")
    write_las(path, ovls, tspace=1000)
    assert las_tspace(path) == 1000
    got = read_las(path, with_traces=True)
    assert got[0].trace == ovls[0].trace


@needs_native
class TestQvStreams:
    """Round-trip of the .qvs QV-stream codec (QV.{h,c} capability,
    SURVEY.md §2 C9): write_dazz_qvs -> native dazz_qv_open/load."""

    def _mk(self, tmp_path, seqs, rng, skew=False):
        from pbdagcon_tpu_torch.dazzio import (
            QV_TRACKS, DazzQv, write_dazz_db, write_dazz_qvs,
        )

        db = str(tmp_path / "qvfix.db")
        write_dazz_db(db, seqs)
        tracks = []
        for s in seqs:
            per = []
            for t in range(5):
                if skew and t == 0:
                    # heavily skewed histogram (one dominant symbol)
                    vals = rng.choice(
                        [7, 40, 41, 42], size=len(s),
                        p=[0.97, 0.01, 0.01, 0.01],
                    )
                elif t == 1:
                    vals = rng.integers(65, 69, size=len(s))  # tag bases
                else:
                    vals = rng.integers(0, 94, size=len(s))
                per.append(bytes(int(v) for v in vals))
            tracks.append(tuple(per))
        write_dazz_qvs(db, tracks)
        return db, tracks

    def test_roundtrip(self, tmp_path):
        import numpy as np

        from pbdagcon_tpu_torch.dazzio import QV_TRACKS, DazzQv

        rng = np.random.default_rng(7)
        seqs = ["ACGT" * 30, "A" * 17, "GATTACA" * 9]
        db, tracks = self._mk(tmp_path, seqs, rng)
        with DazzQv(db) as qv:
            for i, s in enumerate(seqs):
                got = qv.load(i, len(s))
                for t, name in enumerate(QV_TRACKS):
                    assert got[name] == tracks[i][t], (i, name)

    def test_roundtrip_skewed_and_single_symbol(self, tmp_path):
        import numpy as np

        from pbdagcon_tpu_torch.dazzio import QV_TRACKS, DazzQv

        rng = np.random.default_rng(11)
        seqs = ["ACGTTGCA" * 16, "C" * 5]
        db, tracks = self._mk(tmp_path, seqs, rng, skew=True)
        # overwrite track 4 with a single-symbol stream everywhere
        from pbdagcon_tpu_torch.dazzio import write_dazz_qvs

        tracks = [
            (tr[0], tr[1], tr[2], tr[3], bytes([33]) * len(s))
            for tr, s in zip(tracks, seqs)
        ]
        write_dazz_qvs(db, tracks)
        with DazzQv(db) as qv:
            for i, s in enumerate(seqs):
                got = qv.load(i, len(s))
                for t, name in enumerate(QV_TRACKS):
                    assert got[name] == tracks[i][t], (i, name)

    def test_empty_read_and_missing_qvs(self, tmp_path):
        import numpy as np
        import pytest

        from pbdagcon_tpu_torch.dazzio import DazzQv, write_dazz_db

        rng = np.random.default_rng(3)
        seqs = ["ACG", ""]
        db, tracks = self._mk(tmp_path, seqs, rng)
        with DazzQv(db) as qv:
            assert qv.load(1, 0) == {k: b"" for k in (
                "delQV", "delTag", "insQV", "mergeQV", "subQV")}
        other = str(tmp_path / "noqv.db")
        write_dazz_db(other, ["ACGT"])
        with pytest.raises(OSError):
            DazzQv(other)


@needs_native
class TestHostileContainers:
    """Corrupt/truncated/foreign container files must fail the open (or
    the load) with a clean OSError — never crash or return garbage
    (VERDICT r2 #8; ref DB.c::Open_DB error paths, SURVEY.md §2 C9)."""

    def _paths(self, tmp_path, name="fix.db"):
        import os

        db = str(tmp_path / name)
        d = os.path.dirname(db)
        root = os.path.basename(db)[: -len(".db")]
        return db, os.path.join(d, f".{root}.idx"), os.path.join(
            d, f".{root}.bps"
        )

    def _fresh(self, tmp_path, name):
        import random as _r

        from pbdagcon_tpu_torch.dazzio import write_dazz_db

        rng = _r.Random(17)
        db, idx, bps = self._paths(tmp_path, name)
        write_dazz_db(db, [random_seq(rng, n) for n in (40, 80, 160)])
        return db, idx, bps

    def test_truncated_idx(self, tmp_path):
        import pytest

        from pbdagcon_tpu_torch.dazzio import DazzDb

        db, idx, _ = self._fresh(tmp_path, "t1.db")
        data = open(idx, "rb").read()
        for cut in (0, 60, len(data) - 7):
            with open(idx, "wb") as f:
                f.write(data[:cut])
            with pytest.raises(OSError):
                DazzDb(db)

    def test_truncated_bps(self, tmp_path):
        import pytest

        from pbdagcon_tpu_torch.dazzio import DazzDb

        db, _, bps = self._fresh(tmp_path, "t2.db")
        data = open(bps, "rb").read()
        with open(bps, "wb") as f:
            f.write(data[: len(data) // 2])
        with pytest.raises(OSError):
            DazzDb(db)

    def test_bitflipped_boff_and_rlen(self, tmp_path):
        import struct

        import pytest

        from pbdagcon_tpu_torch.dazzio import DazzDb

        # Huge boff on read 1 -> points past .bps -> clean open failure.
        db, idx, _ = self._fresh(tmp_path, "t3.db")
        data = bytearray(open(idx, "rb").read())
        off = 112 + 1 * 40 + 16  # read 1's boff field
        data[off : off + 8] = struct.pack("<q", 1 << 40)
        open(idx, "wb").write(bytes(data))
        with pytest.raises(OSError):
            DazzDb(db)
        # Negative rlen on read 0.
        db, idx, _ = self._fresh(tmp_path, "t4.db")
        data = bytearray(open(idx, "rb").read())
        data[112 + 4 : 112 + 8] = struct.pack("<i", -5)
        open(idx, "wb").write(bytes(data))
        with pytest.raises(OSError):
            DazzDb(db)

    def test_foreign_idx_header(self, tmp_path):
        import pytest

        from pbdagcon_tpu_torch.dazzio import DazzDb

        db, idx, bps = self._paths(tmp_path, "t5.db")
        open(idx, "wb").write(b"\xff" * 200)  # ureads = huge/negative
        open(bps, "wb").write(b"\x00" * 10)
        with pytest.raises(OSError):
            DazzDb(db)

    def test_truncated_and_foreign_las(self, tmp_path):
        import struct

        import pytest

        from pbdagcon_tpu_torch.dazzio import Overlap, read_las, write_las

        path = str(tmp_path / "t.las")
        ovls = [
            Overlap(0, 1, False, 10, 90, 0, 82, 7,
                    trace=((3, 50), (4, 40)))
        ]
        write_las(path, ovls, tspace=100)
        data = open(path, "rb").read()
        # Truncate mid-record and mid-trace.
        for cut in (8, 20, len(data) - 1):
            open(path, "wb").write(data[:cut])
            with pytest.raises(OSError):
                read_las(path)
        # novl beyond what the file can hold.
        bad = bytearray(data)
        bad[0:8] = struct.pack("<q", 1 << 30)
        open(path, "wb").write(bytes(bad))
        with pytest.raises(OSError):
            read_las(path)
        # Negative tspace.
        bad = bytearray(data)
        bad[8:12] = struct.pack("<i", -1)
        open(path, "wb").write(bytes(bad))
        with pytest.raises(OSError):
            read_las(path)

    def test_corrupt_qvs(self, tmp_path):
        import os
        import random as _r

        import numpy as np
        import pytest

        from pbdagcon_tpu_torch.dazzio import (
            QV_TRACKS, DazzQv, write_dazz_db, write_dazz_qvs,
        )

        rng = np.random.default_rng(4)
        db = str(tmp_path / "q.db")
        seqs = ["ACGTACGTAA", "GGTTAACC"]
        write_dazz_db(db, seqs)
        tracks = [
            tuple(
                bytes(rng.integers(0, 50, size=len(s)).astype(np.uint8))
                for _ in range(len(QV_TRACKS))
            )
            for s in seqs
        ]
        write_dazz_qvs(db, tracks)
        d = os.path.dirname(db)
        qvs = os.path.join(d, ".q.qvs")
        data = open(qvs, "rb").read()
        # Truncated payload: open may succeed, load must raise.
        open(qvs, "wb").write(data[: len(data) - 4])
        with pytest.raises(OSError):
            with DazzQv(db) as qv:
                qv.load(1, len(seqs[1]))
        # Truncated table region: open fails.
        open(qvs, "wb").write(data[:6])
        with pytest.raises(OSError):
            DazzQv(db)
        # Wrong track count.
        import struct

        bad = bytearray(data)
        bad[0:4] = struct.pack("<i", 9)
        open(qvs, "wb").write(bytes(bad))
        with pytest.raises(OSError):
            DazzQv(db)


class TestUpstreamLayoutPins:
    """Pin the on-disk constants to the published DAZZ_DB/DALIGNER
    struct definitions (DB.h HITS_DB/HITS_READ, align.h Path/Overlap,
    align.c Write_Overlap) so they cannot silently drift back to the
    round-1/2 reconstructions (which were wrong by 8/4 bytes and
    swapped the Path coordinate pairs)."""

    def test_idx_header_is_sizeof_hits_db(self):
        from pbdagcon_tpu_torch.dazzio import _IDX_HEADER, _READ_REC

        # HITS_DB on LP64: 4*4 (ureads/treads/cutoff/allarr) + 16
        # (freq[4]) + 4 (maxlen) + 4 pad + 8 (totlen) + 5*4 (nreads/
        # trimmed/part/ufirst/tfirst) + 4 pad + 5*8 (pointer slots).
        assert _IDX_HEADER == 16 + 16 + 4 + 4 + 8 + 20 + 4 + 40 == 112
        # HITS_READ: 3*4 + 4 pad + 8 + 8 + 4 + 4 pad.
        assert _READ_REC == 40

    def test_las_header_and_overlap_record(self, tmp_path):
        import struct

        from pbdagcon_tpu_torch.dazzio import (
            _LAS_HEADER, _OVL_REC, Overlap, write_las,
        )

        # align.c writes int64 novl then int tspace as two separate
        # fwrites: 12 bytes, NO struct padding.
        assert _LAS_HEADER == 12
        # sizeof(Overlap) - sizeof(void*) = 48 - 8.
        assert _OVL_REC == 40
        las = str(tmp_path / "pin.las")
        write_las(
            las,
            [Overlap(aread=7, bread=9, comp=False, abpos=11, aepos=22,
                     bbpos=33, bepos=44, diffs=5, trace=((1, 2),))],
            tspace=100,
        )
        raw = open(las, "rb").read()
        (novl,) = struct.unpack_from("<q", raw, 0)
        (tspace,) = struct.unpack_from("<i", raw, 8)
        assert (novl, tspace) == (1, 100)
        rec = raw[_LAS_HEADER : _LAS_HEADER + _OVL_REC]
        tlen, diffs, abpos, bbpos, aepos, bepos = struct.unpack_from(
            "<6i", rec, 0
        )
        # Path stores the BEGIN pair then the END pair.
        assert (abpos, bbpos, aepos, bepos) == (11, 33, 22, 44)
        assert (tlen, diffs) == (2, 5)
        flags, aread, bread = struct.unpack_from("<Iii", rec, 24)
        assert (aread, bread) == (7, 9)


def _m4(q, t, score, qlen, tlen, tstrand=0):
    return parse_m4(
        f"{q} {t} {score} 99.0 0 0 {qlen} {qlen} {tstrand} 0 {tlen} {tlen} 254"
    )


def test_select_hits_orders_and_caps():
    recs = [
        _m4("q1", "t1", -100, 50, 50),
        _m4("q2", "t1", -900, 50, 50),
        _m4("q3", "t1", -500, 50, 50),
        _m4("t1", "t1", -999, 50, 50),  # self-hit dropped
        _m4("q1", "t2", -10, 50, 50),
    ]
    sel = select_hits(recs, max_hits=2)
    assert [r.qname for r in sel["t1"]] == ["q2", "q3"]
    assert [r.qname for r in sel["t2"]] == ["q1"]


def test_dazcon_end_to_end_recovers_target():
    rng = random.Random(41)
    tseq = random_seq(rng, 400)
    reads = {"A0": tseq}
    m4_lines = []
    noise = NoiseProfile(sub=0.01, ins=0.04, dele=0.03)
    for j in range(15):
        qstr, _ = sample_read(rng, tseq, 0, len(tseq), noise)
        qseq = qstr.replace("-", "")
        reads[f"B{j}"] = qseq
        m4_lines.append(
            f"B{j} A0 {-5 * len(qseq)} 99.0 0 0 {len(qseq)} {len(qseq)} "
            f"0 0 {len(tseq)} {len(tseq)} 254"
        )
    out = _io.StringIO()
    n = run_dazcon(
        _io.StringIO("\n".join(m4_lines) + "\n"), reads, out,
        min_weight=5, min_length=100, max_hits=85, device="cpu",
    )
    assert n == 1
    lines = out.getvalue().splitlines()
    assert lines[0] == ">A0"
    assert lines[1] == tseq  # low noise + realign: exact recovery


def test_dazcon_min_length_filter():
    rng = random.Random(42)
    tseq = random_seq(rng, 120)
    reads = {"A0": tseq, "B0": tseq, "B1": tseq}
    m4 = "\n".join(
        f"B{j} A0 -500 99.0 0 0 120 120 0 0 120 120 254" for j in range(2)
    )
    out = _io.StringIO()
    n = run_dazcon(_io.StringIO(m4), reads, out, min_weight=2,
                   min_length=500, device="cpu")
    assert n == 0 and out.getvalue() == ""


@pytest.fixture()
def m4_and_reads(tmp_path):
    rng = random.Random(77)
    targets = {f"t{i}": random_seq(rng, 250) for i in range(2)}
    reads = dict(targets)
    m4_lines = []
    noise = NoiseProfile(sub=0.01, ins=0.05, dele=0.03)
    for tname, tseq in targets.items():
        for j in range(10):
            qstr, _ = sample_read(rng, tseq, 0, len(tseq), noise)
            qseq = qstr.replace("-", "")
            qname = f"{tname}_r{j}"
            reads[qname] = qseq
            m4_lines.append(
                f"{qname} {tname} {-5 * len(qseq)} 99.0 0 0 {len(qseq)} "
                f"{len(qseq)} 0 0 {len(tseq)} {len(tseq)} 254"
            )
    m4 = tmp_path / "ovl.m4"
    m4.write_text("\n".join(m4_lines) + "\n")
    fa = tmp_path / "reads.fa"
    fa.write_text(
        "".join(f">{n}\n{s}\n" for n, s in reads.items())
    )
    return str(m4), str(fa), targets


def test_hgap_cli(m4_and_reads, capsys):
    from pbdagcon_tpu_torch.hgap import main

    m4, fa, targets = m4_and_reads
    rc = main([m4, fa, "--bestn", "20"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.strip()]
    assert len(lines) == 20  # 10 overlaps per target survive
    # target-sorted 'pre' records with 7 fields
    assert all(len(l.split()) == 7 for l in lines)
    tnames = [l.split()[1] for l in lines]
    assert tnames == sorted(tnames)


def test_dazcon_cli(m4_and_reads, capsys):
    from pbdagcon_tpu_torch.dazcon import main

    m4, fa, targets = m4_and_reads
    rc = main([m4, fa, "-c", "4", "-m", "100", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    seqs = {}
    cur = None
    for line in out.splitlines():
        if line.startswith(">"):
            cur = line[1:]
        else:
            seqs[cur] = seqs.get(cur, "") + line
    assert set(seqs) == set(targets)
    for tname, tseq in targets.items():
        assert seqs[tname] == tseq  # low noise: exact recovery


@needs_native
def test_dazcon_trace_guided_cli_parity(tmp_path):
    """tpu-dazcon --trace-guided over .las+db == the unguided run."""
    from pbdagcon_tpu_torch.dazzio import write_dazz_db, write_las

    rng = random.Random(77)
    bb, alns = simulate_pileup(rng, "0", 500, 10, NoiseProfile())
    seqs = [bb]
    ovls = []
    for i, a in enumerate(alns, start=1):
        q = a.qstr.replace("-", "")
        comp = i % 4 == 0  # comp overlaps align unguided (no traces)
        seqs.append(revcomp(q) if comp else q)
        tr = () if comp else traces_from_alignment(
            a.qstr, a.tstr, abpos=a.start - 1, tspace=100
        )
        ovls.append(
            Overlap(0, i, comp, a.start - 1, a.end, 0, len(q), 5,
                    trace=tr)
        )
    db = str(tmp_path / "fix.db")
    write_dazz_db(db, seqs)
    las = str(tmp_path / "ovl.las")
    write_las(las, ovls, tspace=100)

    env = _ENV
    outs = []
    for extra in ([], ["--trace-guided"]):
        r = subprocess.run(
            [sys.executable, "-m", "pbdagcon_tpu_torch.dazcon", las, db,
             "-c", "2", "-m", "50", "--device", "cpu"] + extra,
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1], "--trace-guided changed the consensus"
    assert outs[0].startswith(">0\n")
