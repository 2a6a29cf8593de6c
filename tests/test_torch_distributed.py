"""`--distributed` of the port's CLI (tests/test_distributed.py's
exercise): two CPU processes joined by `torch.distributed` (gloo,
env://) run `--distributed --journal` over the same input; each takes
its round-robin shard, and the merged FASTA must equal the single-process
port run and the JAX package's, on the host backend (the ranks detach
after the split) and on the cuda backend with the plain DP on the CPU.
Then: a rank killed after the split leaves the other to finish, and its
shard resumes from its journal; `--shard-bytes` with `--distributed`;
a group that cannot be joined raises."""

import io
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from pbdagcon_tpu.config import DagconConfig as JaxConfig
from pbdagcon_tpu.io import FastaWriter as JaxWriter
from pbdagcon_tpu.pipeline import run_stream as jax_run_stream
from pbdagcon_tpu_torch.cli import main
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.pipeline import run_stream
from pbdagcon_tpu_torch.simulate import simulate_targets, to_m5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-c", "3", "-m", "50"]
BACKENDS = {"host": ["--backend", "host"],
            "cuda": ["--backend", "cuda", "--device", "cpu"]}
TIMEOUT = 120


def _mk_input(path: str) -> str:
    with open(path, "w") as f:
        for _tid, _bb, alns in simulate_targets(333, 6, 250, 10):
            for a in alns:
                f.write(to_m5(a) + "\n")
    return path


def _single(inp: str, backend: str) -> tuple[str, str]:
    """The single-process port run and the JAX package's run."""
    with open(inp) as f:
        port = io.StringIO()
        run_stream(f, FastaWriter(port), DagconConfig(
            min_weight=3, min_length=50, backend=backend, device="cpu"))
    with open(inp) as f:
        ref = io.StringIO()
        jax_run_stream(f, JaxWriter(ref), JaxConfig(
            min_weight=3, min_length=50,
            backend="xla" if backend == "cuda" else backend))
    return port.getvalue(), ref.getvalue()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp_path, inp, args, stdin_for=None):
    """Two `--distributed` ranks; rank `stdin_for` reads a pipe that the
    caller holds open instead of the file. Returns the processes and
    their output and stderr paths."""
    port = _free_port()
    procs, outs, errs = [], [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank))
        outs.append(str(tmp_path / f"out{rank}.fa"))
        errs.append(str(tmp_path / f"err{rank}.txt"))
        src = "-" if rank == stdin_for else inp
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pbdagcon_tpu_torch", src, *FLAGS, *args,
             "--distributed", "--journal", str(tmp_path / f"journal{rank}.txt")],
            stdin=subprocess.PIPE if rank == stdin_for else subprocess.DEVNULL,
            stdout=open(outs[rank], "w"), stderr=open(errs[rank], "w"),
            env=env, cwd=str(tmp_path)))
    return procs, outs, errs


def _wait(procs, errs) -> None:
    for p, e in zip(procs, errs):
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a distributed rank hung")
        assert p.returncode == 0, open(e).read()[-3000:]


def _targets_of(path: str) -> list[list[str]]:
    """Each target's lines, its fragments together."""
    recs, sids = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                sid = line[1:].rsplit("/", 1)[0]
                if not sids or sids[-1] != sid:
                    sids.append(sid)
                    recs.append([])
            recs[-1].append(line)
    return recs


def _merge(path0: str, path1: str) -> str:
    """Round-robin shards keep each shard's order: interleave by target
    (rank 0's first) to rebuild the input order."""
    t0, t1 = _targets_of(path0), _targets_of(path1)
    merged = []
    for i in range(max(len(t0), len(t1))):
        for t in (t0, t1):
            if i < len(t):
                merged.extend(t[i])
    return "".join(merged)


def _journal(tmp_path, rank: int) -> list[str]:
    return open(tmp_path / f"journal{rank}.txt").read().splitlines()


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_two_ranks_match_single_and_reference(tmp_path, backend):
    inp = _mk_input(str(tmp_path / "pile.m5"))
    procs, outs, errs = _start_ranks(tmp_path, inp, BACKENDS[backend])
    single, ref = _single(inp, backend)
    _wait(procs, errs)
    assert single == ref and single.count(">") == 6
    assert _merge(*outs) == single
    j0, j1 = _journal(tmp_path, 0), _journal(tmp_path, 1)
    assert len(j0) + len(j1) == 6
    assert not set(j0) & set(j1)
    for rank, e in enumerate(errs):
        log = open(e).read()
        assert f"distributed: rank {rank} of 2, shard {rank}/2" in log
        assert ("detached after shard assignment" in log) == (backend == "host")


def test_shard_bytes_with_distributed(tmp_path):
    """Byte-range shards: each rank reads its own range of the file, and
    the ranks' outputs concatenate to the single-process FASTA."""
    inp = _mk_input(str(tmp_path / "pile.m5"))
    procs, outs, errs = _start_ranks(
        tmp_path, inp, BACKENDS["host"] + ["--shard-bytes"])
    single, _ = _single(inp, "host")
    _wait(procs, errs)
    assert open(outs[0]).read() + open(outs[1]).read() == single


def test_rank_killed_after_the_split_resumes(tmp_path):
    """Rank 1 is SIGKILLed once it has its shard and has detached; rank 0
    still finishes with rc 0, and `--shard 1/2` on rank 1's journal
    completes the merge."""
    inp = _mk_input(str(tmp_path / "pile.m5"))
    procs, outs, errs = _start_ranks(tmp_path, inp, BACKENDS["host"],
                                     stdin_for=1)
    deadline = time.time() + TIMEOUT
    while "detached" not in open(errs[1]).read():
        if time.time() > deadline or procs[1].poll() is not None:
            for q in procs:
                q.kill()
            pytest.fail("rank 1 never detached: " + open(errs[1]).read())
        time.sleep(0.1)
    procs[1].send_signal(signal.SIGKILL)
    procs[1].wait(timeout=TIMEOUT)
    assert procs[1].returncode == -signal.SIGKILL
    _wait(procs[:1], errs[:1])
    res = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu_torch", inp, *FLAGS,
         *BACKENDS["host"], "--shard", "1/2",
         "--journal", str(tmp_path / "journal1.txt")],
        stdout=open(outs[1], "w"), stderr=subprocess.PIPE, text=True,
        timeout=TIMEOUT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    single, _ = _single(inp, "host")
    assert _merge(*outs) == single
    assert len(_journal(tmp_path, 0)) + len(_journal(tmp_path, 1)) == 6


def test_distributed_without_a_group_raises(tmp_path, monkeypatch):
    """No env:// variables: joining the group raises; the run does not
    carry on as a single process."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    inp = _mk_input(str(tmp_path / "pile.m5"))
    with pytest.raises(ValueError):
        main([inp, *FLAGS, *BACKENDS["host"], "--distributed"])
