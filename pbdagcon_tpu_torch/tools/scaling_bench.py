"""Multi-process scaling of the port on one machine: the same workload
through 1 process and through N ranks (`--distributed --shard-bytes` on
`torchrun`'s env:// variables: each rank reads its byte range of the
file), with the same thread budget a process, reporting throughput and
the scaling efficiency.

    python -m pbdagcon_tpu_torch.tools.scaling_bench [n_targets] [len] [cov]
        [nproc] [threads] [--backend host|cuda|devbuild|hybrid]
        [--device cuda|cpu] [--reps N]

A warm-up 1-process run, then `--reps` 1-process and N-rank runs in
turns; each time is the slowest rank's `proc_time` (the CLI's own
seconds, without the interpreter's and torch's start-up), the best of
the reps. The ranks' merged records must equal the single process's
(both sorted, since the shards interleave targets). Every rank's wall
and CPU seconds are reported: CPU ~ wall x threads on every rank means
the loss is core contention on the shared machine, a rank with CPU well
under its wall one that waits. On one machine this measures ranks that
share its cores (and one card), not scaling across hosts or cards.
The last stdout line is a JSON report; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from pbdagcon_tpu_torch.tools.soak_multirank import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_procs(a, inp: str, nproc: int, outdir: str):
    """One run on `nproc` processes: (slowest proc_time, sorted records,
    [(proc_time, cpu_time)] a rank)."""
    port = free_port()
    procs, outs = [], []
    for rank in range(nproc):
        env = dict(os.environ, PYTHONPATH=ROOT)
        cmd = [sys.executable, "-m", "pbdagcon_tpu_torch", inp, "-c", "4",
               "-m", "100", "--backend", a.backend, "--device", a.device,
               "-j", str(a.threads)]
        if nproc > 1:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(rank), WORLD_SIZE=str(nproc),
                       LOCAL_RANK=str(rank))
            cmd += ["--distributed", "--shard-bytes"]
        out = os.path.join(outdir, f"out{nproc}_{rank}.fa")
        outs.append(out)
        with open(out, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.PIPE,
                                          env=env, cwd=ROOT))
    ranks = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise SystemExit(f"scaling_bench: a rank failed:\n"
                             f"{err.decode()[-2000:]}")
        for ln in err.decode().splitlines():
            if ln.startswith("proc_time="):
                f = dict(kv.split("=") for kv in ln.split() if "=" in kv)
                ranks.append((float(f["proc_time"].rstrip("s")),
                              float(f["cpu_time"].rstrip("s"))))
    if len(ranks) != nproc:
        raise SystemExit("scaling_bench: a rank printed no proc_time line")
    recs = []
    for o in outs:
        with open(o) as f:
            recs.extend(">" + r for r in f.read().split(">") if r)
    return max(w for w, _c in ranks), "".join(sorted(recs)), ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_targets", nargs="?", type=int, default=64)
    ap.add_argument("length", nargs="?", type=int, default=500)
    ap.add_argument("cov", nargs="?", type=int, default=20)
    ap.add_argument("nproc", nargs="?", type=int, default=2)
    ap.add_argument("threads", nargs="?", type=int, default=2)
    ap.add_argument("--backend", default="host",
                    choices=("host", "cuda", "devbuild", "hybrid"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args(argv)
    if a.nproc < 2:
        raise SystemExit("scaling_bench: nproc is at least 2")
    from pbdagcon_tpu_torch.simulate import write_m5

    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "pile.m5")
        write_m5(inp, seed=777, n_targets=a.n_targets, backbone_len=a.length,
                 coverage=a.cov)
        run_procs(a, inp, 1, d)  # warm-up: imports, page cache, kernels
        t1 = tn = ranks = None
        for _ in range(a.reps):
            dt, fasta_1, _r = run_procs(a, inp, 1, d)
            t1 = dt if t1 is None else min(t1, dt)
            dt, fasta_n, rk = run_procs(a, inp, a.nproc, d)
            if tn is None or dt < tn:
                tn, ranks = dt, rk
            if fasta_n != fasta_1:
                raise SystemExit("scaling_bench: the ranks' merged records "
                                 "differ from the single process's")
    print(json.dumps({
        "metric": "distributed_scaling_efficiency",
        "backend": a.backend,
        "device": a.device,
        "n_processes": a.nproc,
        "threads_per_process": a.threads,
        "targets": a.n_targets,
        "t_1proc_s": t1,
        f"t_{a.nproc}proc_s": tn,
        "speedup": t1 / tn,
        "efficiency": t1 / tn / a.nproc,
        "per_rank": [{"wall_s": w, "cpu_s": c,
                      "cpu_over_wall": c / w if w else 0.0}
                     for w, c in ranks],
        "parity": "merged shards == single-process FASTA",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
