"""Multi-rank streaming soak of the port: streaming, the journal, the
byte-range shard split and kill/resume across 2-4 ranks at once.

Protocol:
  1. Write an N-target multi-class M5 file (templated, fast).
  2. Start R ranks of the CLI on that file, `--distributed --shard-bytes
     --journal j{r}.log`, on `torchrun`'s env:// variables (MASTER_ADDR,
     MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK): each rank reads only its
     byte range and journals its own targets.
  3. SIGKILL rank 1 once its journal holds `--kill-at` of its share.
  4. Let the other ranks finish. On a device backend they stay in the
     gloo group until they exit, so this is where a dead peer would
     show: a survivor that exits non-zero is reported and resumed like
     the victim; one still running after `--timeout` seconds fails the
     soak as hung.
  5. Resume the killed rank (and any failed survivor) alone with
     `--shard r/R` and the same journal.
  6. Check against one uninterrupted single-process run on `host`: every
     target comes out exactly once over the ranks' and the resumes'
     outputs (the same target set, each byte-equal), no target from two
     ranks, and a target both in a killed run and its resume
     byte-identical in both.

Any failed check exits non-zero. The last stdout line is a JSON report
(per-phase walls, the survivors' exit codes, the resumes' duplicates,
the peak RSS, the ranks' kernel launches from the CLI's
`kernel_launches=` lines).

    python -m pbdagcon_tpu_torch.tools.soak_multirank [n_targets]
        [--ranks R] [--kill-at F] [--threads T] [--batch-targets B]
        [--backend host|cuda|devbuild|hybrid] [--device cuda|cpu]
        [--timeout S] [--poll S] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from pbdagcon_tpu_torch.tools.soak_stream import (
    kernel_launches,
    line_count,
    rss_mb,
    targets_of,
    templates,
)

# Small and mid classes keep a million-target input near 20 GB.
CLASSES = [(300, 8), (700, 14), (1200, 25), (2000, 16), (900, 40)]
SEED = 9242
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def generate_file(path: str, n: int) -> None:
    blocks = templates(CLASSES, SEED)
    with open(path, "w") as f:
        for i in range(n):
            f.write(blocks[i % len(blocks)].replace("@SID@", f"s{i:07d}"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_cmd(a, inp: str, rank: int, journal: str | None, world: int | None,
             port: int | None) -> tuple[list[str], dict]:
    """The CLI command and environment of one rank: `--distributed` on
    env:// when `port` is given, else `--shard rank/world` alone (a
    resume), or the whole file when `world` is None."""
    cmd = [sys.executable, "-m", "pbdagcon_tpu_torch", inp, "-c", "3", "-m",
           "100", "--backend", a.backend, "--device", a.device, "-j",
           str(a.threads), "--batch-targets", str(a.batch_targets)]
    if journal is not None:
        cmd += ["--journal", journal]
    env = dict(os.environ, PYTHONPATH=ROOT)
    if world is not None:
        cmd.append("--shard-bytes")
        if port is not None:
            cmd.append("--distributed")
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank))
        else:
            cmd += ["--shard", f"{rank}/{world}"]
    return cmd, env


def _start(a, w: str, tag: str, cmd, env) -> tuple[subprocess.Popen, str, str]:
    out, err = os.path.join(w, f"out{tag}.fa"), os.path.join(w, f"err{tag}.log")
    with open(out, "w") as fo, open(err, "w") as fe:
        p = subprocess.Popen(cmd, stdout=fo, stderr=fe, env=env, cwd=ROOT)
    return p, out, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--kill-at", type=float, default=0.4)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--batch-targets", type=int, default=128)
    ap.add_argument("--backend", default="host",
                    choices=("host", "cuda", "devbuild", "hybrid"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=7200.0,
                    help="seconds the ranks of phase A may take")
    ap.add_argument("--poll", type=float, default=1.0)
    ap.add_argument("--workdir", default=None)
    a = ap.parse_args(argv)
    if not 2 <= a.ranks <= 4:
        raise SystemExit("soak_multirank: --ranks is 2 to 4")

    w = a.workdir or tempfile.mkdtemp(prefix="soak_mr_")
    os.makedirs(w, exist_ok=True)
    for f in os.listdir(w):
        if f.startswith("j") and f.endswith(".log"):
            os.remove(os.path.join(w, f))
    inp = os.path.join(w, "pile.m5")
    t = time.time()
    generate_file(inp, a.n)
    print(f"soak: generated {a.n} targets, {os.path.getsize(inp) / 1e6:.1f}"
          f" MB in {time.time() - t:.1f} s", file=sys.stderr, flush=True)
    report: dict = {"metric": "soak_multirank", "n": a.n, "ranks": a.ranks,
                    "backend": a.backend, "device": a.device}

    # ---- phase A: every rank, rank 1 killed mid-run ----
    port = free_port()
    journals = [os.path.join(w, f"j{r}.log") for r in range(a.ranks)]
    ranks = [_start(a, w, f"{r}A", *rank_cmd(a, inp, r, journals[r], a.ranks,
                                             port))
             for r in range(a.ranks)]
    victim = 1
    kill_n = max(1, int(a.n // a.ranks * a.kill_at))
    print(f"soak: phase A, {a.ranks} ranks on {a.backend}/{a.device}; "
          f"SIGKILL rank {victim} at {kill_n} journaled targets",
          file=sys.stderr, flush=True)
    max_rss, killed_at, t0 = 0.0, None, time.time()
    while any(p.poll() is None for p, _o, _e in ranks):
        time.sleep(a.poll)
        for p, _o, _e in ranks:
            max_rss = max(max_rss, rss_mb(p.pid))
        jc = line_count(journals[victim])
        if killed_at is None and jc >= kill_n and ranks[victim][0].poll() is None:
            ranks[victim][0].send_signal(signal.SIGKILL)
            killed_at = jc
            print(f"soak: SIGKILLed rank {victim} at {jc} targets "
                  f"({time.time() - t0:.1f} s)", file=sys.stderr, flush=True)
        if time.time() - t0 > a.timeout:
            for p, _o, _e in ranks:
                p.kill()
                p.wait()
            raise SystemExit(f"soak_multirank: a rank still ran after "
                             f"{a.timeout} s (hung survivor; killed at "
                             f"{killed_at})")
    report["phaseA_s"] = time.time() - t0
    if killed_at is None:
        raise SystemExit(f"soak_multirank: rank {victim} ended before "
                         f"{kill_n} targets were journaled; raise n")
    rcs = {r: p.returncode for r, (p, _o, _e) in enumerate(ranks)}
    if rcs[victim] != -signal.SIGKILL:
        raise SystemExit(f"soak_multirank: rank {victim} exited {rcs[victim]} "
                         f"before the kill took; raise n")
    report["killed_at"] = killed_at
    report["survivor_rcs"] = [rcs[r] for r in range(a.ranks) if r != victim]
    failed = [r for r in range(a.ranks) if r != victim and rcs[r] != 0]
    for r in failed:
        print(f"soak: surviving rank {r} exited {rcs[r]}:\n"
              + open(ranks[r][2]).read()[-2000:], file=sys.stderr, flush=True)
    print(f"soak: phase A done in {report['phaseA_s']:.1f} s; survivor rcs "
          f"{report['survivor_rcs']}", file=sys.stderr, flush=True)

    # ---- phase B: resume the victim (and any failed survivor) alone ----
    t1 = time.time()
    resumes = {}
    for r in [victim] + failed:
        p, out, err = _start(a, w, f"{r}B", *rank_cmd(a, inp, r, journals[r],
                                                      a.ranks, None))
        while p.poll() is None:
            time.sleep(a.poll)
            max_rss = max(max_rss, rss_mb(p.pid))
        if p.returncode != 0:
            raise SystemExit(f"soak_multirank: the resume of rank {r} failed "
                             f"(rc {p.returncode}):\n"
                             + open(err).read()[-3000:])
        resumes[r] = (out, err)
    report["resume_s"] = time.time() - t1
    report["resumed_ranks"] = sorted(resumes)
    report["max_rss_mb"] = max_rss

    # ---- checks against one uninterrupted run on host ----
    t2 = time.time()
    full_cmd, env = rank_cmd(a, inp, 0, None, None, None)
    full_cmd[full_cmd.index("--backend") + 1] = "host"
    full_cmd[full_cmd.index("--device") + 1] = "cpu"
    full_cmd[full_cmd.index("-j") + 1] = str(a.ranks * a.threads)
    p, out_full, err_full = _start(a, w, "full", full_cmd, env)
    if p.wait() != 0:
        raise SystemExit("soak_multirank: the single-process run failed:\n"
                         + open(err_full).read()[-3000:])
    report["single_proc_s"] = time.time() - t2
    full = targets_of(out_full)

    per_rank = [targets_of(o) for _p, o, _e in ranks]
    seen: dict[str, int] = {}
    for r, d in enumerate(per_rank):
        for sid in d:
            if sid in seen:
                raise SystemExit(f"soak_multirank: {sid} came out of ranks "
                                 f"{seen[sid]} and {r}")
            seen[sid] = r
    merged: dict[str, str] = {}
    dups = 0
    for r, d in enumerate(per_rank):
        merged.update(d)
        if r in resumes:
            again = targets_of(resumes[r][0])
            for sid in set(d) & set(again):
                dups += 1
                if d[sid] != again[sid]:
                    raise SystemExit(f"soak_multirank: {sid} differs between "
                                     f"rank {r}'s killed run and its resume")
            for sid in again:
                if seen.setdefault(sid, r) != r:
                    raise SystemExit(f"soak_multirank: {sid} came out of "
                                     f"ranks {seen[sid]} and {r}")
            merged.update(again)
    report["resume_dups"] = dups
    report["emitted"] = len(merged)
    if set(merged) != set(full):
        raise SystemExit(
            f"soak_multirank: the target set differs from the single run's: "
            f"only here {sorted(set(merged) - set(full))[:3]}, only there "
            f"{sorted(set(full) - set(merged))[:3]}")
    bad = [s for s in full if full[s] != merged[s]]
    if bad:
        raise SystemExit(f"soak_multirank: {len(bad)} targets differ from the "
                         f"single run's, e.g. {bad[:3]}")
    launches: dict[str, int] = {}
    for err in [e for _p, _o, e in ranks] + [e for _o, e in resumes.values()]:
        for k, v in kernel_launches(open(err).read()).items():
            launches[k] = launches.get(k, 0) + v
    report["launches"] = launches
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
