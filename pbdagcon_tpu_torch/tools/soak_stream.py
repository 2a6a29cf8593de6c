"""Streaming soak of the port (BASELINE.json config #5: the HGAP
streaming mode, a continuous stream that is killed and resumed).

Streams a deterministic multi-rung pileup workload (mixed backbone
lengths and coverages: several V, R and C shape rungs) through the
port's CLI (`python -m pbdagcon_tpu_torch -`) on a pipe, SIGKILLs it
once its journal holds `--kill-at` of the targets, resumes it with the
same `--journal`, and checks:

- completeness: every target id is journaled and in run 1's or run 2's
  output;
- exactly once: a target in both outputs (only the unjournaled in-flight
  window) is byte-identical in both; nothing journaled before the kill
  is written again;
- bounded memory over the steady window: the consumer's RSS, sampled
  every `--poll` seconds from its journal's first growth to the sample
  that first sees its last line (at least 8 samples, every quarter
  journaling targets); the last quarter's median must not pass the
  first quarter's by more than 30% + 64 MB. A stream too short for
  such a window fails the soak;
- the per-quarter rates (journaled targets a second) are reported;
- with `--verify-full`, the merged output equals an uninterrupted run's.

`--exactly-once-only` judges completeness and exactly-once alone, for a
stream too short for a steady window; the RSS bound and the rates are
then not judged (null in the report).

Any failed check exits non-zero. The records are rendered once per
class and replayed with new target ids, so the generator never starves
the consumer and regenerates the same stream on resume.

    python -m pbdagcon_tpu_torch.tools.soak_stream [n_targets]
        [--backend host|cuda|devbuild|hybrid] [--device cuda|cpu]
        [--kill-at F] [--verify-full] [--exactly-once-only] [--chunk-mb MB]
        [--threads T] [--poll S] [--timeout S] [--workdir DIR]
    python -m pbdagcon_tpu_torch.tools.soak_stream --emit N   # generator

The last stdout line is a JSON report; it carries the consumers'
kernel launches (the CLI's `kernel_launches=` lines) as "launches".
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

# Length/coverage classes cycled per target: several V/R rungs.
CLASSES = [
    (300, 8), (800, 15), (1500, 30), (3000, 20), (6000, 12), (1000, 60),
]
SEED = 4242
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def templates(classes, seed: int) -> list[str]:
    """One rendered M5 block per (length, coverage) class, with the
    placeholder sid "@SID@"."""
    import random

    from pbdagcon_tpu_torch.simulate import (
        NoiseProfile,
        simulate_pileup,
        to_m5,
    )

    blocks = []
    for ci, (length, cov) in enumerate(classes):
        rng = random.Random(seed + ci)
        _bb, alns = simulate_pileup(rng, "@SID@", length, cov, NoiseProfile())
        blocks.append("\n".join(to_m5(a) for a in alns) + "\n")
    return blocks


def emit(n_targets: int) -> int:
    blocks = templates(CLASSES, SEED)
    w = sys.stdout.write
    try:
        for i in range(n_targets):
            w(blocks[i % len(blocks)].replace("@SID@", f"t{i:07d}"))
        sys.stdout.flush()
    except BrokenPipeError:  # the consumer was killed mid-run: expected
        os._exit(0)
    return 0


def rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def line_count(path: str) -> int:
    try:
        with open(path, "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


def targets_of(path: str) -> dict[str, str]:
    """sid -> its FASTA records (headers and sequences), in file order."""
    recs: dict[str, list[str]] = {}
    cur = None
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(">"):
                    cur = line[1:].rsplit("/", 1)[0]
                    recs.setdefault(cur, []).append(line)
                elif cur is not None:
                    recs[cur].append(line)
    except FileNotFoundError:
        pass
    return {k: "".join(v) for k, v in recs.items()}


def kernel_launches(err: str) -> dict[str, int]:
    """The CLI's `kernel_launches=` line of a run's stderr ({} if none)."""
    for line in reversed(err.splitlines()):
        if line.startswith("kernel_launches="):
            return json.loads(line.split("=", 1)[1])
    return {}


def steady(samples: list) -> list:
    """The steady window of one run's samples (t, RSS MB, journaled
    targets): from the first sample after the journal first grew to the
    first that sees its last line (start-up comes before, the exit
    after)."""
    if not samples:
        return []
    j0, jn = samples[0][2], samples[-1][2]
    out = []
    for x in samples:
        if x[2] > j0:
            out.append(x)
            if x[2] >= jn:
                break
    return out


def judge_memory(samples: list) -> dict:
    """The RSS bound and the per-quarter rates over a steady window.
    Raises SystemExit if the window has fewer than 8 samples, if a
    quarter journaled no target (the stream ended or stalled: no steady
    state to judge), or if the last quarter's median RSS passes the
    first's by more than 30% + 64 MB."""
    if len(samples) < 8:
        raise SystemExit(f"soak_stream: {len(samples)} steady samples, too "
                         f"few for the RSS bound; raise n_targets or lower "
                         f"--poll")
    q = len(samples) // 4
    edges = [samples[k * q] for k in range(4)] + [samples[-1]]
    rates = [(b[2] - a[2]) / (b[0] - a[0]) if b[0] > a[0] else 0.0
             for a, b in zip(edges, edges[1:])]
    idle = [k + 1 for k, r in enumerate(rates) if r <= 0]
    if idle:
        raise SystemExit(f"soak_stream: quarter(s) {idle} of the steady "
                         f"window journaled no target (rates {rates}): no "
                         f"steady state for the RSS bound; raise n_targets")
    rss_first = sorted(r for _t, r, _j in samples[:q])[q // 2]
    rss_last = sorted(r for _t, r, _j in samples[-q:])[q // 2]
    if rss_last > rss_first * 1.3 + 64:
        raise SystemExit(f"soak_stream: RSS grew {rss_first:.0f} -> "
                         f"{rss_last:.0f} MB")
    return {"steady_samples": len(samples), "rss_first_q_mb": rss_first,
            "rss_last_q_mb": rss_last, "targets_per_s_quarters": rates}


def _run(a, journal: str, out_path: str, err_path: str,
         kill_at: int | None = None) -> tuple[int, float, list, bool]:
    """One generator | consumer run; returns (rc, wall s, samples of
    (t, rss MB, journaled targets), whether it was killed)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    gen = subprocess.Popen(
        [sys.executable, "-m", "pbdagcon_tpu_torch.tools.soak_stream",
         "--emit", str(a.n_targets)],
        stdout=subprocess.PIPE, env=env, cwd=ROOT,
    )
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        con = subprocess.Popen(
            [sys.executable, "-m", "pbdagcon_tpu_torch", "-", "-c", "3",
             "-m", "100", "--backend", a.backend, "--device", a.device,
             "-j", str(a.threads), "--chunk-mb", str(a.chunk_mb),
             "--journal", journal],
            stdin=gen.stdout, stdout=out_f, stderr=err_f, env=env, cwd=ROOT,
        )
        gen.stdout.close()
        t0 = time.time()
        samples = []
        killed = False
        try:
            while con.poll() is None:
                time.sleep(a.poll)
                jl = line_count(journal)
                rss = rss_mb(con.pid)
                if rss > 0:  # skip samples after the exit
                    samples.append((time.time() - t0, rss, jl))
                if kill_at is not None and not killed and jl >= kill_at:
                    con.send_signal(signal.SIGKILL)
                    killed = True
                    print(f"soak: SIGKILL at {jl} journaled targets "
                          f"({time.time() - t0:.1f} s)", file=sys.stderr,
                          flush=True)
                if time.time() - t0 > a.timeout:
                    con.kill()
                    raise SystemExit(f"soak_stream: the consumer passed "
                                     f"{a.timeout} s")
        finally:
            gen.kill()
            gen.wait()
            con.wait()
    return con.returncode, time.time() - t0, samples, killed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_targets", nargs="?", type=int, default=200_000)
    ap.add_argument("--emit", type=int, default=None)
    ap.add_argument("--kill-at", type=float, default=0.4)
    ap.add_argument("--verify-full", action="store_true")
    ap.add_argument("--exactly-once-only", action="store_true",
                    help="judge completeness and exactly-once alone (a "
                         "stream too short for a steady window)")
    ap.add_argument("--backend", default="host",
                    choices=("host", "cuda", "devbuild", "hybrid"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--chunk-mb", type=int, default=16)
    ap.add_argument("--poll", type=float, default=1.0,
                    help="seconds between the RSS and journal samples")
    ap.add_argument("--timeout", type=float, default=7200.0,
                    help="seconds a consumer run may take")
    ap.add_argument("--workdir", default=None)
    a = ap.parse_args(argv)
    if a.emit is not None:
        return emit(a.emit)

    n = a.n_targets
    d = a.workdir or tempfile.mkdtemp(prefix="dagcon_soak_")
    os.makedirs(d, exist_ok=True)
    journal = os.path.join(d, "journal.txt")
    for name in ("journal.txt", "journal3.txt"):
        if os.path.exists(os.path.join(d, name)):
            os.remove(os.path.join(d, name))
    out1, out2 = os.path.join(d, "out1.fa"), os.path.join(d, "out2.fa")
    err1, err2 = os.path.join(d, "err1.log"), os.path.join(d, "err2.log")
    print(f"soak: {n} targets, backend {a.backend} on {a.device}, workdir "
          f"{d}", file=sys.stderr, flush=True)

    rc1, t1, s1, killed = _run(a, journal, out1, err1,
                               kill_at=max(1, int(n * a.kill_at)))
    if not killed or rc1 != -signal.SIGKILL:
        raise SystemExit(f"soak_stream: run 1 ended (rc {rc1}) before "
                         f"{int(n * a.kill_at)} targets were journaled; "
                         f"raise n_targets or lower --kill-at")
    journaled = set(open(journal).read().split())
    rc2, t2, s2, _ = _run(a, journal, out2, err2)
    if rc2 != 0:
        raise SystemExit(f"soak_stream: the resumed run failed (rc {rc2}):\n"
                         + open(err2).read()[-3000:])

    r1, r2 = targets_of(out1), targets_of(out2)
    all_ids = {f"t{i:07d}" for i in range(n)}
    union = set(r1) | set(r2)
    journal_ids = set(open(journal).read().split())
    missing = all_ids - journal_ids
    if missing:
        raise SystemExit(f"soak_stream: {len(missing)} targets never "
                         f"completed, e.g. {sorted(missing)[:3]}")
    lost = all_ids - union
    if lost:
        raise SystemExit(f"soak_stream: {len(lost)} targets are in neither "
                         f"output, e.g. {sorted(lost)[:3]}")
    extra = (union | journal_ids) - all_ids
    if extra:
        raise SystemExit(f"soak_stream: unknown target ids "
                         f"{sorted(extra)[:3]}")
    dup = set(r1) & set(r2)
    again = dup & journaled
    if again:
        raise SystemExit(f"soak_stream: {len(again)} targets journaled "
                         f"before the kill were written again, e.g. "
                         f"{sorted(again)[:3]}")
    differ = [s for s in dup if r1[s] != r2[s]]
    if differ:
        raise SystemExit(f"soak_stream: {len(differ)} in-flight targets "
                         f"differ between the runs, e.g. {differ[:3]}")
    merged = dict(r1)
    merged.update(r2)

    # Memory and throughput over the resumed run (the longer clean one)
    # where its steady window has 8 samples, else over the killed run's.
    max_rss = max(r for _t, r, _j in s1 + s2)
    if a.exactly_once_only:
        mem = {"steady_samples": None, "rss_first_q_mb": None,
               "rss_last_q_mb": None, "targets_per_s_quarters": None}
    else:
        w2 = steady(s2)
        mem = judge_memory(w2 if len(w2) >= 8 else steady(s1))

    full_ok = None
    if a.verify_full:
        j3 = os.path.join(d, "journal3.txt")
        out3, err3 = os.path.join(d, "out3.fa"), os.path.join(d, "err3.log")
        rc3, _t3, _s3, _ = _run(a, j3, out3, err3)
        if rc3 != 0:
            raise SystemExit(f"soak_stream: the uninterrupted run failed "
                             f"(rc {rc3})")
        full_ok = targets_of(out3) == merged
        if not full_ok:
            raise SystemExit("soak_stream: the merged kill/resume output != "
                             "the uninterrupted run's")

    launches: dict[str, int] = {}
    for path in (err1, err2):
        for k, v in kernel_launches(open(path).read()).items():
            launches[k] = launches.get(k, 0) + v
    bases = sum(len(l) for rec in merged.values() for l in rec.splitlines()
                if not l.startswith(">"))
    print(json.dumps({
        "metric": "soak_stream",
        "backend": a.backend,
        "device": a.device,
        "targets": n,
        "emitted_targets": len(merged),
        "bases": bases,
        "run1_s": t1,
        "resume_s": t2,
        "journaled_at_kill": len(journaled),
        "dup_inflight_targets": len(dup),
        "max_rss_mb": max_rss,
        **mem,
        "sustained_bases_per_s": bases / max(t1 + t2, 1e-9),
        "verify_full": full_ok,
        "launches": launches,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
