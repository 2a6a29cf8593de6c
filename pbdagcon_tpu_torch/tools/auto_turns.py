"""`--backend auto` on the card beside `cuda` and `host`, in turns, on the
benchmark's configurations (`bench/cells.py`), through
`pipeline.run_stream` at the cells' knobs (8 engine threads, seed 1234):

- (a) the configuration's own stream, held in memory: auto, cuda, host
  in turns, `--rounds` rounds after one untimed round. At the hybrid
  scheduler's default probe deferral (20 s) a stream this short keeps
  the device idle.
- (b) a long stream: the configuration's records replayed with fresh
  target ids (`ReplayStream`, made one copy at a time and never held
  whole), `--copies` copies or enough for `--long-s` seconds of the host
  engine's work (counted from (a)'s median `host` wall): host, auto,
  auto, host.

"auto" and the hybrid scheduler run at the devbuild cells' window (128
targets, the CLI's default); "cuda" at the `cuda` cell's batch. Every
run's FASTA must be byte-equal to the single-thread native engine's:
its FASTA of one copy, with each copy's ids (`replayed_fasta`).

A line on stdout per run (JSON: b/s; the hybrid's host and device
chunks and their bytes and bases; the device-attributable rate, the
device worker's bases over its busy seconds; the first device chunk's
warm-up, its seconds less what its bytes take at the run's later device
rate; B1, B2 and B3 launches), then one line per configuration with the
means and the ratios auto / host and auto / cuda beside the reference's
never-worse guard (auto within 10% of host where the device took a
chunk; reported, not gated), and the last line a JSON report with the
card's name and power limit. Exit 1 on a parity break, 2 without a card
(`--device cpu` runs the kernels' plain versions: "auto" then runs
"cuda").

    python -m pbdagcon_tpu_torch.tools.auto_turns [--config NAME]...
        [--rounds 3] [--long-s 60] [--copies N] [--seed 1234]
        [--device cuda|cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import re
import statistics
import sys
import time

from pbdagcon_tpu_torch.bench import cells as C

GUARD = 0.9  # the reference's never-worse guard: hybrid >= 0.9 x host
HYBRID_BATCH = 128  # the devbuild cells' window, the CLI's default


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sid_segments(text: bytes, fmt: str) -> list[bytes]:
    """`text` cut just past each record's target id (the M5 record's
    sixth field, the 'pre' record's second), so that a copy with fresh
    ids is `tag.join(segments)`."""
    col = 5 if fmt == "m5" else 1
    ends = [m.end(1) for m in re.finditer(
        rb"^(?:\S+[ \t]+){%d}(\S+)" % col, text, re.M)]
    if len(ends) != text.count(b"\n"):
        raise ValueError("a record without a target id field")
    return [text[a:b] for a, b in zip([0] + ends, ends + [len(text)])]


def fasta_segments(fasta: str) -> list[str]:
    """`fasta` cut just past each header's target id (before its last
    "/"), as `sid_segments` cuts the records."""
    ends, at = [], 0
    for line in fasta.splitlines(keepends=True):
        if line.startswith(">"):
            ends.append(at + line.rindex("/"))
        at += len(line)
    return [fasta[a:b] for a, b in zip([0] + ends, ends + [len(fasta)])]


def tag(k: int) -> str:
    """The suffix of copy k's target ids: none on copy 0, the
    configuration's own records."""
    return f"_r{k}" if k else ""


def replayed_fasta(fsegs: list[str], k: int) -> str:
    """Copy k's FASTA: one copy's FASTA with copy k's target ids (each
    group's consensus depends on its own records alone)."""
    return tag(k).join(fsegs)


class ReplayStream:
    """A binary stream of `copies` copies of one configuration's records,
    copy k's target ids suffixed with `tag(k)`; one copy is made at a
    time, so the stream is never held whole."""

    def __init__(self, segs: list[bytes], copies: int):
        self.segs, self.copies = segs, copies
        self.k, self.buf, self.off = 0, b"", 0

    def read(self, n: int = -1) -> bytes:
        parts = []
        while n != 0:
            if self.off == len(self.buf):
                if self.k == self.copies:
                    break
                self.buf = tag(self.k).encode().join(self.segs)
                self.off, self.k = 0, self.k + 1
            end = len(self.buf) if n < 0 else min(len(self.buf), self.off + n)
            parts.append(self.buf[self.off:end])
            if n > 0:
                n -= end - self.off
            self.off = end
        return b"".join(parts)


def check_replayed(fasta: str, fsegs: list[str], copies: int) -> bool:
    """Whether `fasta` is copies 0..copies-1 of `replayed_fasta`, byte
    for byte (compared a copy at a time)."""
    at = 0
    for k in range(copies):
        want = replayed_fasta(fsegs, k)
        if fasta[at:at + len(want)] != want:
            return False
        at += len(want)
    return at == len(fasta)


def first_use_warmup(st) -> float | None:
    """The first device chunk's seconds less what its bytes take at the
    run's later device chunks' rate; None without a later chunk."""
    rest_b = st.hybrid_dev_bytes - st.hybrid_dev_first_bytes
    if not st.hybrid_dev_chunks or rest_b <= 0:
        return None
    warm_spb = (st.hybrid_dev_busy_s - st.hybrid_dev_first_s) / rest_b
    return st.hybrid_dev_first_s - st.hybrid_dev_first_bytes * warm_spb


def run_one(stream, dcfg, device) -> tuple[float, object, str, dict]:
    """One run of `run_stream`: (seconds, stats, FASTA, B1/B2/B3
    launches)."""
    import torch

    from pbdagcon_tpu_torch.cli import launch_counts
    from pbdagcon_tpu_torch.io import FastaWriter
    from pbdagcon_tpu_torch.ops import dp_cuda, mxu_cuda  # noqa: F401
    from pbdagcon_tpu_torch.pipeline import run_stream

    before = launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    stats = run_stream(stream, FastaWriter(out), dcfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    after = launch_counts()
    return dt, stats, out.getvalue(), {
        k: after.get(k, 0) - before.get(k, 0)
        for k in ("dp_scan", "hist", "scatter")}


def record(cfg_name, stream_name, copies, backend, dt, st, fasta_ok,
           launches, bases) -> dict:
    warm = first_use_warmup(st)
    return {
        "config": cfg_name, "stream": stream_name, "copies": copies,
        "backend": backend, "wall_s": dt, "bases": bases,
        "bases_per_s": bases / dt,
        "targets": st.targets, "fasta_ok": fasta_ok,
        "hybrid_host_chunks": st.hybrid_host_chunks,
        "hybrid_dev_chunks": st.hybrid_dev_chunks,
        "hybrid_host_bytes": st.hybrid_host_bytes,
        "hybrid_dev_bytes": st.hybrid_dev_bytes,
        "hybrid_host_bases": st.hybrid_host_bases,
        "hybrid_dev_bases": st.hybrid_dev_bases,
        "hybrid_host_busy_s": st.hybrid_host_busy_s,
        "hybrid_dev_busy_s": st.hybrid_dev_busy_s,
        "dev_attr_bases_per_s": st.hybrid_dev_bases / st.hybrid_dev_busy_s
        if st.hybrid_dev_busy_s > 0 else None,
        "dev_first_s": st.hybrid_dev_first_s,
        "dev_first_bytes": st.hybrid_dev_first_bytes,
        "first_use_warmup_s": warm if warm is not None else "not measured",
        "launches": launches,
    }


def configs_of(cfg: C.Config, device) -> dict:
    """The run configuration of each backend at the cells' knobs."""
    from pbdagcon_tpu_torch.config import DagconConfig

    cuda_batch = next(c.batch_targets for c in C.CELLS.values()
                      if c.config == cfg.name and c.backend == "cuda")
    base = DagconConfig(
        min_weight=cfg.min_weight, min_length=cfg.min_length,
        threads=C.THREADS, fmt=cfg.fmt, align=cfg.align,
        device=str(device), batch_targets=HYBRID_BATCH)
    return {"auto": base,
            "cuda": dataclasses.replace(base, backend="cuda",
                                        batch_targets=cuda_batch),
            "host": dataclasses.replace(base, backend="host")}


def summary(name: str, runs: list[dict], stream_name: str) -> dict:
    """Means by backend of one stream's runs, and the ratios."""
    mean = {b: statistics.fmean(r["bases_per_s"] for r in runs
                                if r["backend"] == b)
            for b in sorted({r["backend"] for r in runs})}
    auto = [r for r in runs if r["backend"] == "auto"]
    out = {"config": name, "stream": stream_name, "mean_bases_per_s": mean,
           "auto_over_host": mean["auto"] / mean["host"]}
    if "cuda" in mean:
        out["auto_over_cuda"] = mean["auto"] / mean["cuda"]
    out["dev_chunks"] = [r["hybrid_dev_chunks"] for r in auto]
    out["guard"] = GUARD
    out["guard_applies"] = any(r["hybrid_dev_chunks"] for r in auto)
    out["guard_holds"] = out["auto_over_host"] >= GUARD
    return out


def turns(cfg: C.Config, seed: int, device, rounds: int, long_s: float,
          copies: int | None) -> tuple[list[dict], list[dict]]:
    from pbdagcon_tpu_torch import native

    t0 = time.perf_counter()
    text = C.config_text(cfg, seed)
    with native.NativeEngine(min_weight=cfg.min_weight,
                             min_length=cfg.min_length, threads=1,
                             align=cfg.align) as eng:
        want = eng.consensus_text(text, fmt=cfg.fmt)
    segs = sid_segments(text, cfg.fmt)
    fsegs = fasta_segments(want)
    log(f"auto_turns {cfg.name}: {cfg.targets} targets, {len(text)} bytes, "
        f"input and the 1-thread engine's FASTA in "
        f"{time.perf_counter() - t0:.1f} s")
    dcfgs = configs_of(cfg, device)
    runs, sums = [], []

    def run(stream_name, backend, n_copies, timed=True):
        stream = ReplayStream(segs, n_copies)
        dt, st, fasta, launches = run_one(stream, dcfgs[backend], device)
        ok = check_replayed(fasta, fsegs, n_copies)
        bases = sum(len(l) for l in fasta.splitlines()
                    if not l.startswith(">"))
        r = record(cfg.name, stream_name, n_copies, backend, dt, st, ok,
                   launches, bases)
        if timed:
            runs.append(r)
            print(json.dumps(r), flush=True)
        log(f"  {cfg.name} {stream_name} {backend}: "
            f"{r['bases_per_s']:.1f} b/s, wall {dt:.4f} s, host/device "
            f"chunks {st.hybrid_host_chunks}/{st.hybrid_dev_chunks}, "
            f"launches {launches}{'' if timed else ' (untimed)'}"
            f"{'' if ok else ', FASTA MISMATCH'}")
        if not ok:
            raise SystemExit(f"auto_turns: {cfg.name} {stream_name} "
                             f"{backend}: FASTA != the 1-thread engine's")
        return r

    # (a) the configuration's own stream (one copy).
    for b in ("auto", "cuda", "host"):
        run("own", b, 1, timed=False)
    for _ in range(rounds):
        for b in ("auto", "cuda", "host"):
            run("own", b, 1)
    own = [r for r in runs if r["stream"] == "own"]
    sums.append(summary(cfg.name, own, "own"))
    # (b) the long stream: enough copies for long_s of the host's work.
    host_wall = statistics.median(r["wall_s"] for r in own
                                  if r["backend"] == "host")
    n = copies or max(2, math.ceil(long_s / host_wall))
    log(f"  {cfg.name} long stream: {n} copies ({n * cfg.targets} targets, "
        f"{n * len(text)} bytes)")
    for b in ("host", "auto", "auto", "host"):
        run("long", b, n)
    sums.append(dict(summary(cfg.name, [r for r in runs
                                        if r["stream"] == "long"], "long"),
                     copies=n))
    for s in sums:
        print(json.dumps(s), flush=True)
    return runs, sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pbdagcon_tpu_torch.tools.auto_turns",
        description="--backend auto beside cuda and host, in turns, on the "
                    "benchmark's configurations: their own streams and "
                    "long replays of them.")
    ap.add_argument("--config", action="append", choices=sorted(C.CONFIGS),
                    help="this configuration (repeatable; default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--long-s", type=float, default=60.0,
                    help="seconds of the host engine's work in the long "
                         "stream (from the own stream's host wall)")
    ap.add_argument("--copies", type=int,
                    help="copies in the long stream (overrides --long-s)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="each configuration at the CPU test's size")
    a = ap.parse_args(argv)

    import torch

    from pbdagcon_tpu_torch import native
    from pbdagcon_tpu_torch.bench.run import card

    if a.device == "cuda" and not torch.cuda.is_available():
        log("auto_turns: no CUDA card (torch.cuda.is_available() is false)")
        return 2
    device = torch.device(a.device)
    if not native.ensure_built():
        log("auto_turns: the native engine failed to build")
        return 1
    dev = card(device)
    log(f"auto_turns: {dev['nvidia_smi']} ({dev['kind']})")
    if device.type == "cuda":
        # The kernels the paths launch, built as a user's earlier runs
        # left them on disk; a run's first device chunk still pays the
        # process's first use of them.
        from concurrent.futures import ThreadPoolExecutor

        from pbdagcon_tpu_torch.ops import _build

        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(_build.build, ("dp_scan", "hist_scatter")))
        log(f"auto_turns: kernels built in {time.perf_counter() - t0:.1f} s")
    sums = []
    for name in a.config or list(C.CONFIGS):
        cfg = C.CONFIGS[name]
        _runs, s = turns(C.tiny(cfg) if a.tiny else cfg, a.seed, device,
                         a.rounds, a.long_s, a.copies)
        sums += s
    print(json.dumps({"ok": True, "card": dev, "summaries": sums}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
