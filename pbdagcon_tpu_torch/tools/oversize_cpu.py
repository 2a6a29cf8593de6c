"""Where the oversize cell's `cuda` path loses to `host`, measured on the
CPU (ROADMAP C11, step 1).

    python -m pbdagcon_tpu_torch.tools.oversize_cpu [--runs N]

The cell is `chip_smoke.py`'s oversize cell: 64 targets x 8000 bp x 30x,
seed 1234, raw 'pre' records with `-a`, `-c 7 -m 100`, 512 targets a
batch, the default V ladder (every target past it), as many engine
threads as the machine has cores. It goes through the
port's `run_stream` in turns on `cuda` with `--device cpu` (the kernels'
plain versions) and on `host`, each FASTA byte-equal to the single-thread
native engine's; a line gives each run's wall and the `cuda` runs'
`stage_s`, `linearize` against `host`'s wall beside it.

Then the producer's slicing, the engine alone: the input through
`linearize_text` in the producer's 4 MiB slices and in the CLI's
`--chunk-mb` chunks (16 MiB), and through `consensus_text` (what `host`
runs) in both, each timed on the host clock.
"""

from __future__ import annotations

import argparse
import io
import os
import shutil
import sys
import tempfile
import time

SEED = 1234
TARGETS, LENGTH, COVERAGE = 64, 8000, 30
THREADS = os.cpu_count() or 8


def _cell_text(targets: int, length: int, coverage: int) -> bytes:
    from pbdagcon_tpu_torch.simulate import (
        NoiseProfile,
        simulate_targets,
        to_pre_raw,
    )

    lines = [to_pre_raw(a) for _t, _b, alns in simulate_targets(
        SEED, targets, length, coverage, NoiseProfile()) for a in alns]
    return ("\n".join(lines) + "\n").encode()


def _slices(data: bytes, size: int):
    views = [data[o:o + size] for o in range(0, len(data), size)]
    return [(v, False) for v in views] + [(b"", True)]


def _engine_split(data: bytes, threads: int, mw: int) -> dict:
    """Host-clock seconds of the engine's linearize and consensus over the
    input cut into 4 MiB slices and into 16 MiB chunks."""
    from pbdagcon_tpu_torch import native

    out = {}
    for name, size in (("4MiB", 4 << 20), ("16MiB", 16 << 20)):
        with native.NativeEngine(min_weight=mw, min_length=100,
                                 threads=threads, align=True) as eng:
            t0 = time.perf_counter()
            n = 0
            for piece, flush in _slices(data, size):
                n += eng.linearize_text(piece, fmt="pre", flush=flush)
            out[f"linearize {name}"] = (time.perf_counter() - t0, n)
        with native.NativeEngine(min_weight=mw, min_length=100,
                                 threads=threads, align=True) as eng:
            t0 = time.perf_counter()
            for piece, flush in _slices(data, size):
                eng.consensus_text(piece, fmt="pre", flush=flush)
            out[f"consensus {name}"] = (time.perf_counter() - t0,
                                        eng.targets_done)
    return out


def main(argv=None) -> int:
    from pbdagcon_tpu_torch import native
    from pbdagcon_tpu_torch.config import DagconConfig
    from pbdagcon_tpu_torch.io import FastaWriter
    from pbdagcon_tpu_torch.pipeline import run_stream

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    a = ap.parse_args(argv)
    if not native.ensure_built():
        print("oversize_cpu: the native engine failed to build",
              file=sys.stderr)
        return 1
    mw = max(2, COVERAGE // 4)
    data = _cell_text(TARGETS, LENGTH, COVERAGE)
    work = tempfile.mkdtemp(prefix="oversize_cpu_")
    try:
        path = os.path.join(work, "cell.pre")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.time()
        with native.NativeEngine(min_weight=mw, min_length=100, threads=1,
                                 align=True) as eng:
            want = eng.consensus_text(data, fmt="pre")
        one_core = time.time() - t0
        bases = sum(len(l) for l in want.splitlines() if not l.startswith(">"))
        print(f"oversize cell: {TARGETS} targets x {LENGTH} bp x "
              f"{COVERAGE}x, {len(data) / 1e6:.1f} MB, {bases} consensus "
              f"bases; single-thread native engine {one_core:.4f} s; "
              f"{THREADS} threads", flush=True)
        base = DagconConfig(min_weight=mw, min_length=100, threads=THREADS,
                            align=True, fmt="pre", device="cpu",
                            batch_targets=512)
        cfgs = {"cuda": DagconConfig(**{**base.__dict__, "backend": "cuda"}),
                "host": DagconConfig(**{**base.__dict__, "backend": "host"})}
        walls: dict[str, list[float]] = {"cuda": [], "host": []}
        order = ["cuda", "host", "host", "cuda"] * a.runs
        for which in ["cuda", "host"] + order[:2 * a.runs]:
            out = io.StringIO()
            t0 = time.time()
            with open(path) as stream:
                st = run_stream(stream, FastaWriter(out), cfgs[which])
            dt = time.time() - t0
            if out.getvalue() != want:
                print(f"oversize_cpu: {which} FASTA != the single-thread "
                      "native engine's", file=sys.stderr)
                return 1
            walls[which].append(dt)
            stages = ", ".join(f"{k} {v:.4f}" for k, v in st.stage_s.items())
            print(f"  {which}: wall {dt:.4f} s; colshard {st.colshard}, "
                  f"host 'oversize' {st.fallback_reasons.get('oversize', 0)}"
                  f"; stage_s {stages or '-'}", flush=True)
        for k in walls:
            walls[k] = walls[k][1:]  # the first of each is the warm-up
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        print(f"port: cuda (device cpu) {med['cuda']:.4f} s, host "
              f"{med['host']:.4f} s (medians of {a.runs}); cuda / host wall "
              f"{med['cuda'] / med['host']:.4f}; b/s cuda "
              f"{bases / med['cuda']:.1f}, host {bases / med['host']:.1f}",
              flush=True)
        for name, (s, n) in _engine_split(data, THREADS, mw).items():
            print(f"engine alone, {name}: {s:.4f} s ({n} targets)",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
