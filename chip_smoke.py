#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`pbdagcon_tpu_torch`) on one
CUDA card: `python3 chip_smoke.py` from the root of a checkout.

Phases, in order; any failure exits non-zero before the last line:

1. Require CUDA, print the card's name and power limit, build the native
   engine (`make -C native`) and the kernels (`csrc/dp_scan.cu`,
   `csrc/hist_scatter.cu`, `csrc/pk_variants.cu`, `csrc/align_scan.cu`,
   `csrc/dp_blocked.cu`: one nvcc each, started together, sm_90a).
2. Hold the DP kernel against its plain PyTorch version on the card,
   bitwise (0 ulp): random arena batches over W in {16,32,64,128} x K in
   {8,32,128} (B not a multiple of 32, long edges, unsup nodes, -1 gaps;
   V = 700, so the exit/cov/unsup rows miss 16-byte alignment), aligned
   ones (V = 512), the scan order's edge cases (`ops.dp.edge_batches`),
   then one real batch of the bench workload from the native packer,
   where both are timed with CUDA events beside the bound, with the rows
   the kernel scans and its cycles per row.
3. The native-loader path at full size: the bench workload (512 targets
   x 1000 bp x 30x, seed 1234, raw 'pre' records, -a host aligner)
   through `pipeline.run_stream` with backend "cuda", once, under
   torch.profiler (the device's busy time against the wall). The FASTA
   must be byte-equal to the single-thread native engine's, and the DP
   kernel's launch count over the run must be > 0.
4. Hold the histogram and scatter kernels against their plain versions
   on the card, integer-equal: random cases on every route their launch
   plans choose (one CTA per row; clusters of 2-16 CTAs, past one
   CTA's shared memory up to D = 929,792; global), each without and
   with a valid mask (B not a multiple of 8, -1 and out-of-range values
   and ranks, hot bins, negative and over-wide payloads, 1-4-byte cuts,
   repeated ranks, clusters forced on small domains), then every hist
   and scatter call of one bench window's device build, captured from
   the build with its valid masks and held in both forms: as the build
   makes it (masked) and with the mask folded into the values
   (pre-masked, the form the earlier kernels took). Each form's window is
   captured in a CUDA graph whose node count (one kernel node per call,
   no memset node) is printed and checked, then timed (kernel
   pre-masked and masked, plain and one `scatter_add_` per output as
   the library yardstick, in turns, replayed from CUDA graphs) with
   CUDA events, then each call alone (pre-masked) with its plan and
   bound; the
   window's DP call, captured too, is held bitwise and timed.
4b. The kernel-variant microbench's kernels P1-P3 (`hist_v1`, `hist_v2`,
   `pallas_scatter`) against their plain versions, integer-equal: random
   cases, every route of P2 and P3 (P3 in one tile and in 3 to 6 tiles,
   1 to 4 payloads; P2 staged and on the ring; every N mod 4, rows on
   and off a 16-byte boundary), the microbench's shapes and every
   hist/scatter call of the bench window from phase 4 (each where the
   kernel takes the shape),
   timed per window beside B2/B3 and the plain versions (the window's
   calls replayed from a CUDA graph: device time); then the
   microbench itself (`pbdagcon_tpu_torch.tools.prof_pk`) once at full
   size, whose lines must agree and whose run must launch all three.
5. The devbuild path at full size: the bench workload through
   `pipeline.run_stream` with backend "devbuild" (batch_targets=128),
   once; the FASTA byte-equal to the single-thread native engine's, and
   the launches of hist, scatter and dp_scan over the run each > 0.
   Prints the host fallbacks by reason and the stages' host-clock
   seconds.
7. Kernel X1 (`csrc/align_scan.cu`: the aligner's scan, traceback and
   replay) against its plain versions, array-equal on the packed
   pointers, the moves and the gapped rows with their path lengths (the
   replay on every case below, and on the random pointers' moves over
   random bases): the scan on both routes (`align_cuda.scan_plan`: "warp",
   a warp per pair, and "cta"; "cta" only where the spans outgrow a
   warp) and the traceback on both of its routes
   (`align_cuda.traceback_plan`: "warp", a warp per pair over staged
   windows, and "thread") on random pairs (B = 77), length skew
   (Wa > 1024: "cta"), identical sequences of lengths 1-2000, the warp
   route's edge cases (spans at every CPL class edge, length-1 and
   short pairs), the traceback also on random pointer tensors (default
   and tiny windows, L cut to 37), then the first 1024 raw records of
   the bench workload, where both kernels are timed with CUDA events
   beside the bound (bytes or int32 operations, whichever is larger)
   and the plain versions, each with its routes in turns (cta, warp,
   warp, cta; thread, warp, warp, thread), and the traceback also on
   the batch's first 32 pairs (dazcon's rung); the replay in turns with
   its plain version (plain, kernel, kernel, plain; the kernel from a
   CUDA graph of 20 calls) beside its byte bound; then `align_batch`'s
   host clock on that batch in three parts (prepare; scan, traceback and
   replay; fetch and decode), three times.
8. The `-a` device path at full width: the bench workload through
   `run_stream` (cuda backend, align_backend "device") once, then with
   the host aligner once (no X1 launch), each FASTA byte-equal to the
   single-thread native engine, the align and dp_scan launches > 0, the
   stage seconds.
9. The frontends: M4 overlaps + reads at the bench scale through
   `hgap.run_hgap` and the `-a` device path (byte-equal to the native
   engine on the same 'pre'), then `dazcon.run_dazcon` on the card over
   64 targets (X1 and dp_scan launched; its first 16 targets byte-equal
   to device="cpu").
10. The hybrid scheduler on the bench workload: forced device pulls
   (device chunks, hist, scatter and dp_scan launches > 0), defaults,
   and no probe deferral; each FASTA byte-equal, the chunk split, b/s
   and the device worker's first-use warmup printed. Then the default
   backend, "auto", there: the hybrid scheduler (host chunks > 0), and
   with DAGCON_AUTO_HYBRID=0 the batched DP (dp_scan launches, no
   hybrid chunk). Then a long stream past the probe deferral: the bench
   workload replayed with fresh target ids (`tools/auto_turns.py`'s
   `ReplayStream`, a copy at a time) for about LONG_S s of the host
   engine's work, "host" then "auto": both byte-equal to the 1-thread
   engine (its FASTA of one copy with each copy's ids, a rule held first
   on two copies of 32 targets), the auto run with device chunks and
   dp_scan, hist and scatter launches > 0; the auto/host ratio printed
   beside the reference's 0.9 guard, not gated.
11. Kernel X2 (`csrc/dp_blocked.cu`: the blocked max-plus solve's
   compose, propagate and fill) against its plain versions: each
   kernel's output integer-equal (the compose, the propagate and the
   fill on their planned routes, "column", "warp" and "lane", and on the
   forced first designs, "cta", "cta" and "reduce"),
   the Kleene-iterated scores bitwise and the flags equal, the unflagged
   rows bitwise equal to B1's, on random batches (W 16-128, long edges),
   the bench batch and one target of the oversize workload (64 targets
   x 8000 bp x 30x, seed 1234, raw 'pre' with -a: every target past the
   top V bucket); the kernels timed with CUDA events in turns with their
   plain phases, and each in turns with its first design (the fill also
   replayed from CUDA graphs, with its chain's ns a step), beside B1 on
   the bench batch, with the Kleene loop of `blocked` (its solves and
   host checks) on that batch. Then the oversize cell
   through `run_stream` on "cuda" (the one-card colshard) once, FASTA
   byte-equal to the single-thread native engine, colshard targets and
   X2 launches > 0, every compose, propagate and fill at W 16 and 32 on
   the new routes (by `route_widths`); then `backend="blocked"` on the
   bench cell once, byte-equal, with its flagged rows and launches.
12. The multi-device modes: the bench batch through
   `parallel.mesh.dp_scores_sharded` on meshes of one and two slots of
   the card (B1 once a slot), bitwise equal to one B1 call, timed in
   turns; every colshard target of the oversize cell through the
   colshard's ring (`parallel.colshard`) at 2 and 4 slots of the card,
   integer-equal to one slot and to the plain version on the CPU, with
   X2's launches and the hops counted; then two CLI ranks
   (`--distributed`, gloo on localhost) sharing the card on the bench
   workload, on `--backend cuda -a` and on `--backend host` (the ranks
   detach), each merged FASTA byte-equal to the single-process CLI run
   and to the single-thread native engine.
13. BASELINE.json configs #3 and #5 through the port's tools: config #3
   (64 targets x 1000 bp, gapped M5 without -a, `-c cov // 4`) at 200x
   and at 100x through `tools.bench_highdepth` on "cuda" and "devbuild",
   one run each (each FASTA byte-equal to the single-thread native engine, host
   fallbacks by reason, the shape rungs; at 100x devbuild takes an R rung
   above 64, B1-B3 launched there), every hist, scatter and DP call of
   the 100x window held against its plain version, and the execute-only
   step rate at 100x; then `tools.soak_stream` on `--backend cuda`
   (killed and resumed with `--journal`: complete and exactly once; a
   stream this short has no steady window, so the RSS bound is judged
   only by the tool's own longer runs) and `tools.soak_multirank` with
   two `--backend cuda` ranks on
   the card (rank 1 killed and resumed; the survivor's exit code), each
   a subprocess that exits non-zero on any failed check.

The end-to-end rates of these paths are the benchmark's
(`python -m pbdagcon_tpu_torch.bench`): this script runs each route once
for exactness. It counts bytes and operations and reads traces with the
benchmark's own code (`bench/roofline.py`, `bench/trace.py`).

Each phase's own seconds are printed on a line of its own ("phase N:
S s") as it ends. Then a JSON line of kernels (each with its launches
on the main paths, max_abs_err, ms, plain_ms, bound_ms, bound_by and
library_ms; hist and scatter also with their masked window and their
per-call readings; blocked_compose and blocked_propagate with their
planned route, the "cta" route's ms and their launches by route and W,
blocked_fill with its planned route, the "reduce" route's ms, both
routes' graph-replayed ms and chain figure, and its launches by route
and W;
dp_scan and X2's three with their launches on phase 12's paths ("sharded",
"ring"), the sharded DP's turns and the ring's hops and times; dp_scan,
hist and scatter with their launches on phase 13's ("highdepth",
"soak") and on phase 10's "auto" runs ("auto_bench": the bench workload;
"hybrid_long": the long stream), dp_scan with config #3's readings, hist
and scatter with the 100x window's;
align_scan with its route and the "cta" route's
ms, align_traceback with its route, the "thread" route's ms, the chain
figure (the longest path's steps, ns a step) and the B = 32 call,
align_replay with its eager ms), and the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import random
import shutil
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 1234
TARGETS, LENGTH, COVERAGE = 512, 1000, 30
GRID_B, GRID_V = 37, 700
DEVBUILD_BATCH = 128  # bench.py's batch_targets for the devbuild path
KERNEL_SOURCES = ("dp_scan", "hist_scatter", "pk_variants", "align_scan",
                  "dp_blocked")
# The oversize cell (phase 11): every target past the top V bucket.
OVERSIZE_TARGETS, OVERSIZE_LENGTH = 64, 8000
# Phase 10's long stream: about this many seconds of the host engine's
# work (the bench workload replayed with fresh target ids).
LONG_S = 40
# The hybrid run of phase 10 in a fresh process with an empty kernel
# build directory (argv: that directory, the config's knobs as JSON):
# prints one JSON line [cold, warm] of the two runs' device statistics.
COLD_HYBRID = r"""
import dataclasses, io, json, os, sys, time
from pbdagcon_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
build_s, _nvcc_build = [0.0], _build.build
def _timed_build(name, defines=()):
    t0 = time.time()
    try:
        return _nvcc_build(name, defines)
    finally:
        build_s[0] += time.time() - t0
_build.build = _timed_build
from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter
from pbdagcon_tpu_torch.pipeline import run_stream
knobs = json.loads(sys.argv[2])
cfg = DagconConfig(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in knobs.items()})
text = open(os.path.join(sys.argv[1], "input.pre"), "rb").read()
with native.NativeEngine(min_weight=cfg.min_weight, min_length=cfg.min_length,
                         threads=cfg.threads, align=True) as eng:
    want = eng.consensus_text(text, fmt="pre")
runs = []
for _ in range(2):
    out = io.StringIO()
    t0 = time.time()
    st = run_stream(io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg)
    runs.append({
        "wall": time.time() - t0, "fasta_ok": out.getvalue() == want,
        "first_s": st.hybrid_dev_first_s, "first_bytes": st.hybrid_dev_first_bytes,
        "dev_busy_s": st.hybrid_dev_busy_s - st.hybrid_dev_first_s,
        "dev_bytes": st.hybrid_dev_bytes - st.hybrid_dev_first_bytes,
        "dev_chunks": st.hybrid_dev_chunks, "host_chunks": st.hybrid_host_chunks,
        "build_s": 0.0,
    })
runs[0]["build_s"] = build_s[0]
print(json.dumps(runs))
"""


def log(*a) -> None:
    print(*a, flush=True)


_PHASE = {"name": None, "t0": 0.0}


def phase(name) -> None:
    """Print the seconds of the phase that ends here, on a line of its
    own, and start the next one (None: the last one ended)."""
    now = time.time()
    if _PHASE["name"] is not None:
        log(f"phase {_PHASE['name']}: {now - _PHASE['t0']:.1f} s")
    _PHASE.update(name=name, t0=now)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def bitwise_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    )


def max_abs_err(a, b) -> float:
    """Largest |a - b|; 0 where both are the same infinity, inf where
    only one is infinite."""
    import torch

    same = a == b
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import numpy as np
    import torch

    phase("1")
    # ---- phase 1: the card and the native engine ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    from pbdagcon_tpu_torch import (
        FastaWriter,
        NoiseProfile,
        simulate_targets,
        to_pre_raw,
    )
    from pbdagcon_tpu_torch import native
    from pbdagcon_tpu_torch.bench import roofline
    from pbdagcon_tpu_torch.bench.roofline import bound_ms
    from pbdagcon_tpu_torch.bench.trace import trace_report
    from pbdagcon_tpu_torch.config import DagconConfig
    from pbdagcon_tpu_torch.ops import _build, dp_cuda
    from pbdagcon_tpu_torch.ops.dp import (
        dp_scores_reference,
        edge_batches,
        random_batch,
        start_rows,
        to_arena,
        unpack_arena,
    )
    from pbdagcon_tpu_torch.pipeline import _choose_layout_native, run_stream
    from pbdagcon_tpu_torch.tools.cuda_graph import graph_ms

    t = time.time()
    if not native.ensure_built():
        raise SystemExit("chip_smoke: the native engine failed to build")
    log(f"native engine ready in {time.time() - t:.1f}s")

    t = time.time()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(_build.build, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        _build.load(name)
    log(f"kernels {', '.join(KERNEL_SOURCES)} built in {time.time() - t:.1f}s")
    for name in KERNEL_SOURCES:
        for line in _build.build_logs.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "wgmma", "Performance", "entry")):
                log(f"  ptxas {name}: {line.strip()}")

    phase("2")
    # ---- phase 2: DP kernel vs plain version, bitwise ----
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    worst = 0.0

    def hold_dp(batch, what) -> None:
        nonlocal worst
        B, V, W = batch["win_count"].shape
        K = batch["long_u"].shape[1]
        args = unpack_arena(torch.from_numpy(to_arena(batch)).to(dev),
                            B, V, W, K)
        got = dp_cuda.dp_scores_cuda(*args)
        want = dp_scores_reference(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        ok = bitwise_equal(got, want)
        log(f"{what} B={B} V={V} W={W:3d} K={K:3d}: "
            f"bitwise {'OK' if ok else 'MISMATCH'} max_abs_err={err}")
        if not ok:
            raise SystemExit("chip_smoke: kernel != plain version")

    for W in (16, 32, 64, 128):
        for K in (8, 32, 128):
            hold_dp(random_batch(rng, GRID_B, GRID_V, W, K), "grid")
    for W, K in ((16, 32), (48, 32)):
        hold_dp(random_batch(rng, GRID_B, 512, W, K), "aligned rows")
    for W, K, V in ((16, 32, 301), (48, 8, 129), (128, 128, 203)):
        for name, batch in edge_batches(rng, GRID_B, V, W, K).items():
            hold_dp(batch, f"edge case {name}")

    # The bench workload (as bench.py makes it).
    t = time.time()
    lines: list[str] = []
    for _tid, _bb, alns in simulate_targets(
        SEED, TARGETS, LENGTH, COVERAGE, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()
    log(f"workload: {TARGETS} targets x {LENGTH} bp x {COVERAGE}x, "
        f"{len(text) / 1e6:.1f} MB in {time.time() - t:.1f}s")
    threads = os.cpu_count() or 8
    min_weight = max(2, COVERAGE // 4)
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as probe:
        cnt = probe.linearize_text(
            "\n".join(lines[: 12 * COVERAGE]).encode() + b"\n", fmt="pre"
        )
        max_n = int(probe.metas(cnt)[:, 0].max())
    v_bucket = -(-int(max_n * 1.3) // 256) * 256
    cfg = DagconConfig(
        min_weight=min_weight, min_length=100, threads=threads,
        backend="cuda", device="cuda", batch_targets=TARGETS, fmt="pre",
        align=True, v_buckets=(v_bucket,), w_buckets=(16, 32, 64),
    )

    # One real bench batch from the packer.
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as eng:
        cnt = eng.linearize_text(text, fmt="pre")
        ns = eng.metas(cnt)[:, 0]
        idxs = [i for i in range(cnt) if ns[i] <= v_bucket]
        W, K, outliers = _choose_layout_native(eng, idxs, cfg)
        idxs = [i for i in idxs if i not in outliers]
        batch = native.pack_batch(eng, idxs, v_bucket, W, K, pin_memory=True)
    B, V, W, K = batch["_dims"]
    args = unpack_arena(batch["_arena"].to(dev), B, V, W, K)
    got = dp_cuda.dp_scores_cuda(*args)
    want = dp_scores_reference(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    worst = max(worst, err)
    ok = bitwise_equal(got, want)
    log(f"bench batch B={B} V={V} W={W} K={K}: bitwise "
        f"{'OK' if ok else 'MISMATCH'} max_abs_err={err}")
    if not ok:
        raise SystemExit("chip_smoke: kernel != plain version (bench batch)")
    # In turns (plain, kernel, kernel, plain); the band (B*V*W int16)
    # outgrows the 50 MB L2, so each launch reads it from device memory.
    plain_a = time_ms(lambda: dp_scores_reference(*args), 2)
    kernel_a = time_ms(lambda: dp_cuda.dp_scores_cuda(*args), 20)
    kernel_b = time_ms(lambda: dp_cuda.dp_scores_cuda(*args), 20)
    plain_b = time_ms(lambda: dp_scores_reference(*args), 2)
    kernel_ms = (kernel_a + kernel_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    # The bound: the rows each target's scan needs read once, the long
    # edges read once and the scores written once.
    top = start_rows(args[0], args[1], args[4])
    dp_work = roofline.dp_scan(args, got, top.cpu())
    dp_bound = dp_work.bound_ms()
    scanned = torch.where(top >= 0, (top // 4 + 1) * 4, 0)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    log(f"dp_scan at B={B} V={V} W={W} K={K}: kernel {kernel_a} / "
        f"{kernel_b} ms, plain PyTorch {plain_a} / {plain_b} ms, bound "
        f"{dp_bound} ms ({dp_work.bytes} bytes) [{card}]")
    log(f"dp_scan rows scanned: {int(scanned.sum())} of {B * V} (longest "
        f"target {int(scanned.max())}); {kernel_ms * 1e-3 * clock_mhz * 1e6 / int(scanned.max())} "
        f"cycles per row of the longest target at the {clock_mhz} MHz max "
        f"SM clock")
    del args, got, want, batch

    phase("3")
    # ---- phase 3: the native-loader path at full size ----
    # One run, under torch.profiler (the device's busy time against the
    # wall); the benchmark (`python -m pbdagcon_tpu_torch.bench`) times it.
    from torch.profiler import ProfilerActivity, profile

    def run_port():
        out = io.StringIO()
        t0 = time.time()
        stats = run_stream(
            io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg
        )
        torch.cuda.synchronize()
        return time.time() - t0, stats, out.getvalue()

    dp_cuda.launches = 0
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        run_dt, stats, fasta = run_port()
    launches = dp_cuda.launches
    bases = sum(len(l) for l in fasta.splitlines() if not l.startswith(">"))

    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=1, align=True
    ) as eng:
        fasta_host = eng.consensus_text(text, fmt="pre")
    if fasta != fasta_host:
        raise SystemExit("chip_smoke: port FASTA != single-core C++ FASTA")
    if bases == 0 or stats.targets != TARGETS:
        raise SystemExit(f"chip_smoke: bad run: {stats}")
    if launches == 0:
        raise SystemExit("chip_smoke: the main path never launched dp_scan")
    log(f"main path: targets={stats.targets} batches={stats.batches} "
        f"consensus_bases={bases} host_fallbacks={stats.host_fallbacks} "
        f"dp_scan launches={launches}; FASTA byte-equal to the "
        f"single-thread native engine [{card}]")
    if stats.host_fallbacks:
        log(f"host fallbacks by reason: {stats.fallback_reasons}")
    stages = ", ".join(f"{k} {v:.4f}" for k, v in stats.stage_s.items())
    log(f"host-clock seconds by stage (wall {run_dt:.4f}): {stages}")
    trace_report("traced run", prof, run_dt, card, top=6, log=log)

    cuda_path_launches = launches

    phase("4")
    # ---- phase 4: hist and scatter kernels vs plain versions ----
    from pbdagcon_tpu_torch.ops import mxu, mxu_cuda

    def int_err(a, b) -> int:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    worst_k = {"hist": 0, "scatter": 0}
    rng = np.random.default_rng(SEED + 2)

    # Random cases on every route the plans choose (one CTA per row;
    # clusters of 2, 5 and 16 CTAs; global), each unmasked and masked,
    # then clusters of 4 and 8 forced on small domains with hot bins.
    for B, N, D, cs in ((3, 700, 257, None), (37, 41000, 15000, None),
                        (5, 5000, 60000, None), (129, 100, 8, None),
                        (300, 100, 50, None), (7, 20000, 245000, None),
                        (3, 9000, 929_792, None), (2, 100, 1_000_000, None),
                        (5, 3000, 300, 4), (3, 40000, 64, 8)):
        plan = (mxu_cuda.hist_plan(B, N, D) if cs is None
                else mxu_cuda.cluster_plan(N, D, 1, cs))
        for masked in (False, True):
            vn = rng.integers(-3, D + 5, (B, N)).astype(np.int32)
            vn[:, ::5] = D - 1
            v = torch.from_numpy(vn).to(dev)
            valid = (torch.from_numpy(rng.random((B, N)) < 0.8).to(dev)
                     if masked else None)
            got = mxu_cuda.hist_cuda(v, valid, D, plan=plan)
            want = mxu.hist_reference(v, valid, D)
            ok = torch.equal(got, want)
            worst_k["hist"] = max(worst_k["hist"], int_err(got, want))
            log(f"hist B={B} N={N} D={D} masked={masked} "
                f"[{plan.describe()}]: {'equal' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit("chip_smoke: hist kernel != plain version")
    for B, N, D, nb, NP, rep, cs in (
            (3, 700, 800, 1, 2, False, None), (37, 5000, 5000, 2, 2, False, None),
            (5, 40000, 4000, 4, 2, True, None), (11, 3000, 300, 3, 2, True, None),
            (128, 6144, 78848, 4, 2, False, None),
            (7, 30000, 70001, 2, 1, True, None), (6, 20000, 60000, 4, 4, False, None),
            (2, 40000, 4000, 3, 4, True, None), (128, 64, 2052, 4, 1, True, None),
            (5, 3001, 300, 3, 3, True, 2), (3, 40000, 64, 4, 2, True, 8)):
        plan = (mxu_cuda.scatter_plan(B, N, D, NP) if cs is None
                else mxu_cuda.cluster_plan(N, D, NP, cs))
        for masked in (False, True):
            r = (rng.integers(-3, D + 5, (B, N)) if rep else
                 np.stack([rng.permutation(D + 5)[:N] for _ in range(B)]) - 2)
            r = torch.from_numpy(r.astype(np.int32)).to(dev)
            valid = (torch.from_numpy(rng.random((B, N)) < 0.8).to(dev)
                     if masked else None)
            ps = tuple(torch.from_numpy(rng.integers(
                -(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)).to(dev)
                for _ in range(NP))
            mask = (1 << (8 * nb)) - 1
            pairs = list(zip(mxu_cuda.scatter_cuda(r, valid, ps, D, mask, plan=plan),
                             mxu.scatter_reference(r, valid, ps, D, mask)))
            ok = all(torch.equal(a, b) for a, b in pairs)
            worst_k["scatter"] = max([worst_k["scatter"]]
                                     + [int_err(a, b) for a, b in pairs])
            log(f"scatter B={B} N={N} D={D} nbytes={nb} NP={NP} repeated={rep} "
                f"masked={masked} [{plan.describe()}]: "
                f"{'equal' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit("chip_smoke: scatter kernel != plain version")

    # Every hist/scatter call and the DP call of one bench window's
    # build, captured with the valid mask the build passes.
    from pbdagcon_tpu_torch.tools.bins_ablate import call_shape, capture_window

    real_hist, real_scatter = mxu_cuda.hist_cuda, mxu_cuda.scatter_cuda
    real_dp = dp_cuda.dp_scores_cuda
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as eng:
        cnt = eng.encode_text(text, fmt="pre")
        calls, caps, n_window = capture_window(eng, DEVBUILD_BATCH,
                                               min_weight, dev)
    log(f"bench window caps: {caps} ({cnt} targets encoded, window of "
        f"{n_window})")

    # The window's DP call: bitwise, then timed in turns.
    (dp_args,) = calls.pop("dp")
    got, want = real_dp(*dp_args), dp_scores_reference(*dp_args)
    torch.cuda.synchronize()
    worst = max(worst, max_abs_err(got, want))
    if not bitwise_equal(got, want):
        raise SystemExit("chip_smoke: kernel != plain version (devbuild call)")
    dpw_pa = time_ms(lambda: dp_scores_reference(*dp_args), 1)
    dpw_ka = time_ms(lambda: real_dp(*dp_args), 20)
    dpw_kb = time_ms(lambda: real_dp(*dp_args), 20)
    dpw_pb = time_ms(lambda: dp_scores_reference(*dp_args), 1)
    dpw_bound = roofline.dp_scan(
        dp_args, got, start_rows(dp_args[0], dp_args[1], dp_args[4]).cpu()
    ).bound_ms()
    dB, dV, dW = dp_args[0].shape
    log(f"dp_scan devbuild window call B={dB} V={dV} W={dW} "
        f"K={dp_args[4].shape[1]}: bitwise OK; kernel {dpw_ka} / {dpw_kb} "
        f"ms, plain PyTorch {dpw_pa} / {dpw_pb} ms, bound {dpw_bound} ms "
        f"[{card}]")
    del dp_args, got, want

    # Each call also in the pre-masked form (`valid` folded into the
    # values as -1, valid=None): the form the earlier kernels took, whose
    # window times PERF.md holds.
    def premask(c):
        v = c[0] if c[1] is None else torch.where(c[1], c[0], -1)
        return (v, None, *c[2:])

    masked_calls = calls
    calls = {k: [premask(c) for c in cs] for k, cs in masked_calls.items()}

    def run_calls(fn, cs):
        for c in cs:
            fn(*c)

    # The library yardstick: one `scatter_add_` per output (into a zeroed
    # [B, D + 1] int32 tensor, the last column taking what is dropped),
    # with its indices and ones or cut payloads made here, outside the
    # timed region. The port never calls it.
    def lib_hist_prep(cs):
        out = []
        for values, _valid, D in cs:
            ok = (values >= 0) & (values < D)
            out.append((torch.where(ok, values, D).long(),
                        torch.ones_like(values), D))
        return out

    def lib_scatter_prep(cs):
        out = []
        for ranks, _valid, payloads, D, mask in cs:
            ok = (ranks >= 0) & (ranks < D)
            idx = torch.where(ok, ranks, D).long()
            for p in payloads:
                out.append((idx, torch.where(ok, p.long() & mask, 0).int(), D))
        return out

    def run_lib(prep):
        for idx, src, D in prep:
            torch.zeros((idx.shape[0], D + 1), dtype=torch.int32,
                        device=dev).scatter_add_(1, idx, src)

    def window_bytes(op, cs) -> int:
        """Each call's inputs read once (the valid bytes where a call
        has them) and outputs written once."""
        if op == "hist":
            return sum(roofline.hist(v, m, D).bytes for v, m, D in cs)
        return sum(roofline.scatter(r, m, ps, D).bytes
                   for r, m, ps, D, _ in cs)

    def graph_nodes(fn) -> dict:
        """Node types of `fn` captured in a CUDA graph."""
        from pbdagcon_tpu_torch.tools.cuda_graph import node_counts

        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            fn()
        return node_counts(g.raw_cuda_graph())

    lib_prep = {"hist": lib_hist_prep, "scatter": lib_scatter_prep}
    plain = {"hist": mxu.hist_reference, "scatter": mxu.scatter_reference}
    real = {"hist": real_hist, "scatter": real_scatter}
    timed, window_masked, per_call = {}, {}, {}
    for name in ("hist", "scatter"):
        for form in (calls[name], masked_calls[name]):
            for c in form:
                if name == "hist":
                    pairs = [(real_hist(*c), mxu.hist_reference(*c))]
                else:
                    pairs = list(zip(real_scatter(*c), mxu.scatter_reference(*c)))
                ok = all(torch.equal(a, b) for a, b in pairs)
                worst_k[name] = max([worst_k[name]]
                                    + [int_err(a, b) for a, b in pairs])
                if not ok:
                    raise SystemExit(f"chip_smoke: {name} kernel != plain "
                                     f"version on a bench window call")
        for label, form in (("pre-masked", calls[name]),
                            ("masked", masked_calls[name])):
            nodes = graph_nodes(lambda f=form: run_calls(real[name], f))
            log(f"{name} window graph ({label}): nodes {nodes} for "
                f"{len(form)} calls")
            if nodes.get("memset") or nodes.get("kernel") != len(form):
                raise SystemExit(f"chip_smoke: {name} window is not one kernel "
                                 f"node per call: {nodes}")
        # In turns (plain, kernel, masked, library, library, masked, kernel,
        # plain); device ms for all the window's calls, replayed from a
        # CUDA graph (an eager loop would time the host's launches).
        prep = lib_prep[name](calls[name])
        runs = {
            "plain": lambda: run_calls(plain[name], calls[name]),
            "kernel": lambda: run_calls(real[name], calls[name]),
            "masked": lambda: run_calls(real[name], masked_calls[name]),
            "library": lambda: run_lib(prep),
        }
        ms = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            ms[k].append(graph_ms(runs[k], 20))
        avg = {k: sum(v) / 2 for k, v in ms.items()}
        timed[name] = (avg["kernel"], avg["plain"], avg["library"],
                       bound_ms(window_bytes(name, calls[name])))
        window_masked[name] = {
            "ms": avg["masked"],
            "bound_ms": bound_ms(window_bytes(name, masked_calls[name])),
        }
        shapes = sorted({call_shape(name, c) for c in calls[name]})
        log(f"{name}: {len(calls[name])} calls per bench window (B, N, D, "
            f"NP in {shapes}), all equal to "
            f"the plain version, pre-masked and masked; device ms per window "
            f"(CUDA graph): " + ", ".join(f"{k} {v[0]} / {v[1]}"
                                         for k, v in ms.items())
            + f"; bound {timed[name][3]} ms (masked "
            f"{window_masked[name]['bound_ms']} ms) [{card}]")
        # Each call alone (pre-masked), 20 copies to a graph: a single
        # call of a few microseconds would read the graph replay's own
        # floor. Other plans: `tools/bins_ablate.py`.
        per_call[name] = []
        for c in calls[name]:
            one = {
                "shape": call_shape(name, c),
                "plan": mxu_cuda.bin_plan(*call_shape(name, c)).describe(),
                "ms": graph_ms(lambda c=c: real[name](*c), 10, copies=20),
                "bound_ms": bound_ms(window_bytes(name, [c])),
            }
            per_call[name].append(one)
            log(f"  {name} call {one['shape']} [{one['plan']}]: kernel "
                f"{one['ms']:.4f} ms (bound {one['bound_ms']:.4f})")

    phase("4b")
    # ---- phase 4b: the microbench's kernels P1-P3 vs plain versions ----
    from pbdagcon_tpu_torch.ops import pk_cuda
    from pbdagcon_tpu_torch.tools import prof_pk

    p_hist = {"hist_v1": pk_cuda.hist_v1_cuda, "hist_v2": pk_cuda.hist_v2_cuda}
    # The variants take no mask: they run on the pre-masked calls.
    p_window = {name: (lambda v, _m, D, f=f: f(v, D)) for name, f in p_hist.items()}
    p_window["pallas_scatter"] = (lambda r, _m, ps, D, mask:
                                  pk_cuda.scatter_tile_cuda(r, ps, D, mask))
    worst_p = {"hist_v1": 0, "hist_v2": 0, "pallas_scatter": 0}

    def takes(name, D) -> bool:
        return name != "hist_v2" or D <= pk_cuda.MAX_ROW_BINS

    def hold(name, pairs, what) -> None:
        worst_p[name] = max([worst_p[name]] + [int_err(a, b) for a, b in pairs])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise SystemExit(f"chip_smoke: {name} kernel != plain version "
                             f"({what})")

    def hold_hist(values, D, what) -> None:
        want = mxu.hist_reference(values, None, D)
        for name, f in p_hist.items():
            if takes(name, D):
                hold(name, [(f(values, D), want)], what)

    def hold_scatter(ranks, payloads, D, mask, what) -> None:
        hold("pallas_scatter", list(zip(
            pk_cuda.scatter_tile_cuda(ranks, payloads, D, mask),
            mxu.scatter_reference(ranks, None, payloads, D, mask))), what)

    rng = np.random.default_rng(SEED + 3)
    # Random cases, P1's hi-width edges (wgmma widths filled and spilled,
    # one full tile of HIST_V1_MAX_WIDTH hi rows and one bin past it; N
    # not a multiple of 4 or 32), then the microbench's shapes (B = 128).
    # Row 0 of each case puts every value in its last bin.
    cap = pk_cuda.HIST_V1_MAX_WIDTH * 128
    for B, N, D in ((3, 700, 257), (37, 41000, 15000), (129, 100, 8),
                    (5, 0, 300), (5, 5000, 48 * 1024), (7, 20000, 245000),
                    (3, 1001, 128), (2, 999, 129), (4, 4099, 1024),
                    (5, 2050, 1025), (3, 5003, cap), (3, 70001, cap + 1),
                    (128, 40960, 1026), (128, 40960, 9234), (128, 6144, 8208)):
        v = rng.integers(-3, D + 300, (B, N)).astype(np.int32)
        v[:, 1::29] = D - 1
        v[0] = D - 1
        hold_hist(torch.from_numpy(v).to(dev), D, f"B={B} N={N} D={D}")
        log(f"hist_v1{'/v2' if takes('hist_v2', D) else ''} B={B} N={N} "
            f"D={D}: equal")
    for B, N, D, nb, NP, rep in (
            (3, 700, 800, 1, 1, False), (37, 5000, 5000, 2, 2, False),
            (5, 40000, 4000, 4, 3, True), (11, 3000, 300, 3, 4, True),
            (7, 30000, 70001, 2, 1, True), (6, 20000, 60000, 4, 4, False),
            (128, 6144, 78848, 4, 2, False), (128, 6144, 5632, 4, 2, True),
            (128, 3072, 12 * 5632, 4, 2, False)):
        r = (rng.integers(-3, D + 5, (B, N)) if rep else
             np.stack([rng.permutation(D + 5)[:N] for _ in range(B)]) - 2)
        ps = tuple(torch.from_numpy(rng.integers(
            -(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)).to(dev)
            for _ in range(NP))
        what = f"B={B} N={N} D={D} nbytes={nb} NP={NP} repeated={rep}"
        hold_scatter(torch.from_numpy(r.astype(np.int32)).to(dev), ps, D,
                     (1 << (8 * nb)) - 1, what)
        log(f"pallas_scatter {what}: equal")
    # Every route of P2 and P3, on rows that start on and off a 16-byte
    # boundary (each array's allocation offset by 0-3 values; odd rows
    # off by N mod 4 more): P3 in one tile and in 3 to 6 tiles (a CTA
    # each) with 1 to 4 payloads, every N mod 4, payload rows misaligned
    # unlike the ranks'; P2 staged and on the ring (rows past one CTA's
    # shared memory). Each launch counts under the JAX tool's name.
    def offset_rows(a, off):
        flat = torch.empty(a.size + off, dtype=torch.int32, device=dev)
        flat[off:] = torch.from_numpy(a.reshape(-1)).to(dev)
        return flat[off:].view(a.shape)

    for B, N, D, NP, offs in (
            (5, 3000, 300, 1, (0, 0)), (3, 3001, 60001, 2, (1, 1, 1)),
            (4, 2042, 40003, 3, (2, 2, 2, 2)),
            (3, 4099, 50000, 4, (3, 3, 3, 3, 3)),
            (5, 1500, 80, 2, (0, 1, 3)), (7, 1021, 41, 1, (3, 0)),
            (2, 20000, 4000, 2, (0, 0, 0)),
            (3, 5003, 1000, 4, (1, 2, 3, 0, 1)),
            (128, 6144, 14364, 2, (1, 1, 1)),
            (2, 3000, 250_000, 1, (1, 2))):
        r = rng.integers(-3, D + 5, (B, N)).astype(np.int32)
        r[:, ::5] = D - 1
        ranks = offset_rows(r, offs[0])
        ps = tuple(offset_rows(rng.integers(
            -(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32), offs[1 + k])
            for k in range(NP))
        plan = pk_cuda.tile_plan(N, D, NP)
        before = pk_cuda.launches["pallas_scatter"]
        what = f"B={B} N={N} D={D} NP={NP} offsets={offs} [{plan.describe()}]"
        hold("pallas_scatter", list(zip(
            pk_cuda.scatter_tile_cuda(ranks, ps, D, 0xFFFFFF),
            mxu.scatter_reference(ranks, None, ps, D, 0xFFFFFF))), what)
        if pk_cuda.launches["pallas_scatter"] != before + 1:
            raise SystemExit(f"chip_smoke: pallas_scatter launch not counted ({what})")
        log(f"pallas_scatter route {what}: equal")
    for N, D, off in ((9000, 700, 0), (9001, 700, 1), (8186, 33, 2),
                      (4095, 1026, 3), (41000, 15000, 1), (70001, 9234, 1),
                      (100_000, 48 * 1024, 2)):
        v = rng.integers(-3, D + 300, (3, N)).astype(np.int32)
        v[0] = D - 1
        values = offset_rows(v, off)
        plan = pk_cuda.hist_row_plan(N, D)
        before = pk_cuda.launches["hist_v2"]
        what = f"N={N} D={D} offset={off} [{plan.describe()}]"
        hold("hist_v2", [(pk_cuda.hist_v2_cuda(values, D),
                          mxu.hist_reference(values, None, D))], what)
        if pk_cuda.launches["hist_v2"] != before + 1:
            raise SystemExit(f"chip_smoke: hist_v2 launch not counted ({what})")
        log(f"hist_v2 route {what}: equal")
    for values, _valid, D in calls["hist"]:
        hold_hist(values, D, "a bench window call")
    for ranks, _valid, payloads, D, mask in calls["scatter"]:
        hold_scatter(ranks, payloads, D, mask, "a bench window call")
    torch.cuda.synchronize()

    # Device ms per bench window (the window's calls replayed from a CUDA
    # graph), in turns (plain, B, P..., P..., B, plain), on the calls that
    # every variant takes.
    hist_calls = [c for c in calls["hist"] if takes("hist_v2", c[2])]
    variants = {
        "hist": (hist_calls, {"plain": mxu.hist_reference, "B2": real_hist,
                              **{k: p_window[k] for k in p_hist}}),
        "scatter": (calls["scatter"], {"plain": mxu.scatter_reference,
                                       "B3": real_scatter,
                                       "pallas_scatter":
                                           p_window["pallas_scatter"]}),
    }
    window_ms = {}
    for op, (cs, fns) in variants.items():
        prep = lib_prep[op](cs)
        runs = {k: (lambda f=f: [f(*c) for c in cs]) for k, f in fns.items()}
        runs["library"] = lambda: run_lib(prep)
        ms = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            ms[k].append(graph_ms(runs[k], 20))
        window_ms.update({k: sum(v) / 2 for k, v in ms.items()
                          if k not in ("B2", "B3", "plain", "library")})
        for k in ("plain", "library"):
            window_ms[f"{op} {k}"] = sum(ms[k]) / 2
        window_ms[f"{op} bound"] = bound_ms(window_bytes(op, cs))
        log(f"{op}: {len(cs)} of {len(calls[op])} bench window calls, all "
            f"equal to the plain version; device ms per window (CUDA graph): "
            + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in ms.items())
            + f" [{card}]")
        for c in cs:  # one reading per call and design
            B_, N_, D_, NP_ = call_shape(op, c)
            plan = (pk_cuda.hist_row_plan(N_, D_) if op == "hist"
                    else pk_cuda.tile_plan(N_, D_, NP_))
            log(f"  {op} B, N, D = {(B_, N_, D_)} [P2/P3 {plan.describe()}]: "
                f"device ms " + ", ".join(
                    f"{k} {graph_ms(lambda f=f, c=c: f(*c), 10, copies=20):.4f}"
                    for k, f in fns.items()))

    # The microbench at full size: the variants' own main path.
    for k in pk_cuda.launches:
        pk_cuda.launches[k] = 0
    prof_ms, disagree = prof_pk.run(dev)
    pk_launches = dict(pk_cuda.launches)
    if disagree or any(v == 0 for v in pk_launches.values()):
        raise SystemExit(f"chip_smoke: the microbench failed (lines of "
                         f"{disagree} disagree; launches {pk_launches})")
    log(f"prof_pk: every shape's lines agree; launches {pk_launches} [{card}]")
    del calls, masked_calls, prep

    phase("5")
    # ---- phase 5: the devbuild path at full size ----
    dcfg = DagconConfig(
        min_weight=min_weight, min_length=100, threads=threads,
        backend="devbuild", device="cuda", batch_targets=DEVBUILD_BATCH,
        fmt="pre", align=True,
    )

    def run_dev():
        out = io.StringIO()
        t0 = time.time()
        stats = run_stream(
            io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), dcfg
        )
        torch.cuda.synchronize()
        return time.time() - t0, stats, out.getvalue()

    dp_cuda.launches = 0
    mxu_cuda.launches.update(hist=0, scatter=0)
    ddt, dstats, dfasta = run_dev()
    dev_launches = {"dp_scan": dp_cuda.launches, **mxu_cuda.launches}
    if dfasta != fasta_host:
        raise SystemExit("chip_smoke: devbuild FASTA != single-core C++ FASTA")
    if dstats.targets != TARGETS or any(v == 0 for v in dev_launches.values()):
        raise SystemExit(f"chip_smoke: devbuild path did not run its kernels "
                         f"({dev_launches}, {dstats})")
    emitted = dstats.targets - dstats.host_fallbacks
    log(f"devbuild path: targets={dstats.targets} batches={dstats.batches} "
        f"launches {dev_launches}; FASTA byte-equal to the single-thread "
        f"native engine [{card}]")
    log(f"devbuild host fallbacks by reason: {dstats.fallback_reasons} "
        f"({dstats.host_fallbacks} of {dstats.targets}; the device emitted "
        f"{emitted / dstats.targets:.4f} of the targets)")
    stages = ", ".join(f"{k} {v:.4f}" for k, v in dstats.stage_s.items())
    log(f"devbuild host-clock seconds by stage (wall {ddt:.4f}): {stages} "
        f"[{card}]")

    phase("7")
    # ---- phase 7: kernel X1 (the device aligner) vs plain versions ----
    from pbdagcon_tpu_torch.aligner import align_pair
    from pbdagcon_tpu_torch.ops import align_cuda, align_tpu
    from pbdagcon_tpu_torch.simulate import random_seq, sample_read

    worst_a = {"align_scan": 0, "align_traceback": 0, "align_replay": 0}

    def x1_args(pairs, B=None):
        """The padded batch of `pairs` on the card, cut to its first B
        rows (the kernels take any B; align_batch pads to the ladder)."""
        p = align_tpu.prepare_batch(pairs)
        B = len(p["m"]) if B is None else B
        return p, [torch.from_numpy(np.ascontiguousarray(p[k][:B])).to(dev)
                   for k in ("qb", "tb_pad", "m", "n", "bw")]

    def hold_replay(moves, qb, tb, m, n, dmin) -> bool:
        """The replay kernel against its plain version on the same moves:
        gq, gt and plen array-equal."""
        got = align_cuda.replay_cuda(moves, qb, tb, m, n, dmin)
        want = align_tpu.replay_plain(moves, qb, tb, m, n, dmin)
        torch.cuda.synchronize()
        worst_a["align_replay"] = max(worst_a["align_replay"], *(
            int_err(g, w) for g, w in zip(got, want)))
        return all(torch.equal(g, w) for g, w in zip(got, want))

    def hold_x1(pairs, what, B=None) -> tuple:
        """Both scan routes where the plan takes the batch ("cta" only
        past a warp's span), each array-equal to the plain version, the
        traceback on both of its routes ("warp", the plan's, and
        "thread"), each array-equal to the plain version, and the replay
        of the moves, array-equal to its plain version."""
        p, args = x1_args(pairs, B)
        M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
        auto = align_cuda.scan_plan(args[2], args[3], args[4], M, Wa, dmin)
        routes = ("warp", "cta") if auto["route"] == "warp" else ("cta",)
        want = align_tpu.align_scan_plain(*args, M, Wa, dmin)
        oks = {}
        for r in routes:
            g = align_cuda.align_scan_cuda(*args, M, Wa, dmin, align_cuda.
                                           scan_plan(args[2], args[3], args[4],
                                                     M, Wa, dmin, route=r))
            torch.cuda.synchronize()
            worst_a["align_scan"] = max(worst_a["align_scan"], int_err(g, want))
            oks[r] = torch.equal(g, want)
            if r == auto["route"]:
                got = g
        if align_cuda.traceback_plan(args[2], args[3], M, Wa, L)[
                "route"] != "warp":
            raise SystemExit(f"chip_smoke: the traceback plan did not take "
                             f"the warp route ({what})")
        mv_want = align_tpu.traceback_plain(want, args[2], args[3], M, Wa,
                                            dmin, L)
        tb_oks, mv = hold_tb(got, args[2], args[3], M, Wa, dmin, L, mv_want)
        rp_ok = hold_replay(mv, args[0], args[1], args[2], args[3], dmin)
        ok = all(oks.values()) and all(tb_oks.values()) and rp_ok
        log(f"X1 {what}: B={args[0].shape[0]} M={M} Wa={Wa} dmin={dmin} "
            f"L={L}, plan {auto['route']}; scan "
            + ", ".join(f"{r} {'array-equal' if v else 'MISMATCH'}"
                        for r, v in oks.items())
            + "; moves " + ", ".join(f"{r} {'equal' if v else 'MISMATCH'}"
                                     for r, v in tb_oks.items())
            + f"; replay {'array-equal' if rp_ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"chip_smoke: X1 != plain version ({what})")
        return p, args, got, mv

    def hold_tb(packed, m, n, M, Wa, dmin, L, want, **kw) -> tuple:
        """The traceback on its "warp" route (the plan's, and with `kw`
        forced) and its "thread" route against the plain version's
        moves `want`: ({route: equal}, the warp route's moves)."""
        oks, moves = {}, {}
        for r in ("warp", "thread"):
            moves[r] = align_cuda.traceback_cuda(
                packed, m, n, M, Wa, dmin, L, align_cuda.traceback_plan(
                    m, n, M, Wa, L, route=r, **(kw if r == "warp" else {})))
            torch.cuda.synchronize()
            worst_a["align_traceback"] = max(worst_a["align_traceback"],
                                             int_err(moves[r], want))
            oks[r] = torch.equal(moves[r], want)
        return oks, moves["warp"]

    arng = random.Random(SEED + 7)
    noise = NoiseProfile(sub=0.05, ins=0.12, dele=0.08)
    pairs = []
    for _ in range(77):
        tt = random_seq(arng, arng.randint(1, 900))
        qq, _ = sample_read(arng, tt, 0, len(tt), noise)
        pairs.append((qq.replace("-", "") or "A", tt))
    hold_x1(pairs, "random pairs", B=77)
    skew = []
    for k in range(9):
        tt = random_seq(arng, 1400 + 150 * k)
        skew += [(tt[300 + 40 * k: 800], tt), (tt, tt[50: 400 + 25 * k])]
    p_skew, _, _, _ = hold_x1(skew, "length skew", B=18)
    if p_skew["Wa"] <= 1024:
        raise SystemExit("chip_smoke: the skew case did not reach Wa > 1024")
    same = []
    for ln in (1, 2, 3, 7, 64, 255, 256, 257, 511, 999, 1000, 1500, 2000):
        ss = random_seq(arng, ln)
        same.append((ss, ss))
    hold_x1(same, "identical sequences, lengths 1-2000", B=13)
    # The warp route's edge cases (tests/test_torch_align_plan.py).
    hold_x1(align_tpu.warp_edge_pairs(), "spans at every CPL class edge")
    hold_x1(align_tpu.short_pairs(), "length-1 and short pairs")
    # The traceback on random pointer tensors (walks that leave every
    # window: long left runs, climbing lanes, pointer 3s; lanes below 0
    # and past Wa - 1), on the default and a tiny forced window, with L
    # cut short of the paths and off a 16-byte multiple.
    prng = np.random.default_rng(SEED)
    for probs, L_cut in (((0.2, 0.1, 0.7, 0.0), 700),
                         ((0.1, 0.7, 0.2, 0.0), 700),
                         ((0.25, 0.25, 0.25, 0.25), 700),
                         ((0.3, 0.3, 0.4, 0.0), 37)):
        Bq, Mq, Waq, dq = 200, 300, 256, -64
        fl = prng.choice(4, size=(Bq, Mq, Waq // 4, 4), p=probs)
        pk = torch.from_numpy((fl.astype(np.uint8) << np.array(
            [0, 2, 4, 6], np.uint8)).sum(axis=3, dtype=np.uint8)).to(dev)
        mq = torch.from_numpy(prng.integers(0, Mq + 1, Bq).astype(
            np.int32)).to(dev)
        nq = torch.from_numpy(prng.integers(0, 501, Bq).astype(
            np.int32)).to(dev)
        want_q = align_tpu.traceback_plain(pk, mq, nq, Mq, Waq, dq, L_cut)
        # Its moves replayed over random bases (rows off 16-byte
        # boundaries where L_cut is 37).
        qq_ = torch.from_numpy(prng.integers(65, 91, (Bq, Mq)).astype(
            np.uint8)).to(dev)
        tq_ = torch.from_numpy(prng.integers(65, 91, (Bq, 600)).astype(
            np.uint8)).to(dev)
        if not hold_replay(want_q, qq_, tq_, mq, nq, dq):
            raise SystemExit(f"chip_smoke: X1 replay != plain version "
                             f"(random moves {probs}, L={L_cut})")
        for kw in ({}, {"rows": 8, "window": 32}):
            oks, _ = hold_tb(pk, mq, nq, Mq, Waq, dq, L_cut, want_q, **kw)
            log(f"X1 traceback on random pointers {probs} (B={Bq} M={Mq} "
                f"Wa={Waq} L={L_cut}, warp plan {kw or 'default'}): "
                + ", ".join(f"{r} {'equal' if v else 'MISMATCH'}"
                            for r, v in oks.items()))
            if not all(oks.values()):
                raise SystemExit("chip_smoke: X1 traceback != plain version "
                                 "(random pointers)")
    for what, prs in (("random pairs", pairs), ("length skew", skew),
                      ("identical", same)):
        if align_tpu.align_batch(prs, dev) != [align_pair(q, t) for q, t in prs]:
            raise SystemExit(f"chip_smoke: align_batch != align_pair ({what})")
    log("X1 align_batch on the card: byte-equal to align_pair on all three")

    # One full batch of the bench workload: its first 1024 raw records.
    bench_pairs = [(f[5], f[6]) for f in (l.split() for l in lines[:1024])]
    p, args, got, mv = hold_x1(bench_pairs, "bench batch (first 1024 records)")
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    plans = {r: align_cuda.scan_plan(p["m"], p["n"], p["bw"], M, Wa, dmin,
                                     route=r) for r in ("warp", "cta")}
    if align_cuda.scan_plan(p["m"], p["n"], p["bw"], M, Wa, dmin)[
            "route"] != "warp":
        raise SystemExit("chip_smoke: the bench batch did not take the warp "
                         "route")
    scan_k = lambda: align_cuda.align_scan_cuda(*args, M, Wa, dmin,
                                                plans["warp"])
    scan_c = lambda: align_cuda.align_scan_cuda(*args, M, Wa, dmin,
                                                plans["cta"])
    scan_p = lambda: align_tpu.align_scan_plain(*args, M, Wa, dmin)
    tb_plans = {}
    for r in ("warp", "thread"):
        tb_plans[r] = align_cuda.traceback_plan(p["m"], p["n"], M, Wa, L,
                                                route=r)
        if "order" in tb_plans[r]:  # on the card once, not every launch
            tb_plans[r]["order"] = torch.from_numpy(
                tb_plans[r]["order"]).to(dev)
    tb_k = lambda: align_cuda.traceback_cuda(got, args[2], args[3], M, Wa,
                                             dmin, L, tb_plans["warp"])
    tb_t = lambda: align_cuda.traceback_cuda(got, args[2], args[3], M, Wa,
                                             dmin, L, tb_plans["thread"])
    tb_p = lambda: align_tpu.traceback_plain(got, args[2], args[3], M, Wa, dmin, L)
    # In turns (plain, kernel, kernel, plain).
    x1 = {}
    for name, k_fn, p_fn in (("align_scan", scan_k, scan_p),
                             ("align_traceback", tb_k, tb_p)):
        pa = time_ms(p_fn, 1)
        ka = time_ms(k_fn, 10)
        kb = time_ms(k_fn, 10)
        pb = time_ms(p_fn, 1)
        x1[name] = {"ms": (ka + kb) / 2, "plain_ms": (pa + pb) / 2,
                    "turns": (pa, ka, kb, pb)}
    # The replay of the batch's moves: its plain version eager, the
    # kernel replayed from a CUDA graph of 20 copies (a call of a few
    # microseconds would read the host's launch), in turns (plain,
    # kernel, kernel, plain), and eager beside them.
    rp_out = torch.empty(align_tpu.replay_bytes(len(p["m"]), L),
                         dtype=torch.uint8, device=dev)
    rp_args = (mv, args[0], args[1], args[2], args[3], dmin)
    rp_k = lambda: align_cuda.replay_cuda(*rp_args, rp_out)
    rp_p = lambda: align_tpu.replay_plain(*rp_args)
    pa = time_ms(rp_p, 1)
    ka = graph_ms(rp_k, 10, copies=20)
    kb = graph_ms(rp_k, 10, copies=20)
    pb_ = time_ms(rp_p, 1)
    x1["align_replay"] = {"ms": (ka + kb) / 2, "plain_ms": (pa + pb_) / 2,
                          "turns": (pa, ka, kb, pb_),
                          "eager_ms": time_ms(rp_k, 10)}
    # The scan's routes in turns (cta, warp, warp, cta).
    ca = time_ms(scan_c, 10)
    wa = time_ms(scan_k, 10)
    wb = time_ms(scan_k, 10)
    cb = time_ms(scan_c, 10)
    x1["align_scan"].update(cta_ms=(ca + cb) / 2, route_turns=(ca, wa, wb, cb))
    log(f"align_scan routes in turns (cta, warp, warp, cta): {ca} / {wa} / "
        f"{wb} / {cb} ms; warp plan {plans['warp']['warps']} pairs a CTA, "
        f"CPL classes {plans['warp']['cpl_counts']} [{card}]")
    # The traceback's routes in turns (thread, warp, warp, thread), on the
    # bench batch and on its first 32 pairs (dazcon's rung), each beside
    # the plain version; the chain figure is the longest path's steps
    # and the warp route's ns a step.
    mv_np = mv.cpu().numpy()
    steps_np = (mv_np != 3).sum(axis=1)
    tt_a = time_ms(tb_t, 10)
    tw_a = time_ms(tb_k, 10)
    tw_b = time_ms(tb_k, 10)
    tt_b = time_ms(tb_t, 10)
    longest = int(steps_np.max())
    x1["align_traceback"].update(
        thread_ms=(tt_a + tt_b) / 2, route_turns=(tt_a, tw_a, tw_b, tt_b),
        chain={"longest_steps": longest,
               "ns_per_step": (tw_a + tw_b) / 2 * 1e6 / longest})
    log(f"align_traceback routes in turns (thread, warp, warp, thread) at "
        f"B={len(p['m'])}: {tt_a} / {tw_a} / {tw_b} / {tt_b} ms; longest path "
        f"{longest} steps, {(tw_a + tw_b) / 2 * 1e6 / longest:.1f} ns a step on "
        f"the warp route; plan {tb_plans['warp']['warps']} pairs a CTA, "
        f"{tb_plans['warp']['rows']} rows a stage, window "
        f"{tb_plans['warp']['window']} bytes [{card}]")
    B32 = 32
    pk32, m32, n32 = (x[:B32].contiguous() for x in (got, args[2], args[3]))
    p32 = {r: align_cuda.traceback_plan(p["m"][:B32], p["n"][:B32], M, Wa, L,
                                        route=r) for r in ("warp", "thread")}
    if p32["warp"]["route"] != "warp" or p32["warp"]["warps"] != 1:
        raise SystemExit(f"chip_smoke: the B=32 traceback plan is not one "
                         f"warp a CTA on the warp route ({p32['warp']})")
    p32["warp"]["order"] = torch.from_numpy(p32["warp"]["order"]).to(dev)
    f32 = {r: (lambda pl=pl: align_cuda.traceback_cuda(
        pk32, m32, n32, M, Wa, dmin, L, pl)) for r, pl in p32.items()}
    want32 = align_tpu.traceback_plain(pk32, m32, n32, M, Wa, dmin, L)
    for r, fn in f32.items():
        got32 = fn()
        torch.cuda.synchronize()
        if not torch.equal(got32, want32):
            raise SystemExit(f"chip_smoke: X1 traceback at B=32 ({r}) != "
                             "plain version")
    t32 = [time_ms(f32[r], 10) for r in ("thread", "warp", "warp", "thread")]
    pl32 = [time_ms(lambda: align_tpu.traceback_plain(
        pk32, m32, n32, M, Wa, dmin, L), 1) for _ in range(2)]
    longest32 = int(steps_np[:B32].max())
    x1["align_traceback"]["b32_call"] = {
        "ms": (t32[1] + t32[2]) / 2, "thread_ms": (t32[0] + t32[3]) / 2,
        "plain_ms": sum(pl32) / 2, "route_turns": t32,
        "longest_steps": longest32}
    log(f"align_traceback at B=32 (first 32 pairs), in turns (thread, warp, "
        f"warp, thread): {t32} ms, plain PyTorch {pl32} ms; longest path "
        f"{longest32} steps [{card}]")
    # Bounds (the benchmark's counts, `bench/roofline.py`): bytes or int32
    # operations, whichever is larger.
    Bb = len(p["m"])
    cells = roofline.band_cells(p["m"], p["n"], p["bw"])
    path_len = int(steps_np.sum())
    # The replay: each path's moves and its first 3 (where the row has
    # one), the bases the paths take (m + n a pair), m and n read once,
    # the rows and path lengths written once; 6 int32 operations a path
    # step (two compares, two running counts, two selects).
    rp_rows = align_cuda.replay_cuda(*rp_args)
    rp_work = roofline.Work(
        path_len + int((steps_np < L).sum()) + int((p["m"] + p["n"]).sum())
        + roofline.nbytes(args[2], args[3], *rp_rows), 6 * path_len)
    for name, work in (
            ("align_scan", roofline.align_scan(args, got, cells)),
            ("align_traceback", roofline.align_traceback(args[2], args[3], mv,
                                                         path_len)),
            ("align_replay", rp_work)):
        nb_, ops = work.bytes, work.int32_ops
        t_bytes, t_ops = work.bytes_ms(), work.ops_ms()
        x1[name].update(bound_ms=work.bound_ms(), bound_by=work.bound_by(),
                        bytes=nb_, int32_ops=ops)
        log(f"{name} at B={Bb} M={M} Wa={Wa} L={L} (rows {M}, lanes {Wa}; band "
            f"cells {cells}, path steps {path_len}): kernel "
            f"({'graph-replayed' if name == 'align_replay' else 'warp route'}) "
            f"{x1[name]['turns'][1]} / "
            f"{x1[name]['turns'][2]} ms, plain PyTorch {x1[name]['turns'][0]} / "
            f"{x1[name]['turns'][3]} ms, bound {x1[name]['bound_ms']} ms "
            f"(bytes {nb_} -> {t_bytes} ms, int32 ops {ops} -> {t_ops} ms: "
            f"{x1[name]['bound_by']}) [{card}]")
    log(f"align_replay eager (each call launched from the host): "
        f"{x1['align_replay']['eager_ms']} ms [{card}]")
    # align_batch on the same batch, in its parts, three times: the host
    # preparation, the device part (upload, scan, traceback, replay, to
    # a synchronise), the fetch (one copy) and the host's decode.
    for _ in range(3):
        t0 = time.perf_counter()
        pb = align_tpu.prepare_batch(bench_pairs)
        t1 = time.perf_counter()
        flat = align_tpu.device_replay(pb, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gapped = align_tpu.fetch_gapped(flat, pb)
        t3 = time.perf_counter()
        log(f"align_batch of the bench batch, host clock: prepare "
            f"{t1 - t0:.4f} s, scan + traceback + replay {t2 - t1:.4f} s, "
            f"fetch + decode {t3 - t2:.4f} s [{card}]")
    if gapped != [align_pair(q, t) for q, t in bench_pairs[:64]] + gapped[64:]:
        raise SystemExit("chip_smoke: align_batch != align_pair (bench batch)")
    for line in _build.build_logs.get("align_scan", "").splitlines():
        if any(w in line for w in ("registers", "spill", "error", "entry")):
            log(f"  ptxas align_scan: {line.strip()}")
    del args, got, mv, rp_args, rp_out, rp_rows

    phase("8")
    # ---- phase 8: the -a device path at full width ----
    acfg = dataclasses.replace(cfg, align_backend="device")

    def run_align(c):
        out = io.StringIO()
        t0 = time.time()
        st = run_stream(io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), c)
        torch.cuda.synchronize()
        return time.time() - t0, st, out.getvalue()

    # One run a route: the device aligner, then the host aligner. The
    # counts are set to 0 just before each run and read just after it:
    # the device run must launch every kernel of its path; a host-aligner
    # run must launch no X1.
    aruns = {}
    for which in ("device", "host"):
        for k in align_cuda.launches:
            align_cuda.launches[k] = 0
        for k in align_cuda.traceback_routes:
            align_cuda.traceback_routes[k] = 0
        dp_cuda.launches = 0
        aruns[which] = run_align(acfg if which == "device" else cfg)
        run_launches = {**align_cuda.launches, "dp_scan": dp_cuda.launches}
        if which == "host" and any(align_cuda.launches.values()):
            raise SystemExit(f"chip_smoke: a host-aligner run launched X1 "
                             f"({run_launches})")
        if which == "device":
            if any(v == 0 for v in run_launches.values()):
                raise SystemExit(f"chip_smoke: an -a device run did not run "
                                 f"its kernels ({run_launches})")
            align_launches = run_launches
            tb_routes = dict(align_cuda.traceback_routes)
    # The plan takes the "warp" route for every batch: each traceback of
    # the -a device run went there.
    if tb_routes["warp"] != align_launches["align_traceback"]:
        raise SystemExit(f"chip_smoke: an -a device run's traceback left the "
                         f"warp route ({tb_routes})")
    if any(r[2] != fasta_host for r in aruns.values()):
        raise SystemExit("chip_smoke: -a device path FASTA != single-core C++")
    adt, astats, _ = aruns["device"]
    if "align" not in astats.stage_s or astats.targets != TARGETS:
        raise SystemExit(f"chip_smoke: bad -a device run: {astats}")
    log(f"-a device path: targets={astats.targets} batches={astats.batches} "
        f"launches {align_launches}, traceback by route {tb_routes}; FASTA "
        f"byte-equal to the single-thread native engine, as is the host "
        f"aligner's [{card}]")
    stages = ", ".join(f"{k} {v:.4f}" for k, v in astats.stage_s.items())
    log(f"-a device host-clock seconds by stage (wall {adt:.4f}): {stages} "
        f"[{card}]")

    phase("9")
    # ---- phase 9: the frontends (hgap -> -a device path; dazcon) ----
    from pbdagcon_tpu_torch.dazcon import run_dazcon
    from pbdagcon_tpu_torch.hgap import run_hgap
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    # Reads FASTA + M4 overlaps at the bench scale (the generator of
    # tests/test_frontend_clis.py).
    t = time.time()
    frng = random.Random(SEED)
    ftargets = {f"t{i:04d}": random_seq(frng, LENGTH) for i in range(TARGETS)}
    freads = dict(ftargets)
    m4_lines = []
    fnoise = NoiseProfile(sub=0.01, ins=0.05, dele=0.03)
    for tname, tseq in ftargets.items():
        for j in range(COVERAGE):
            qstr, _ = sample_read(frng, tseq, 0, len(tseq), fnoise)
            qseq = qstr.replace("-", "")
            qname = f"{tname}_r{j}"
            freads[qname] = qseq
            m4_lines.append(
                f"{qname} {tname} {-5 * len(qseq)} 99.0 0 0 {len(qseq)} "
                f"{len(qseq)} 0 0 {len(tseq)} {len(tseq)} 254")
    pre_text = run_hgap(io.StringIO("\n".join(m4_lines) + "\n"), freads)
    log(f"frontends: {len(ftargets)} targets, {len(m4_lines)} M4 hits, hgap "
        f"'pre' {len(pre_text) / 1e6:.1f} MB in {time.time() - t:.1f}s")
    for k in align_cuda.launches:
        align_cuda.launches[k] = 0
    dp_cuda.launches = 0
    t0 = time.time()
    out = io.StringIO()
    hstats = run_stream(io.StringIO(pre_text), FastaWriter(out), acfg)
    hgap_dt = time.time() - t0
    hgap_launches = {**align_cuda.launches, "dp_scan": dp_cuda.launches}
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as eng:
        hgap_host = eng.consensus_text(pre_text.encode(), fmt="pre")
    if out.getvalue() != hgap_host or hstats.targets != TARGETS:
        raise SystemExit("chip_smoke: hgap -> -a device FASTA != native engine")
    if any(v == 0 for v in hgap_launches.values()):
        raise SystemExit(f"chip_smoke: the hgap chain did not run its kernels "
                         f"({hgap_launches})")
    log(f"hgap -> -a device path: targets={hstats.targets} wall {hgap_dt:.4f} s,"
        f" launches {hgap_launches}; FASTA byte-equal to the native engine "
        f"on the same 'pre' [{card}]")
    # dazcon on the card over the first 64 targets, then the first 16 of
    # them on the CPU (plain versions) against the card's.
    names = sorted(ftargets)[:64]
    keep = set(names)
    sub_m4 = [l for l in m4_lines if l.split()[1] in keep]
    for k in align_cuda.launches:
        align_cuda.launches[k] = 0
    dp_cuda.launches = 0
    dz_stats = PipelineStats()
    t0 = time.time()
    dz_out = io.StringIO()
    n_dz = run_dazcon(iter(sub_m4), freads, dz_out, min_weight=min_weight,
                      min_length=100, device="cuda", stats=dz_stats)
    torch.cuda.synchronize()
    dz_dt = time.time() - t0
    dz_launches = {**align_cuda.launches, "dp_scan": dp_cuda.launches}
    if n_dz == 0 or any(v == 0 for v in dz_launches.values()):
        raise SystemExit(f"chip_smoke: dazcon did not run its kernels "
                         f"({dz_launches}, {n_dz} emitted)")
    first = set(names[:16])
    dz_cpu = io.StringIO()
    t0 = time.time()
    run_dazcon(iter(l for l in sub_m4 if l.split()[1] in first), freads,
               dz_cpu, min_weight=min_weight, min_length=100, device="cpu")
    dz_cpu_dt = time.time() - t0
    recs = dz_out.getvalue().split(">")[1:]
    prefix = "".join(">" + r for r in recs if r.split("\n", 1)[0] in first)
    if prefix != dz_cpu.getvalue() or not prefix:
        raise SystemExit("chip_smoke: dazcon on the card != device='cpu'")
    log(f"dazcon on the card: {len(names)} targets, {n_dz} emitted, wall "
        f"{dz_dt:.4f} s, launches {dz_launches}, host DP {dz_stats.fallback_reasons}"
        f"; its first 16 targets byte-equal to device='cpu' (CPU wall "
        f"{dz_cpu_dt:.4f} s) [{card}]")

    phase("10")
    # ---- phase 10: hybrid on the bench workload ----
    hcfg = dataclasses.replace(cfg, backend="hybrid",
                               batch_targets=DEVBUILD_BATCH)

    from pbdagcon_tpu_torch.tools import auto_turns

    def first_use_warmup(st) -> str:
        """The first device chunk's seconds less what its bytes take at
        the device's later (warm) rate."""
        w = auto_turns.first_use_warmup(st)
        return ("not measured (no later device chunk)" if w is None
                else f"{w:.4f} s")

    def run_env(c, env, stream):
        """One run of `c` under the environment `env` (None unsets), the
        B1-B3 counts set to 0 just before: (stats, seconds, FASTA,
        launches)."""
        saved = {k: os.environ.get(k) for k in env}
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        dp_cuda.launches = 0
        mxu_cuda.launches.update(hist=0, scatter=0)
        try:
            out = io.StringIO()
            t0 = time.time()
            st = run_stream(stream, FastaWriter(out), c)
            torch.cuda.synchronize()
            dt = time.time() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return st, dt, out.getvalue(), {"dp_scan": dp_cuda.launches,
                                        **mxu_cuda.launches}

    def chunk_line(st) -> str:
        return (f"host/device chunks {st.hybrid_host_chunks}/"
                f"{st.hybrid_dev_chunks} (bytes {st.hybrid_host_bytes}/"
                f"{st.hybrid_dev_bytes}; busy s {st.hybrid_host_busy_s:.4f}/"
                f"{st.hybrid_dev_busy_s:.4f})")

    # Forced: every pull goes to the device, in chunks of 512 KB with no
    # hedging, so the device takes several chunks and its warm rate shows.
    for label, env in (("forced", {"DAGCON_HYBRID_FORCE_DEV": "1",
                                   "DAGCON_HYBRID_CHUNK_KB": "512",
                                   "DAGCON_HYBRID_HEDGE": "0"}),
                       ("defaults", {}),
                       ("probe_defer_0", {"DAGCON_HYBRID_PROBE_DEFER_S": "0"})):
        st, dt, got, hl = run_env(hcfg, env, io.TextIOWrapper(io.BytesIO(text)))
        if got != fasta_host or st.targets != TARGETS:
            raise SystemExit(f"chip_smoke: hybrid ({label}) FASTA != "
                             "single-core C++")
        if label == "forced" and (st.hybrid_dev_chunks == 0
                                  or any(v == 0 for v in hl.values())):
            raise SystemExit(f"chip_smoke: forced hybrid did not run the "
                             f"device ({st.hybrid_dev_chunks} chunks, {hl})")
        log(f"hybrid {label}: {chunk_line(st)}, {bases / dt:.1f} b/s (wall "
            f"{dt:.4f} s), launches {hl}; device first chunk "
            f"{st.hybrid_dev_first_s:.4f} s for {st.hybrid_dev_first_bytes} "
            f"bytes, warmup in this (warm) process {first_use_warmup(st)}; "
            f"FASTA byte-equal [{card}]")

    # The device worker's first use in a fresh process: CUDA set-up and
    # the nvcc builds of dp_scan and hist_scatter into an empty build
    # directory, then the same run warm; forced pulls as above.
    cold_dir = os.path.join(_build.BUILD_DIR, "cold")
    shutil.rmtree(cold_dir, ignore_errors=True)
    os.makedirs(cold_dir)
    with open(os.path.join(cold_dir, "input.pre"), "wb") as f:
        f.write(text)
    knobs = {k: getattr(hcfg, k) for k in (
        "min_weight", "min_length", "threads", "fmt", "align", "backend",
        "v_buckets", "w_buckets", "batch_targets")}
    res = subprocess.run(
        [sys.executable, "-c", COLD_HYBRID, cold_dir, json.dumps(knobs)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, DAGCON_HYBRID_FORCE_DEV="1",
                 DAGCON_HYBRID_CHUNK_KB="512", DAGCON_HYBRID_HEDGE="0"),
    )
    if res.returncode != 0:
        raise SystemExit(f"chip_smoke: the cold hybrid run failed:\n"
                         f"{res.stderr[-3000:]}")
    cold, warm = json.loads(res.stdout.strip().splitlines()[-1])
    if cold["build_s"] <= 0:
        raise SystemExit("chip_smoke: the cold hybrid run built no kernel")
    if cold["fasta_ok"] is not True or warm["fasta_ok"] is not True:
        raise SystemExit("chip_smoke: cold hybrid FASTA != single-core C++")
    if warm["dev_bytes"]:
        warm_spb = warm["dev_busy_s"] / warm["dev_bytes"]
        rate = f"{warm_spb * 1e6:.4f} s/MB"
        warmup = f"{cold['first_s'] - cold['first_bytes'] * warm_spb:.4f} s"
    else:
        rate = warmup = "not measured (one device chunk in the warm run)"
    log(f"hybrid first use (fresh process, forced): device first chunk "
        f"{cold['first_s']:.4f} s for {cold['first_bytes']} bytes (nvcc "
        f"builds {cold['build_s']:.1f} s of it), the warm run's later "
        f"device chunks {rate}: first-use warmup {warmup}; walls cold "
        f"{cold['wall']:.4f} s, warm {warm['wall']:.4f} s "
        f"(host/device chunks {cold['host_chunks']}/{cold['dev_chunks']}, "
        f"{warm['host_chunks']}/{warm['dev_chunks']}) [{card}]")

    # The default backend, "auto", on the card with the native engine:
    # the hybrid scheduler (host-only here, by the probe deferral); with
    # DAGCON_AUTO_HYBRID=0 the batched DP ("cuda").
    auto_cfg = dataclasses.replace(hcfg, backend=DagconConfig().backend)
    auto_launches = {"dp_scan": 0, "hist": 0, "scatter": 0}
    for label, env in (("auto", {"DAGCON_AUTO_HYBRID": None}),
                       ("auto, DAGCON_AUTO_HYBRID=0",
                        {"DAGCON_AUTO_HYBRID": "0"})):
        st, dt, got, hl = run_env(auto_cfg, env,
                                  io.TextIOWrapper(io.BytesIO(text)))
        for k, v in hl.items():
            auto_launches[k] += v
        if got != fasta_host or st.targets != TARGETS:
            raise SystemExit(f"chip_smoke: {label} FASTA != single-core C++")
        hybrid_ran = st.hybrid_host_chunks + st.hybrid_dev_chunks > 0
        if "=0" in label and (hybrid_ran or hl["dp_scan"] == 0):
            raise SystemExit(f"chip_smoke: {label} did not take cuda "
                             f"({chunk_line(st)}, {hl})")
        if "=0" not in label and st.hybrid_host_chunks == 0:
            raise SystemExit(f"chip_smoke: {label} did not take the hybrid "
                             f"scheduler ({chunk_line(st)}, {hl})")
        log(f"backend {label} on the bench workload: "
            f"{'hybrid' if hybrid_ran else 'cuda'}, {chunk_line(st)}, "
            f"{bases / dt:.1f} b/s (wall {dt:.4f} s), launches {hl}; FASTA "
            f"byte-equal [{card}]")

    # A long stream, past the probe deferral: the bench workload (the
    # first 512 targets of the benchmark's cfg2-batched) replayed with
    # fresh target ids, made a copy at a time, about LONG_S s of the host
    # engine's work; "host", then "auto". The expected FASTA is the
    # 1-thread engine's of one copy with each copy's ids, a rule first
    # held against the 1-thread engine on two copies of 32 targets.
    segs = auto_turns.sid_segments(text, "pre")
    fsegs = auto_turns.fasta_segments(fasta_host)
    head = ("\n".join(lines[:32 * COVERAGE]) + "\n").encode()
    with native.NativeEngine(min_weight=min_weight, min_length=100,
                             threads=1, align=True) as eng:
        head_fa = eng.consensus_text(head, fmt="pre")
        two = eng.consensus_text(
            auto_turns.ReplayStream(auto_turns.sid_segments(head, "pre"),
                                    2).read(), fmt="pre")
    if not auto_turns.check_replayed(two, auto_turns.fasta_segments(head_fa),
                                     2):
        raise SystemExit("chip_smoke: a replayed copy's FASTA is not the "
                         "1-thread engine's with the copy's ids")
    st, dt, got, _ = run_env(dataclasses.replace(hcfg, backend="host"), {},
                             io.TextIOWrapper(io.BytesIO(text)))
    copies = max(2, math.ceil(LONG_S / dt))
    long = {}
    for b in ("host", "auto"):
        st, dt, got, hl = run_env(
            dataclasses.replace(hcfg, backend=b), {"DAGCON_AUTO_HYBRID": None},
            auto_turns.ReplayStream(segs, copies))
        if not auto_turns.check_replayed(got, fsegs, copies):
            raise SystemExit(f"chip_smoke: long stream {b} FASTA != "
                             "single-core C++")
        long[b] = (st, dt, hl)
    st, dt, hl = long["auto"]
    if st.hybrid_dev_chunks == 0 or any(v == 0 for v in hl.values()):
        raise SystemExit(f"chip_smoke: the long stream's auto run gave the "
                         f"device no chunk or launched no kernel "
                         f"({chunk_line(st)}, {hl})")
    hybrid_long_launches = hl
    long_bases = copies * bases
    host_rate = long_bases / long["host"][1]
    attr = (f"{st.hybrid_dev_bases / st.hybrid_dev_busy_s:.1f} b/s"
            if st.hybrid_dev_busy_s > 0 else "not measured")
    log(f"long stream ({copies} copies, {copies * TARGETS} targets, "
        f"{copies * len(text)} bytes): host {host_rate:.1f} b/s (wall "
        f"{long['host'][1]:.4f} s); auto {long_bases / dt:.1f} b/s (wall "
        f"{dt:.4f} s), {chunk_line(st)}, device bases "
        f"{st.hybrid_dev_bases}, device-attributable {attr}, first device "
        f"chunk {st.hybrid_dev_first_s:.4f} s for "
        f"{st.hybrid_dev_first_bytes} bytes, first-use warmup "
        f"{first_use_warmup(st)}, launches {hl}; auto/host "
        f"{long['host'][1] / dt:.4f} (the reference's guard: >= 0.9, not "
        f"gated here); both FASTAs byte-equal [{card}]")

    phase("11")
    # ---- phase 11: kernel X2 (the blocked solve), colshard, "blocked" ----
    from pbdagcon_tpu_torch.ops import dp_blocked as dpb
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as x2c

    X2 = tuple(x2c.launches)
    worst_x2 = 0.0

    def arena_args(batch):
        B, V, W = batch["win_count"].shape
        K = batch["long_u"].shape[1]
        return unpack_arena(torch.from_numpy(to_arena(batch)).to(dev),
                            B, V, W, K)

    def hold_x2(args, what) -> None:
        """X2 against its plain version on the card: each kernel's output
        integer-equal, the Kleene-iterated scores bitwise and the flags
        equal, and the unflagged rows bitwise equal to B1's."""
        nonlocal worst_x2
        B, V, W = args[0].shape
        K = args[4].shape[1]
        L = dpb._blocked_L(V)
        e_ex = dpb.exit_half_units(args[1])
        a = dpb._rows(dpb._esc2_band(args[0], args[2], args[3]), e_ex, L)
        M = x2c.compose_cuda(args[0], args[2], args[3], e_ex, L)
        x_in = x2c.propagate_cuda(M)
        s2 = x2c.fill_cuda(args[0], args[2], args[3], e_ex, x_in, L)
        M_p = dpb._compose(a)
        x_p = dpb._propagate(M_p)
        s_p = dpb._fill(a, x_p)
        # The first design's routes, forced, on the same inputs.
        cta_c = x2c.compose_plan(B, V // L, W, L, route="cta")
        cta_p = x2c.propagate_plan(B, V // L, W, route="cta")
        M_cta = x2c.compose_cuda(args[0], args[2], args[3], e_ex, L, plan=cta_c)
        x_cta = x2c.propagate_cuda(M_p, plan=cta_p)
        red_f = x2c.fill_plan(B, V // L, W, L, route="reduce")
        s_red = x2c.fill_cuda(args[0], args[2], args[3], e_ex, x_p, L,
                              plan=red_f)
        routes = (x2c.compose_plan(B, V // L, W, L)["route"],
                  x2c.propagate_plan(B, V // L, W)["route"],
                  x2c.fill_plan(B, V // L, W, L)["route"])
        ok = (torch.equal(M, M_p) and torch.equal(x_in, x_p)
              and torch.equal(s2, s_p) and torch.equal(s_red, s_p)
              and torch.equal(M_cta, M_p) and torch.equal(x_cta, x_p))
        before = x2c.launches["blocked_compose"]
        s, f = dpb.dp_scores_blocked(*args, L=L)
        solves = x2c.launches["blocked_compose"] - before
        s_p, f_p = dpb.dp_scores_blocked_reference(*args, L=L)
        seq = dp_cuda.dp_scores_cuda(*args)
        torch.cuda.synchronize()
        ok = ok and bitwise_equal(s, s_p) and torch.equal(f, f_p)
        err = max_abs_err(s, s_p)
        worst_x2 = max(worst_x2, err)
        b1_ok = bitwise_equal(s[~f], seq[~f])
        log(f"X2 {what} B={B} V={V} W={W} K={K} L={L}: compose ({routes[0]} "
            f"and cta), propagate ({routes[1]} and cta), fill ({routes[2]} "
            f"and reduce) {'integer-equal' if ok else 'MISMATCH'}, scores "
            f"and flags "
            f"{'bitwise' if ok else 'MISMATCH'} (max_abs_err={err}, {solves} "
            f"solves, {int(f.sum())} rows flagged); unflagged rows against B1 "
            f"{'bitwise' if b1_ok else 'MISMATCH'}")
        if not (ok and b1_ok):
            raise SystemExit(f"chip_smoke: X2 != plain version or B1 ({what})")

    rng = np.random.default_rng(SEED + 11)
    for W in (16, 32, 64, 128):
        hold_x2(arena_args(random_batch(rng, GRID_B, 704, W, 16)), "grid")
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as eng:
        cnt = eng.linearize_text(text, fmt="pre")
        ns = eng.metas(cnt)[:, 0]
        idxs = [i for i in range(cnt) if ns[i] <= v_bucket]
        W, K, outliers = _choose_layout_native(eng, idxs, cfg)
        idxs = [i for i in idxs if i not in outliers]
        bench = native.pack_batch(eng, idxs, v_bucket, W, K)
    bargs = unpack_arena(bench["_arena"].to(dev), *bench["_dims"])
    hold_x2(bargs, "bench batch")

    # The oversize workload: targets of 8 kb, every one past the V ladder.
    t = time.time()
    olines: list[str] = []
    for _tid, _bb, alns in simulate_targets(
        SEED, OVERSIZE_TARGETS, OVERSIZE_LENGTH, COVERAGE, NoiseProfile()
    ):
        olines.extend(to_pre_raw(a) for a in alns)
    otext = ("\n".join(olines) + "\n").encode()
    ocfg = dataclasses.replace(cfg, v_buckets=DagconConfig().v_buckets)
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as eng:
        cnt = eng.linearize_text(otext, fmt="pre")
        metas = eng.metas(cnt)
        spans = metas[:, 1]
        fits = [int(s) <= ocfg.w_buckets[-1] for s in spans]
        # the first that fits a W bucket, one whose V takes L = 128 first
        pick = min((i for i in range(cnt) if fits[i]),
                   key=lambda i: (-(-int(metas[i, 0]) // 64) % 2, i))
        on, ospan = int(metas[pick, 0]), int(spans[pick])
        oV = -(-on // 64) * 64
        oW = next(w for w in ocfg.w_buckets if ospan <= w)
        one = native.pack_batch(eng, [pick], oV, oW, 1)
    log(f"oversize workload: {OVERSIZE_TARGETS} targets x {OVERSIZE_LENGTH} bp "
        f"x {COVERAGE}x, {len(otext) / 1e6:.1f} MB in {time.time() - t:.1f}s; "
        f"n {int(metas[:, 0].min())}-{int(metas[:, 0].max())} (past the top "
        f"V bucket {ocfg.v_buckets[-1]}: {int((metas[:, 0] > ocfg.v_buckets[-1]).sum())}), "
        f"span <= {ocfg.w_buckets[-1]}: {sum(fits)} (spans of the rest: "
        f"{sorted(int(s) for s, f in zip(spans, fits) if not f)})")
    oargs = unpack_arena(one["_arena"].to(dev), 1, oV, oW, 1)
    hold_x2(oargs, f"oversize target (n={on}, span={ospan})")
    del one

    def x2_times(args, what) -> dict:
        """Each X2 kernel's device ms per call (CUDA events, in turns
        with its plain phase), its bound, and the solve's sum."""
        B, V, W = args[0].shape
        L = dpb._blocked_L(V)
        G = V // L
        e_ex = dpb.exit_half_units(args[1])
        a = dpb._rows(dpb._esc2_band(args[0], args[2], args[3]), e_ex, L)
        M = x2c.compose_cuda(args[0], args[2], args[3], e_ex, L)
        x_in = x2c.propagate_cuda(M)
        cta_c = x2c.compose_plan(B, G, W, L, route="cta")
        cta_p = x2c.propagate_plan(B, G, W, route="cta")
        red_f = x2c.fill_plan(B, G, W, L, route="reduce")
        # The first design's routes, forced: timed in turns with the new.
        first = {
            "blocked_compose": lambda: x2c.compose_cuda(
                args[0], args[2], args[3], e_ex, L, plan=cta_c),
            "blocked_propagate": lambda: x2c.propagate_cuda(M, plan=cta_p),
            "blocked_fill": lambda: x2c.fill_cuda(
                args[0], args[2], args[3], e_ex, x_in, L, plan=red_f),
        }
        old_route = {"blocked_compose": "cta", "blocked_propagate": "cta",
                     "blocked_fill": "reduce"}
        new_route = {"blocked_compose": x2c.compose_plan(B, G, W, L)["route"],
                     "blocked_propagate": x2c.propagate_plan(B, G, W)["route"],
                     "blocked_fill": x2c.fill_plan(B, G, W, L)["route"]}
        fns = {
            "blocked_compose": (
                lambda: x2c.compose_cuda(args[0], args[2], args[3], e_ex, L),
                lambda: dpb._compose(a)),
            "blocked_propagate": (lambda: x2c.propagate_cuda(M),
                                  lambda: dpb._propagate(M)),
            "blocked_fill": (
                lambda: x2c.fill_cuda(args[0], args[2], args[3], e_ex, x_in, L),
                lambda: dpb._fill(a, x_in)),
        }
        # Inputs read once, outputs written once; int32 operations: an
        # add and a max per term, (W+1)^2 terms a node (compose) or a
        # block (propagate), W+1 a node (fill).
        band = (args[0], args[2], args[3], e_ex)
        work = {"blocked_compose": roofline.blocked_compose(band, M, L),
                "blocked_propagate": roofline.blocked_propagate(M, x_in),
                "blocked_fill": roofline.blocked_fill(band, x_in, L)}
        out = {}
        for name, (k_fn, p_fn) in fns.items():
            pa = time_ms(p_fn, 1)
            ka = time_ms(k_fn, 10)
            kb = time_ms(k_fn, 10)
            pb = time_ms(p_fn, 1)
            w = work[name]
            nb_, ops, t_b, t_o = w.bytes, w.int32_ops, w.bytes_ms(), w.ops_ms()
            out[name] = {"ms": (ka + kb) / 2, "plain_ms": (pa + pb) / 2,
                         "bound_ms": w.bound_ms(), "bound_by": w.bound_by()}
            ca = time_ms(first[name], 10)
            na, nb2 = time_ms(k_fn, 10), time_ms(k_fn, 10)
            cb = time_ms(first[name], 10)
            old, new = old_route[name], new_route[name]
            out[name].update({"plan_route": new, f"{old}_ms": (ca + cb) / 2,
                              "turns_ms": [ca, na, nb2, cb]})
            turns = (f"; in turns with route {old} ({old}, {new}, {new}, "
                     f"{old}): {ca} / {na} / {nb2} / {cb} ms")
            if name == "blocked_fill":
                # Replayed from CUDA graphs (20 launches a graph): device
                # time without the host's launches; the chain's ns a step.
                g = [graph_ms(f, 10, copies=20)
                     for f in (first[name], k_fn, k_fn, first[name])]
                out[name]["graph_turns_ms"] = g
                out[name]["chain"] = {
                    "steps": L, "ns_a_step": (g[1] + g[2]) / 2 * 1e6 / L,
                    f"{old}_ns_a_step": (g[0] + g[3]) / 2 * 1e6 / L}
                turns += (f"; from CUDA graphs ({old}, {new}, {new}, {old}): "
                          f"{g[0]} / {g[1]} / {g[2]} / {g[3]} ms, "
                          f"{out[name]['chain']['ns_a_step']} ns a step of "
                          f"{L} ({old} "
                          f"{out[name]['chain'][f'{old}_ns_a_step']})")
            log(f"{name} at {what} B={B} V={V} W={W} L={L}: kernel {ka} / {kb} "
                f"ms, plain PyTorch {pa} / {pb} ms, bound {max(t_b, t_o)} ms "
                f"(bytes {nb_} -> {t_b} ms, int32 ops {ops} -> {t_o} ms)"
                f"{turns} [{card}]")
        # The solve: the band read and the scores written once, the three
        # kernels' operations.
        solve = roofline.Work(
            roofline.nbytes(*band) + B * V * 4,
            sum(w.int32_ops for w in work.values()))
        out["solve"] = {"ms": sum(out[n]["ms"] for n in X2),
                        "bound_ms": solve.bound_ms()}
        return out

    x2_bench = x2_times(bargs, "the bench batch")
    b1_a = time_ms(lambda: dp_cuda.dp_scores_cuda(*bargs), 20)
    sv = lambda: x2c.solve_band_cuda(
        bargs[0], bargs[2], bargs[3], dpb.exit_half_units(bargs[1]),
        dpb._blocked_L(bargs[0].shape[1]))
    sv_a = time_ms(sv, 10)
    sv_b = time_ms(sv, 10)
    # The Kleene loop as `blocked` runs it on this batch: its solves, each
    # behind a host check (the narrow-band routing's number).
    kl = lambda: dpb.dp_scores_blocked(*bargs, L=dpb._blocked_L(
        bargs[0].shape[1]))
    before = x2c.launches["blocked_fill"]
    kl()
    kl_solves = x2c.launches["blocked_fill"] - before
    kl_a = time_ms(kl, 10)
    kl_b = time_ms(kl, 10)
    b1_b = time_ms(lambda: dp_cuda.dp_scores_cuda(*bargs), 20)
    log(f"X2 solve at the bench batch {tuple(bench['_dims'])}: the three "
        f"kernels {x2_bench['solve']['ms']} ms summed, {sv_a} / {sv_b} ms "
        f"as one solve (bound {x2_bench['solve']['bound_ms']} ms); the "
        f"Kleene loop ({kl_solves} solves, a host check after each) "
        f"{kl_a} / {kl_b} ms; B1 {b1_a} / {b1_b} ms on the same batch "
        f"[{card}]")
    x2_over = x2_times(oargs, f"the oversize target (n={on})")
    log(f"X2 solve at the oversize target: {x2_over['solve']['ms']} ms "
        f"summed (bound {x2_over['solve']['bound_ms']} ms) [{card}]")
    del bargs, oargs

    def x2_zero() -> None:
        for k in X2:
            x2c.launches[k] = 0
        for counts in (x2c.compose_routes, x2c.propagate_routes,
                       x2c.fill_routes):
            for k in counts:
                counts[k] = 0
        x2c.route_widths.clear()
        dp_cuda.launches = 0

    def x2_routes_new(what) -> dict:
        """Fails unless every compose, propagate and fill at W in {16, 32}
        took the new route in the run just ended, and each of the three
        launched there; the run's counts by (kernel, route, W)."""
        old = {k: n for k, n in x2c.route_widths.items()
               if k[1] in ("cta", "reduce") and k[2] in (16, 32)}
        new = [sum(n for k, n in x2c.route_widths.items()
                   if k[0] == kn and k[1] in ("column", "warp", "lane")
                   and k[2] in (16, 32)) for kn in X2]
        if old or not all(new):
            raise SystemExit(f"chip_smoke: {what}: X2 at W in (16, 32) not on "
                             f"the new routes ({x2c.route_widths})")
        return dict(x2c.route_widths)

    def run_text(data, c):
        out = io.StringIO()
        t0 = time.time()
        st = run_stream(io.TextIOWrapper(io.BytesIO(data)), FastaWriter(out), c)
        torch.cuda.synchronize()
        return time.time() - t0, st, out.getvalue()

    # The oversize cell at full size: one run on "cuda" (the benchmark's
    # hgap-oversize-cuda cell times it beside "host").
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=1, align=True
    ) as eng:
        ofasta_host = eng.consensus_text(otext, fmt="pre")
    x2_zero()
    odt, ost, ofasta = run_text(otext, ocfg)
    if ofasta != ofasta_host:
        raise SystemExit("chip_smoke: oversize cell FASTA (cuda) != "
                         "single-core C++")
    colshard_launches = {k: x2c.launches[k] for k in X2}
    colshard_launches["dp_scan"] = dp_cuda.launches
    colshard_routes = x2_routes_new("the oversize cell")
    if ost.colshard == 0 or any(colshard_launches[k] == 0 for k in X2):
        raise SystemExit(f"chip_smoke: the oversize cell never ran colshard "
                         f"({ost.colshard} targets, {colshard_launches})")
    log(f"oversize cell: targets={ost.targets} colshard={ost.colshard} "
        f"host 'oversize'={ost.fallback_reasons.get('oversize', 0)} "
        f"batches={ost.batches}; launches {colshard_launches}, by (kernel, "
        f"route, W) {colshard_routes}; FASTA byte-equal to the "
        f"single-thread native engine [{card}]")
    stages = ", ".join(f"{k} {v:.4f}" for k, v in ost.stage_s.items())
    log(f"oversize cell host-clock seconds by stage (wall {odt:.4f}): "
        f"{stages}")

    # backend="blocked" on the bench cell: one run.
    bcfg = dataclasses.replace(cfg, backend="blocked")
    x2_zero()
    _, bst, bfasta = run_text(text, bcfg)
    if bfasta != fasta_host:
        raise SystemExit("chip_smoke: bench FASTA (blocked) != single-core C++")
    blocked_launches = {k: x2c.launches[k] for k in X2}
    blocked_launches["dp_scan"] = dp_cuda.launches
    blocked_routes = x2_routes_new("backend='blocked'")
    if any(blocked_launches[k] == 0 for k in X2):
        raise SystemExit(f"chip_smoke: backend='blocked' never ran X2 "
                         f"({blocked_launches})")
    log(f"blocked on the bench cell: batches={bst.batches} rows flagged and "
        f"re-run through B1 {bst.blocked_reruns}; launches "
        f"{blocked_launches}, by (kernel, route, W) {blocked_routes}; FASTA "
        f"byte-equal [{card}]")

    phase("12")
    # ---- phase 12: the multi-device modes ----
    from pbdagcon_tpu_torch.ops.dp import DP_ARGS
    from pbdagcon_tpu_torch.parallel import colshard as csh
    from pbdagcon_tpu_torch.parallel.mesh import Mesh, dp_scores_sharded

    # (a) The bench batch through the sharded DP on meshes of one and of
    # two slots of this card, each bitwise equal to one B1 call on the
    # whole batch; the counts are set to 0 before each sharded run and
    # read after it (the comparison's own launch is not counted). The
    # batch is phase 11's.
    sbatch = {k: bench[k] for k in DP_ARGS}
    meshes = {1: Mesh((dev,)), 2: Mesh((dev, dev))}
    sharded_launches = 0
    whole = dp_cuda.dp_scores_cuda(*(
        torch.from_numpy(np.ascontiguousarray(sbatch[k])).to(dev)
        for k in DP_ARGS)).cpu()
    for n, mesh in meshes.items():
        dp_cuda.launches = 0
        got = torch.from_numpy(dp_scores_sharded(sbatch, mesh))
        launched = dp_cuda.launches
        sharded_launches += launched
        ok = bitwise_equal(got, whole)
        worst = max(worst, max_abs_err(got, whole))
        log(f"sharded DP on {n} slot(s) of {dev} at {tuple(bench['_dims'])}: "
            f"{launched} dp_scan launches; bitwise "
            f"{'OK' if ok else 'MISMATCH'} against one B1 call")
        if not ok or launched != n:
            raise SystemExit(f"chip_smoke: sharded DP on {n} slots != B1")
    sh = [time_ms(lambda m=meshes[n]: dp_scores_sharded(sbatch, m), 3)
          for n in (1, 2, 2, 1)]
    log(f"sharded DP in turns (1, 2, 2, 1 slots; host upload, B1 a slot, "
        f"fetch): {sh[0]} / {sh[1]} / {sh[2]} / {sh[3]} ms [{card}]")
    del bench, sbatch, whole

    # (b) Every target of the oversize cell that the colshard takes
    # (span within the W ladder, the int32 bound at V padded to 64 x 4):
    # the ring over 2 and 4 slots of this card, integer-equal to one slot
    # and to the plain version on the CPU. The counts are set to 0 just
    # before the ring runs and read just after them.
    DMAX = 4
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=threads, align=True
    ) as eng:
        cnt = eng.linearize_text(otext, fmt="pre")
        metas = eng.metas(cnt)
        bands = []
        for i in range(cnt):
            n, span = int(metas[i, 0]), int(metas[i, 1])
            Wb = next((w for w in ocfg.w_buckets if span <= w), None)
            if Wb is None:
                continue
            Vb = -(-n // (64 * DMAX)) * (64 * DMAX)
            pb = native.pack_batch(eng, [i], Vb, Wb, 1)
            if dpb.blocked_safe(dpb.max_escore(pb), Vb):
                bands.append(tuple(np.array(pb[k][0]) for k in (
                    "win_count", "exit_count", "cov", "unsup")))
    if not bands:
        raise SystemExit("chip_smoke: no oversize target for the ring")
    one = [csh.colsharded_scores(*b, Mesh((dev,))) for b in bands]
    plain = [csh.colsharded_scores(*b, device="cpu") for b in bands]
    x2_zero()
    hops0 = csh.hops
    ring = {D: [csh.colsharded_scores(*b, Mesh((dev,) * D)) for b in bands]
            for D in (2, DMAX)}
    torch.cuda.synchronize()
    ring_launches = {k: x2c.launches[k] for k in X2}
    ring_hops = csh.hops - hops0
    for D, outs in ring.items():
        for j, s in enumerate(outs):
            if not (np.array_equal(s.view(np.int32), one[j].view(np.int32))
                    and np.array_equal(s.view(np.int32),
                                       plain[j].view(np.int32))):
                raise SystemExit(f"chip_smoke: ring at D={D} != one slot or "
                                 f"the plain version (target {j})")
    want = len(bands) * (2 + DMAX)
    if any(ring_launches[k] != want for k in X2) or ring_hops != len(bands) * (
            1 + DMAX - 1):
        raise SystemExit(f"chip_smoke: the ring launched {ring_launches}, "
                         f"{ring_hops} hops (want {want} each)")
    big = max(range(len(bands)), key=lambda j: bands[j][0].shape[0])
    rt = {D: time_ms(lambda m=Mesh((dev,) * D): csh.colsharded_scores(
        *bands[big], m), 3) for D in (1, 2, DMAX)}
    log(f"ring over the oversize cell's {len(bands)} colshard targets (V "
        f"{min(b[0].shape[0] for b in bands)}-{max(b[0].shape[0] for b in bands)}"
        f"): at D = 2 and {DMAX} slots of {dev} integer-equal to D = 1 and "
        f"to the plain version; X2 launches {ring_launches}, {ring_hops} hops; "
        f"the largest target (V={bands[big][0].shape[0]}) {rt[1]} / {rt[2]} / "
        f"{rt[DMAX]} ms at D = 1 / 2 / {DMAX} (CUDA events around whole "
        f"calls, each ending with the scores on the host) [{card}]")

    # (c, d) Two CLI ranks (--distributed, gloo on localhost) sharing this
    # card on the bench workload: cuda with -a, then host; each merged
    # FASTA byte-equal to the single-process CLI run's and to the
    # single-thread native engine's.
    root = os.path.dirname(os.path.abspath(__file__))
    dist_dir = os.path.join(_build.BUILD_DIR, "dist")
    shutil.rmtree(dist_dir, ignore_errors=True)
    os.makedirs(dist_dir)
    inp = os.path.join(dist_dir, "bench.pre")
    with open(inp, "wb") as f:
        f.write(text)
    flags = ["-c", str(min_weight), "-m", "100", "-j", str(threads),
             "--fmt", "pre", "-a", "--batch-targets", str(TARGETS)]

    def cli(args, rank=None, port=None):
        env = dict(os.environ, PYTHONPATH=root)
        if rank is not None:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
        out = os.path.join(dist_dir, f"out{rank}.fa")
        return subprocess.Popen(
            [sys.executable, "-m", "pbdagcon_tpu_torch", inp, *flags, *args],
            stdout=open(out, "w"), stderr=subprocess.PIPE, text=True,
            cwd=root, env=env), out

    def finish(p, out):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            raise SystemExit("chip_smoke: a CLI rank hung")
        if p.returncode != 0:
            raise SystemExit(f"chip_smoke: a CLI run failed:\n{err[-3000:]}")
        return open(out).read(), err

    def targets(fasta):
        recs = []  # [sid, lines] a target, its fragments together
        for line in fasta.splitlines(keepends=True):
            if line.startswith(">"):
                sid = line[1:].rsplit("/", 1)[0]
                if not recs or recs[-1][0] != sid:
                    recs.append([sid, []])
            recs[-1][1].append(line)
        return recs

    def merged(a, b):
        ta, tb = targets(a), targets(b)
        return "".join("".join(t[1]) for i in range(max(len(ta), len(tb)))
                       for t in (ta[i:i + 1] + tb[i:i + 1]))

    for backend in ("cuda", "host"):
        args = ["--backend", backend]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ranks = [cli(args + ["--distributed"], r, port) for r in (0, 1)]
        res = [finish(*r) for r in ranks]
        single = finish(*cli(args))
        both = merged(res[0][0], res[1][0])
        if not (both == single[0] == fasta_host):
            raise SystemExit(f"chip_smoke: --distributed --backend {backend}: "
                             "the merged FASTA != the single run's or the "
                             "single-thread native engine's")
        detached = ["detached after shard assignment" in r[1] for r in res]
        if any(d != (backend == "host") for d in detached):
            raise SystemExit(f"chip_smoke: --backend {backend}: ranks "
                             f"detached {detached}")
        log(f"--distributed --backend {backend}: 2 ranks on {dev}, "
            f"{len(targets(res[0][0]))} + {len(targets(res[1][0]))} targets, "
            f"merged FASTA byte-equal to the single run and the "
            f"single-thread native engine (detached {detached}) [{card}]")
    shutil.rmtree(dist_dir, ignore_errors=True)

    phase("13")
    # ---- phase 13: config #3 (high depth) and config #5 (the stream) ----
    from pbdagcon_tpu_torch.tools import bench_highdepth as bhd

    # (a) Config #3, 64 targets x 1000 bp, gapped M5 without -a, at 200x
    # (devbuild's targets pass the 14-bit node cap and take the host,
    # "ins_cap") and at 100x (under it: devbuild at an R rung above 64).
    # The counts are set to 0 just before the runs and read just after.
    dp_cuda.launches = 0
    mxu_cuda.launches.update(hist=0, scatter=0)
    hd = {cov: bhd.bench(cov, 64, 1000, dev, backends=("cuda", "devbuild"),
                         reps=1, threads=threads, log=log)
          for cov in (200, 100)}
    hd_launches = {"dp_scan": dp_cuda.launches, **mxu_cuda.launches}
    for cov, rep in hd.items():
        if not rep["parity"]:
            raise SystemExit(f"chip_smoke: config #3 at {cov}x: a FASTA != "
                             "the single-thread native engine's")
        fb = rep["backends"]["devbuild"]["fallback_reasons"]
        log(f"config #3 at {cov}x: cuda and devbuild byte-equal to the "
            f"single-thread native engine; devbuild fallbacks by reason {fb}"
            f" of {rep['backends']['devbuild']['targets']} [{card}]")
    deep = [r for r in hd[100]["backends"]["devbuild"]["rungs"]
            if r["R"] > 64]
    dev100 = hd[100]["backends"]["devbuild"]["launches"]
    if not deep or dev100["hist"] == 0 or dev100["scatter"] == 0 or any(
            hd[c]["backends"]["cuda"]["launches"]["dp_scan"] == 0
            for c in hd) or dev100["dp_scan"] == 0:
        raise SystemExit(f"chip_smoke: config #3 did not launch B1-B3 at an "
                         f"R rung above 64 ({hd[100]['backends']})")
    held = bhd.hold_window(100, 64, 1000, dev, threads=threads, log=log)
    ex = bhd.exec_only(100, 64, 1000, dev, steps=3, threads=threads, log=log)
    log(f"config #3 launches (cuda and devbuild at 200x and 100x, 2 runs "
        f"each): {hd_launches}; devbuild rungs above R=64 at 100x: {deep}; "
        f"the 100x window's calls (R={held['R']}) equal to the plain "
        f"versions: {held['held']}; exec-only step {ex['bases_per_s']:.1f} "
        f"b/s over the {ex['targets'] - ex['flagged']} unflagged of "
        f"{ex['targets']} targets [{card}]")

    # (b) Config #5: soak_stream on --backend cuda, killed and resumed;
    # (c) two --backend cuda ranks on this card, rank 1 killed and
    # resumed. Each tool exits non-zero on any failed check.
    soak_dir = os.path.join(_build.BUILD_DIR, "soak")
    shutil.rmtree(soak_dir, ignore_errors=True)
    soak_launches: dict = {}

    def soak_tool(module, args):
        res = subprocess.run(
            [sys.executable, "-m", module, *args], capture_output=True,
            text=True, cwd=root, env=dict(os.environ, PYTHONPATH=root),
            timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"chip_smoke: {module} failed "
                             f"(rc {res.returncode}):\n{res.stderr[-3000:]}")
        rep = json.loads(res.stdout.strip().splitlines()[-1])
        for k, v in rep["launches"].items():
            soak_launches[k] = soak_launches.get(k, 0) + v
        return rep

    ss = soak_tool("pbdagcon_tpu_torch.tools.soak_stream", [
        "1200", "--backend", "cuda", "--exactly-once-only", "--poll", "0.1",
        "--threads", str(threads), "--timeout", "300", "--workdir",
        os.path.join(soak_dir, "stream")])
    log(f"soak_stream --backend cuda --exactly-once-only: {ss['targets']} "
        f"targets, SIGKILL at {ss['journaled_at_kill']} journaled, resumed; "
        f"every target once ({ss['dup_inflight_targets']} in flight written "
        f"twice, byte-identical); run 1 {ss['run1_s']:.4f} s, resume "
        f"{ss['resume_s']:.4f} s; max RSS {ss['max_rss_mb']:.1f} MB (too "
        f"short a stream for the RSS bound); launches {ss['launches']} "
        f"[{card}]")
    mr = soak_tool("pbdagcon_tpu_torch.tools.soak_multirank", [
        "1200", "--ranks", "2", "--backend", "cuda", "--threads",
        str(max(1, threads // 2)), "--poll", "0.1", "--timeout", "300",
        "--workdir", os.path.join(soak_dir, "multirank")])
    log(f"soak_multirank, 2 --backend cuda ranks on {dev}: rank 1 SIGKILLed "
        f"at {mr['killed_at']} journaled, survivor rcs {mr['survivor_rcs']}, "
        f"resumed {mr['resumed_ranks']}; {mr['emitted']} targets once, "
        f"byte-equal to one host process; phase A {mr['phaseA_s']:.4f} s, "
        f"resume {mr['resume_s']:.4f} s; launches {mr['launches']} [{card}]")
    if soak_launches.get("dp_scan", 0) == 0:
        raise SystemExit(f"chip_smoke: the soaks launched no B1 "
                         f"({soak_launches})")
    shutil.rmtree(soak_dir, ignore_errors=True)

    phase(None)
    # ---- results ----
    log(card)
    hist_ms, hist_plain, hist_lib, hist_bound = timed["hist"]
    sc_ms, sc_plain, sc_lib, sc_bound = timed["scatter"]
    print(json.dumps({"kernels": [{
        "name": "dp_scan",
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/dp_scan.cu",
        "replaces": "pbdagcon_tpu/ops/dp_pallas.py:40",
        "launches": cuda_path_launches + dev_launches["dp_scan"]
        + blocked_launches["dp_scan"] + colshard_launches["dp_scan"]
        + sharded_launches + hd_launches["dp_scan"]
        + soak_launches.get("dp_scan", 0) + auto_launches["dp_scan"]
        + hybrid_long_launches["dp_scan"],
        "launches_by_path": {"cuda": cuda_path_launches,
                             "devbuild": dev_launches["dp_scan"],
                             "blocked": blocked_launches["dp_scan"],
                             "colshard": colshard_launches["dp_scan"],
                             "sharded": sharded_launches,
                             "highdepth": hd_launches["dp_scan"],
                             "soak": soak_launches.get("dp_scan", 0),
                             "auto_bench": auto_launches["dp_scan"],
                             "hybrid_long": hybrid_long_launches["dp_scan"]},
        "highdepth": {"exec_only": ex, "window": held,
                      "by_cov": {c: {b: {k: r[k] for k in (
                          "bases_per_s", "vs_1core", "fallback_reasons",
                          "rungs", "launches")}
                          for b, r in rep["backends"].items()}
                          for c, rep in hd.items()}},
        "sharded_ms": {"turns_1_2_2_1_slots": sh},
        "max_abs_err": max(worst, held["worst"]["dp_scan"]),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": dp_bound,
        "bound_by": "bytes",
        # No one PyTorch call computes a banded max-plus scan.
        "library_ms": None,
        "devbuild_call": {"ms": (dpw_ka + dpw_kb) / 2,
                          "plain_ms": (dpw_pa + dpw_pb) / 2,
                          "bound_ms": dpw_bound},
    }, {
        "name": "hist",
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/hist_scatter.cu",
        "replaces": "pbdagcon_tpu/ops/mxu.py:60",
        "launches": dev_launches["hist"] + hd_launches["hist"]
        + soak_launches.get("hist", 0) + auto_launches["hist"]
        + hybrid_long_launches["hist"],
        "launches_by_path": {"devbuild": dev_launches["hist"],
                             "highdepth": hd_launches["hist"],
                             "soak": soak_launches.get("hist", 0),
                             "auto_bench": auto_launches["hist"],
                             "hybrid_long": hybrid_long_launches["hist"]},
        "highdepth_window": {"R": held["R"], "calls": held["held"]["hist"],
                             "max_abs_err": held["worst"]["hist"]},
        "max_abs_err": max(worst_k["hist"], held["worst"]["hist"]),
        "ms": hist_ms,
        "plain_ms": hist_plain,
        "bound_ms": hist_bound,
        "bound_by": "bytes",
        "library_ms": hist_lib,
        "window_masked": window_masked["hist"],
        "per_call": per_call["hist"],
    }, {
        "name": "scatter",
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/hist_scatter.cu",
        "replaces": "pbdagcon_tpu/ops/mxu.py:305",
        "launches": dev_launches["scatter"] + hd_launches["scatter"]
        + soak_launches.get("scatter", 0) + auto_launches["scatter"]
        + hybrid_long_launches["scatter"],
        "launches_by_path": {"devbuild": dev_launches["scatter"],
                             "highdepth": hd_launches["scatter"],
                             "soak": soak_launches.get("scatter", 0),
                             "auto_bench": auto_launches["scatter"],
                             "hybrid_long": hybrid_long_launches["scatter"]},
        "highdepth_window": {"R": held["R"], "calls": held["held"]["scatter"],
                             "max_abs_err": held["worst"]["scatter"]},
        "max_abs_err": max(worst_k["scatter"], held["worst"]["scatter"]),
        "ms": sc_ms,
        "plain_ms": sc_plain,
        "bound_ms": sc_bound,
        "bound_by": "bytes",
        "library_ms": sc_lib,
        "window_masked": window_masked["scatter"],
        "per_call": per_call["scatter"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/pk_variants.cu",
        "replaces": f"tools/prof_pk.py:{line}",
        "launches": pk_launches[name],
        "max_abs_err": worst_p[name],
        "ms": window_ms[name],
        "plain_ms": window_ms[f"{op} plain"],
        "bound_ms": window_ms[f"{op} bound"],
        "bound_by": "bytes",
        "library_ms": window_ms[f"{op} library"],
        "prof_pk_ms": {k: v for k, v in prof_ms.items() if tag in k},
    } for name, line, op, tag in (
        ("hist_v1", 58, "hist", "v1 P1"), ("hist_v2", 113, "hist", "v2 P2"),
        ("pallas_scatter", 169, "scatter", "P3"))] + [{
        "name": name,
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/align_scan.cu",
        "replaces": f"pbdagcon_tpu/ops/align_tpu.py:{line}",
        "launches": align_launches[name],
        "launches_by_path": {"align_device": align_launches[name],
                             "dazcon": dz_launches[name]},
        "max_abs_err": worst_a[name],
        "ms": x1[name]["ms"],
        "plain_ms": x1[name]["plain_ms"],
        "bound_ms": x1[name]["bound_ms"],
        "bound_by": x1[name]["bound_by"],
        # No one PyTorch call computes a banded alignment scan, walk or
        # replay of moves into gapped rows.
        "library_ms": None,
        **({"scan_route": "warp", "cta_ms": x1[name]["cta_ms"]}
           if name == "align_scan" else {
               "traceback_route": max(tb_routes, key=tb_routes.get),
               "thread_ms": x1[name]["thread_ms"],
               "chain": x1[name]["chain"],
               "b32_call": x1[name]["b32_call"]}
           if name == "align_traceback" else {
               "ms_from": "CUDA graph of 20 calls",
               "eager_ms": x1[name]["eager_ms"]}),
    } for name, line in (("align_scan", 88), ("align_traceback", 47),
                         ("align_replay", 244))] + [{
        "name": name,
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/dp_blocked.cu",
        "replaces": f"pbdagcon_tpu/ops/dp_blocked.py:{line} (_solve_band, "
                    f":104); pbdagcon_tpu/parallel/colshard.py:{cs_line}",
        "launches": colshard_launches[name] + blocked_launches[name]
        + ring_launches[name],
        "launches_by_path": {"colshard": colshard_launches[name],
                             "blocked": blocked_launches[name],
                             "ring": ring_launches[name]},
        "ring": {"targets": len(bands), "slots": [2, DMAX], "hops": ring_hops,
                 "largest_target_ms_by_slots": rt},
        "max_abs_err": worst_x2,
        "ms": x2_bench[name]["ms"],
        "plain_ms": x2_bench[name]["plain_ms"],
        "bound_ms": x2_bench[name]["bound_ms"],
        "bound_by": x2_bench[name]["bound_by"],
        # No one PyTorch call computes a max-plus solve.
        "library_ms": None,
        "oversize_call": x2_over[name],
        "plan_route": x2_bench[name]["plan_route"],
        **({"cta_ms": x2_bench[name]["cta_ms"]}
           if name != "blocked_fill" else {
               "reduce_ms": x2_bench[name]["reduce_ms"],
               "graph_turns_ms": x2_bench[name]["graph_turns_ms"],
               "chain": x2_over[name]["chain"]}),
        "launches_by_route": {
            f"{r}/W={w}": colshard_routes.get((name, r, w), 0)
            + blocked_routes.get((name, r, w), 0)
            for (kn, r, w) in sorted({*colshard_routes, *blocked_routes})
            if kn == name},
    } for name, line, cs_line in (("blocked_compose", 121, 46),
                                  ("blocked_propagate", 137, 89),
                                  ("blocked_fill", 152, 116))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
