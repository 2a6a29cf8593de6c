#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`pbdagcon_tpu_torch`) on one
CUDA card: `python3 chip_smoke.py` from the root of a checkout.

Phases, in order; any failure exits non-zero before the last line:

1. Require CUDA, print the card's name and power limit, build the native
   engine (`make -C native`).
2. Build the DP kernel (`csrc/dp_scan.cu`, nvcc, sm_90a) and hold it
   against its plain PyTorch version on the card, bitwise (0 ulp): random
   arena batches over W in {16,32,64,128} x K in {8,32,128} (B not a
   multiple of 32, long edges, unsup nodes, -1 gaps), then one real batch of the
   bench workload from the native packer, where both are timed with
   CUDA events.
3. The main path at full size: the bench workload (512 targets x 1000 bp
   x 30x, seed 1234, raw 'pre' records, -a host aligner) through
   `pipeline.run_stream` with backend "cuda". The FASTA must be
   byte-equal to the single-thread native engine's, and the kernel's
   launch count over the run must be > 0.
4. A JSON line of kernels, then the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

SEED = 1234
TARGETS, LENGTH, COVERAGE = 512, 1000, 30
GRID_B, GRID_V = 37, 700


def log(*a) -> None:
    print(*a, flush=True)


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
    from pbdagcon_tpu_torch.config import DagconConfig
    from pbdagcon_tpu_torch.ops import _build, dp_cuda
    from pbdagcon_tpu_torch.ops.dp import (
        dp_scores_reference,
        random_batch,
        to_arena,
        unpack_arena,
    )
    from pbdagcon_tpu_torch.pipeline import _choose_layout_native, run_stream

    t = time.time()
    if not native.ensure_built():
        raise SystemExit("chip_smoke: the native engine failed to build")
    log(f"native engine ready in {time.time() - t:.1f}s")

    # ---- phase 2: kernel vs plain version, bitwise ----
    t = time.time()
    _build.load("dp_scan")
    log(f"dp_scan built in {time.time() - t:.1f}s")
    for line in _build.build_logs.get("dp_scan", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for W in (16, 32, 64, 128):
        for K in (8, 32, 128):
            arena = to_arena(random_batch(rng, GRID_B, GRID_V, W, K))
            args = unpack_arena(torch.from_numpy(arena).to(dev),
                                GRID_B, GRID_V, W, K)
            got = dp_cuda.dp_scores_cuda(*args)
            want = dp_scores_reference(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            ok = bitwise_equal(got, want)
            log(f"grid B={GRID_B} V={GRID_V} W={W:3d} K={K:3d}: "
                f"bitwise {'OK' if ok else 'MISMATCH'} max_abs_err={err}")
            if not ok:
                raise SystemExit("chip_smoke: kernel != plain version")

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
    log(f"dp_scan at B={B} V={V} W={W} K={K}: kernel {kernel_a} / "
        f"{kernel_b} ms, plain PyTorch {plain_a} / {plain_b} ms [{card}]")
    del args, got, want, batch

    # ---- phase 3: the main path at full size ----
    def run_port():
        out = io.StringIO()
        t0 = time.time()
        stats = run_stream(
            io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg
        )
        return time.time() - t0, stats, out.getvalue()

    run_port()  # warm-up: pinned-memory pool, CUDA context, caches
    dp_cuda.launches = 0
    runs = [run_port() for _ in range(3)]
    launches = dp_cuda.launches
    dts = sorted(r[0] for r in runs)
    _, stats, fasta = runs[-1]
    bases = sum(len(l) for l in fasta.splitlines() if not l.startswith(">"))

    t = time.time()
    with native.NativeEngine(
        min_weight=min_weight, min_length=100, threads=1, align=True
    ) as eng:
        fasta_host = eng.consensus_text(text, fmt="pre")
    host_dt = time.time() - t
    if any(r[2] != fasta_host for r in runs):
        raise SystemExit("chip_smoke: port FASTA != single-core C++ FASTA")
    if bases == 0 or stats.targets != TARGETS:
        raise SystemExit(f"chip_smoke: bad run: {stats}")
    if launches == 0:
        raise SystemExit("chip_smoke: the main path never launched dp_scan")
    log(f"main path: targets={stats.targets} batches={stats.batches} "
        f"consensus_bases={bases} host_fallbacks={stats.host_fallbacks} "
        f"dp_scan launches={launches} (3 runs); FASTA byte-equal to the "
        f"single-thread native engine [{card}]")
    if stats.host_fallbacks:
        log(f"host fallbacks by reason: {stats.fallback_reasons}")
    stages = ", ".join(f"{k} {v:.4f}" for k, v in stats.stage_s.items())
    log(f"host-clock seconds by stage (last run, wall {runs[-1][0]:.4f}): "
        f"{stages}")
    log(f"port end-to-end: {bases / dts[1]:.1f} b/s median of 3 "
        f"(min {bases / dts[-1]:.1f}, max {bases / dts[0]:.1f}; "
        f"{threads} host threads) [{card}]")
    log(f"single-core C++ engine: {bases / host_dt:.1f} b/s [{card} host]")

    # One more run under torch.profiler: device busy time (the union of
    # kernel and copy spans on the card) against the run's wall time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        traced_dt, _, traced_fa = run_port()
    if traced_fa != fasta_host:
        raise SystemExit("chip_smoke: traced run FASTA != single-core C++")
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    if spans:
        log(f"traced run: wall {traced_dt:.4f} s, device busy "
            f"{busy_us / 1e3:.3f} ms, idle share "
            f"{1 - busy_us / 1e6 / traced_dt:.4f} [{card}]")
        for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
            log(f"  device {us / 1e3:.3f} ms  {name[:90]}")
    else:
        log("traced run: the profiler recorded no device spans; device "
            "busy time not measured")

    # ---- phase 4: results ----
    log(card)
    print(json.dumps({"kernels": [{
        "name": "dp_scan",
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/dp_scan.cu",
        "replaces": "pbdagcon_tpu/ops/dp_pallas.py:40",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
