#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`pbdagcon_tpu_torch`) on one
CUDA card: `python3 chip_smoke.py` from the root of a checkout.

Phases, in order; any failure exits non-zero before the last line:

1. Require CUDA, print the card's name and power limit, build the native
   engine (`make -C native`) and the kernels (`csrc/dp_scan.cu`,
   `csrc/hist_scatter.cu`, `csrc/pk_variants.cu`: one nvcc each, started
   together, sm_90a).
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
   through `pipeline.run_stream` with backend "cuda". The FASTA must be
   byte-equal to the single-thread native engine's, and the DP kernel's
   launch count over the run must be > 0.
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
   warm-up then 3 runs; every FASTA byte-equal to the single-thread
   native engine's, and the launches of hist, scatter and dp_scan over
   the runs each > 0. Prints the host fallbacks by reason, the stages'
   host-clock seconds, b/s, and a traced run's device busy time.
6. A JSON line of kernels (each with its launches on the main paths,
   max_abs_err, ms, plain_ms, bound_ms and library_ms; hist and scatter
   also with their masked window and their per-call readings), then the
   last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 1234
TARGETS, LENGTH, COVERAGE = 512, 1000, 30
GRID_B, GRID_V = 37, 700
DEVBUILD_BATCH = 128  # bench.py's batch_targets for the devbuild path
KERNEL_SOURCES = ("dp_scan", "hist_scatter", "pk_variants")
# Device-memory rate of an H100 SXM (80 GB HBM3), the `bound_ms` basis.
HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: int) -> float:
    """Least ms to move `nbytes` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def trace_report(label, prof, wall, card, top, batches=None) -> None:
    """Device busy time (the union of kernel and copy spans on the card)
    of a torch.profiler run against its wall time, and the top spans."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        log(f"{label}: the profiler recorded no device spans; device busy "
            "time not measured")
        return
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    per = f"; {len(spans)} device spans over {batches} batches" if batches else ""
    log(f"{label}: wall {wall:.4f} s, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / 1e6 / wall:.4f}{per} [{card}]")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:top]:
        log(f"  device {us / 1e3:.3f} ms  {name[:90]}")


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
    # The bound: every input read once and the scores written once.
    dp_bound = bound_ms(nbytes(*args, got))
    top = start_rows(args[0], args[1], args[4])
    scanned = torch.where(top >= 0, (top // 4 + 1) * 4, 0)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    log(f"dp_scan at B={B} V={V} W={W} K={K}: kernel {kernel_a} / "
        f"{kernel_b} ms, plain PyTorch {plain_a} / {plain_b} ms, bound "
        f"{dp_bound} ms ({nbytes(*args, got)} bytes) [{card}]")
    log(f"dp_scan rows scanned: {int(scanned.sum())} of {B * V} (longest "
        f"target {int(scanned.max())}); {kernel_ms * 1e-3 * clock_mhz * 1e6 / int(scanned.max())} "
        f"cycles per row of the longest target at the {clock_mhz} MHz max "
        f"SM clock")
    del args, got, want, batch

    # ---- phase 3: the native-loader path at full size ----
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
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        traced_dt, _, traced_fa = run_port()
    if traced_fa != fasta_host:
        raise SystemExit("chip_smoke: traced run FASTA != single-core C++")
    trace_report("traced run", prof, traced_dt, card, top=6)

    cuda_path_launches = launches

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
    dpw_bound = bound_ms(nbytes(*dp_args, got))
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
            return sum(nbytes(v) + (0 if m is None else nbytes(m))
                       + v.shape[0] * D * 4 for v, m, D in cs)
        return sum(nbytes(r, *ps) + (0 if m is None else nbytes(m))
                   + len(ps) * r.shape[0] * D * 4 for r, m, ps, D, _ in cs)

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

    run_dev()  # warm-up
    dp_cuda.launches = 0
    mxu_cuda.launches.update(hist=0, scatter=0)
    druns = [run_dev() for _ in range(3)]
    dev_launches = {"dp_scan": dp_cuda.launches, **mxu_cuda.launches}
    if any(r[2] != fasta_host for r in druns):
        raise SystemExit("chip_smoke: devbuild FASTA != single-core C++ FASTA")
    ddts = sorted(r[0] for r in druns)
    _, dstats, _ = druns[-1]
    if dstats.targets != TARGETS or any(v == 0 for v in dev_launches.values()):
        raise SystemExit(f"chip_smoke: devbuild path did not run its kernels "
                         f"({dev_launches}, {dstats})")
    emitted = dstats.targets - dstats.host_fallbacks
    log(f"devbuild path: targets={dstats.targets} batches={dstats.batches} "
        f"launches over 3 runs {dev_launches}; FASTA byte-equal to the "
        f"single-thread native engine in every run [{card}]")
    log(f"devbuild host fallbacks by reason: {dstats.fallback_reasons} "
        f"({dstats.host_fallbacks} of {dstats.targets}; the device emitted "
        f"{emitted / dstats.targets:.4f} of the targets)")
    stages = ", ".join(f"{k} {v:.4f}" for k, v in dstats.stage_s.items())
    log(f"devbuild host-clock seconds by stage (last run, wall "
        f"{druns[-1][0]:.4f}): {stages} [{card}]")
    log(f"devbuild end-to-end: {bases / ddts[1]:.1f} b/s median of 3 "
        f"(min {bases / ddts[-1]:.1f}, max {bases / ddts[0]:.1f}; "
        f"{threads} host threads) [{card}]")
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        traced_dt, tstats, traced_fa = run_dev()
    if traced_fa != fasta_host:
        raise SystemExit("chip_smoke: traced devbuild FASTA != single-core C++")
    trace_report("devbuild traced run", prof, traced_dt, card, top=10,
                 batches=tstats.batches)

    # ---- phase 6: results ----
    log(card)
    hist_ms, hist_plain, hist_lib, hist_bound = timed["hist"]
    sc_ms, sc_plain, sc_lib, sc_bound = timed["scatter"]
    print(json.dumps({"kernels": [{
        "name": "dp_scan",
        "route": "cuda",
        "source": "pbdagcon_tpu_torch/csrc/dp_scan.cu",
        "replaces": "pbdagcon_tpu/ops/dp_pallas.py:40",
        "launches": cuda_path_launches + dev_launches["dp_scan"],
        "launches_by_path": {"cuda": cuda_path_launches,
                             "devbuild": dev_launches["dp_scan"]},
        "max_abs_err": worst,
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
        "launches": dev_launches["hist"],
        "max_abs_err": worst_k["hist"],
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
        "launches": dev_launches["scatter"],
        "max_abs_err": worst_k["scatter"],
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
        ("pallas_scatter", 169, "scatter", "P3"))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
