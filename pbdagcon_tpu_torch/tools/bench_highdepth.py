"""High-depth benchmark of the port (BASELINE.json config #3: 100-500x
coverage): the device paths against the single-core native engine,
checked for FASTA parity.

    python -m pbdagcon_tpu_torch.tools.bench_highdepth [cov] [n_targets] [length]
        [--device cuda|cpu] [--backends cuda,devbuild,hybrid]
    python -m pbdagcon_tpu_torch.tools.bench_highdepth exec [cov] [n_targets]
        [length] [--device cuda|cpu]

The workload is gapped M5 without `-a` (config #3 stresses the merge and
vote engine, not the re-aligner): `simulate_targets(4321, n_targets,
length, cov)` with the default noise, `-c cov // 4 -m 100`; defaults
200x, 64 targets of 1000 bp, 4 host threads. Each backend runs through
`pipeline.run_stream` twice (the best wall counts) and its FASTA
must be byte-equal to `NativeEngine`'s on one thread (`run_stream` on
"host", one thread: the 1-core yardstick). A line a backend gives b/s,
the ratio to the 1-core run, the host fallbacks by reason, the device
batches by shape rung (V/W/K on `cuda`; R/C/L/W/V on devbuild) and the
kernels' launches (B1 `dp_scan`, B2 `hist`, B3 `scatter`).

At the default noise, 200x exceeds devbuild's 14-bit node cap: a target's
inserted bases (~ length x cov x 0.09) pass ND = 2^14 - 1, so the whole
target takes the host, counted as "ins_cap" (the JAX package records the
same limit in its tool's comments). 100x stays under it.

`exec` is the execute-only harness at depth: one window of the encoded
targets (caps as the devbuild path chooses them) built, scored and
backtracked on the device (`devpipe.run_batch`: the build with B2/B3,
B1, the backtrack) 3 times back to back, timed with CUDA events (host
clock on the CPU); it prints the step rate in b/s over the targets the
device emits, and the flagged ones beside it.

Any parity failure or error exits non-zero; nothing is caught.
"""

from __future__ import annotations

import argparse
import functools
import io
import json
import sys
import time

SEED = 4321


@functools.lru_cache(maxsize=2)
def highdepth_text(cov: int, n_targets: int, length: int,
                   seed: int = SEED) -> bytes:
    """Config #3's gapped M5 records from `seed` (the last two kept:
    simulating 200x takes seconds)."""
    from pbdagcon_tpu_torch.simulate import (
        NoiseProfile,
        simulate_targets,
        to_m5,
    )

    lines = [to_m5(a) for _t, _b, alns in simulate_targets(
        seed, n_targets, length, cov, NoiseProfile()) for a in alns]
    return ("\n".join(lines) + "\n").encode()


def min_weight(cov: int) -> int:
    return max(2, cov // 4)


def launches() -> dict[str, int]:
    """Kernel launches so far in this process (`cli.launch_counts`),
    B1, B2 and B3 always among them."""
    from pbdagcon_tpu_torch.cli import launch_counts
    from pbdagcon_tpu_torch.ops import dp_cuda, mxu_cuda  # noqa: F401

    return launch_counts()


def since(before: dict[str, int]) -> dict[str, int]:
    """The launches since `before` (a `launches()` reading)."""
    return {k: v - before.get(k, 0) for k, v in launches().items()}


def rung_list(rungs: dict) -> list[dict]:
    """`PipelineStats.rungs` as JSON: one {dim: size, "batches": n} a
    rung."""
    return [{**dict(k), "batches": n} for k, n in rungs.items()]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_backend(text: bytes, backend: str, cov: int, device="cuda",
                threads: int = 4, reps: int = 1) -> dict:
    """`reps` runs of `run_stream` on `backend`: the best wall, the last
    run's FASTA and statistics, and the launches over all runs."""
    from pbdagcon_tpu_torch.config import DagconConfig
    from pbdagcon_tpu_torch.io import FastaWriter
    from pbdagcon_tpu_torch.pipeline import run_stream

    cfg = DagconConfig(fmt="m5", align=False, min_weight=min_weight(cov),
                       min_length=100, backend=backend, use_native=True,
                       threads=threads, device=str(device))
    best = None
    before = launches()
    for _ in range(reps):
        buf = io.StringIO()
        t0 = time.time()
        st = run_stream(io.BytesIO(text), FastaWriter(buf), cfg)
        if backend != "host":
            _sync(device)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    fa = buf.getvalue()
    bases = sum(len(l) for l in fa.splitlines() if not l.startswith(">"))
    return {"fasta": fa, "bases": bases, "wall": best, "stats": st,
            "launches": since(before)}


def bench(cov: int = 200, n_targets: int = 64, length: int = 1000,
          device="cuda", backends=("cuda", "devbuild", "hybrid"),
          reps: int = 2, threads: int = 4, log=print) -> dict:
    """Every backend against the 1-core host run. Returns the report;
    its "parity" is True only if every FASTA was byte-equal."""
    text = highdepth_text(cov, n_targets, length)
    log(f"highdepth: {n_targets} targets x {length} bp x {cov}x "
        f"({len(text) / 1e6:.1f} MB), -c {min_weight(cov)} -m 100, "
        f"device {device}")
    host = run_backend(text, "host", cov, device, threads=1)
    t_h = host["wall"]
    log(f"highdepth: host 1-core {host['bases'] / t_h:.1f} b/s ({t_h:.4f} s, "
        f"{host['bases']} bases)")
    report = {"cov": cov, "targets": n_targets, "length": length,
              "device": str(device), "bases": host["bases"],
              "host_1core_s": t_h, "parity": True, "backends": {}}
    for b in backends:
        r = run_backend(text, b, cov, device, threads=threads, reps=reps)
        st = r["stats"]
        ok = r["fasta"] == host["fasta"]
        report["parity"] &= ok
        report["backends"][b] = {
            "wall_s": r["wall"], "bases_per_s": r["bases"] / r["wall"],
            "vs_1core": t_h / r["wall"], "parity": ok,
            "targets": st.targets, "host_fallbacks": st.host_fallbacks,
            "fallback_reasons": dict(st.fallback_reasons),
            "rungs": rung_list(st.rungs), "batches": st.batches,
            "launches": r["launches"],
            **({"dev_chunks": st.hybrid_dev_chunks,
                "host_chunks": st.hybrid_host_chunks} if b == "hybrid" else {}),
        }
        log(f"highdepth: {b} {r['bases'] / r['wall']:.1f} b/s "
            f"({r['wall']:.4f} s) vs 1-core = {t_h / r['wall']:.4f}x "
            f"parity={'OK' if ok else 'MISMATCH'}; fallbacks "
            f"{st.host_fallbacks}/{st.targets} {dict(st.fallback_reasons)}; "
            f"rungs {rung_list(st.rungs)}; launches over {reps} runs "
            f"{r['launches']}")
    return report


def exec_only(cov: int = 200, n_targets: int = 128, length: int = 1000,
              device="cuda", steps: int = 3, threads: int = 4,
              log=print) -> dict:
    """The device-resident devbuild step at depth: one window (the first
    min(count, n_targets) targets, caps as the path chooses them,
    `bins_ablate.window_batch`) built, scored and backtracked `steps`
    times back to back (after a warm-up step), timed with CUDA events
    on a card. Returns the caps, the window's targets, the flagged ones,
    the launches a step and the rate in b/s over the targets the device
    emits (the flagged ones take the host on the path)."""
    import torch

    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.tools.bins_ablate import window_batch

    dev = torch.device(device)
    mw = min_weight(cov)
    text = highdepth_text(cov, n_targets, length)
    with native.NativeEngine(min_weight=mw, min_length=100, threads=threads,
                             align=False) as eng:
        count = eng.encode_text(text, fmt="m5", flush=True)
        inputs, caps, P, n = window_batch(eng, count, dev)
    log(f"highdepth exec {cov}x: caps={caps}; {n} of {count} targets in "
        f"the window")
    if not n:
        return {"cov": cov, "caps": str(caps), "R": caps.R, "targets": 0,
                "flagged": 0, "bases_per_s": 0.0}

    def step():
        return devpipe.run_batch(inputs, caps, P, mw, packed=True)

    out = step()  # warm-up
    _sync(dev)
    before = launches()
    if dev.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(steps):
            out = step()
        t1.record()
        torch.cuda.synchronize(dev)
        dt = t0.elapsed_time(t1) / 1e3
    else:
        t = time.perf_counter()
        for _ in range(steps):
            out = step()
        dt = time.perf_counter() - t
    per_step = {k: v / steps for k, v in since(before).items()}
    host = {k: v.cpu().numpy() for k, v in out.items()}
    flagged = sum(why is not None for why in devpipe.fallback_reasons(host, n))
    rate = (n - flagged) * length * steps / dt
    log(f"highdepth exec-only {cov}x: {rate:.1f} b/s over the {n - flagged} "
        f"unflagged of {n} targets ({flagged} flagged to the host; "
        f"{steps} steps, {dt:.4f} s; launches a step {per_step})")
    return {"cov": cov, "caps": str(caps), "R": caps.R, "targets": n,
            "flagged": flagged, "steps": steps, "seconds": dt,
            "bases_per_s": rate, "launches_per_step": per_step}


def hold_window(cov: int, n_targets: int, length: int, device="cuda",
                threads: int = 4, log=print) -> dict:
    """Every hist (B2), scatter (B3) and DP (B1) call of one devbuild
    window of the high-depth encode (the first min(count, 128) targets,
    caps as `devpipe` chooses them), captured with its inputs and held
    against its plain version: integer-equal, the scores bitwise. On a
    card; returns the window's caps, the calls held and the worst
    integer difference (0 where equal). Raises on any disagreement."""
    import torch

    from pbdagcon_tpu_torch import native
    from pbdagcon_tpu_torch.ops import dp_cuda, mxu, mxu_cuda
    from pbdagcon_tpu_torch.ops.dp import dp_scores_reference
    from pbdagcon_tpu_torch.tools.bins_ablate import capture_window

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("hold_window holds the kernels: it needs a card")
    text = highdepth_text(cov, n_targets, length)
    with native.NativeEngine(min_weight=min_weight(cov), min_length=100,
                             threads=threads, align=False) as eng:
        count = eng.encode_text(text, fmt="m5", flush=True)
        calls, caps, n = capture_window(eng, min(count, 128),
                                        min_weight(cov), dev)
    worst = {"hist": 0, "scatter": 0, "dp_scan": 0}

    def err(a, b) -> int:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    for v, valid, D in calls["hist"]:
        got, want = mxu_cuda.hist_cuda(v, valid, D), mxu.hist_reference(
            v, valid, D)
        worst["hist"] = max(worst["hist"], err(got, want))
    for r, valid, ps, D, cut in calls["scatter"]:
        for a, b in zip(mxu_cuda.scatter_cuda(r, valid, ps, D, cut),
                        mxu.scatter_reference(r, valid, ps, D, cut)):
            worst["scatter"] = max(worst["scatter"], err(a, b))
    for args in calls["dp"]:
        got = dp_cuda.dp_scores_cuda(*args)
        want = dp_scores_reference(*args)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        worst["dp_scan"] = max(worst["dp_scan"], 0 if same else 1)
    held = {"hist": len(calls["hist"]), "scatter": len(calls["scatter"]),
            "dp_scan": len(calls["dp"])}
    log(f"highdepth window {cov}x ({n} targets, R={caps.R} C={caps.C} "
        f"L={caps.L} W={caps.W} V={caps.V} ND={caps.ND}): calls held "
        f"against the plain versions {held}, worst difference {worst}")
    if any(worst.values()) or not all(held.values()):
        raise SystemExit(f"bench_highdepth: a kernel disagrees with its "
                         f"plain version at R={caps.R} ({worst}, {held})")
    return {"cov": cov, "R": caps.R, "caps": str(caps), "targets": n,
            "held": held, "worst": worst}


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    do_exec = "exec" in argv
    if do_exec:
        argv.remove("exec")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cov", nargs="?", type=int, default=200)
    ap.add_argument("n_targets", nargs="?", type=int,
                    default=128 if do_exec else 64)
    ap.add_argument("length", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backends", default="cuda,devbuild,hybrid")
    a = ap.parse_args(argv)
    from pbdagcon_tpu_torch import native
    from pbdagcon_tpu_torch.config import resolve_device

    device = resolve_device(a.device)
    if not native.ensure_built():
        raise SystemExit("bench_highdepth: the native engine failed to build")
    if do_exec:
        report = exec_only(a.cov, a.n_targets, a.length, device, log=_log)
    else:
        report = bench(a.cov, a.n_targets, a.length, device,
                       tuple(b for b in a.backends.split(",") if b), log=_log)
    print(json.dumps({"metric": "bench_highdepth", **report}), flush=True)
    return 0 if report.get("parity", True) else 1


if __name__ == "__main__":
    sys.exit(main())
