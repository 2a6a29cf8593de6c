"""Kernel X1 (`csrc/align_scan.cu`) on the bench batch, its routes in
turns and beside builds with parts switched off or clocked.

    python -m pbdagcon_tpu_torch.tools.align_ablate [--reps N]
        [--parts scan,traceback]

The bench batch is the first 1024 raw records of the bench workload
(512 targets x 1000 bp x 30x, seed 1234, `NoiseProfile()`), prepared by
`ops/align_tpu.py::prepare_batch` (B=1024, M=1280, Wa=768, L=2304), as
`chip_smoke.py`'s phase 7 makes it.

The scan: the "warp" route against the "cta" route, beside builds of
the warp route with parts switched off (`X1_ABLATE` bits; their pointers
are wrong, only their times count) and its pair clocks (-D X1_PROF=1).
The traceback: the "warp" route against the "thread" route, on the
bench batch and on its first 32 pairs (dazcon's rung), beside forced
stage plans (rows, window bytes), the build whose look-ahead reads one
row, a step an event (-D X1_TB_ABLATE=1, exact), and its pair records
(-D X1_PROF=1): pointer reads outside the staged windows (0 expected on
the bench batch), and the longest walk's steps, ns and cycles a step,
stage waits and stores. Every route and build is held array-equal to
the plain version first (exit 1 if not). Each timing line gives the
device ms per launch (an eager loop of launches between CUDA events) in
the order old, new, new, old, and the bound: the bytes moved once at
3.35 TB/s. Exit 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 1234
TARGETS, LENGTH, COVERAGE = 512, 1000, 30
RECORDS = 1024
HBM_BYTES_PER_S = 3.35e12
# Each ablation build's -D define and what it leaves out.
BUILDS = {
    "X1_ABLATE=1": "no stores of the computed rows",
    "X1_ABLATE=2": "no closed-form rows past m + 1",
    "X1_ABLATE=4": "no warp scan of the thread totals",
    "X1_ABLATE=3": "no stores at all (compute only)",
}
PROF = "X1_PROF=1"
TB_ABLATE = "X1_TB_ABLATE=1"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def bench_pairs(records: int = RECORDS) -> list[tuple[str, str]]:
    """(query, target) of the bench workload's first `records` raw
    records."""
    from pbdagcon_tpu_torch.simulate import (
        NoiseProfile,
        simulate_targets,
        to_pre_raw,
    )

    lines: list[str] = []
    for _tid, _bb, alns in simulate_targets(
        SEED, TARGETS, LENGTH, COVERAGE, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
        if len(lines) >= records:
            break
    return [(f[5], f[6]) for f in (ln.split() for ln in lines[:records])]


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> int:
    import torch

    from pbdagcon_tpu_torch.ops import _build, align_tpu

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="scan,traceback")
    a = ap.parse_args(argv)
    parts = set(a.parts.split(","))
    if not torch.cuda.is_available():
        print("align_ablate: no CUDA card", file=sys.stderr)
        return 2
    card = _card()
    t = time.time()
    builds = [(), (PROF,), (TB_ABLATE,),
              *((k,) for k in BUILDS if "scan" in parts)]
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda d: _build.build("align_scan", d), builds))
    print(f"built align_scan and {len(builds) - 1} profiling and ablation "
          f"builds in {time.time() - t:.1f} s", flush=True)
    for key, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error")):
                print(f"  ptxas {key}: {line.strip()}")

    dev = torch.device("cuda")
    p = align_tpu.prepare_batch(bench_pairs())
    args = [torch.from_numpy(p[k]).to(dev)
            for k in ("qb", "tb_pad", "m", "n", "bw")]
    if "scan" in parts:
        rc = _scan(a, p, args, card)
        if rc:
            return rc
    if "traceback" in parts:
        return _traceback(a, p, args, card)
    return 0


def _scan(a, p, args, card) -> int:
    import numpy as np
    import torch

    from pbdagcon_tpu_torch.ops import _build, align_cuda, align_tpu

    dev = args[0].device
    M, Wa, dmin = p["M"], p["Wa"], p["dmin"]
    B = args[0].shape[0]
    plans = {r: align_cuda.scan_plan(p["m"], p["n"], p["bw"], M, Wa, dmin,
                                     route=r) for r in ("cta", "warp")}
    auto = align_cuda.scan_plan(p["m"], p["n"], p["bw"], M, Wa, dmin)
    print(f"bench batch: B={B} M={M} Wa={Wa} dmin={dmin}; plan "
          f"{auto['route']}, warp plan {plans['warp']} [{card}]", flush=True)
    got = {r: align_cuda.align_scan_cuda(*args, M, Wa, dmin, plans[r])
           for r in plans}
    want = align_tpu.align_scan_plain(*args, M, Wa, dmin)
    torch.cuda.synchronize()
    ok = all(torch.equal(g, want) for g in got.values())
    for r, g in got.items():
        bad = int((g != want).sum())
        print(f"{r} route against the plain version: "
              f"{'array-equal' if not bad else f'{bad} bytes differ'}")
    if not ok:
        return 1

    nbytes = sum(x.numel() for x in args[:2]) + 12 * B + want.numel()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    packed = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    order = torch.from_numpy(plans["warp"]["order"]).to(dev)

    def launcher(lib, plan):
        def run():
            rc = lib.dagcon_align_scan(
                *(x.data_ptr() for x in args), packed.data_ptr(),
                order.data_ptr() if plan["route"] == "warp" else None, B, M,
                args[1].shape[1], Wa, dmin, align_cuda.ROUTES[plan["route"]],
                plan.get("warps", 0), plan.get("cpl_max", 0), plan["smem"],
                stream)
            if rc:
                raise RuntimeError(f"align_scan launch failed ({rc})")
        return run

    whole = _build.load("align_scan")
    cta = launcher(whole, plans["cta"])
    warp = launcher(whole, plans["warp"])
    # The warp route with the pairs in their own order, 4 a CTA.
    plain_order = torch.arange(B, dtype=torch.int32, device=dev)
    p4 = align_cuda.scan_plan(p["m"], p["n"], p["bw"], M, Wa, dmin,
                              route="warp", warps=4)

    def warp_in_order():
        rc = whole.dagcon_align_scan(
            *(x.data_ptr() for x in args), packed.data_ptr(),
            plain_order.data_ptr(), B, M, args[1].shape[1], Wa, dmin, 1, 4,
            p4["cpl_max"], p4["smem"], stream)
        if rc:
            raise RuntimeError(f"align_scan launch failed ({rc})")

    turns = [_time_ms(f, a.reps) for f in (cta, warp, warp, cta)]
    print(f"align_scan bench batch, ms a launch (cta, warp, warp, cta): "
          f"{turns}; warp {(turns[1] + turns[2]) / 2} against cta "
          f"{(turns[0] + turns[3]) / 2}; bound {bound} ms (bytes {nbytes}) "
          f"[{card}]", flush=True)
    wa, wb = _time_ms(warp, a.reps), _time_ms(warp_in_order, a.reps)
    print(f"  pairs in their own order, 4 a CTA: {wb} ms against the plan's "
          f"{plans['warp']['warps']} a CTA in a snake {wa} [{card}]",
          flush=True)
    for define, what in BUILDS.items():
        lib = _build.load("align_scan", (define,))
        run = launcher(lib, plans["warp"])
        if "ABLATE" not in define:
            run()
            torch.cuda.synchronize()
            if not torch.equal(packed, want):
                print(f"  {define}: MISMATCH against the plain version")
                return 1
        wa, wb = _time_ms(warp, a.reps), _time_ms(run, a.reps)
        print(f"  {define} ({what}): {wb} ms against the whole warp route "
              f"{wa} [{card}]", flush=True)
    # Pair clocks (-D X1_PROF=1): when each pair's warp ends, its rows
    # and CPL, its SM and warp slot, and what shares that SM's slot.
    plib = _build.load("align_scan", (PROF,))
    plib.dagcon_x1_prof_read.restype = ctypes.c_int
    plib.dagcon_x1_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    prun = launcher(plib, plans["warp"])
    prun()
    torch.cuda.synchronize()
    prof = np.zeros((B, 12), dtype=np.uint64)
    rc = plib.dagcon_x1_prof_read(prof.ctypes.data, B)
    if rc:
        raise RuntimeError(f"dagcon_x1_prof_read failed ({rc})")
    t0 = int(prof[:, 0].min())
    start = (prof[:, 0].astype(np.int64) - t0) / 1e3
    end = (prof[:, 1].astype(np.int64) - t0) / 1e3
    rows, cpl = prof[:, 2].astype(np.int64), prof[:, 3].astype(np.int64)
    sm, wid = prof[:, 4].astype(np.int64), prof[:, 5].astype(np.int64)
    print(f"pair clocks: last end {end.max():.1f} us, median end "
          f"{np.median(end):.1f} us, starts within {start.max():.1f} us; "
          f"SMs used {len(set(sm.tolist()))} [{card}]")
    print(f"  ns a row by CPL class (median over pairs): " + ", ".join(
        f"{c}: {np.median((end - start)[cpl == c] * 1e3 / rows[cpl == c]):.0f}"
        for c in sorted(set(cpl.tolist()))))
    phases = prof[:, 6:].astype(np.float64)
    for b in np.argsort(-end)[:6]:
        print(f"  pair {b}: cycles a row by phase (first pass, warp scan, "
              f"second pass + shift, stores): "
              f"{[round(float(x), 1) for x in phases[b] / rows[b]]}")
        mates = [int(x) for x in np.flatnonzero((sm == sm[b]) & (wid % 4 == wid[b] % 4))
                 if x != b]
        print(f"  pair {b}: end {end[b]:.1f} us, rows {rows[b]}, CPL {cpl[b]}, "
              f"{(end[b] - start[b]) * 1e3 / rows[b]:.0f} ns a row, SM "
              f"{sm[b]} warp {wid[b]}; its scheduler's other pairs (rows, CPL, "
              f"end us): {[(int(rows[x]), int(cpl[x]), round(float(end[x]), 1)) for x in mates]}")
    print(f"warp route CPL classes (pairs): {plans['warp']['cpl_counts']}; "
          f"rows computed {int(np.minimum(p['m'] + 1, M).sum())} of "
          f"{B * M}")
    return 0


def _traceback(a, p, args, card) -> int:
    import numpy as np
    import torch

    from pbdagcon_tpu_torch.ops import _build, align_cuda, align_tpu

    dev = args[0].device
    M, Wa, dmin, L = p["M"], p["Wa"], p["dmin"], p["L"]
    packed = align_cuda.align_scan_cuda(*args, M, Wa, dmin)
    m, n = args[2], args[3]
    want = align_tpu.traceback_plain(packed, m, n, M, Wa, dmin, L)
    torch.cuda.synchronize()
    mv = want.cpu().numpy()
    steps = (mv != 3).sum(axis=1)
    longest = int(steps.max())
    stream = torch.cuda.current_stream().cuda_stream

    def plan_of(B, **kw):
        pl = align_cuda.traceback_plan(p["m"][:B], p["n"][:B], M, Wa, L, **kw)
        if "order" in pl:
            pl["order"] = torch.from_numpy(pl["order"]).to(dev)
        return pl

    def launcher(lib, B, plan):
        out = torch.empty((B, L), dtype=torch.uint8, device=dev)
        pk, mm, nn = (x[:B].contiguous() for x in (packed, m, n))
        order = plan.get("order")

        def run():
            rc = lib.dagcon_align_traceback(
                pk.data_ptr(), mm.data_ptr(), nn.data_ptr(), out.data_ptr(),
                None if order is None else order.data_ptr(), B, M, Wa, dmin,
                L, align_cuda.TB_ROUTES[plan["route"]], plan["warps"],
                plan.get("rows", 0), plan.get("window", 0), plan["smem"],
                stream)
            if rc:
                raise RuntimeError(f"align_traceback launch failed ({rc})")
            return out
        return run

    def held(run, B, what) -> bool:
        got = run()
        torch.cuda.synchronize()
        ok = torch.equal(got, want[:B])
        if not ok:
            print(f"  traceback {what}: MISMATCH against the plain version")
        return ok

    whole = _build.load("align_scan")
    B = len(p["m"])
    nbytes = int(steps.sum()) + 8 * B + B * L
    print(f"traceback bench batch: B={B} L={L}, path steps {int(steps.sum())}"
          f", longest {longest}; plan {plan_of(B)['route']}, "
          f"{ {k: v for k, v in plan_of(B).items() if k != 'order'} } "
          f"[{card}]", flush=True)
    for nb in (B, 32):
        thread = launcher(whole, nb, plan_of(nb, route="thread"))
        warp = launcher(whole, nb, plan_of(nb))
        if not (held(thread, nb, "thread") and held(warp, nb, "warp")):
            return 1
        turns = [_time_ms(f, a.reps) for f in (thread, warp, warp, thread)]
        lg = int(steps[:nb].max())
        print(f"align_traceback B={nb}, ms a launch (thread, warp, warp, "
              f"thread): {turns}; warp {(turns[1] + turns[2]) / 2} against "
              f"thread {(turns[0] + turns[3]) / 2}; longest path {lg} steps, "
              f"{(turns[1] + turns[2]) / 2 * 1e6 / lg:.1f} ns a step [{card}]",
              flush=True)
    print(f"  bound {nbytes / HBM_BYTES_PER_S * 1e3} ms (bytes {nbytes}: the "
          f"path steps' pointer bytes, m and n, the moves)")
    warp = launcher(whole, B, plan_of(B))
    for kw in ({"rows": 64}, {"rows": 256}, {"window": 32},
               {"window": 128}, {"warps": 4}):
        run = launcher(whole, B, plan_of(B, **kw))
        if not held(run, B, str(kw)):
            return 1
        wa, wb = _time_ms(warp, a.reps), _time_ms(run, a.reps)
        print(f"  plan {kw}: {wb} ms against the plan's {wa} [{card}]",
              flush=True)
    ab = launcher(_build.load("align_scan", (TB_ABLATE,)), B, plan_of(B))
    if not held(ab, B, TB_ABLATE):
        return 1
    wa, wb = _time_ms(warp, a.reps), _time_ms(ab, a.reps)
    print(f"  {TB_ABLATE} (a look-ahead of one row: a step an event): {wb} ms "
          f"against {wa} [{card}]", flush=True)
    plib = _build.load("align_scan", (PROF,))
    plib.dagcon_x1_tb_prof_read.restype = ctypes.c_int
    plib.dagcon_x1_tb_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    prun = launcher(plib, B, plan_of(B))
    if not held(prun, B, PROF):
        return 1
    prof = np.zeros((B, 12), dtype=np.uint64)
    rc = plib.dagcon_x1_tb_prof_read(prof.ctypes.data, B)
    if rc:
        raise RuntimeError(f"dagcon_x1_tb_prof_read failed ({rc})")
    pr = prof.astype(np.int64)
    t0 = pr[:, 0].min()
    end = (pr[:, 1] - t0) / 1e3
    slow = int(pr[:, 3].sum())
    print(f"traceback pair records: pointer reads outside the windows "
          f"{slow} (steps in windows {int(pr[:, 4].sum())} of "
          f"{int(pr[:, 2].sum())}); last end {end.max():.1f} us, median "
          f"{np.median(end):.1f} us, starts within "
          f"{(pr[:, 0].max() - t0) / 1e3:.1f} us; SMs "
          f"{len(set(pr[:, 7].tolist()))} [{card}]")
    for b in np.argsort(-end)[:4]:
        st, ev = max(1, int(pr[b, 9])), max(1, int(pr[b, 11]))
        print(f"  pair {b}: {pr[b, 2]} steps ({pr[b, 4]} in windows, "
              f"{pr[b, 3]} outside) in {(pr[b, 1] - pr[b, 0]) / 1e3:.1f} us, "
              f"{(pr[b, 1] - pr[b, 0]) / max(1, pr[b, 2]):.1f} ns a step; "
              f"cycles walking {pr[b, 8]} in {ev} events ({pr[b, 8] / ev:.1f}"
              f" an event, {pr[b, 8] / max(1, pr[b, 4]):.1f} a step), "
              f"entering {st} stages {pr[b, 5]} ({pr[b, 5] / st:.0f} a "
              f"stage, {pr[b, 10] / st:.0f} of it waiting), writing moves "
              f"{pr[b, 6]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
