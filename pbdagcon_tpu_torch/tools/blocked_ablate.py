"""Kernel X2's compose, propagate and fill (`csrc/dp_blocked.cu`) on
their routes, in turns, at the bench batch's shape and at one oversize
target's.

    python -m pbdagcon_tpu_torch.tools.blocked_ablate [--reps N]

The two shapes are `chip_smoke.py` phase 11's: the bench batch (B=512,
V=5632, W=16, K=32, L=64) and one oversize target (B=1, V=31360, W=32,
L=128, G=245), here filled by `ops/dp.py::random_batch` from the seed,
so no native engine is needed (no kernel's time depends on the band's
values). Each route is first held integer-equal to its plain phase
(`_compose`, `_propagate`, `_fill`) on the card (exit 1 if not). Then,
each line in the order old, new, new, old: the compose's "cta" and
"column" routes, the propagate's "cta" and "warp" routes and the fill's
"reduce" and "lane" routes, in device ms a launch (an eager loop of
launches between CUDA events), beside the bound (the larger of the
bytes read and written once at 3.35 TB/s and the int32 operations, an
add and a max a term, at 64 x 132 x 1.98 GHz), and for the propagate
and the fill the ns a step of their chains (G and L steps); then the
new routes under forced plans (the compose's blocks a CTA, the
propagate's matrices a ring slot, slots and targets a CTA, the fill's
blocks a warp) against the unforced plan; builds with parts switched
off (`X2_ABLATE` bits; their outputs may be wrong, only their times
count); the phase clocks (-D X2_PROF=1: cycles a step of target 0's
consumer warp and its producer in the propagate; cycles of the fill's
warp of block 0 in its copies, start terms, steps and stores); and the
three kernels of a solve on the new routes against the first design's.
ptxas' registers and spills of the build come first. Exit 2 without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 1234
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# (label, B, V, W, K): chip_smoke.py phase 11's two shapes.
SHAPES = (("bench batch", 512, 5632, 16, 32),
          ("oversize target", 1, 31360, 32, 1))
# Each ablation build's -D define and what it leaves out.
BUILDS = {
    "X2_ABLATE=1": "no proxy fence before a ring slot's bulk copy",
    "X2_ABLATE=2": "no M stores in the compose (wrong)",
    "X2_ABLATE=4": "no row arithmetic in the propagate (wrong)",
    "X2_ABLATE=8": "no steps in the compose (wrong)",
    "X2_ABLATE=16": "no a rows formed in the compose (wrong)",
    "X2_ABLATE=26": "the compose's copies alone (wrong)",
    "X2_ABLATE=32": "add and max as two instructions, not one DPX",
    "X2_ABLATE=64": "no ring refills, stale slots read (wrong)",
    "X2_ABLATE=128": "no band copies in the fill's lane route (wrong)",
    "X2_ABLATE=256": "no steps in the fill's lane route (wrong)",
    "X2_ABLATE=384": "the fill's gathers, start terms and stores alone (wrong)",
}
PROF = "X2_PROF=1"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


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


def _bound_ms(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


def _shape(label, B, V, W, K, reps, card) -> int:
    import numpy as np
    import torch

    from pbdagcon_tpu_torch.convert import batch_to_torch
    from pbdagcon_tpu_torch.ops import _build
    from pbdagcon_tpu_torch.ops import dp as tdp
    from pbdagcon_tpu_torch.ops import dp_blocked as dpb
    from pbdagcon_tpu_torch.ops import dp_blocked_cuda as x2c

    rng = np.random.default_rng(SEED)
    t = batch_to_torch(tdp.random_batch(rng, B, V, W, K), "cuda")
    win, cov, uns = t["win_count"], t["cov"], t["unsup"]
    e_ex = dpb.exit_half_units(t["exit_count"])
    L = dpb._blocked_L(V)
    G, Wp = V // L, W + 1
    a = dpb._rows(dpb._esc2_band(win, cov, uns), e_ex, L)
    M_p = dpb._compose(a)
    x_p = dpb._propagate(M_p)
    s_p = dpb._fill(a, x_p)

    def compose(plan):
        return lambda: x2c.compose_cuda(win, cov, uns, e_ex, L, plan=plan)

    def propagate(plan):
        return lambda: x2c.propagate_cuda(M_p, plan=plan)

    def fill(plan):
        return lambda: x2c.fill_cuda(win, cov, uns, e_ex, x_p, L, plan=plan)

    c_new, c_old = x2c.compose_plan(B, G, W, L), x2c.compose_plan(
        B, G, W, L, route="cta")
    p_new, p_old = x2c.propagate_plan(B, G, W), x2c.propagate_plan(
        B, G, W, route="cta")
    for plan in (c_new, c_old):
        if not torch.equal(compose(plan)(), M_p):
            print(f"blocked_ablate: compose {plan} != _compose ({label})")
            return 1
    for plan in (p_new, p_old):
        if not torch.equal(propagate(plan)(), x_p):
            print(f"blocked_ablate: propagate {plan} != _propagate ({label})")
            return 1
    f_new, f_old = x2c.fill_plan(B, G, W, L), x2c.fill_plan(
        B, G, W, L, route="reduce")
    for plan in (f_new, f_old):
        if not torch.equal(fill(plan)(), s_p):
            print(f"blocked_ablate: fill {plan} != _fill ({label})")
            return 1
    band = sum(x.numel() * x.element_size() for x in (win, cov, uns, e_ex))
    mb, xb = M_p.numel() * 4, x_p.numel() * 4
    print(f"{label} B={B} V={V} W={W} L={L} G={G}: compose plan {c_new}, "
          f"propagate plan {p_new}, fill plan {f_new}; both routes of each "
          f"integer-equal to the plain phases [{card}]", flush=True)
    rows = (("blocked_compose", compose(c_old), compose(c_new),
             band + mb, 2 * Wp * Wp * B * V, "cta", "column"),
            ("blocked_propagate", propagate(p_old), propagate(p_new),
             mb + xb, 2 * Wp * Wp * B * G, "cta", "warp"),
            ("blocked_fill", fill(f_old), fill(f_new), band + xb + B * V * 4,
             2 * Wp * B * V, "reduce", "lane"))
    for name, old, new, nbytes, ops, r_old, r_new in rows:
        turns = [_time_ms(f, reps) for f in (old, new, new, old)]
        per_step = ""
        steps = {"blocked_propagate": G, "blocked_fill": L}.get(name)
        if steps:
            per_step = (f"; {r_new} {(turns[1] + turns[2]) / 2 * 1e6 / steps:.1f}"
                        f" ns a step of {steps}, {r_old} "
                        f"{(turns[0] + turns[3]) / 2 * 1e6 / steps:.1f}")
        print(f"  {name} ms a launch ({r_old}, {r_new}, {r_new}, {r_old}): "
              f"{turns}; bound {_bound_ms(nbytes, ops)} ms (bytes {nbytes}, "
              f"int32 ops {ops}){per_step} [{card}]", flush=True)
    base = _time_ms(compose(c_new), reps)
    for nb in (1, 3, 5, 9, 15):
        try:
            plan = x2c.compose_plan(B, G, W, L, blocks=nb)
        except ValueError:
            continue
        if not torch.equal(compose(plan)(), M_p):
            print(f"blocked_ablate: compose {plan} != _compose ({label})")
            return 1
        print(f"  compose blocks={nb} (threads {plan['threads']}, smem "
              f"{plan['smem']}): {_time_ms(compose(plan), reps)} ms against "
              f"the plan's {base} [{card}]", flush=True)
    base = _time_ms(propagate(p_new), reps)
    for kw in (dict(chunk=1), dict(chunk=4), dict(chunk=16), dict(depth=2),
               dict(depth=3), dict(warps=1), dict(warps=2), dict(warps=8)):
        try:
            plan = x2c.propagate_plan(B, G, W, **kw)
        except ValueError:
            continue
        if not torch.equal(propagate(plan)(), x_p):
            print(f"blocked_ablate: propagate {plan} != _propagate ({label})")
            return 1
        print(f"  propagate {kw} (warps {plan['warps']}, chunk "
              f"{plan['chunk']}, depth {plan['depth']}): "
              f"{_time_ms(propagate(plan), reps)} ms against the plan's "
              f"{base} [{card}]", flush=True)
    base = _time_ms(fill(f_new), reps)
    for nb in (1, 2):
        try:
            plan = x2c.fill_plan(B, G, W, L, blocks=nb)
        except ValueError:
            continue
        if not torch.equal(fill(plan)(), s_p):
            print(f"blocked_ablate: fill {plan} != _fill ({label})")
            return 1
        print(f"  fill blocks={nb} (warps {plan['warps']}, smem "
              f"{plan['smem']}): {_time_ms(fill(plan), reps)} ms against the "
              f"plan's {base} [{card}]", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for define in (*BUILDS, PROF):
        lib = _build.load("dp_blocked", (define,))

        def c_run():
            M = torch.empty_like(M_p)
            rc = lib.dagcon_blocked_compose(
                win.data_ptr(), cov.data_ptr(), uns.data_ptr(), e_ex.data_ptr(),
                M.data_ptr(), B, V, W, L, 1, c_new["blocks"],
                c_new["threads"], c_new["smem"], stream)
            _build.check(lib, rc, "blocked_compose launch")

        def p_run():
            x = torch.empty_like(x_p)
            rc = lib.dagcon_blocked_propagate(
                M_p.data_ptr(), x.data_ptr(), B, G, W, 1, p_new["warps"],
                p_new["depth"], p_new["chunk"], p_new["smem"], stream)
            _build.check(lib, rc, "blocked_propagate launch")
            return x

        def f_run():
            s2 = torch.empty((B, V), dtype=torch.int32, device=win.device)
            rc = lib.dagcon_blocked_fill(
                win.data_ptr(), cov.data_ptr(), uns.data_ptr(), e_ex.data_ptr(),
                x_p.data_ptr(), s2.data_ptr(), B, V, W, L, 1, f_new["blocks"],
                f_new["warps"], f_new["smem"], stream)
            _build.check(lib, rc, "blocked_fill launch")

        what = BUILDS.get(define, "the phase clocks")
        line = (f"  -D {define} ({what}): compose {_time_ms(c_run, reps)} ms, "
                f"propagate {_time_ms(p_run, reps)} ms, fill "
                f"{_time_ms(f_run, reps)} ms")
        if define == PROF:
            lib.dagcon_x2_prof_read.restype = ctypes.c_int
            lib.dagcon_x2_prof_read.argtypes = [ctypes.c_void_p]
            lib.dagcon_x2_prof_reset.restype = ctypes.c_int
            torch.cuda.synchronize()
            lib.dagcon_x2_prof_reset()
            p_run()
            f_run()
            torch.cuda.synchronize()
            pr = np.zeros(16, dtype=np.uint64)
            rc = lib.dagcon_x2_prof_read(pr.ctypes.data)
            if rc:
                raise RuntimeError(f"dagcon_x2_prof_read failed ({rc})")
            n = max(1, int(pr[5]))
            line += (f"; cycles a step of target 0: consumer next wait and "
                     f"row loads {pr[0] / n:.0f}, exit row and rows "
                     f"{pr[1] / n:.0f}, x written and released "
                     f"{pr[2] / n:.0f}; producer waiting {pr[3] / n:.0f}, "
                     f"writing x_in {pr[4] / n:.0f}, issuing {pr[6] / n:.0f} "
                     f"({n} steps); fill, cycles of block 0's warp: copies "
                     f"and gathers {pr[8]}, start terms {pr[9]}, steps "
                     f"{pr[10]} ({pr[10] / max(1, int(pr[12])):.1f} a step of "
                     f"{pr[12]}), stores {pr[11]}")
        print(f"{line} [{card}]", flush=True)

    def solve(cp, pp, fp):
        def run():
            M = x2c.compose_cuda(win, cov, uns, e_ex, L, plan=cp)
            x_in = x2c.propagate_cuda(M, plan=pp)
            return x2c.fill_cuda(win, cov, uns, e_ex, x_in, L, plan=fp)
        return run

    old, new = solve(c_old, p_old, f_old), solve(c_new, p_new, f_new)
    if not torch.equal(new(), old()):
        print(f"blocked_ablate: the solve's routes disagree ({label})")
        return 1
    turns = [_time_ms(f, reps) for f in (old, new, new, old)]
    print(f"  solve (compose, propagate, fill) ms (first design, new routes, "
          f"new, first): {turns} [{card}]", flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    from pbdagcon_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blocked_ablate: no CUDA card", file=sys.stderr)
        return 2
    card = _card()
    t = time.time()
    builds = [(), *((d,) for d in (*BUILDS, PROF))]
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda d: _build.build("dp_blocked", d), builds))
    _build.load("dp_blocked")
    print(f"built dp_blocked and {len(builds) - 1} ablation and clock builds "
          f"in {time.time() - t:.1f} s", flush=True)
    log = _build.build_logs.get("dp_blocked", "")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    for shape in SHAPES:
        rc = _shape(*shape, a.reps, card)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
