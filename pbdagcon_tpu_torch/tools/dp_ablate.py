"""What bounds the DP kernel: builds of `csrc/dp_scan.cu` with parts
switched off (`DP_ABLATE` bits; their scores are wrong, only their times
count) or with the general near/far split at W = 16 (`DP_W16_D0=8`),
timed on the card in turns against the whole kernel.

    python -m pbdagcon_tpu_torch.tools.dp_ablate [--reps N]

Inputs are `ops.dp.random_batch` batches from seed 0 at the bench batch's
shape (B=512, V=5632, W=16, K=32) and at the devbuild calls' (B=128,
V=5632, W=48, K=32). Each line gives the device ms per launch (an eager
loop of launches between CUDA events, two readings in turns) and the
cycles per row of the longest target at the card's max SM clock. A
`phases` line per shape splits the whole kernel's cycles per row of the
longest target by phase, from a build with clock64() phase counters
(`-D DP_PROF=1`; its own time is on the line too). Exit 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

PHASES = ("setup", "wait", "fill+ring", "near table", "top group",
          "group loop", "store+flush", "refill")
# Each build's -D define and what it measures.
BUILDS = {
    "DP_ABLATE=0": "whole kernel",
    "DP_ABLATE=1": "no far terms (band d >= D0, long-edge folds, reduction)",
    "DP_ABLATE=2": "no near terms d > 0",
    "DP_ABLATE=4": "no near table per chunk",
    "DP_ABLATE=8": "no warp reduction",
    "DP_ABLATE=7": "the d = 0 chain, latches, window shift, staging only",
    "DP_W16_D0=8": "D0 = 8 at W = 16 too (elsewhere the whole kernel)",
}
SHAPES = ((512, 5632, 16, 32), (128, 5632, 48, 32))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import numpy as np
    import torch

    from pbdagcon_tpu_torch.ops import _build
    from pbdagcon_tpu_torch.ops.dp import (
        random_batch,
        start_rows,
        to_arena,
        unpack_arena,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_ablate: no CUDA card", file=sys.stderr)
        return 2
    card = _card()
    clock_mhz = float(card.split(",")[-1])
    defines = {k: (k,) for k in BUILDS}
    prof_def = ("DP_PROF=1",)
    with ThreadPoolExecutor(len(defines) + 1) as ex:
        list(ex.map(lambda d: _build.build("dp_scan", d),
                    [*defines.values(), prof_def]))
    libs = {k: _build.load("dp_scan", d) for k, d in defines.items()}
    prof_lib = _build.load("dp_scan", prof_def)
    prof_lib.dagcon_dp_prof_read.restype = ctypes.c_int
    prof_lib.dagcon_dp_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for k in BUILDS:
        for line in _build.build_logs.get(" ".join(("dp_scan",) + defines[k]),
                                          "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {k}: {line.strip()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B, V, W, K in SHAPES:
        args = unpack_arena(
            torch.from_numpy(to_arena(random_batch(rng, B, V, W, K))).to(dev),
            B, V, W, K,
        )
        out = torch.empty((B, V), dtype=torch.float32, device=dev)
        top = start_rows(args[0], args[1], args[4])
        longest = int(((top // 4 + 1) * 4).max())
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]

        def run(lib):
            rc = lib.dagcon_dp_scan(*ptrs, B, V, W, K, stream)
            _build.check(lib, rc, "dp_scan launch")

        def time_ms(lib) -> float:
            run(lib)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(a.reps):
                run(lib)
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / a.reps

        ms = {k: [] for k in BUILDS}
        for k in list(BUILDS) + list(BUILDS)[::-1]:
            ms[k].append(time_ms(libs[k]))
        for k, desc in BUILDS.items():
            avg = sum(ms[k]) / 2
            print(f"dp_scan B={B} V={V} W={W} K={K} {k} "
                  f"({desc}): {ms[k][0]:.4f} / {ms[k][1]:.4f} ms, "
                  f"{avg * 1e-3 * clock_mhz * 1e6 / longest:.1f} cycles per "
                  f"row of the longest target ({longest} rows) [{card}]",
                  flush=True)
        prof_ms = time_ms(prof_lib)
        clocks = np.zeros((B, len(PHASES) + 1), np.uint64)
        _build.check(prof_lib, prof_lib.dagcon_dp_prof_read(
            clocks.ctypes.data, B), "dp_scan phase read")
        t = int(np.argmax(clocks[:, -1]))
        rows = max(int(clocks[t, -1]), 1)
        parts = ", ".join(f"{name} {int(c) / rows:.1f}"
                          for name, c in zip(PHASES, clocks[t, :-1]))
        print(f"dp_scan B={B} V={V} W={W} K={K} phases (DP_PROF build, "
              f"{prof_ms:.4f} ms): cycles per row of the longest target "
              f"({rows} rows): {parts}; total "
              f"{int(clocks[t, :-1].sum()) / rows:.1f} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
