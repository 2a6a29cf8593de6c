"""Randomised end-to-end soak of the port's devbuild path against the
host path: random pileup shapes through the CLI's pipeline
(`pipeline.run_stream`, as `python -m pbdagcon_tpu_torch` runs it), each
trial's FASTA on "devbuild" byte-equal to "host"'s.

    python -m pbdagcon_tpu_torch.tools.soak_devbuild [trials] [offset]
        [--device cuda|cpu]

Trial t draws from `random.Random(90_000 + t)`: M5 (a third of the
records reverse-strand) or gapped 'pre', 1-6 targets of 40-900 bp at
2-70x under one of three noise profiles, `-c` in {1, 2, 4, 8}, `-m` in
{1, 25, 100}, `-t` in {0, 0, 3}. It prints a FAIL line for each trial
whose outputs differ, then the trial count, the failures and the host
fallbacks over the targets, and exits 1 if any trial failed.
"""

from __future__ import annotations

import argparse
import io
import random
import sys


def trial_input(trial: int) -> tuple[str, dict]:
    """Trial `trial`'s records and its config knobs."""
    from pbdagcon_tpu_torch.simulate import (
        NoiseProfile,
        simulate_pileup,
        to_m5,
        to_pre,
    )

    profiles = [
        NoiseProfile(),
        NoiseProfile(sub=0.05, ins=0.2, dele=0.1),
        NoiseProfile(sub=0.02, ins=0.25, dele=0.12, max_ins_run=5),
    ]
    rng = random.Random(90_000 + trial)
    fmt = rng.choice(["m5", "pre"])
    lines = []
    for t in range(rng.randint(1, 6)):
        _bb, alns = simulate_pileup(
            rng, f"t{trial}_{t}", rng.randint(40, 900), rng.randint(2, 70),
            profiles[trial % 3],
        )
        for a in alns:
            lines.append(to_m5(a, flip=rng.random() < 0.3) if fmt == "m5"
                         else to_pre(a))
    kw = dict(
        fmt=fmt,
        min_weight=rng.choice([1, 2, 4, 8]),
        min_length=rng.choice([1, 25, 100]),
        trim=rng.choice([0, 0, 3]),
    )
    return "\n".join(lines) + "\n", kw


def soak(trials: int, offset: int = 0, device="cuda", log=print) -> dict:
    """Run the trials; returns {"trials", "fails", "fallbacks",
    "targets"}."""
    from pbdagcon_tpu_torch.config import DagconConfig
    from pbdagcon_tpu_torch.io import FastaWriter
    from pbdagcon_tpu_torch.pipeline import run_stream

    fails = fallbacks = targets = 0
    for trial in range(offset, offset + trials):
        text, kw = trial_input(trial)
        b1, b2 = io.StringIO(), io.StringIO()
        run_stream(io.StringIO(text), FastaWriter(b1),
                   DagconConfig(backend="host", use_native=True, **kw))
        st = run_stream(io.StringIO(text), FastaWriter(b2), DagconConfig(
            backend="devbuild", use_native=True, device=str(device), **kw))
        targets += st.targets
        fallbacks += st.host_fallbacks
        if b1.getvalue() != b2.getvalue():
            fails += 1
            log(f"FAIL trial {trial} ({kw})")
    log(f"soak: {trials} trials, {fails} fails, fallbacks "
        f"{fallbacks}/{targets} targets")
    return {"trials": trials, "fails": fails, "fallbacks": fallbacks,
            "targets": targets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trials", nargs="?", type=int, default=40)
    ap.add_argument("offset", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from pbdagcon_tpu_torch import native
    from pbdagcon_tpu_torch.config import resolve_device

    device = resolve_device(a.device)
    if not native.ensure_built():
        raise SystemExit("soak_devbuild: the native engine failed to build")
    res = soak(a.trials, a.offset, device,
               log=lambda *x: print(*x, flush=True))
    return 1 if res["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
