"""devbuild's host assemble stage on a cut of a benchmark cell's records.

Runs backend devbuild once over the first `--targets` targets of a
benchmark configuration's records (the same generator, widths and knobs
as the cell `--cell`; only the target count is cut) and prints one JSON
line: the run's wall, `stage_s` (the pipeline's host stages, `assemble`
among them), fragments, bases and fallback reasons. It also keeps every
batch the run fetched and times, on those same arrays, the per-target
assembly (`assemble_fragments` a row) against the batch assembly
(`assemble_batch`, where the package has it), and checks that they
agree; and the emitter's count of fragments and bases over the written
FASTA text against a count over the results.

    python -m pbdagcon_tpu_torch.tools.assemble_turns --device cpu --targets 64

To hold another tree's package against this one on the same records,
run this file with that tree first on the path:

    PYTHONPATH=<tree> python pbdagcon_tpu_torch/tools/assemble_turns.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="cfg2-1k-align-devbuild")
    ap.add_argument("--targets", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import pbdagcon_tpu_torch
    from pbdagcon_tpu_torch import devpipe
    from pbdagcon_tpu_torch.bench import cells as C
    from pbdagcon_tpu_torch.bench.run import dagcon_config
    from pbdagcon_tpu_torch.io import FastaWriter, format_fasta
    from pbdagcon_tpu_torch.ops import devemit
    from pbdagcon_tpu_torch.pipeline import run_stream

    cell = C.CELLS[args.cell]
    cfg = dataclasses.replace(C.CONFIGS[cell.config], targets=args.targets)
    device = torch.device(args.device)
    dcfg = dagcon_config(cell, cfg, device)
    text = C.config_text(cfg, args.seed)

    fetched: list[dict] = []
    result = devpipe._Fetch.result

    def keep(self):
        o = result(self)
        fetched.append(o)
        return o

    devpipe._Fetch.result = keep
    try:
        t0 = time.perf_counter()
        stats = run_stream(io.StringIO(text.decode()), FastaWriter(io.StringIO()), dcfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        devpipe._Fetch.result = result

    # The emitted rows of every fetched batch, as the emitter reads them.
    batches = []
    for o in fetched:
        emitted = ~(o["flags"].astype(bool) | o["ambiguous"] | o["overflow"])
        rows = np.nonzero(emitted)[0]
        bk = o["bk"][rows]
        batches.append((bk & 0x7F, bk >= 128, o["bbpos"][rows], o["path_len"][rows]))

    def per_target():
        return [[devemit.assemble_fragments(b[j], k[j], p[j], int(n[j]), cfg.min_length)
                 for j in range(len(n))] for b, k, p, n in batches]

    def batch():
        return [devemit.assemble_batch(b, k, p, n, cfg.min_length)
                for b, k, p, n in batches]

    def best(fn):
        times = []
        for _ in range(args.reps):
            t = time.perf_counter()
            got = fn()
            times.append(time.perf_counter() - t)
        return min(times), got

    layer: dict = {"batches": len(batches), "rows": sum(len(b[3]) for b in batches),
                   "steps": int(sum(b[3].sum() for b in batches))}
    layer["per_target_s"], want = best(per_target)
    # The emitter's count of fragments and bases, over the written text
    # against over the results.
    targets = [t for b in want for t in b]
    texts = [format_fasta("t", t) for t in targets]
    layer["count_text_s"], _ = best(lambda: [
        (t.count(">"), sum(len(x) for x in t.splitlines() if not x.startswith(">")))
        for t in texts])
    layer["count_results_s"], _ = best(lambda: [
        (len(t), sum(len(r.seq) for r in t)) for t in targets])
    if hasattr(devemit, "assemble_batch"):
        layer["batch_s"], got = best(batch)
        layer["equal"] = [[[(r.range, r.seq) for r in t] for t in b] for b in got] == [
            [[(r.range, r.seq) for r in t] for t in b] for b in want]
    print(json.dumps({
        "package": pbdagcon_tpu_torch.__file__, "cell": args.cell,
        "targets": args.targets, "device": args.device, "wall_s": wall,
        "stage_s": stats.stage_s, "fragments": stats.fragments,
        "consensus_bases": stats.consensus_bases,
        "fallback_reasons": stats.fallback_reasons, "layer": layer,
    }))
    return 0 if layer.get("equal", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
