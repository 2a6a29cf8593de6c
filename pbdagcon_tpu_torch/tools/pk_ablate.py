"""P3's tile width and ring depth (`csrc/pk_variants.cu`,
`scatter_tile_kernel`), timed on the card:

    python -m pbdagcon_tpu_torch.tools.pk_ablate

The calls are the scatters that narrower tiles would split: the
microbench's [6144 -> 78848] and [3072 -> 12 V] with two payloads (B =
128, seed 0), and the bench window's scatters (512 targets x 1000 bp x
30x, seed 1234, raw 'pre' records with -a; the first 128 targets, caps
as the path chooses them; `bins_ablate.capture_window`) whose planes
outgrow one pair tile. Plans:

- "plan": `tile_plan`'s own, the fewest tiles that fit one CTA's 227 KB
  beside TILE_STAGES stages, then the stages the rest holds;
- "4 stages": the same tiles with a ring of TILE_STAGES;
- "pair": tiles of at most ~113 KB beside 2 stages, so that two CTAs
  share an SM, then the stages the rest of the 113 KB holds.

Each is held against the plain version first (exit 1 on a mismatch),
then each call alone (20 copies to a CUDA graph) is timed in turns, each
plan then each again in reverse order, device ms. Exit 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

SEED = 1234
TARGETS, LENGTH, COVERAGE = 512, 1000, 30
WINDOW = 128
# The shared memory with which two CTAs share an SM (228 KB, 1 KB of it
# reserved per CTA).
PAIR_SMEM = 115712


def pair_plan(N: int, D: int, NP: int):
    """Tiles of the most bins that fit beside a ring of MIN_STAGES within
    PAIR_SMEM, evened out, then the stages the chunks use and the rest of
    PAIR_SMEM holds."""
    from pbdagcon_tpu_torch.ops import pk_cuda

    smem = pk_cuda.tile_smem
    cap = ((PAIR_SMEM - smem(NP, 0, pk_cuda.MIN_STAGES)) // (4 * NP) - 4) // 4 * 4
    bins = -(-(-(-D // -(-D // cap))) // 4) * 4
    stage = smem(NP, 0, 1) - smem(NP, 0, 0)
    room = (PAIR_SMEM - smem(NP, bins, 0)) // stage
    stages = max(pk_cuda.MIN_STAGES,
                 min(pk_cuda.MAX_STAGES, -(-N // pk_cuda.TILE_CHUNK), room))
    return pk_cuda.TilePlan(-(-D // bins), bins, stages, smem(NP, bins, stages))


def plans(N: int, D: int, NP: int) -> dict:
    """{name: TilePlan} of the ablation for rows of N ranks and NP
    payloads into D bins."""
    from pbdagcon_tpu_torch.ops import pk_cuda

    plan = pk_cuda.tile_plan(N, D, NP)
    four = pk_cuda.TILE_STAGES
    return {"plan": plan,
            "4 stages": pk_cuda.TilePlan(plan.tiles, plan.bins, four,
                                         pk_cuda.tile_smem(NP, plan.bins, four)),
            "pair": pair_plan(N, D, NP)}


def main(argv=None) -> int:
    import torch

    argparse.ArgumentParser(
        prog="python -m pbdagcon_tpu_torch.tools.pk_ablate",
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("pk_ablate: no CUDA card", file=sys.stderr)
        return 2
    from pbdagcon_tpu_torch import NoiseProfile, native, simulate_targets, to_pre_raw
    from pbdagcon_tpu_torch.ops import mxu, pk_cuda
    from pbdagcon_tpu_torch.tools.bins_ablate import _card, capture_window
    from pbdagcon_tpu_torch.tools.cuda_graph import graph_ms

    card = _card()
    dev = torch.device("cuda")
    if not native.ensure_built():
        print("pk_ablate: the native engine failed to build", file=sys.stderr)
        return 1
    lines = []
    for _tid, _bb, alns in simulate_targets(SEED, TARGETS, LENGTH, COVERAGE,
                                            NoiseProfile()):
        lines.extend(to_pre_raw(x) for x in alns)
    text = ("\n".join(lines) + "\n").encode()
    min_weight = max(2, COVERAGE // 4)
    with native.NativeEngine(min_weight=min_weight, min_length=100,
                             align=True) as eng:
        eng.encode_text(text, fmt="pre")
        calls, caps, n = capture_window(eng, WINDOW, min_weight, dev)
    print(f"window of {n} targets: {caps} [{card}]", flush=True)
    scatters = [(r if m is None else torch.where(m, r, -1), ps, D, mask)
                for r, m, ps, D, mask in calls["scatter"]
                if pair_plan(r.shape[1], D, len(ps)).tiles > 1]
    del calls
    rng = np.random.default_rng(0)
    for N, D in ((6144, 78848), (3072, 12 * 5632)):
        ranks = rng.permutation(D)[None, :N].repeat(128, 0).astype(np.int32)
        r = torch.from_numpy(ranks).to(dev)
        c = torch.from_numpy(rng.integers(0, 1 << 28, (128, N)).astype(np.int32)).to(dev)
        scatters.append((r, (c, c + 1), D, 0xFFFFFFFF))
    for r, ps, D, mask in scatters:
        B, N = r.shape
        runs = plans(N, D, len(ps))
        want = mxu.scatter_reference(r, None, ps, D, mask)
        for name, p in runs.items():
            got = pk_cuda.scatter_tile_cuda(r, ps, D, mask, plan=p)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                print(f"pk_ablate: P3 {name} != plain version on "
                      f"{(B, N, D)}", file=sys.stderr)
                return 1
        ms = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            ms[k].append(graph_ms(lambda k=k: pk_cuda.scatter_tile_cuda(
                r, ps, D, mask, plan=runs[k]), 10, copies=20))
        print(f"P3 call B, N, D, NP = {(B, N, D, len(ps))}: " + ", ".join(
            f"{k} [{runs[k].describe()}] {v[0]:.4f} / {v[1]:.4f}"
            for k, v in ms.items()) + f" ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
