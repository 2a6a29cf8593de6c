"""Launch plans of the histogram and scatter kernels (`csrc/hist_scatter.cu`)
on the calls of real devbuild windows, timed on the card.

    python -m pbdagcon_tpu_torch.tools.bins_ablate [--batches 8,32,64,128]

The input is the bench workload (512 targets x 1000 bp x 30x, seed 1234,
raw 'pre' records with -a). For each window size B (the devbuild path's
ladder, `devpipe._B_LADDER`) the device build of the first B targets runs
once under caps chosen as the path chooses them, and every hist and
scatter call it makes is captured with its valid mask (`capture_window`).
Each call is then timed as the build makes it (masked) under:

- "plan": `hist_plan` / `scatter_plan`, the kernels' own choice (the
  fewest CTAs whose shared memory holds the row's planes);
- "fill": the plan's cluster grown to fill the card at small B (`fill_cs`:
  while 2 B cs <= 132 SMs, up to min(8, ceil(132 / B), N // 4096) CTAs),
  a design these readings rejected;
- "cs=1 t=512", "cs=2 t=512": one CTA (or the fewest, where one does not
  hold the planes) and two CTAs per row, 512 threads each.

A call's time is the device ms of 20 copies of it replayed from a CUDA
graph, per copy. Each window's calls are also timed together (one graph,
in turns: plan, fill, fill, plan). Every result is held against the
plain version first; a mismatch exits 1. Exit 2 without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

SEED = 1234
TARGETS, LENGTH, COVERAGE = 512, 1000, 30
NUM_SMS = 132  # an H100 SXM's


def window_batch(eng, count: int, dev) -> tuple:
    """One devbuild window of the first `count` targets encoded in `eng`
    (caps chosen as `devpipe` chooses them, the targets past the
    insertion cap left out, at most B): returns (the packed inputs on
    `dev`, caps, the backtrack's P, the targets in the window)."""
    from pbdagcon_tpu_torch import devpipe, native

    metas = eng.enc_metas(count)
    R, C, L = (int(metas[:, k].max()) for k in range(3))
    bkey = (devpipe._ladder(R, devpipe._R_LADDER),
            devpipe._ladder(C, devpipe._C_LADDER),
            devpipe._ladder(L, devpipe._L_LADDER))
    prof = devpipe._profile(int(metas[:, 3].sum()), int(metas[:, 4].sum()))
    caps = devpipe.choose_window_caps(bkey + (prof.W,), metas, prof, {}, {}, {})
    idxs = [i for i in range(count)
            if int(metas[i, 3]) <= devpipe.ins_cap(caps)][:caps.B]
    host = native.enc_fill_packed(eng, idxs, caps.R, caps.C, caps.L,
                                  devpipe.ins_cap(caps), B=caps.B,
                                  pin_memory=dev.type == "cuda")
    inputs = tuple(x.to(dev) for x in host)
    return inputs, caps, min(caps.V, 2 * caps.L + 64), len(idxs)


def capture_window(eng, count: int, min_weight: int, dev) -> tuple:
    """Run the device build of the first `count` targets encoded in
    `eng` as one window (`window_batch`) and capture its kernel calls:
    returns ({"hist": [(values, valid, D)], "scatter": [(ranks, valid,
    payloads, D, cut_mask)], "dp": [args]}, caps, targets in the
    window)."""
    import torch

    from pbdagcon_tpu_torch import devpipe
    from pbdagcon_tpu_torch.ops import dp_cuda, mxu_cuda

    inputs, caps, P, n = window_batch(eng, count, dev)

    calls = {"hist": [], "scatter": [], "dp": []}
    real_hist, real_scatter = mxu_cuda.hist_cuda, mxu_cuda.scatter_cuda
    real_dp = dp_cuda.dp_scores_cuda

    def clone(t):
        return None if t is None else t.clone()

    def rec_hist(values, valid, D, **kw):
        calls["hist"].append((values.clone(), clone(valid), D))
        return real_hist(values, valid, D, **kw)

    def rec_scatter(ranks, valid, payloads, D, cut_mask, **kw):
        calls["scatter"].append((ranks.clone(), clone(valid),
                                 tuple(p.clone() for p in payloads), D, cut_mask))
        return real_scatter(ranks, valid, payloads, D, cut_mask, **kw)

    def rec_dp(*args):
        calls["dp"].append(tuple(a.clone() for a in args))
        return real_dp(*args)

    mxu_cuda.hist_cuda, mxu_cuda.scatter_cuda = rec_hist, rec_scatter
    dp_cuda.dp_scores_cuda = rec_dp
    try:
        devpipe.run_batch(inputs, caps, P, min_weight, packed=True)
    finally:
        mxu_cuda.hist_cuda, mxu_cuda.scatter_cuda = real_hist, real_scatter
        dp_cuda.dp_scores_cuda = real_dp
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return calls, caps, n


def call_shape(op: str, c) -> tuple:
    """(B, N, D, planes) of a captured call."""
    if op == "hist":
        return (*c[0].shape, c[2], 1)
    return (*c[0].shape, c[3], len(c[2]))


def fill_cs(B: int, N: int, cs: int) -> int:
    """`cs` CTAs per row grown to fill the card while B rows leave most
    SMs idle, keeping at least 4096 values per CTA."""
    if 2 * B * cs > NUM_SMS:
        return cs
    return max(cs, min(8, -(-NUM_SMS // B), N // 4096))


def plans(op: str, c) -> dict:
    """The plans this tool times for a call, by name."""
    from pbdagcon_tpu_torch.ops import mxu_cuda

    B, N, D, NP = call_shape(op, c)
    few = mxu_cuda.fewest_ctas(D, NP)
    return {
        "plan": mxu_cuda.bin_plan(B, N, D, NP),
        "fill": mxu_cuda.cluster_plan(N, D, NP, fill_cs(B, N, few)),
        "cs=1 t=512": mxu_cuda.cluster_plan(N, D, NP, few, threads=512),
        "cs=2 t=512": mxu_cuda.cluster_plan(N, D, NP, max(2, few), threads=512),
    }


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="8,32,64,128",
                    help="window sizes B, comma-separated")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bins_ablate: no CUDA card", file=sys.stderr)
        return 2
    from pbdagcon_tpu_torch import NoiseProfile, native, simulate_targets, to_pre_raw
    from pbdagcon_tpu_torch.ops import mxu, mxu_cuda
    from pbdagcon_tpu_torch.tools.cuda_graph import graph_ms

    card = _card()
    dev = torch.device("cuda")
    if not native.ensure_built():
        print("bins_ablate: the native engine failed to build", file=sys.stderr)
        return 1
    lines = []
    for _tid, _bb, alns in simulate_targets(SEED, TARGETS, LENGTH, COVERAGE,
                                            NoiseProfile()):
        lines.extend(to_pre_raw(x) for x in alns)
    text = ("\n".join(lines) + "\n").encode()
    min_weight = max(2, COVERAGE // 4)
    kernel = {"hist": mxu_cuda.hist_cuda, "scatter": mxu_cuda.scatter_cuda}
    plain = {"hist": mxu.hist_reference, "scatter": mxu.scatter_reference}
    with native.NativeEngine(min_weight=min_weight, min_length=100,
                             align=True) as eng:
        eng.encode_text(text, fmt="pre")
        for B in (int(x) for x in a.batches.split(",")):
            calls, caps, n = capture_window(eng, B, min_weight, dev)
            print(f"window of {n} targets: {caps}", flush=True)
            for op in ("hist", "scatter"):
                cs = calls[op]
                per_call = [plans(op, c) for c in cs]
                for c, ps in zip(cs, per_call):
                    want = plain[op](*c)
                    want = (want,) if op == "hist" else want
                    for name, p in ps.items():
                        got = kernel[op](*c, plan=p)
                        got = (got,) if op == "hist" else got
                        if not all(torch.equal(x, y) for x, y in zip(got, want)):
                            print(f"bins_ablate: {op} {call_shape(op, c)} "
                                  f"[{p.describe()}] != plain version",
                                  file=sys.stderr)
                            return 1
                    ms = {name: graph_ms(lambda c=c, p=p: kernel[op](*c, plan=p),
                                         10, copies=20)
                          for name, p in ps.items()}
                    print(f"  B={B} {op} (B, N, D, NP) = {call_shape(op, c)}: "
                          + ", ".join(f"{k} [{ps[k].describe()}] {v:.4f} ms"
                                      for k, v in ms.items())
                          + f" [{card}]", flush=True)

                def window(key, cs=cs, per_call=per_call, op=op):
                    for c, ps in zip(cs, per_call):
                        kernel[op](*c, plan=ps[key])

                win = {k: [] for k in ("plan", "fill")}
                for k in ("plan", "fill", "fill", "plan"):
                    win[k].append(graph_ms(lambda k=k: window(k), 20))
                differ = sum(ps["plan"] != ps["fill"] for ps in per_call)
                print(f"B={B} {op} window ({len(cs)} calls, {differ} of them "
                      f"with a fill plan other than the plan): plan "
                      f"{win['plan'][0]:.4f} / {win['plan'][1]:.4f} ms, fill "
                      f"{win['fill'][0]:.4f} / {win['fill'][1]:.4f} ms "
                      f"[{card}]", flush=True)
            del calls
    return 0


if __name__ == "__main__":
    sys.exit(main())
