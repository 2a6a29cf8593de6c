"""Kernel-variant microbench (port of `tools/prof_pk.py`): the histogram
designs and the payload scatter of the devbuild build against each other
and against their plain PyTorch versions, at the build's real shapes.

- hist v0 (B2, the build's kernel), v1 (P1, tensor cores), v2 (P2, the
  row staged whole beside its bins in one CTA) and the plain version, at
  (N, D) in {(40960, 1026), (40960, 9234), (6144, 8208)}, B = 128;
- scatter P3 (a CTA per D tile, each staging the row by TMA), B3
  (`mxu.mxu_scatter`) and the plain version, with two int32 payloads, at
  [6144 -> 78848], [6144 -> V = 5632] (colliding ranks) and
  [3072 -> 12 V];
- the tail-compaction sort: [B, 6144] int16-range keys carrying two
  int32 payloads (`torch.sort(stable=True)` and `gather`).

Each line chains K dependent calls, each call's output fed into the next
one's input, as the JAX tool chains them in one `jit`. On a card the
chain is captured once in a CUDA graph and replayed, timed with CUDA
events (best of 3 replays), and a floor chain of K adds is subtracted:
ms per call. On the CPU the chain runs eagerly, timed by the host clock.
The chains of one shape compute one contract, so every line of a shape
must end on the same array; a mismatch fails the run (exit 1).

    python -m pbdagcon_tpu_torch.tools.prof_pk                       # CUDA card
    python -m pbdagcon_tpu_torch.tools.prof_pk --device cpu --small  # plain versions

Without a card the default `--device cuda` exits with an error; only an
explicit `--device cpu` runs, and there every line is a plain version.
`--small` keeps the widths D and cuts B to 8 and N by 10.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from pbdagcon_tpu_torch.ops import mxu, pk

K = 12
REPS = 3
V = 5632


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them (the
    name alone where nvidia-smi is missing); "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def chain(body, x0: torch.Tensor, extra=()) -> tuple[float, torch.Tensor]:
    """(ms of K dependent calls of `body`, the chain's final array)."""
    if x0.device.type == "cuda":
        # One eager call first: it builds and loads the kernels and sets
        # their shared-memory limits outside the capture.
        body(x0, *extra)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            c = x0
            for _ in range(K):
                c = body(c, *extra)
        ts = []
        for _ in range(REPS + 1):  # the first replay warms up
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            graph.replay()
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1))
        return min(ts[1:]), c.clone()
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        c = x0
        for _ in range(K):
            c = body(c, *extra)
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), c


def run(dev: torch.device, small: bool = False,
        log=print) -> tuple[dict[str, float], list[str]]:
    """Time every line: ({line: ms per call}, [shapes whose lines'
    chains disagree])."""
    rng = np.random.default_rng(0)
    B, cut = (8, 10) if small else (128, 1)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    floor, _ = chain(lambda c: c + 1, put(rng.integers(0, 100, (B, 256))))
    log(f"floor: {floor:.4f} ms for {K} adds [{card_name(dev)}]")
    per_call: dict[str, float] = {}
    bad: list[str] = []

    def lines(shape: str, variants, x0, extra=()) -> None:
        outs = []
        for tag, body in variants:
            ms, out = chain(body, x0, extra)
            name = f"{shape} {tag}"
            per_call[name] = (ms - floor) / K
            log(f"{name:52s} {per_call[name]:9.4f} ms/op (total {ms:8.3f})")
            outs.append(out)
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            bad.append(shape)
            log(f"{shape}: the lines' chains DISAGREE")

    for D, N in ((1026, 40960), (9234, 40960), (8208, 6144)):
        N //= cut

        def hist_body(h, D=D):
            return lambda c: (c + h(c, D)[:, :1]) % D

        lines(f"hist[N={N},D={D}]", [
            ("v0 B2 hist_cuda", hist_body(pk.hist_v0)),
            ("v1 P1 tensor-core wgmma", hist_body(pk.hist_v1)),
            ("v2 P2 row in smem", hist_body(pk.hist_v2)),
            ("plain scatter_add_", hist_body(
                lambda v, D: mxu.hist_reference(v, None, D))),
        ], put(rng.integers(0, D, (B, N))))

    def scatter_body(f, D):
        def body(c, r):
            o1, o2 = f(r, (c, c + 1), D)
            return (c + o1[:, :1] + o2[:, :1]) % (1 << 28)
        return body

    def scatter_lines(shape, ranks, N, D):
        lines(shape, [
            ("P3 tiled 2xi32", scatter_body(
                lambda r, ps, D: pk.pallas_scatter(r, ps, D, 4), D)),
            ("B3 mxu_scatter 2xi32", scatter_body(
                lambda r, ps, D: mxu.mxu_scatter(
                    r, r >= 0, ps, D, chunk=N, max_payload=1 << 31), D)),
            ("plain scatter_add_ 2xi32", scatter_body(
                lambda r, ps, D: mxu.scatter_reference(r, None, ps, D,
                                                        0xFFFFFFFF),
                D)),
        ], put(rng.integers(0, 1 << 28, (B, N))), (put(ranks),))

    # SE-block shape: unique ranks into D = 78848.
    N, D = 6144 // cut, 78848
    scatter_lines(f"scatter[{N}->{D}]",
                  rng.permutation(D)[None, :N].repeat(B, 0), N, D)
    # Tiered SE plan: per-slot scatter at D = V (ranks collide), and the
    # compacted tail at D = 12 V with N / 2 rows.
    scatter_lines(f"scatter[{N}->V={V}]",
                  rng.permutation(8192)[None, :N].repeat(B, 0) % V, N, V)
    NT, DT = 3072 // cut, 12 * V
    scatter_lines(f"scatter[{NT}->12V]",
                  rng.permutation(DT)[None, :NT].repeat(B, 0), NT, DT)

    def sort3(c):
        key, idx = torch.sort(c & 0xFFFF, dim=-1, stable=True)
        return (key + torch.gather(c + 1, -1, idx)
                + torch.gather(c + 2, -1, idx)) % 6144

    lines(f"sort[{N}] u16+2xu32", [("3-op stable sort", sort3)],
          put(rng.integers(0, 6144, (B, N))))
    return per_call, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pbdagcon_tpu_torch.tools.prof_pk",
        description="Histogram and scatter kernel variants vs their plain "
                    "versions at the devbuild build's shapes.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a card is required) or cpu (plain "
                         "versions only)")
    ap.add_argument("--small", action="store_true",
                    help="B = 8 and N / 10 (the widths D are kept)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("prof_pk: no CUDA card (torch.cuda.is_available() is false); "
              "use --device cpu for the plain versions", file=sys.stderr)
        return 2
    if dev.type not in ("cuda", "cpu"):
        print(f"prof_pk: device {dev} is not supported", file=sys.stderr)
        return 2
    _, bad = run(dev, args.small)
    if bad:
        print(f"prof_pk: the lines of {bad} disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
