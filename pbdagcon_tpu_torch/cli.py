"""The port's `dagcon` CLI (`python -m pbdagcon_tpu_torch`), mirroring
the reference flags and the JAX package's CLI.

Reference flags: positional M5/'pre' input (or stdin), `-c` min coverage
(8), `-m` min length (500), `-j` threads (4), `-t` trim (0), `-a`
re-align. `--align-scorer`, `--affine-params` and `--align-backend` are
the JAX package's -a knobs, with its names, choices and defaults;
`--align-backend device` re-aligns raw 'pre' records in kernel X1 on the
"cuda" and "blocked" backends. `--backend blocked` runs the batches that
the int32 bound admits through the blocked max-plus solve (kernel X2).
`--backend devbuild` runs the graph build, the DP and the
backtrack on the device; `--backend hybrid` runs the host engine and the
devbuild pipeline side by side on group-aligned chunks. `--device` picks the device (default cuda;
"cpu" runs the kernels' plain PyTorch versions). `--distributed` runs one
rank of a multi-process run: `torch.distributed` with the gloo backend,
initialised from the env:// variables that `torchrun` sets
(`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`; `LOCAL_RANK` picks
the card), `--shard` defaulting to rank/world; each rank writes its own
output. On the host backend a rank leaves the group once every rank has
its shard, so that a dead peer cannot stop the others.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import sys
import time

from pbdagcon_tpu_torch.io import FastaWriter, open_input
from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.pipeline import run_stream


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbdagcon-torch",
        description=(
            "DAG consensus with pbdagcon's capabilities on PyTorch + CUDA: "
            "M5/'pre' alignments in, consensus FASTA out."
        ),
    )
    p.add_argument(
        "input", nargs="?", default="-",
        help="M5/'pre' alignment file, target-sorted ('-' = stdin)",
    )
    p.add_argument(
        "-c", "--min-coverage", type=int, default=8,
        help="minimum coverage (node weight) to keep a consensus base",
    )
    p.add_argument(
        "-m", "--min-length", type=int, default=500,
        help="minimum consensus fragment length to emit",
    )
    p.add_argument(
        "-t", "--trim", type=int, default=0,
        help="trim N aligned query bases off both alignment ends",
    )
    p.add_argument(
        "-a", "--align", action="store_true",
        help="re-align raw (ungapped) seq pairs before consensus "
        "(for 'pre' records carrying unaligned sequences)",
    )
    p.add_argument(
        "-j", "--threads", type=int, default=4,
        help="host worker threads (native graph build)",
    )
    p.add_argument(
        "--fmt", choices=("m5", "pre"), default="m5", help="input format"
    )
    p.add_argument(
        "--backend",
        choices=("auto", "cuda", "blocked", "devbuild", "hybrid", "host"),
        default="auto",
        help="consensus backend: cuda (batched DP kernel), blocked (the "
        "blocked max-plus solve where the int32 bound admits a batch, "
        "flagged rows through the DP kernel), devbuild "
        "(graph build, DP and backtrack on the device), hybrid (host "
        "engine and devbuild side by side, rate-adaptive), host (native "
        "engine only); auto = hybrid on a card with the native engine "
        "(DAGCON_AUTO_HYBRID=0 opts out), else cuda",
    )
    p.add_argument(
        "--device", default="cuda",
        help="device of the DP and the device build (cuda, cuda:N, or cpu "
        "for the kernels' plain PyTorch versions)",
    )
    p.add_argument(
        "--align-backend", choices=("host", "device"), default="host",
        help="where -a re-alignment runs: threaded C++ banded DP (host) "
        "or the batched device kernel (device; raw 'pre' records on the "
        "cuda and blocked backends: auto on a card runs hybrid, which "
        "aligns on the host); both are exact",
    )
    p.add_argument(
        "--align-scorer", choices=("simple", "affine"), default="simple",
        help="-a scoring scheme: linear-gap 1/-2/-3 (simple, default) "
        "or affine Gotoh (SPEC §1.6); see docs/SCORER_SENSITIVITY.md",
    )
    p.add_argument(
        "--affine-params", default="1,-2,-4,-1", metavar="M,X,O,E",
        help="affine scorer parameters match,mismatch,open,extend "
        "(gap of length k scores open+(k-1)*extend)",
    )
    p.add_argument(
        "--batch-targets", type=int, default=128,
        help="targets per device batch",
    )
    p.add_argument(
        "--chunk-mb", type=int, default=16,
        help="streaming feed-chunk size (MB); DAGCON_CHUNK_MB overrides",
    )
    p.add_argument(
        "--width", type=int, default=0,
        help="FASTA line width (0 = unwrapped)",
    )
    p.add_argument(
        "--shard", default=None, metavar="I/N",
        help="process only target-groups i mod N == I (each process "
        "writes its own output)",
    )
    p.add_argument(
        "--shard-bytes", action="store_true",
        help="with --shard/--distributed and a file input: read only "
        "this shard's byte range of the file (group-boundary exact)",
    )
    p.add_argument(
        "--journal", default=None, metavar="PATH",
        help="completed-target journal: skip targets already recorded, "
        "append as they finish (restart-safe streaming)",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="write a torch.profiler chrome trace of the run to DIR",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="one rank of a multi-process run: torch.distributed (gloo) "
        "from the env:// variables MASTER_ADDR, MASTER_PORT, RANK and "
        "WORLD_SIZE (as torchrun sets them); --shard defaults to "
        "rank/world and the card to cuda:(LOCAL_RANK mod cards); each "
        "rank writes its own output",
    )
    p.add_argument(
        "--selfcheck", action="store_true",
        help="debug: per target, assert graph invariants and that the "
        "linearized DP reproduces the graph-walk consensus; output "
        "unchanged",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    in_group = args.distributed and _join_group(args)
    try:
        return _run(args)
    finally:
        if in_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join_group(args: argparse.Namespace) -> bool:
    """Initialise this rank's process group (gloo, env://; raises if it
    cannot), default `--shard` to rank/world and a bare "cuda" device to
    the rank's card. On the host backend, leave the group once every
    rank has joined: after the shard split the ranks share nothing, and
    a dead peer must not stop the others. Returns whether the rank is
    still in the group."""
    import torch
    import torch.distributed as dist

    log = logging.getLogger("pbdagcon_tpu_torch")
    dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    if not args.shard:
        args.shard = f"{rank}/{world}"
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        args.device = f"cuda:{local % torch.cuda.device_count()}"
    log.info("distributed: rank %d of %d, shard %s, device %s", rank, world,
             args.shard, args.device)
    if args.backend != "host":
        return True
    # Every rank waits here, so that rank 0, which hosts the store, does
    # not tear it down before the others have joined.
    dist.barrier()
    dist.destroy_process_group()
    log.info("distributed: detached after shard assignment "
             "(host backend, shared-nothing)")
    return False


def launch_counts() -> dict[str, int]:
    """This process's kernel launches by kernel, from the wrappers'
    counts (of the wrapper modules the run imported; none on the CPU)."""
    out: dict[str, int] = {}
    dp = sys.modules.get("pbdagcon_tpu_torch.ops.dp_cuda")
    if dp is not None:
        out["dp_scan"] = dp.launches
    for name in ("mxu_cuda", "align_cuda", "dp_blocked_cuda"):
        mod = sys.modules.get(f"pbdagcon_tpu_torch.ops.{name}")
        if mod is not None:
            out.update(mod.launches)
    return out


def _run(args: argparse.Namespace) -> int:
    cfg = DagconConfig(
        min_weight=args.min_coverage,
        min_length=args.min_length,
        threads=args.threads,
        trim=args.trim,
        align=args.align,
        align_backend=args.align_backend,
        align_scorer=args.align_scorer,
        affine_params=tuple(int(x) for x in args.affine_params.split(",")),
        fmt=args.fmt,
        backend=args.backend,
        device=args.device,
        batch_targets=args.batch_targets,
        chunk_mb=args.chunk_mb,
    )
    stream = open_input(args.input)

    journal = None
    if args.journal:
        from pbdagcon_tpu_torch.parallel.journal import TargetJournal

        journal = TargetJournal(args.journal, before_flush=sys.stdout.flush)

    if args.shard or journal is not None:
        from pbdagcon_tpu_torch.io import filter_groups_text, shard_stream_bytes

        shard_i, shard_n = 0, 1
        if args.shard:
            shard_i, shard_n = (int(x) for x in args.shard.split("/"))
        if args.shard_bytes and args.shard and args.input != "-":
            stream.close()
            stream = shard_stream_bytes(args.input, cfg.fmt, shard_i, shard_n)
            if journal is not None:
                stream = filter_groups_text(
                    stream, cfg.fmt, lambda sid, _g: sid not in journal
                )
        else:
            if args.shard_bytes:
                logging.getLogger("pbdagcon_tpu_torch").warning(
                    "--shard-bytes needs --shard and a file input; "
                    "falling back to filtered streaming"
                )

            def keep(sid: str, gidx: int) -> bool:
                if gidx % shard_n != shard_i:
                    return False
                return journal is None or sid not in journal

            stream = filter_groups_text(stream, cfg.fmt, keep)

    if args.selfcheck:
        from pbdagcon_tpu_torch.selfcheck import run_selfcheck

        rc = run_selfcheck(stream, cfg)
        if journal is not None:
            journal.close()
        return rc

    writer = FastaWriter(sys.stdout, width=args.width)
    prof = None
    if args.profile_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    t0 = time.time()
    try:
        run_stream(stream, writer, cfg, journal=journal)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(
            f"proc_time={time.time() - t0:.3f}s "
            f"cpu_time={ru.ru_utime + ru.ru_stime:.3f}s",
            file=sys.stderr,
        )
        print("kernel_launches=" + json.dumps(launch_counts()),
              file=sys.stderr)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
        if journal is not None:
            journal.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
