"""End-to-end consensus pipeline of the port: stream -> groups -> graphs
-> device DP -> backtrack -> FASTA (port of `pbdagcon_tpu/pipeline.py`).

Targets are batched: each target's merged graph is linearized on the
host (natively when the C++ engine is built), batches are bucketed by
padded size, and the weighted best-path DP runs for the whole bucket at
once in the CUDA kernel. The exact creation-order backtrack and fragment
emission stay on the host, so the output is bit-identical to the oracle
whatever the backend.

Backends (`DagconConfig.backend`):
- "cuda": batched DP in the hand-written kernel (`ops/dp_cuda.py`) on
  `cfg.device`; with device "cpu", its plain PyTorch version.
- "blocked": as "cuda", but each bucket batch that the int32 bound
  admits takes the blocked max-plus solve (kernel X2,
  `ops/dp_blocked.py`); the rows it flags re-run through the scan.
- "devbuild": graph build, DP and backtrack all on `cfg.device`
  (`devpipe.py`); the host encodes and assembles the fragments.
- "hybrid": the native engine and the devbuild pipeline side by side on
  group-aligned chunks, rate-adaptive (`hybrid.py`).
- "host": host DP only (the native engine end to end when built).
- "auto": "hybrid" on a card with the native engine present, unless
  DAGCON_AUTO_HYBRID=0 (`auto_takes_hybrid`, the reference's rule);
  otherwise "cuda" (so on `device="cpu"`, in the tests).

With `-a`, `align_backend="device"`, raw 'pre' records and the "cuda"
or "blocked" backend, the records are re-aligned by kernel X1 first
(`device_align_stream`), and the rest of the run goes without `-a`.
On the hybrid scheduler (so "auto" on a card) the host aligner runs,
as in the reference.

On the native-loader path, a target past the top V bucket takes the
column-sharded DP over the process's cards (`parallel/colshard.py`, X2
at B = 1, its boundary chain over the mesh's slots) when the reference
would: a W bucket holds its span and the int32 bound
holds. Other targets outside every (V, W, K) bucket, and oversized ones
whose scores cross the f32-parity line, take the exact host DP and are
counted in `PipelineStats.host_fallbacks` (SPEC.md §3.1).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Iterable, Iterator, TextIO

import numpy as np
import torch

from pbdagcon_tpu_torch.io import FastaWriter, TargetGroup, read_groups
from pbdagcon_tpu_torch.oracle.graph import CnsResult
from pbdagcon_tpu_torch.ops.linearize import (
    LinearGraph,
    backtrack,
    consensus_from_path,
    graph_from_group,
    host_scores,
    linearize,
)
from pbdagcon_tpu_torch import native
from pbdagcon_tpu_torch.config import DagconConfig, resolve_device
from pbdagcon_tpu_torch.ops.dp import (
    LongEdgeOverflow,
    choose_layout,
    pad_batch,
    submit_arena_scores,
    submit_batch_scores,
)
from pbdagcon_tpu_torch.ops.dp_blocked import (
    blocked_eligible,
    blocked_safe,
    max_escore,
)
from pbdagcon_tpu_torch.parallel.colshard import colsharded_scores
from pbdagcon_tpu_torch.parallel.mesh import make_mesh

log = logging.getLogger("pbdagcon_tpu_torch")


@dataclasses.dataclass
class PipelineStats:
    """Counters mirroring the reference's log output."""

    targets: int = 0
    fragments: int = 0
    consensus_bases: int = 0
    host_fallbacks: int = 0
    batches: int = 0
    pad_nodes: int = 0  # padded - real nodes (pad-waste measure)
    real_nodes: int = 0
    # Targets past the V ladder whose DP ran column-sharded on the
    # device (each also counts one batch), and rows that the blocked
    # solve flagged and re-ran through the scan.
    colshard: int = 0
    blocked_reruns: int = 0
    # Records skipped (raw pair without -a) and groups dropped (backbone
    # recovery/build failed): input is never lost invisibly.
    dropped_records: int = 0
    dropped_groups: int = 0
    # Why targets took the host DP: "oversize" (n past every V bucket),
    # "long_edges" (more long edges than the K register file holds); on
    # the devbuild path, "oversize" (past every shape ladder), "ins_cap"
    # (more inserted bases than the window's insertion stream holds,
    # `devpipe.ins_cap`) and the reasons of `devpipe.FLAG_REASONS`,
    # "ambiguous" and "overflow".
    fallback_reasons: dict[str, int] = dataclasses.field(default_factory=dict)
    # Host-clock seconds per stage of the native-loader path, summed
    # over batches: "align" (device re-alignment of a batch of records,
    # `device_align_stream`, in the producer thread), "linearize"
    # (producer thread), "pack", "dispatch" (upload + kernel + copy-back
    # enqueued; with the blocked solve, its Kleene rounds too),
    # "colshard" (targets past the V ladder: pack, solve and fetch, or
    # the eligibility check that sends them to the host DP), "host_dp"
    # (the exact host DP of the targets the colshard declines, and of
    # the Python path's oversize targets: stats.fallback "oversize"),
    # "wait" (emitter blocked on the batch's CUDA event), "emit" (native
    # backtrack + FASTA). The stages overlap across
    # threads, so they may sum past the wall time.
    stage_s: dict[str, float] = dataclasses.field(default_factory=dict)
    # Hybrid-scheduler accounting: chunks, input bytes, consensus bases
    # and busy seconds of each worker (the device's rate is
    # hybrid_dev_bases / hybrid_dev_busy_s).
    hybrid_host_chunks: int = 0
    hybrid_dev_chunks: int = 0
    hybrid_host_bytes: int = 0
    hybrid_dev_bytes: int = 0
    hybrid_host_bases: int = 0
    hybrid_dev_bases: int = 0
    hybrid_host_busy_s: float = 0.0
    hybrid_dev_busy_s: float = 0.0
    # Seconds and input bytes of the device worker's first chunk, its
    # first-use warmup included (set when the device took a chunk).
    hybrid_dev_first_s: float = 0.0
    hybrid_dev_first_bytes: int = 0
    # Calls that fed the native engine a slice of the stream for
    # consensus or linearize: the "host" loop, the "cuda" producer and
    # the hybrid's host worker (devbuild's encode slices not counted).
    engine_calls: int = 0
    # Device batches by shape rung, keyed by the rung's (name, size)
    # pairs: V, W, K on the native-loader path; R, C, L, W, V on devbuild.
    rungs: dict[tuple, int] = dataclasses.field(default_factory=dict)

    def rung(self, **dims: int) -> None:
        key = tuple(dims.items())
        self.rungs[key] = self.rungs.get(key, 0) + 1

    def fallback(self, reason: str, n: int = 1) -> None:
        self.host_fallbacks += n
        self.fallback_reasons[reason] = self.fallback_reasons.get(reason, 0) + n

    def add_time(self, stage: str, t0: float) -> None:
        """Add the seconds since `t0` (time.perf_counter) to `stage`."""
        dt = time.perf_counter() - t0
        self.stage_s[stage] = self.stage_s.get(stage, 0.0) + dt


def resolve_backend(cfg: DagconConfig) -> str:
    """The backend a batch runs on: "auto" reads "cuda" here. Only
    `run_stream` may take "auto" to the hybrid scheduler
    (`auto_takes_hybrid`)."""
    return "cuda" if cfg.backend == "auto" else cfg.backend


def auto_takes_hybrid(cfg: DagconConfig) -> bool:
    """Whether `run_stream` runs backend "auto" on the hybrid scheduler:
    the reference's rule (`pbdagcon_tpu/pipeline.py`, its "auto"
    branch), on a card with the native engine present, unless
    DAGCON_AUTO_HYBRID=0 (e.g. while soaking the scheduler on new
    hardware). The reference holds the additive scheduler never
    materially slower than the host engine alone; on an H100 the port's
    reads below it, for the host worker's flush on every chunk (ROADMAP
    D11). With `device` "cpu" the "device" would be the cores the host
    engine runs on, so "auto" stays "cuda" there. An explicit backend is
    never re-resolved. A requested card that is absent raises
    (`resolve_device`): never a run on the CPU that was not asked for."""
    return (
        resolve_device(cfg.device).type == "cuda"
        and cfg.use_native
        and native.available()
        and os.environ.get("DAGCON_AUTO_HYBRID", "1") != "0"
    )


def _bucket_of(x: int, ladder: tuple[int, ...]) -> int | None:
    for v in ladder:
        if x <= v:
            return v
    return None


def _count_output(text: str, stats: PipelineStats) -> None:
    stats.fragments += text.count(">")
    stats.consensus_bases += sum(
        len(l) for l in text.splitlines() if not l.startswith(">")
    )


def linearize_group(
    group: TargetGroup,
    cfg: DagconConfig,
    stats: PipelineStats | None = None,
) -> LinearGraph:
    """Normalize/trim, build + merge the graph, linearize (host side)."""
    alns = group.alns
    if cfg.align:
        from pbdagcon_tpu_torch.aligner import align_record

        alns = [
            align_record(a, cfg.align_scorer, cfg.affine_params)
            for a in alns
        ]
    else:
        # Raw (ungapped) pairs without -a cannot be threaded; skip and
        # count them, matching the native engine's policy.
        kept = [a for a in alns if len(a.qstr) == len(a.tstr)]
        if len(kept) != len(alns):
            n_bad = len(alns) - len(kept)
            log.warning(
                "target %s: skipped %d raw record(s) without -a",
                group.sid, n_bad,
            )
            if stats is not None:
                stats.dropped_records += n_bad
            alns = kept
    g = graph_from_group(group.backbone, alns, trim=cfg.trim)
    return linearize(g, sid=group.sid)


def consensus_for_lin(
    lin: LinearGraph, scores, cfg: DagconConfig
) -> list[CnsResult]:
    path = backtrack(lin, scores)
    return consensus_from_path(lin, path, cfg.min_weight, cfg.min_length)


def _flush_bucket(
    lins: list[LinearGraph],
    V: int,
    cfg: DagconConfig,
    stats: PipelineStats,
) -> Iterator[tuple[str, list[CnsResult]]]:
    """Run one padded bucket batch through the DP."""
    try:
        W, K = choose_layout(lins, w_ladder=cfg.w_buckets)
        batch = pad_batch(lins, V, W, K)
        fut = submit_batch_scores(
            batch, resolve_device(cfg.device),
            blocked=resolve_backend(cfg) == "blocked"
            and blocked_eligible(batch),
        )
        stats.blocked_reruns += fut.reruns
        scores = fut.result()
    except LongEdgeOverflow:
        # Pathological targets: exact host DP, never wrong (SPEC §3.1).
        stats.fallback("long_edges", len(lins))
        for lin in lins:
            yield lin.sid, consensus_for_lin(lin, host_scores(lin), cfg)
        return
    stats.batches += 1
    for i, lin in enumerate(lins):
        stats.pad_nodes += V - lin.n
        stats.real_nodes += lin.n
        yield lin.sid, consensus_for_lin(lin, scores[i, : lin.n], cfg)


def run_pipeline(
    groups: Iterable[TargetGroup],
    cfg: DagconConfig = DagconConfig(),
    stats: PipelineStats | None = None,
) -> Iterator[tuple[str, list[CnsResult]]]:
    """Consensus for a stream of target groups, in input order (the
    pure-Python path, used when the native library is absent).

    Batches consecutive targets into per-V-bucket batches of up to
    `cfg.batch_targets`; when any bucket fills, all pending work is
    flushed so results leave in input order."""
    stats = stats if stats is not None else PipelineStats()
    backend = resolve_backend(cfg)

    if backend == "host":
        for group in groups:
            lin = linearize_group(group, cfg, stats)
            stats.targets += 1
            res = consensus_for_lin(lin, host_scores(lin), cfg)
            stats.fragments += len(res)
            stats.consensus_bases += sum(len(r.seq) for r in res)
            yield group.sid, res
        return

    pending: list[tuple[LinearGraph | None, TargetGroup | None]] = []
    per_bucket: dict[int, int] = {}

    def flush() -> Iterator[tuple[str, list[CnsResult]]]:
        nonlocal pending, per_bucket
        # Key results by pending-list position, NOT sid: repeated,
        # non-consecutive target ids in one flush window are distinct
        # groups and must emit distinct results.
        buckets: dict[int, list[tuple[int, LinearGraph]]] = {}
        for pi, (lin, _grp) in enumerate(pending):
            if lin is not None:
                V = _bucket_of(lin.n, cfg.v_buckets)
                assert V is not None
                buckets.setdefault(V, []).append((pi, lin))
        results: dict[int, list[CnsResult]] = {}
        for V, entries in buckets.items():
            lins = [l for _, l in entries]
            for (pi, _), (_sid, res) in zip(
                entries, _flush_bucket(lins, V, cfg, stats)
            ):
                results[pi] = res
        for pi, (lin, grp) in enumerate(pending):
            if lin is None:
                assert grp is not None
                stats.fallback("oversize")
                t0 = time.perf_counter()
                hl = linearize_group(grp, cfg, stats)
                scores = host_scores(hl)
                stats.add_time("host_dp", t0)
                res = consensus_for_lin(hl, scores, cfg)
                sid = grp.sid
            else:
                sid = lin.sid
                res = results[pi]
            stats.fragments += len(res)
            stats.consensus_bases += sum(len(r.seq) for r in res)
            yield sid, res
        pending = []
        per_bucket = {}

    for group in groups:
        stats.targets += 1
        lin = linearize_group(group, cfg, stats)
        V = _bucket_of(lin.n, cfg.v_buckets)
        if V is None:
            pending.append((None, group))  # host fallback, keeps order
            continue
        pending.append((lin, None))
        per_bucket[V] = per_bucket.get(V, 0) + 1
        if per_bucket[V] >= cfg.batch_targets:
            yield from flush()
    yield from flush()


def device_align_stream(
    stream: TextIO | Iterable[str],
    fmt: str = "pre",
    batch_records: int = 1024,
    device="cuda",
    stats: PipelineStats | None = None,
) -> Iterator[str]:
    """Re-align raw 'pre' records on `device` in batches of
    `batch_records` (kernel X1, `ops/align_tpu.py`); yields gapped 'pre'
    lines in input order, for a run without `-a` downstream. Each
    batch's seconds go to `stats.stage_s["align"]`.

    Only fields 6/7 change: a raw record's start/end/tlen already
    describe the target window, and the gapped strings keep them."""
    from pbdagcon_tpu_torch.ops.align_tpu import align_batch

    if fmt != "pre":
        raise ValueError("device alignment requires raw 'pre' records")
    buf: list[list[str]] = []

    def flush(buf: list[list[str]]) -> Iterator[str]:
        t0 = time.perf_counter()
        gapped = align_batch([(f[5], f[6]) for f in buf], device)
        if stats is not None:
            stats.add_time("align", t0)
        for f, (gq, gt) in zip(buf, gapped):
            yield f"{f[0]} {f[1]} {f[2]} {f[3]} {f[4]} {gq} {gt}\n"

    for line in stream:
        if isinstance(line, bytes):  # binary file/CLI streams
            line = line.decode()
        f = line.split()
        if not f:
            continue
        if len(f) != 7:
            raise ValueError(f"pre record has {len(f)} fields, expected 7")
        buf.append(f)
        if len(buf) >= batch_records:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)


def _native_engine(cfg: DagconConfig):
    """Native C++ engine if requested and built, else None."""
    if not cfg.use_native or not native.available():
        return None
    return native.NativeEngine(
        min_weight=cfg.min_weight,
        min_length=cfg.min_length,
        trim=cfg.trim,
        threads=cfg.threads,
        align=cfg.align,
        scorer=cfg.align_scorer,
        affine_params=cfg.affine_params,
    )


def _colshard_oversize(
    eng, idx: int, n: int, span: int, cfg: DagconConfig, device
) -> np.ndarray | None:
    """Column-sharded DP for retained target `idx`, past every V bucket
    (the reference's `_colshard_oversize`), over the run's mesh: one
    slot on a card with an index (`--device cuda:1`, or a rank's card
    under `--distributed`), every visible card for a bare "cuda" (as
    the reference's mesh is `jax.devices()`), one slot on the CPU.
    Returns scores[n + 1], or None when the reference
    would take the host DP: no W bucket holds the span (long edges),
    counts past the packer's int16 format, the int32 bound exceeded, or
    scores past the f32-parity line. Any other failure raises."""
    W = next((w for w in cfg.w_buckets if span <= w), None)
    if W is None:
        return None
    mesh = make_mesh(device=str(device))
    D = mesh.size
    V = -(-max(n, 1) // (64 * D)) * (64 * D)
    try:
        batch = native.pack_batch(eng, [idx], V, W, 1)
    except LongEdgeOverflow:
        return None
    if not blocked_safe(max_escore(batch), V):
        return None
    try:
        s = colsharded_scores(
            batch["win_count"][0], batch["exit_count"][0], batch["cov"][0],
            batch["unsup"][0], mesh,
        )
    except OverflowError:  # past the f32-parity line: exact host DP
        return None
    full = np.empty(n + 1, dtype=np.float32)
    full[:n] = s[:n]
    full[n] = 0.0  # the exit node
    return full


def _choose_layout_native(
    eng, idxs: list[int], cfg: DagconConfig
) -> tuple[int, int, set[int]]:
    """choose_layout on native long-edge counts (no array export).

    Returns (W, K, outliers). The long-edge register file costs
    O(B*V*K) device work, so K is capped; the few targets whose
    long-edge count exceeds the cap at every W go to the host fallback
    instead of inflating the whole batch."""
    w_ladder = cfg.w_buckets
    k_ladder = (8, 32, 128)
    counts = {i: eng.long_counts(i, w_ladder) for i in idxs}
    k_cap = k_ladder[-1]
    outliers = {
        i for i in idxs if all(c > k_cap for c in counts[i])
    }
    fit = [i for i in idxs if i not in outliers]
    best = None
    best_cost = None
    for wi, W in enumerate(w_ladder):
        worst = max((int(counts[i][wi]) for i in fit), default=0)
        K = next((k for k in k_ladder if k >= worst), None)
        if K is None:
            continue
        cost = 2 * W + K / 2
        if best_cost is None or cost < best_cost:
            best, best_cost = (W, K), cost
    if best is None:
        # No single (W, K) fits everyone: push per-target misfits out.
        W = w_ladder[-1]
        for i in fit:
            if counts[i][-1] > k_cap:
                outliers.add(i)
        best = (W, k_cap)
    return best[0], best[1], outliers


def _run_stream_native(
    stream: TextIO | Iterable[str],
    out: FastaWriter,
    cfg: DagconConfig,
    backend: str,
    stats: PipelineStats,
    journal=None,
) -> PipelineStats:
    """Native-loader path: C++ parse/normalize/graph/linearize (threaded),
    the DP per bucket batch on `cfg.device`, native backtrack + FASTA.

    With backend == "host" the DP runs natively too: the all-C++ path
    with Python only feeding text chunks.

    Otherwise three threads form the pipeline: the producer linearizes
    text slices of `cfg.chunk_bytes()` (the "host" loop's call size) in
    the engine (ctypes releases the GIL); the main thread
    (submitter) packs each batch of `cfg.batch_targets` targets into a
    pinned arena and dispatches upload + kernel + score copy on the
    current CUDA stream; the emitter waits on each batch's CUDA event,
    then runs the native backtrack and writes FASTA. The engine retains
    linearized targets until `clear_linears`; `idx_lock` serializes
    access to retained indices, because a clear shifts them.
    """
    eng = _native_engine(cfg)
    assert eng is not None
    chunk_bytes = cfg.chunk_bytes()

    def chunks() -> Iterator[tuple[bytes, bool]]:
        if hasattr(stream, "read"):
            while True:
                buf = stream.read(chunk_bytes)  # type: ignore[union-attr]
                if not buf:
                    break
                yield buf.encode() if isinstance(buf, str) else buf, False
        else:
            acc: list[bytes] = []
            n = 0
            for line in stream:
                b = line.encode() if isinstance(line, str) else line
                acc.append(b)
                n += len(b)
                if n >= chunk_bytes:
                    yield b"".join(acc), False
                    acc, n = [], 0
            if acc:
                yield b"".join(acc), False
        yield b"", True

    producer_thread = None  # (thread, stop, cond) once the producer runs
    try:
        if backend == "host":
            for data, flush in chunks():
                text = eng.consensus_text(data, fmt=cfg.fmt, flush=flush)
                stats.engine_calls += 1
                if text:
                    out.stream.write(text)
                    _count_output(text, stats)
                    if journal is not None:
                        for l in text.splitlines():
                            if l.startswith(">"):
                                journal.mark(l[1:].rsplit("/", 1)[0])
            stats.targets = eng.targets_done
            return stats

        device = resolve_device(cfg.device)
        pin = device.type == "cuda"

        def submit_chunk(offset: int, count: int) -> dict:
            metas = eng.metas(count, offset=offset)
            ns = metas[:, 0]
            buckets: dict[int, list[int]] = {}
            for i in range(count):
                V = _bucket_of(int(ns[i]), cfg.v_buckets)
                buckets.setdefault(V if V is not None else -1, []).append(i)
            scores: dict[int, np.ndarray] = {}
            futures: list[tuple[list[int], object]] = []
            for V, idxs in buckets.items():
                if V < 0:
                    # Outside every V bucket: the column-sharded DP on
                    # the device where eligible, else the exact host DP.
                    for i in idxs:
                        t0 = time.perf_counter()
                        s = _colshard_oversize(
                            eng, offset + i, int(ns[i]), int(metas[i, 1]),
                            cfg, device,
                        )
                        stats.add_time("colshard", t0)
                        if s is None:
                            stats.fallback("oversize")
                            t0 = time.perf_counter()
                            s = eng.target_scores(offset + i, int(ns[i]))
                            stats.add_time("host_dp", t0)
                        else:
                            stats.batches += 1
                            stats.colshard += 1
                        scores[i] = s
                    continue
                abs_idxs = [offset + i for i in idxs]
                try:
                    W, K, outliers = _choose_layout_native(eng, abs_idxs, cfg)
                    for a in outliers:
                        i = a - offset
                        stats.fallback("long_edges")
                        scores[i] = eng.target_scores(a, int(ns[i]))
                    idxs = [i for i in idxs if offset + i not in outliers]
                    if idxs:
                        t0 = time.perf_counter()
                        batch = native.pack_batch(
                            eng, [offset + i for i in idxs], V, W, K,
                            pin_memory=pin,
                        )
                        stats.add_time("pack", t0)
                        t0 = time.perf_counter()
                        fut = submit_arena_scores(
                            batch["_arena"], batch["_dims"], device,
                            blocked=backend == "blocked"
                            and blocked_eligible(batch),
                        )
                        stats.blocked_reruns += fut.reruns
                        stats.add_time("dispatch", t0)
                        stats.batches += 1
                        stats.rung(V=V, W=W, K=K)
                        futures.append((idxs, fut))
                    for i in idxs:
                        stats.pad_nodes += V - int(ns[i])
                        stats.real_nodes += int(ns[i])
                except LongEdgeOverflow:
                    for i in idxs:
                        stats.fallback("long_edges")
                        scores[i] = eng.target_scores(offset + i, int(ns[i]))
            return {
                "count": count,
                "ns": ns,
                "scores": scores,
                "futures": futures,
            }

        def emit_chunk(work: dict, idx_lock) -> None:
            # Wait for the device scores outside the index lock, then
            # emit. The work's targets sit at retained indices
            # 0..count-1 by now (works are emitted in submit order and
            # each clears its own targets).
            ns = work["ns"]
            scores = work["scores"]
            for idxs, fut in work["futures"]:
                t0 = time.perf_counter()
                sc = fut.result()
                stats.add_time("wait", t0)
                for j, i in enumerate(idxs):
                    n = int(ns[i])
                    full = np.empty(n + 1, dtype=np.float32)
                    full[:n] = sc[j, :n]
                    full[n] = 0.0  # the exit node
                    scores[i] = full
            with idx_lock:
                t0 = time.perf_counter()
                for i in range(work["count"]):
                    text = eng.target_consensus(i, scores[i])
                    if text:
                        out.stream.write(text)
                        _count_output(text, stats)
                    if journal is not None:
                        journal.mark(eng.target_sid(i))
                eng.clear_linears(work["count"])
                work["_cleared"][0] += work["count"]
                stats.add_time("emit", t0)

        SENTINEL = object()
        q: "queue.Queue[object]" = queue.Queue()
        producer_err: list[BaseException] = []
        stop = threading.Event()
        cond = threading.Condition()
        retained = [0]
        dispatch_n = cfg.batch_targets
        limit = 3 * dispatch_n  # retained-target cap: backpressure

        def producer() -> None:
            try:
                for data, flush in chunks():
                    with cond:
                        while retained[0] >= limit and not stop.is_set():
                            cond.wait(1.0)
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    appended = eng.linearize_text(data, fmt=cfg.fmt, flush=flush)
                    stats.add_time("linearize", t0)
                    stats.engine_calls += 1
                    if appended:
                        with cond:
                            retained[0] += appended
                        q.put(appended)
            except BaseException as e:  # pragma: no cover
                producer_err.append(e)
            finally:
                q.put(SENTINEL)

        idx_lock = threading.Lock()
        emq: "queue.Queue[object]" = queue.Queue(maxsize=2)
        emit_err: list[BaseException] = []

        def emitter() -> None:
            try:
                while True:
                    w = emq.get()
                    if w is SENTINEL:
                        return
                    emit_chunk(w, idx_lock)  # type: ignore[arg-type]
                    with cond:
                        retained[0] -= w["count"]  # type: ignore[index]
                        cond.notify()
            except BaseException as e:  # pragma: no cover
                emit_err.append(e)
                # Drain so the main thread's put() never deadlocks.
                while emq.get() is not SENTINEL:
                    pass

        t = threading.Thread(target=producer, daemon=True)
        producer_thread = (t, stop, cond)
        t.start()
        et = threading.Thread(target=emitter, daemon=True)
        et.start()
        cleared = [0]  # total targets emitted+cleared (under idx_lock)
        submitted = 0
        avail = 0
        eof = False
        try:
            while not eof:
                item = q.get()
                while True:  # drain whatever else is already linearized
                    if item is SENTINEL:
                        eof = True
                    else:
                        avail += int(item)  # type: ignore[arg-type]
                        stats.targets += int(item)  # type: ignore[arg-type]
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                while avail >= dispatch_n or (eof and avail > 0):
                    cnt = min(dispatch_n, avail)
                    with idx_lock:
                        work = submit_chunk(submitted - cleared[0], cnt)
                    submitted += cnt
                    avail -= cnt
                    work["_cleared"] = cleared
                    emq.put(work)
                    if emit_err:
                        raise emit_err[0]
        finally:
            emq.put(SENTINEL)
            et.join()
        t.join()
        if emit_err:
            raise emit_err[0]
        if producer_err:
            raise producer_err[0]
        return stats
    finally:
        # On a main-thread error the producer may still be inside the
        # engine (or blocked on a slot); freeing the engine under it is
        # a use-after-free. Signal, unblock, and join before close.
        if producer_thread is not None:
            _t, _stop, _cond = producer_thread
            _stop.set()
            with _cond:
                _cond.notify_all()
            _t.join(timeout=60)
        _, drec, dgrp = eng.status()
        stats.dropped_records += drec
        stats.dropped_groups += dgrp
        if drec or dgrp:
            log.warning(
                "input loss: %d records skipped, %d groups dropped",
                drec, dgrp,
            )
        eng.close()


def run_stream(
    stream: TextIO | Iterable[str],
    out: FastaWriter,
    cfg: DagconConfig = DagconConfig(),
    journal=None,
) -> PipelineStats:
    """Reference-CLI-equivalent entry: M5/'pre' text stream in, FASTA out."""
    stats = PipelineStats()
    backend = resolve_backend(cfg)
    if cfg.backend == "auto" and auto_takes_hybrid(cfg):
        backend = "hybrid"
        log.warning(
            "backend=auto resolved to the hybrid scheduler "
            "(host engine + device pipeline); set "
            "DAGCON_AUTO_HYBRID=0 or --backend to override"
        )
    if backend == "hybrid":
        if cfg.use_native and native.available():
            from pbdagcon_tpu_torch.hybrid import run_stream_hybrid

            # A missing card raises here: never a host-only run.
            run_stream_hybrid(
                stream, out, cfg, stats, resolve_device(cfg.device),
                journal=journal,
            )
            log.info(
                "hybrid: targets=%d fragments=%d bases=%d batches=%d "
                "host_fallbacks=%d engine_calls=%d",
                stats.targets, stats.fragments, stats.consensus_bases,
                stats.batches, stats.host_fallbacks, stats.engine_calls,
            )
            return stats
        # No native engine: the "cuda" backend on cfg.device.
        backend = "cuda"
    if backend == "devbuild":
        from pbdagcon_tpu_torch.devpipe import (
            run_devbuild_native,
            run_devbuild_pipeline,
        )

        device = resolve_device(cfg.device)
        if cfg.use_native and native.available():
            run_devbuild_native(stream, out, cfg, stats, device, journal=journal)
        else:
            for sid, results in run_devbuild_pipeline(
                read_groups(stream, cfg.fmt), cfg, stats, device
            ):
                out.write_target(sid, results)
                if journal is not None:
                    journal.mark(sid)
        log.info(
            "devbuild: targets=%d fragments=%d bases=%d batches=%d "
            "host_fallbacks=%d %s",
            stats.targets, stats.fragments, stats.consensus_bases,
            stats.batches, stats.host_fallbacks, stats.fallback_reasons,
        )
        return stats
    if (
        cfg.align
        and cfg.align_backend == "device"
        and backend in ("cuda", "blocked")
        and cfg.fmt == "pre"
    ):
        # Device re-alignment up front; the rest runs on gapped records.
        stream = device_align_stream(
            stream, cfg.fmt, device=resolve_device(cfg.device), stats=stats
        )
        cfg = dataclasses.replace(cfg, align=False)
    if cfg.use_native and native.available():
        _run_stream_native(stream, out, cfg, backend, stats, journal=journal)
    else:
        for sid, results in run_pipeline(read_groups(stream, cfg.fmt), cfg, stats):
            out.write_target(sid, results)
            if journal is not None:
                journal.mark(sid)
    log.info(
        "targets=%d fragments=%d bases=%d batches=%d host_fallbacks=%d "
        "pad_waste=%.1f%% engine_calls=%d",
        stats.targets,
        stats.fragments,
        stats.consensus_bases,
        stats.batches,
        stats.host_fallbacks,
        100.0 * stats.pad_nodes / max(1, stats.pad_nodes + stats.real_nodes),
        stats.engine_calls,
    )
    return stats
