"""Additive hybrid scheduler: host engine + device pipeline in parallel
(port of `pbdagcon_tpu/hybrid.py`).

The chip is one more worker next to the host cores: the native C++
engine and the devbuild pipeline (`devpipe.run_devbuild_native` on the
run's device) consume target-group-aligned chunks concurrently from one
queue, and their outputs are re-ordered to input order, so the FASTA is
byte-identical to every other backend (chunks are independent streams;
each group's consensus depends only on its own records).

Work distribution is rate-adaptive, not round-robin. Rates are tracked
as **seconds per input byte** (EMAs weighted by chunk byte sizes): with
h = EMA host s/byte, d = EMA device s/byte, n = bytes of the head
chunk, and rest = bytes queued behind it, the device pulls iff its
chunk finishes inside the host's drain of the rest
(margin * d * n <= rest * h); while the chunker is still reading, the
backlog is treated as effectively unbounded. Consequences:

- on a fast host + slow device the device tapers to zero steals near
  end-of-stream instead of stretching the critical path with one long
  trailing chunk;
- a device pipeline faster than the host cores pulls almost everything;
- a device measured slower than beta x host retires (its own host-side
  stages cost ~1/beta of the cores, so its chunks are net-negative),
  with a periodic re-probe in case the measurement was a one-time
  warmup;
- an idle host HEDGES the device's in-flight chunk (re-processes a
  copy; the writer keeps whichever byte-identical result lands first),
  so a stalled device never blocks the output pipeline;
- neither case needs configuration: both rates are measured in-run.

The host worker feeds its engine a run of queued chunks in one call (up
to `cfg.chunk_bytes()`, the size of a "host" backend call), so that the
engine's threads drain once a call and not once a chunk, and splits the
FASTA back per chunk (`group_ids`, `split_fasta`); the reference makes
one call a chunk. The output is the same: the chunks are group-aligned.

The pure parts (`_sid_of_line`, `dev_should_pull`, `iter_group_chunks`,
`_last_group_cut`, `iter_group_chunks_blocks`) are copies of the
reference's; `run_stream_hybrid` is its port, with the same environment
knobs and defaults (the 20 s probe deferral included).
"""

from __future__ import annotations

import collections
import dataclasses
import io as _io
import logging
import os
import threading
import time
from typing import Iterable, Iterator, TextIO

from pbdagcon_tpu_torch.config import DagconConfig
from pbdagcon_tpu_torch.io import FastaWriter, sid_of_line

log = logging.getLogger("pbdagcon_tpu_torch")

_WORKER_DONE = object()


def _sid_of_line(s: str, fmt: str) -> str:
    """sid_of_line with the engines' malformed-input policy: a record
    with too few fields raises a diagnosable ValueError instead of a
    bare IndexError from inside a chunker thread."""
    try:
        return sid_of_line(s, fmt)
    except Exception as e:
        raise ValueError(
            f"malformed alignment record in input: {s.strip()[:80]!r}"
        ) from e


def dev_should_pull(
    pending_sizes: list[int],
    h_spb: float | None,
    d_spb: float | None,
    chunker_done: bool,
    margin: float = 1.2,
    beta: float = 4.0,
) -> bool:
    """The steal rule, as a pure function of queue state and measured
    per-byte rates (unit-testable without threads or timing).

    Profitability gate first: the device pipeline's host-side stages
    (parse/normalize/encode, assembly) consume roughly 1/beta of the
    host cores, so a device slower than beta * host is NET-NEGATIVE —
    the chunks it takes cost more host throughput than the chip adds
    (measured on the 4-core dev box: unconditional steals put the
    hybrid aggregate ~10% BELOW host-only). Once both rates are
    measured, a device with d > beta * h stops pulling for the rest of
    the run (rates are stable in-run; the one probe chunk that measured
    d is the entire cost of learning this).

    While the chunker is still reading, the backlog is effectively
    unbounded — a profitable device helps whenever >= 2 chunks are
    queued (one is left to the host in case EOF is imminent); an
    unmeasured device rate is allowed one probe pull. After EOF the
    queue is the whole remaining tail: the device pulls the head chunk
    (n bytes) only if its processing (d * n seconds) finishes inside
    the host's drain of the REST of the queue (rest * h seconds), so a
    slow device never becomes the critical-path tail. An unmeasured
    device rate is assumed 8x the host's (pessimistic cold start)."""
    if not pending_sizes:
        return False
    if (
        h_spb is not None
        and d_spb is not None
        and d_spb > beta * h_spb
    ):
        return False  # measured net-negative: retire from this run
    if not chunker_done:
        return len(pending_sizes) >= 2
    if h_spb is None:
        return False  # host rate unmeasured: let the host lead
    d = d_spb if d_spb is not None else 8.0 * h_spb
    n = pending_sizes[0]
    rest = sum(pending_sizes) - n
    return margin * d * n <= rest * h_spb


def iter_group_chunks(
    stream: TextIO | Iterable[str], fmt: str, groups_per_chunk: int
) -> Iterator[tuple[bytes, int]]:
    """Split a record stream into byte chunks cut at target-group
    boundaries (>= 1 whole group per chunk; blank lines dropped).
    Yields (chunk_bytes, group_count); concatenating the chunks
    reproduces the input's record lines in order."""
    cur: str | None = None
    acc: list[bytes] = []
    n = 0
    for line in stream:
        s = line if isinstance(line, str) else line.decode()
        if not s.strip():
            continue
        sid = _sid_of_line(s, fmt)
        if sid != cur:
            if n >= groups_per_chunk and acc:
                yield b"".join(acc), n
                acc, n = [], 0
            cur = sid
            n += 1
        acc.append((s if s.endswith("\n") else s + "\n").encode())
    if acc:
        yield b"".join(acc), n


def _last_group_cut(complete: bytes, fmt: str) -> int:
    """Byte offset in `complete` (which ends with b'\\n') of the first
    line of its LAST group, or 0 if it is all one group. Scans lines
    backward from the end — O(group) work per chunk, not O(chunk)."""
    end = len(complete)
    sid: str | None = None
    start = end
    while start > 0:
        nl = complete.rfind(b"\n", 0, start - 1)
        s2 = nl + 1
        line = complete[s2:start]
        if line.strip():
            cur = _sid_of_line(line.decode(), fmt)
            if sid is None:
                sid = cur
            elif cur != sid:
                return start
        start = s2
    return 0


def iter_group_chunks_blocks(
    stream, fmt: str, chunk_bytes: int, ramp: bool = True
) -> Iterator[bytes]:
    """Group-aligned byte chunks from a file-like stream: read big
    blocks, cut each at the start of its last (possibly incomplete)
    group. Only the trailing group's lines are ever scanned in Python,
    so the chunker costs ~nothing per byte.

    With `ramp`, the first few blocks are read small (cb/8, cb/8, cb/4,
    cb/2, then cb): the early chunks double as cheap rate probes for
    both workers, so a slow device's one mandatory probe pull (see
    `dev_should_pull`) wastes ~cb/8 of work instead of a full chunk."""
    carry = b""
    sizes = (
        [max(4096, chunk_bytes // 8)] * 2
        + [max(4096, chunk_bytes // 4), max(4096, chunk_bytes // 2)]
        if ramp
        else []
    )
    while True:
        blk = stream.read(sizes.pop(0) if sizes else chunk_bytes)
        if not blk:
            break
        if isinstance(blk, str):
            blk = blk.encode()
        data = carry + blk
        nl = data.rfind(b"\n")
        if nl < 0:
            carry = data
            continue
        complete, partial = data[: nl + 1], data[nl + 1 :]
        cut = _last_group_cut(complete, fmt)
        if cut == 0:  # single giant group: keep reading
            carry = data
            continue
        yield complete[:cut]
        carry = complete[cut:] + partial
    if carry.strip():
        yield carry if carry.endswith(b"\n") else carry + b"\n"


def group_ids(data: bytes, fmt: str) -> list[str]:
    """The target id of each record group in `data`, in order (a group
    is a run of records with one id, so an id that recurs after another
    group's is listed again). Reads each line's id from its first 256
    bytes where it ends there; blank lines and lines with too few fields
    are skipped (the engine refuses the latter)."""
    idx = 5 if fmt == "m5" else 1
    ids: list[str] = []
    prev = None
    p, n = 0, len(data)
    while p < n:
        e = data.find(b"\n", p)
        if e < 0:
            e = n
        f = data[p:min(e, p + 256)].split(None, idx + 1)
        if len(f) <= idx + 1 and e > p + 256:
            f = data[p:e].split(None, idx + 1)
        if len(f) > idx and f[idx] != prev:
            prev = f[idx]
            ids.append(prev.decode(errors="replace"))
        p = e + 1
    return ids


def split_fasta(text: str, ids: list[list[str]]) -> list[str]:
    """Split the FASTA of one engine call over the chunks it was fed:
    `ids[k]` are chunk k's group ids (`group_ids`), no id in two chunks.
    A record goes to the chunk that holds its header's target id (the
    header is `>id/start_end`), so a group that emits nothing moves no
    split. A header whose id no chunk holds stays with the chunk before
    it, and the chunk never steps back: the pieces always concatenate
    to `text`."""
    owner = {sid: k for k, chunk in enumerate(ids) for sid in chunk}
    parts: list[list[str]] = [[] for _ in ids]
    k = 0
    for line in text.splitlines(keepends=True):
        if line.startswith(">"):
            k = max(k, owner.get(line[1:].rstrip("\n").rsplit("/", 1)[0], k))
        parts[k].append(line)
    return ["".join(p) for p in parts]


def run_stream_hybrid(
    stream: TextIO | Iterable[str],
    out: FastaWriter,
    cfg: DagconConfig,
    stats,
    device,
    journal=None,
    chunk_bytes: int | None = None,
):
    """Run the hybrid host+device scheduler over one record stream; the
    device worker runs the devbuild pipeline on `device`."""
    from pbdagcon_tpu_torch import devpipe, native
    from pbdagcon_tpu_torch.pipeline import PipelineStats

    if chunk_bytes is None:
        # Small enough for fine-grained balance (the host drains one in
        # ~100ms at bench rates), big enough that a device window
        # amortizes its fixed dispatch cost. Env knob for tests.
        chunk_bytes = (
            int(os.environ.get("DAGCON_HYBRID_CHUNK_KB", "3072")) << 10
        )
    # The most text one host engine call takes: the "host" backend's
    # call size.
    call_bytes = cfg.chunk_bytes()
    maxq = 8
    margin = 1.2
    # Profitability threshold for the steal rule: the device worker's
    # host-side stages get ~threads//4 of the cores, so its break-even
    # rate is (threads / that share) x the host engine's. Overridable
    # for boxes where the device's host-stage cost is negligible.
    beta = float(os.environ.get("DAGCON_HYBRID_BETA", "0")) or (
        cfg.threads / max(1, cfg.threads // 4)
    )
    # Reorder-window cap: don't issue chunk k while chunk k - cap is
    # still unwritten. Bounds the writer's `buffered` dict (worst case
    # one stalled worker holds the window open while the other races
    # ahead) to ~cap * chunk_bytes of FASTA instead of the whole output.
    reorder_cap = int(os.environ.get("DAGCON_HYBRID_REORDER_CAP", "16"))
    force_dev = os.environ.get("DAGCON_HYBRID_FORCE_DEV", "0") == "1"
    hedge_on = os.environ.get("DAGCON_HYBRID_HEDGE", "1") == "1"

    cv = threading.Condition()
    pending: collections.deque = collections.deque()
    chunk_ids: dict[int, list[str]] = {}  # queued chunk idx -> group ids
    chunker_done = [False]
    abort = [False]
    written = [0]  # writer's next-expected chunk idx (under cv)
    h_spb: list[float | None] = [None]  # host seconds/byte (EMA)
    d_spb: list[float | None] = [None]  # device seconds/byte (EMA)
    errors: list[BaseException] = []
    # Hedging state (under cv): chunks the device currently holds, and
    # chunk idxs already completed by either worker. An idle host
    # re-processes the device's in-flight chunk instead of retiring:
    # outputs are byte-identical, the writer keeps whichever result
    # lands first, so a stalled device (first-use kernel builds, a slow
    # window) can never stretch the critical path by more than one host redo.
    dev_inflight: dict[int, bytes] = {}
    completed: set[int] = set()
    host_hedged: set[int] = set()
    dev_exited = [False]
    # A device slower than beta * host retires — but its one probe may
    # have carried the first-use warmup (kernel builds, CUDA context,
    # pinned pools). Allow a fresh probe after every reprobe_bytes of
    # host progress so a warm device gets a second chance on long
    # streams.
    reprobe_bytes = (
        int(os.environ.get("DAGCON_HYBRID_REPROBE_MB", "128")) << 20
    )
    host_bytes_done = [0]
    calls = [0]  # host engine calls
    probe_mark = [0]
    # Probe deferral: the device's FIRST pull triggers its warmup (on
    # the reference's TPU, jit compiles; here nvcc builds and CUDA
    # context set-up), whose host-side CPU cost competes with the host
    # engine. So the probe is only allowed once the stream has run long
    # enough to amortize it: elapsed >= probe_defer_s, or a quarter of
    # that when the host is visibly drowning (queue saturated). Short
    # streams therefore collapse to host-only by construction. Boxes
    # where the device is known-fast set DAGCON_HYBRID_PROBE_DEFER_S=0.
    # The default is the reference's 20 s.
    probe_defer_s = float(
        os.environ.get("DAGCON_HYBRID_PROBE_DEFER_S", "20")
    )
    t_start = time.monotonic()

    import queue as _queue

    resq: "_queue.Queue[object]" = _queue.Queue()

    def _ema(slot: list, val: float) -> None:
        slot[0] = val if slot[0] is None else 0.7 * slot[0] + 0.3 * val

    def chunker() -> None:
        idx = 0
        try:
            if hasattr(stream, "read"):
                it = iter_group_chunks_blocks(stream, cfg.fmt, chunk_bytes)
            else:  # line iterable: per-line fallback (rare path)
                it = (
                    c
                    for c, _n in iter_group_chunks(
                        stream, cfg.fmt, max(1, chunk_bytes // 2048)
                    )
                )
            for data in it:
                ids = group_ids(data, cfg.fmt)
                with cv:
                    while len(pending) >= maxq and not abort[0]:
                        cv.wait(0.2)
                    if abort[0]:
                        return
                    pending.append((idx, data))
                    chunk_ids[idx] = ids
                    idx += 1
                    cv.notify_all()
        except BaseException as e:  # pragma: no cover - IO errors
            errors.append(e)
            with cv:
                abort[0] = True
        finally:
            with cv:
                chunker_done[0] = True
                cv.notify_all()

    def _dev_would_pull() -> bool:
        # Called under cv; the rule itself is the pure per-byte
        # formulation in `dev_should_pull` (see its docstring).
        if force_dev:
            return True
        d = d_spb[0]
        if (
            d is not None
            and h_spb[0] is not None
            and d > beta * h_spb[0]
            and host_bytes_done[0] - probe_mark[0] >= reprobe_bytes
        ):
            # Re-probe: the gating measurement may have been a cold
            # compile; treat the rate as unmeasured for one pull.
            d = None
        if d is None:
            # This pull would be a (re-)probe: defer until its warmup
            # cost is amortized (see probe_defer_s above).
            el = time.monotonic() - t_start
            saturated = len(pending) >= maxq
            if el < probe_defer_s and not (
                saturated and el >= probe_defer_s / 4
            ):
                return False
        return dev_should_pull(
            [len(dd) for _, dd in pending],
            h_spb[0], d, chunker_done[0], margin, beta,
        )

    def _host_run(item) -> list:
        # Called under cv with the head chunk taken: the chunks queued
        # behind it join the host's call, in order, up to call_bytes and
        # inside the reorder window; a chunk that repeats a group id of
        # the run (so that the split is exact), or that an idle device
        # would pull now, starts the next call. Never waits for more.
        run = [(item[0], item[1], chunk_ids.pop(item[0]))]
        seen = set(run[0][2])
        size = len(item[1])
        while pending:
            j, d = pending[0]
            ids = chunk_ids[j]
            if (
                size + len(d) > call_bytes
                or j - written[0] > reorder_cap
                or not seen.isdisjoint(ids)
                or (not dev_inflight and not dev_exited[0]
                    and _dev_would_pull())
            ):
                break
            pending.popleft()
            del chunk_ids[j]
            run.append((j, d, ids))
            seen.update(ids)
            size += len(d)
        return run

    def get_chunk(is_dev: bool):
        # The device gets one (idx, data); the host a run of
        # (idx, data, group ids) for one engine call.
        with cv:
            while True:
                if abort[0]:
                    return None
                if pending:
                    if pending[0][0] - written[0] > reorder_cap:
                        cv.wait(0.2)  # bound the reorder window
                        continue
                    if not is_dev or _dev_would_pull():
                        item = pending.popleft()
                        cv.notify_all()
                        if not is_dev:
                            return _host_run(item)
                        del chunk_ids[item[0]]
                        dev_inflight[item[0]] = item[1]
                        probe_mark[0] = host_bytes_done[0]
                        return item
                    if chunker_done[0]:
                        return None  # backlog too small: retire
                elif chunker_done[0]:
                    if not is_dev and hedge_on:
                        # Hedge: duplicate the lowest still-unfinished
                        # device chunk instead of going idle.
                        for hidx in sorted(dev_inflight):
                            if (
                                hidx not in completed
                                and hidx not in host_hedged
                            ):
                                host_hedged.add(hidx)
                                return [(hidx, dev_inflight[hidx], None)]
                        if all(
                            i in completed for i in dev_inflight
                        ):
                            return None
                        # hedged already; wait for a result
                        cv.wait(0.2)
                        continue
                    return None
                cv.wait(0.2)

    def host_worker() -> None:
        eng = None
        try:
            eng = native.NativeEngine(
                min_weight=cfg.min_weight, min_length=cfg.min_length,
                trim=cfg.trim, threads=cfg.threads, align=cfg.align,
                scorer=cfg.align_scorer, affine_params=cfg.affine_params,
            )
            prev_done = 0
            while True:
                run = get_chunk(False)
                if run is None:
                    break
                data = b"".join(d for _, d, _ in run)
                t0 = time.monotonic()
                text = eng.consensus_text(data, fmt=cfg.fmt, flush=True)
                dt_s = time.monotonic() - t0
                calls[0] += 1
                _ema(h_spb, dt_s / max(1, len(data)))
                td = eng.targets_done
                if len(run) == 1:
                    texts, counts = [text], [td - prev_done]
                else:
                    texts = split_fasta(text, [ids for _, _, ids in run])
                    counts = [len(ids) for _, _, ids in run]
                    counts[-1] += td - prev_done - sum(counts)
                with cv:
                    completed.update(idx for idx, _, _ in run)
                    host_bytes_done[0] += len(data)
                    cv.notify_all()
                # Each chunk under its own index, with the call's seconds
                # shared out by bytes.
                for (idx, d, _), t, n in zip(run, texts, counts):
                    resq.put((idx, t, n, None, False,
                              dt_s * len(d) / max(1, len(data)), len(d)))
                prev_done = td
        except BaseException as e:
            errors.append(e)
            with cv:
                abort[0] = True
                cv.notify_all()
        finally:
            if eng is not None:
                try:
                    _, drec, dgrp = eng.status()
                    st = PipelineStats()
                    st.dropped_records, st.dropped_groups = drec, dgrp
                    st.engine_calls = calls[0]
                    resq.put((-1, "", 0, st, False, 0.0, 0))
                except Exception:  # pragma: no cover
                    pass
                eng.close()
            resq.put(_WORKER_DONE)

    def dev_worker() -> None:
        # The device pipeline's host stages (parse/normalize/encode,
        # assembly) get a small thread share; the chip is the worker.
        dcfg = dataclasses.replace(
            cfg, backend="devbuild", threads=max(1, cfg.threads // 4)
        )
        try:
            while True:
                item = get_chunk(True)
                if item is None:
                    break
                idx, data = item
                sio = _io.StringIO()
                st = PipelineStats()
                t0 = time.monotonic()
                devpipe.run_devbuild_native(
                    _io.BytesIO(data), FastaWriter(sio), dcfg, st, device
                )
                dt_s = time.monotonic() - t0
                _ema(d_spb, dt_s / max(1, len(data)))
                with cv:
                    completed.add(idx)
                    dev_inflight.pop(idx, None)
                    cv.notify_all()
                resq.put(
                    (idx, sio.getvalue(), st.targets, st, True, dt_s,
                     len(data))
                )
        except BaseException as e:
            errors.append(e)
            with cv:
                abort[0] = True
                cv.notify_all()
        finally:
            with cv:
                dev_exited[0] = True
            resq.put(_WORKER_DONE)

    ct = threading.Thread(target=chunker, daemon=True)
    ht = threading.Thread(target=host_worker, daemon=True)
    dt = threading.Thread(target=dev_worker, daemon=True)
    ct.start()
    ht.start()
    dt.start()

    # Writer (this thread): re-order chunk outputs to input order.
    # A hedged chunk can produce TWO results; the first one wins and
    # the duplicate is dropped (outputs are byte-identical, so which
    # worker wins never changes the FASTA).
    buffered: dict[int, str] = {}
    accepted: set[int] = set()
    expected = 0
    done_workers = 0
    dev_chunks = host_chunks = 0
    try:
        while done_workers < 2:
            item = resq.get()
            if item is _WORKER_DONE:
                done_workers += 1
                continue
            idx, text, n, st, from_dev, dt_s, nbytes = item  # type: ignore[misc]
            if idx >= 0 and idx in accepted:
                continue  # hedge duplicate: first result already taken
            if idx >= 0:
                accepted.add(idx)
            if st is not None:
                stats.batches += st.batches
                stats.host_fallbacks += st.host_fallbacks
                stats.dropped_records += st.dropped_records
                stats.dropped_groups += st.dropped_groups
                stats.engine_calls += st.engine_calls
            if idx < 0:
                continue  # stats-only record (host engine close)
            stats.targets += n
            chunk_bases = sum(
                len(l) for l in text.splitlines() if not l.startswith(">")
            )
            if from_dev:
                if dev_chunks == 0:
                    stats.hybrid_dev_first_s = dt_s
                    stats.hybrid_dev_first_bytes = nbytes
                dev_chunks += 1
                stats.hybrid_dev_bytes += nbytes
                stats.hybrid_dev_bases += chunk_bases
                stats.hybrid_dev_busy_s += dt_s
            else:
                host_chunks += 1
                stats.hybrid_host_bytes += nbytes
                stats.hybrid_host_bases += chunk_bases
                stats.hybrid_host_busy_s += dt_s
            buffered[idx] = text
            advanced = False
            while expected in buffered:
                t = buffered.pop(expected)
                expected += 1
                advanced = True
                if not t:
                    continue
                out.stream.write(t)
                stats.fragments += t.count(">")
                for l in t.splitlines():
                    if l.startswith(">"):
                        if journal is not None:
                            journal.mark(l[1:].rsplit("/", 1)[0])
                    else:
                        stats.consensus_bases += len(l)
            if advanced:
                with cv:  # release workers blocked on the reorder cap
                    written[0] = expected
                    cv.notify_all()
    finally:
        with cv:
            abort[0] = abort[0] or bool(errors)
            cv.notify_all()
        ct.join(timeout=60)
        ht.join(timeout=60)
        dt.join(timeout=60)
    if errors:
        raise errors[0]
    if buffered:  # pragma: no cover - defensive
        for idx in sorted(buffered):
            t = buffered[idx]
            out.stream.write(t)
            stats.fragments += t.count(">")
            stats.consensus_bases += sum(
                len(l) for l in t.splitlines() if not l.startswith(">")
            )
    stats.hybrid_host_chunks = host_chunks
    stats.hybrid_dev_chunks = dev_chunks
    log.info(
        "hybrid: host_chunks=%d in %d engine calls, dev_chunks=%d "
        "(host=%s dev=%s)",
        host_chunks, calls[0], dev_chunks,
        f"{1e-6 / h_spb[0]:.1f}MB/s" if h_spb[0] else "unmeasured",
        f"{1e-6 / d_spb[0]:.1f}MB/s" if d_spb[0] else "unmeasured",
    )
    return stats
