"""Sharded batch scheduler: manifest sharding, bucketed batching, prefetch
(port of `pbdagcon_tpu/parallel/scheduler.py`).

- `shard_for_host`: deterministic round-robin split of the target stream
  across processes (pure data parallelism over targets: each rank owns a
  disjoint manifest shard, no coordination needed); the rank and the
  world size come from `torch.distributed` where a process group is
  initialised, as the reference's come from `jax.process_index()`;
- `BucketScheduler`: groups linearized targets into (V-bucket) batches
  up to `batch_targets`;
- `Prefetcher`: a bounded background producer (the reference's
  reader-thread backpressure, as a thread and a queue).

`_bucket_of`, `BucketScheduler` and `Prefetcher` are copies of the
reference's; only the `LinearGraph` import is the port's.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

from pbdagcon_tpu_torch.ops.linearize import LinearGraph

T = TypeVar("T")


def _rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the initialised `torch.distributed` group,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_for_host(
    groups: Iterable[T],
    host_id: int | None = None,
    n_hosts: int | None = None,
) -> Iterator[T]:
    """Round-robin manifest shard for this process (the process group's
    rank and world size by default, 0 and 1 without a group).
    Deterministic: group i belongs to host i % n_hosts."""
    if host_id is None or n_hosts is None:
        rank, world = _rank_and_world()
        host_id = rank if host_id is None else host_id
        n_hosts = world if n_hosts is None else n_hosts
    for i, g in enumerate(groups):
        if i % n_hosts == host_id:
            yield g


def _bucket_of(x: int, ladder: tuple[int, ...]) -> int | None:
    for v in ladder:
        if x <= v:
            return v
    return None


class BucketScheduler:
    """Accumulates linearized targets into per-V-bucket batches.

    `add` returns a full batch when one is ready; `drain` flushes the
    rest. Emission order within a bucket is arrival order; callers that
    need global input order track indices (the pipeline does)."""

    def __init__(self, v_buckets: tuple[int, ...], batch_targets: int):
        self.v_buckets = v_buckets
        self.batch_targets = batch_targets
        self._pend: dict[int, list[tuple[int, LinearGraph]]] = {}

    def add(
        self, idx: int, lin: LinearGraph
    ) -> tuple[int, list[tuple[int, LinearGraph]]] | None:
        V = _bucket_of(lin.n, self.v_buckets)
        if V is None:
            return (-1, [(idx, lin)])  # out-of-bucket: host fallback batch
        q = self._pend.setdefault(V, [])
        q.append((idx, lin))
        if len(q) >= self.batch_targets:
            del self._pend[V]
            return (V, q)
        return None

    def drain(self) -> Iterator[tuple[int, list[tuple[int, LinearGraph]]]]:
        for V in sorted(self._pend):
            yield V, self._pend[V]
        self._pend.clear()


class Prefetcher:
    """Bounded background producer (the reference's reader-thread
    backpressure, as a thread + queue instead of BoundedBuffer<T>)."""

    _SENTINEL = object()

    def __init__(self, producer: Callable[[], Iterable[T]], depth: int = 4):
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def run() -> None:
            try:
                for item in producer():
                    self._q.put(item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item  # type: ignore[misc]
