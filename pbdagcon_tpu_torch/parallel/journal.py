"""Completed-target journal: restart-safe streaming without checkpoints.

The reference has no failure recovery — crash = rerun everything
(SURVEY.md §5). Per-target statelessness makes something much better
nearly free: append each finished target id to a journal file (fsync'd
batches), and on restart skip any group whose id is already journaled.
This is the TPU build's entire "checkpoint/resume" story because there
is no other state to save (no model, no optimizer — a pure stream
processor)."""

from __future__ import annotations

import os
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


class TargetJournal:
    """Append-only journal of completed target ids.

    `before_flush` (e.g. the output stream's flush) runs before every
    journal fsync: a target is durably marked done only AFTER its FASTA
    left the process's own buffers, so a SIGKILL never produces a
    journaled-but-unwritten target (crash-resume correctness; the
    OS-cached output survives process death once flushed)."""

    def __init__(self, path: str, fsync_every: int = 64,
                 before_flush=None):
        self.path = path
        self.fsync_every = fsync_every
        self.before_flush = before_flush
        self._done: set[str] = set()
        self._pending = 0
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._done.add(line)
        self._f = open(path, "a")

    def __contains__(self, sid: str) -> bool:
        return sid in self._done

    def __len__(self) -> int:
        return len(self._done)

    def mark(self, sid: str) -> None:
        if sid in self._done:
            return
        self._done.add(sid)
        self._f.write(sid + "\n")
        self._pending += 1
        if self._pending >= self.fsync_every:
            self.flush()

    def flush(self) -> None:
        if self.before_flush is not None:
            try:
                self.before_flush()
            except Exception:  # pragma: no cover - closed stream etc.
                pass
        self._f.flush()
        os.fsync(self._f.fileno())
        self._pending = 0

    def close(self) -> None:
        self.flush()
        self._f.close()

    def __enter__(self) -> "TargetJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def filter_new(
        self, groups: Iterable[T], key=lambda g: g.sid
    ) -> Iterator[T]:
        """Yield only groups whose id is not yet journaled."""
        for g in groups:
            if key(g) not in self._done:
                yield g
