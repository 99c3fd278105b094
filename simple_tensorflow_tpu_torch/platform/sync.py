"""Named, rank-ordered locks; the part of ``simple_tensorflow_tpu/
platform/sync.py`` (``Lock`` :315, ``Condition`` :507, the rank bands
:64-71) that the input pipeline takes.

A lock has a *name* (many instances may share one) and a *rank* (lower =
acquired first, outer): they document the order in which the pipeline
nests its locks. Left out: the lock-order witness, the wait-for graph,
rank-violation records, contention metrics and leaf locks.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["Lock", "Condition", "RANK_LIFECYCLE", "RANK_SESSION",
           "RANK_ENGINE", "RANK_QUEUE", "RANK_STATE", "LEAF"]

RANK_LIFECYCLE = 100   # open-close of process-wide resources
RANK_SESSION = 200     # Session/Graph state
RANK_ENGINE = 300      # pipeline runs
RANK_QUEUE = 400       # ring buffers
RANK_STATE = 500       # small per-object state
LEAF = 900             # nothing nests under these


class Lock:
    """Named, ranked drop-in for ``threading.Lock``."""

    __slots__ = ("_lock", "name", "rank", "blocking_ok")

    def __init__(self, name: str, rank: int = RANK_STATE, *,
                 blocking_ok: bool = False):
        self._lock = threading.Lock()
        self.name = name
        self.rank = rank
        self.blocking_ok = blocking_ok

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self._lock.release()

    def __repr__(self):
        return f"<stf.sync.Lock {self.name!r} rank={self.rank}>"


class Condition(threading.Condition):
    """``threading.Condition`` over a sync :class:`Lock` (several may
    share one, as a ring buffer's ``not_empty``/``not_full`` do); a
    standalone ``Condition(name=...)`` makes its own lock."""

    def __init__(self, lock: Optional[Lock] = None, *,
                 name: str = "sync/anon_condition", rank: int = RANK_QUEUE):
        self.sync_lock = lock if lock is not None else Lock(name, rank)
        super().__init__(self.sync_lock._lock)
