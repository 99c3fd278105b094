"""Device staging of ``Dataset.prefetch_to_device``: pinned host slots and
the copy to the card on a side stream.

The port's counterpart of the JAX package's ``ArenaPool``
(``runtime/native.py:435-511``) and ``jax.device_put`` in
``data/dataset.py:376-461``:

- :class:`PinnedPool` rotates ``slots`` arenas of pinned host memory
  (:class:`PinnedArena`, 64-byte aligned bump allocation). The terminal
  ``batch``/``superbatch`` stage stacks straight into a slot
  (``pipeline.ArenaBatch``); any other element is copied into one
  (:meth:`PinnedPool.stage`).
- :func:`to_device` copies an element's arrays ``non_blocking`` to the
  card on the pipeline's side stream and records an event after them.
  :meth:`PinnedPool.mark_in_flight` ties that event to the slot, and
  :meth:`PinnedPool.acquire` reuses a slot only after its event has
  completed (``ArenaPool.mark_in_flight``'s role): a slot rewritten
  while its copy is queued would corrupt a batch silently.
- :func:`hand_over` makes the consumer's stream wait on the event and
  records that stream on each tensor, so the caching allocator keeps the
  block until the consumer's work on it is done.

Every CUDA call made here from a pipeline thread holds
``compiler.aot.CAPTURE_LOCK``: a CUDA graph captured meanwhile on the
consumer's thread would otherwise see them. Strings stay numpy ``object``
arrays on the host. On the CPU nothing is pinned and nothing waits: the
arrays become CPU tensors.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..framework import dtypes as dtypes_mod
from ..platform import sync as _sync

_ALIGN = 64
_ASSEMBLING = object()


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _cuda_lock(device: torch.device):
    """The capture lock around a pipeline thread's CUDA calls (none on
    the CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from ..compiler import aot

    return aot.CAPTURE_LOCK


def map_leaves(x, fn: Callable[[Any], Any]):
    """``fn`` over the arrays of an element (an array, a tuple or a
    dict), keeping its structure."""
    if isinstance(x, tuple):
        return tuple(map_leaves(e, fn) for e in x)
    if isinstance(x, dict):
        return {k: map_leaves(v, fn) for k, v in x.items()}
    return fn(x)


def leaves(x) -> List[Any]:
    out: List[Any] = []
    map_leaves(x, out.append)
    return out


class PinnedArena:
    """Bump allocation of numpy arrays over pinned host blocks.
    :meth:`reset` recycles the memory: arrays handed out before it must
    not be used after it."""

    def __init__(self, block_bytes: int):
        self._block_bytes = int(block_bytes)
        self._blocks: List[torch.Tensor] = []
        self._cur = -1
        self._off = 0

    def _new_block(self, need: int) -> torch.Tensor:
        with _cuda_lock(torch.device("cuda")):   # a page-locked allocation
            block = torch.empty(max(self._block_bytes, _aligned(need)),
                                dtype=torch.uint8, pin_memory=True)
        self._blocks.append(block)
        return block

    def alloc_ndarray(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        shape = tuple(int(d) for d in shape)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        need = max(nbytes, 1)
        while True:
            if self._cur < 0 or self._cur >= len(self._blocks):
                self._cur = len(self._blocks)
                self._new_block(need)
                self._off = 0
            block = self._blocks[self._cur]
            if self._off + need <= block.numel():
                break
            self._cur += 1
            self._off = 0
        raw = block[self._off:self._off + nbytes].numpy()
        self._off = _aligned(self._off + need)
        return raw.view(dtype).reshape(shape)

    def reset(self) -> None:
        """Free every allocation; blocks that overflowed are merged into
        one, so the next round fits in a single block."""
        if len(self._blocks) > 1:
            total = sum(b.numel() for b in self._blocks)
            self._blocks = []
            self._block_bytes = max(self._block_bytes, total)
            self._new_block(total)
        self._cur = 0 if self._blocks else -1
        self._off = 0


class PinnedPool:
    """``slots`` pinned arenas in rotation. A slot handed out by
    :meth:`acquire` is reused only after :meth:`mark_in_flight` gave it
    its copy's event and that event completed; ``wait_copies = False``
    (private) skips both waits: the planted fault of a slot rewritten
    while its copy is queued."""

    WAIT_POLL_S = 0.1

    def __init__(self, slots: int, device: torch.device,
                 block_bytes: int = 1 << 22):
        self.device = torch.device(device)
        self._arenas = [PinnedArena(block_bytes) for _ in range(slots)]
        # per slot: None (free), _ASSEMBLING (handed out, no copy yet) or
        # the event recorded after its copy
        self._state: List[Any] = [None] * slots
        self._i = 0
        self._cond = _sync.Condition(name="data/pinned_pool",
                                     rank=_sync.RANK_STATE)
        self._closed = False
        self.wait_copies = True

    def acquire(self):
        """``(slot, arena)``: the next slot, reset, once its earlier copy
        has completed."""
        with self._cond:
            slot = self._i
            self._i = (self._i + 1) % len(self._arenas)
            while (self.wait_copies and self._state[slot] is _ASSEMBLING
                   and not self._closed):
                self._cond.wait(self.WAIT_POLL_S)
            pending = self._state[slot]
            self._state[slot] = _ASSEMBLING
        if isinstance(pending, torch.cuda.Event) and self.wait_copies:
            with _cuda_lock(self.device):
                pending.synchronize()
        arena = self._arenas[slot]
        arena.reset()
        return slot, arena

    def stage(self, x):
        """Copy an element's arrays into the next slot: ``(slot, the
        element on pinned memory)``; strings stay where they are."""
        slot, arena = self.acquire()

        def copy(a):
            a = np.asarray(a)
            if a.dtype.hasobject or a.dtype.kind in "USV":
                return a
            out = arena.alloc_ndarray(a.shape, a.dtype)
            np.copyto(out, a)
            return out

        return slot, map_leaves(x, copy)

    def mark_in_flight(self, slot: int, event) -> None:
        """The copy out of ``slot`` is queued; ``event`` (None on the CPU)
        completes after it."""
        with self._cond:
            self._state[slot] = event
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


_BF16 = dtypes_mod.bfloat16.np_dtype


def _leaf_to_device(a, device: torch.device, non_blocking: bool):
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=non_blocking)
    a = np.asarray(a)
    if a.dtype.hasobject or a.dtype.kind in "USV":
        return a  # strings never become torch tensors
    if a.dtype == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.to(device, non_blocking=non_blocking).view(torch.bfloat16)
    if device.type == "cpu":
        return torch.from_numpy(np.array(a, copy=True))
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=non_blocking)


def to_device(x, device: torch.device,
              stream: Optional["torch.cuda.Stream"]):
    """``(x on device, event)``: on the card each array is copied
    ``non_blocking`` on ``stream`` and ``event`` is recorded after the
    copies; on the CPU, CPU tensors and no event."""
    if stream is None:
        return map_leaves(x, lambda a: _leaf_to_device(a, device, False)), \
            None
    with _cuda_lock(device), torch.cuda.device(device), \
            torch.cuda.stream(stream):
        out = map_leaves(x, lambda a: _leaf_to_device(a, device, True))
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def hand_over(x, event, device: torch.device):
    """Order the consumer's current stream after ``event`` and record it
    on each tensor of ``x`` (nothing on the CPU)."""
    if event is None:
        return x
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    for t in leaves(x):
        if isinstance(t, torch.Tensor):
            t.record_stream(cur)
    return x
