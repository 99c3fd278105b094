"""Ahead-of-time compiled steps: one CUDA graph per planned step and
feed-shape bucket.

The counterpart of ``simple_tensorflow_tpu/compiler/aot.py``:
``compile_step`` (:126) turns a planned Session step into one XLA program
for one feed-shape bucket (``feed_signature`` :98), and the paged serving
model compiles one program per decode and prefill bucket. Here the
program is the step's own eager dispatch, captured once into a
``torch.cuda.CUDAGraph`` and replayed: a replay launches every kernel of
the step with one host call.

What a capture fixes, and what this module keeps static around it:

- the addresses the kernels read and write: each feed has a static
  device buffer (:class:`StagedInput`), refilled before every replay from
  pinned host staging by one ``non_blocking`` copy, the staging guarded by
  an event so a copy still in flight is never overwritten;
- the launch arguments: a value that changes between runs must be read
  on the device. The random ops' keys are one ``(n, 2)`` int32 key
  buffer (the uint32 words' bits), refilled like a feed;
- the outputs: the tensors the capture produced, rewritten by every
  replay (read them before the next one);
- the launch counters: ``count_launch`` runs in Python, which a replay
  does not, so the counts made while capturing are taken off the global
  counters onto the graph, and each replay adds them back
  (:class:`DeviceGraph`).

Capture needs the usual preconditions: the same function ran eagerly
first, on a side stream (:func:`on_side_stream`: kernel library loads,
cuBLAS/cuDNN handles, lazily built buffers), and nothing inside syncs
with the host. A capture that fails raises; nothing falls back to eager
dispatch. On the CPU (a tensor on the CPU, which a caller asks for) the
same objects run the function eagerly into the same static buffers at
every replay: everything but the ``CUDAGraph`` itself.

Left out: the persistent compile cache and ``compile_fetches`` (XLA
programs of frozen graphs).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.kernels import common as kcommon


def feed_signature(feeds: Dict[Any, Any]) -> tuple:
    """The bucket key of a set of feeds: sorted ``(tensor name, shape,
    dtype)`` triples (values may be numpy arrays or tensors)."""
    return tuple(sorted(
        (getattr(t, "name", str(t)), tuple(np.shape(v)),
         str(getattr(v, "dtype", type(v).__name__)))
        for t, v in feeds.items()))


def on_side_stream(fn: Callable[[], Any], device) -> Any:
    """``fn()`` on a fresh side stream ordered after the current one, the
    current stream then ordered after it: the warm-up a capture needs.
    On the CPU, ``fn()``."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn()
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


class StagedInput:
    """A static device tensor and the pinned host staging it is refilled
    from. :meth:`stage` waits for the previous copy out of the staging
    (its event), writes the new value there and copies it to the device
    without a sync."""

    def __init__(self, shape, dtype, device):
        self.static = torch.zeros(tuple(shape), dtype=dtype, device=device)
        cuda = self.static.device.type == "cuda"
        self._host = torch.empty(tuple(shape), dtype=dtype, pin_memory=cuda)
        self._copied = torch.cuda.Event() if cuda else None

    def stage(self, value) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
            if value.dtype.kind == "V":  # bfloat16: exact through f32
                value = value.astype(np.float32)
            if not value.flags.c_contiguous:
                value = value.copy(order="C")
            value = torch.from_numpy(value)
        self._host.copy_(value)
        self.static.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class DeviceGraph:
    """``fn() -> sequence of tensors (or None)`` captured once on a CUDA
    device and replayed; on the CPU run at every replay into the same
    output tensors. ``launches``: the kernel launches one replay makes."""

    def __init__(self, fn: Callable[[], Sequence[Any]], device):
        self._fn = fn
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[list] = None
        self.launches: Dict[str, int] = {}

    def capture(self) -> None:
        """Record ``fn`` into a CUDA graph (nothing executes). The launch
        counts made while recording move onto :attr:`launches`. On the
        CPU, nothing: the first replay allocates the outputs."""
        if self.device.type != "cuda":
            return
        graph = torch.cuda.CUDAGraph()
        before = kcommon.launch_counts()
        try:
            with warnings.catch_warnings():
                # a step of reads only captures no kernel: fine here
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(graph):
                    outs = list(self._fn())
        finally:
            self.launches = kcommon.take_launches(before)
        self.graph = graph
        self.outputs = outs

    def release(self) -> None:
        """Drop the graph, its outputs and the function now (after the
        device is done with them), not whenever a reference cycle through
        ``fn`` is collected: a graph freed by the collector during another
        capture would free memory inside it."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
        self.graph = None
        self.outputs = None
        self._fn = None
        self.launches = {}

    def replay(self) -> list:
        """Run the step once; returns the (static) outputs."""
        if self.graph is not None:
            self.graph.replay()
            kcommon.add_launches(self.launches)
            return self.outputs
        outs = list(self._fn())
        if self.outputs is None:
            self.outputs = [None if o is None else o.detach().clone()
                            for o in outs]
        else:
            for buf, o in zip(self.outputs, outs):
                if buf is not None:
                    buf.copy_(o)
        return self.outputs


class StepExecutable:
    """One planned Session step compiled for one feed-shape bucket (the
    port's ``AotStepExecutable``): a static buffer per feed, the static
    device key buffer ``(n_keys, 2)`` int32 of the step's random ops, the
    fetch outputs and the graph (:attr:`graph`), the launch counts it
    captured, and the store version it was captured at (a replay after the
    store's tensors moved would write to old addresses: the Session
    re-captures instead). ``feed_signature`` and ``host_key`` (the host
    scalars the step read, e.g. a fed ``keep_prob``) are its key."""

    def __init__(self, feed_specs: Dict[Any, tuple], n_keys: int, device,
                 feed_sig: tuple, host_key: tuple, store_version: int):
        self.device = torch.device(device)
        self.feeds = {t: StagedInput(shape, dtype, self.device)
                      for t, (shape, dtype) in feed_specs.items()}
        self.keys = (StagedInput((n_keys, 2), torch.int32, self.device)
                     if n_keys else None)
        self.seeds = (StagedInput((n_keys, 1), torch.int32, self.device)
                      if n_keys else None)
        self.seeded = None   # unknown until the step has run once
        self.feed_signature = feed_sig
        self.host_key = host_key
        self.store_version = store_version
        self.graph: Optional[DeviceGraph] = None

    @property
    def key_buffer(self) -> Optional[torch.Tensor]:
        return None if self.keys is None else self.keys.static

    @property
    def seed_buffer(self) -> Optional[torch.Tensor]:
        return None if self.seeds is None else self.seeds.static

    @property
    def launches(self) -> Dict[str, int]:
        return self.graph.launches if self.graph is not None else {}

    @property
    def outputs(self) -> Optional[list]:
        return self.graph.outputs if self.graph is not None else None

    def stage(self, feeds: Dict[Any, Any], keys: Optional[np.ndarray],
              seeds: Optional[np.ndarray] = None):
        """Refill the feed buffers, the key buffer when ``keys`` (the
        ``(n_keys, 2)`` uint32 words) is given, and the seed buffer when
        ``seeds`` (``(n_keys, 1)`` int32) is."""
        for t, buf in self.feeds.items():
            buf.stage(feeds[t])
        if keys is not None:
            self.keys.stage(np.asarray(keys, np.uint32).view(np.int32))
        if seeds is not None:
            self.seeds.stage(np.asarray(seeds, np.int32))

    def replay(self) -> list:
        return self.graph.replay()

    def release(self) -> None:
        if self.graph is not None:
            self.graph.release()
        self.feeds.clear()
        self.keys = None
        self.seeds = None


def compile_step(step_fn: Callable[["StepExecutable"], Sequence[Any]],
                 feed_specs: Dict[Any, tuple], n_keys: int, device,
                 feed_sig: tuple, host_key: tuple,
                 store_version: int) -> StepExecutable:
    """Compile a planned step for one feed-shape bucket:
    ``step_fn(exe)`` runs the step against ``exe``'s static feed and key
    buffers and returns its fetch tensors; it is captured here (run at
    every replay on the CPU). Its warm-up is the caller's."""
    exe = StepExecutable(feed_specs, n_keys, device, feed_sig, host_key,
                         store_version)
    exe.graph = DeviceGraph(lambda: step_fn(exe), device)
    exe.graph.capture()
    return exe
