"""Branches and loops inside a captured CUDA graph: conditional nodes, set
by the kernel ``csrc/control_flow.cu``, and the host loop that is their
plain version.

It replaces no TPU kernel: the JAX package's ``cond`` and ``while_loop``
lower to ``lax.cond`` and ``lax.while_loop``
(``simple_tensorflow_tpu/ops/control_flow_ops.py:192``, ``:337``), control
flow that XLA keeps on the device. A Session step captured into a CUDA
graph (``compiler/aot.py``) would otherwise fix the branch taken and the
trip count at capture, or read the predicate on the host at every replay.

- :func:`run_if` ``(pred, fn)``: ``fn()`` runs when the one-element bool
  ``pred`` holds. On the card, under a capture, it is captured into the
  body graph of an IF node whose handle the setter kernel sets from
  ``pred`` when the graph runs.
- :func:`run_while` ``(pred, body)``: ``body()`` runs while the predicate
  holds; it returns the predicate recomputed from the state it updated in
  place. On the card a WHILE node: the setter runs before the node and at
  the end of every body.

On the CPU (a ``pred`` on the CPU) both are the plain version: a host
``if``/``while`` on ``pred``'s value. A CUDA ``pred`` outside a capture
raises: the eager Session path reads its predicates itself.

The body is captured on a child stream (one per nesting depth) into the
node's body graph; its allocations go to a memory pool of its own
(PyTorch's caching allocator routes a stream's allocations to a pool), so
nothing the body frees is handed to the parent graph. The pools live as
long as the graph: a capture collects them (:func:`collect_bodies`) and
:func:`release_pools` gives them back when the graph is dropped.

Launch counts: a replay adds the launches its capture counted, once each
(``compiler/aot.py``), but a kernel in a body runs once per run of the
body. So every body counts its runs on the device (a counter it adds one
to when it starts, :class:`BodyFrame`), and :func:`settle` adds the
difference, body runs less parent runs, times the body's own launches:
the counts are exact per kernel after a settle (``common.launch_counts``
settles first). The setter counts under ``cond_set``: once per node and
once per run of a WHILE body.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build, common
from .common import check_status, count_launch

# the open body frames (innermost last) and the pools and frames being
# collected: one capture runs at a time (the Session's lock), and autograd
# may run a backward's body capture on its own device thread
_state = {"frames": [], "pools": None, "bodies": None}
_streams: dict = {}


# the bodies' run counters: slots of one int64 buffer a device, made
# outside any capture (``ensure_counters``). A counter made inside a
# capture would take a block that an earlier kernel of the same capture
# writes as a temporary at every replay: a capture reuses a block in
# stream order, and a counter must persist across replays.
COUNTER_SLOTS = 4096
_counters: dict = {}


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def ensure_counters(device) -> None:
    """Make the device's counter buffer (outside a capture) if it has
    none."""
    index = _index(device)
    if index not in _counters:
        # a normal tensor also when first made under torch.inference_mode
        # (the serving model captures there): bodies add to it in place in
        # and out of that mode
        with torch.inference_mode(False):
            buf = torch.zeros(COUNTER_SLOTS, dtype=torch.int64,
                              device=torch.device("cuda", index))
        _counters[index] = (buf, list(range(COUNTER_SLOTS - 1, -1, -1)))


def _take_counter(device):
    buf, free = _counters.get(device.index, (None, None))
    if buf is None:
        raise RuntimeError("conditional-node bodies count their runs in a "
                           "buffer made before the capture: call "
                           "control_flow.ensure_counters(device) first")
    if not free:
        raise RuntimeError(f"all {COUNTER_SLOTS} body run counters are in "
                           "use: release graphs that are no longer needed")
    return buf, free.pop()


def release_frames(device, frames) -> None:
    """Give back the counter slots of a dropped graph's bodies."""
    free = _counters[_index(device)][1]
    for f in frames:
        free.append(f.slot)
    frames.clear()


class BodyFrame:
    """One captured body: ``runs``, a device counter its every run adds
    one to (a slot of the device's counter buffer); ``own``, the launches
    captured in it and not in a body nested in it (each runs once per run
    of the body); ``parent``, the enclosing body or None (the graph
    itself)."""

    def __init__(self, device, parent, graph):
        self._buf, self.slot = _take_counter(device)
        self.parent = parent
        self.graph = graph  # the body graph, which its node owns
        self.own: dict = {}
        self._before = common.counts_now()
        self._nested: dict = {}

    @property
    def runs(self) -> torch.Tensor:
        # a view made anew at each use: one made under inference_mode may
        # not be updated in place outside it
        return self._buf.narrow(0, self.slot, 1)

    def close(self):
        now = common.counts_now()
        total = {k: now[k] - self._before.get(k, 0) for k in now}
        self.own = {k: v - self._nested.get(k, 0) for k, v in total.items()
                    if v - self._nested.get(k, 0)}
        if self.parent is not None:
            for k, v in total.items():
                self.parent._nested[k] = self.parent._nested.get(k, 0) + v


def _pred_arg(pred: torch.Tensor) -> torch.Tensor:
    if pred.numel() != 1:
        raise ValueError(f"a predicate holds one value, got "
                         f"{tuple(pred.shape)}")
    return pred.reshape(1).to(torch.bool).contiguous()


def _host_truth(pred: torch.Tensor) -> bool:
    return bool(pred.reshape(()).item())


def _child_stream(device, depth):
    key = (device.index, depth)
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(device)
    return s


@contextlib.contextmanager
def collect_bodies():
    """Within the block (a graph's capture), every body pool and
    :class:`BodyFrame` a node capture makes is appended to the yielded
    lists ``(pools, frames)``."""
    prev = _state["pools"], _state["bodies"]
    got = [], []
    _state["pools"], _state["bodies"] = got
    try:
        yield got
    finally:
        _state["pools"], _state["bodies"] = prev


def node_count(graph_ptr) -> int:
    """The nodes of a CUDA graph (``cudaGraph_t`` as an int)."""
    n = ctypes.c_ulonglong()
    check_status("graph_node_count", _build.library().stf_graph_node_count(
        graph_ptr, ctypes.byref(n)))
    return n.value


def settle(frames, replays) -> None:
    """Count the launches of ``replays`` replays that the capture-time
    counts left out: a body's own launches once per run of it, less the
    once per run of its parent that the capture counted (an IF body that
    never ran takes its launches back). Reads the body counters (a sync)
    and zeroes them."""
    if not frames:
        return
    runs = {f: int(f.runs.item()) for f in frames}
    for f in frames:
        delta = runs[f] - (replays if f.parent is None else runs[f.parent])
        if delta:
            common.add_launches({k: v * delta for k, v in f.own.items()})
    for f in frames:
        f.runs.zero_()


def release_pools(device, pools) -> None:
    """Give back the body pools of a dropped graph."""
    index = _index(device)
    for pool in pools:
        torch._C._cuda_releasePool(index, pool)
    pools.clear()


def _begin_node(pred, is_while, negate):
    """Add the setter and a conditional node to the current stream's
    capture: ``(handle, body graph pointer)``."""
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a conditional node needs a CUDA graph capture under way; an "
            "eager step reads its predicates on the host")
    lib = _build.library()
    handle = ctypes.c_ulonglong()
    body = ctypes.c_void_p()
    status = lib.stf_cond_node_begin(
        _build.stream_handle(pred.device), int(is_while), pred.data_ptr(),
        int(negate), ctypes.byref(handle), ctypes.byref(body))
    check_status("cond_set", status)
    count_launch("cond_set")
    return handle.value, body.value


@contextlib.contextmanager
def _body_capture(graph_ptr, device):
    """Capture the block's work, on a child stream, into ``graph_ptr``;
    the body first adds one to its frame's run counter."""
    frames = _state["frames"]
    frame = BodyFrame(device, frames[-1] if frames else None, graph_ptr)
    child = _child_stream(device, len(frames))
    pool = torch.cuda.graph_pool_handle()
    lib = _build.library()
    check_status("capture_to_graph",
                 lib.stf_capture_to_graph_begin(child.cuda_stream, graph_ptr))
    frames.append(frame)
    try:
        with torch.cuda.stream(child):
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index,
                                                           pool)
            try:
                frame.runs.add_(1)
                yield child
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool)
    finally:
        frames.pop()
        frame.close()
        status = lib.stf_capture_to_graph_end(child.cuda_stream)
        if _state["pools"] is not None:
            _state["pools"].append(pool)
            _state["bodies"].append(frame)
    check_status("capture_to_graph", status)


def run_if(pred: torch.Tensor, fn, negate: bool = False) -> None:
    """``fn()`` when ``pred`` holds (with ``negate``, when it does not):
    under an IF node on the card, a host ``if`` on the CPU."""
    if pred.device.type == "cpu":
        if _host_truth(pred) != negate:
            fn()
        return
    pred = _pred_arg(pred)
    _, body = _begin_node(pred, False, negate)
    with _body_capture(body, pred.device):
        fn()


def run_while(pred: torch.Tensor, body) -> None:
    """``body()`` while the predicate holds, ``body`` returning it anew:
    under a WHILE node on the card, a host ``while`` on the CPU."""
    if pred.device.type == "cpu":
        while _host_truth(pred):
            pred = body()
        return
    pred = _pred_arg(pred)
    handle, graph = _begin_node(pred, True, False)
    with _body_capture(graph, pred.device) as child:
        nxt = _pred_arg(body())
        status = _build.library().stf_cond_set(
            child.cuda_stream, handle, nxt.data_ptr(), 0)
        check_status("cond_set", status)
        count_launch("cond_set")
