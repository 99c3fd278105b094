"""``stf.Session`` of the port: run a graph on the card (or the CPU).

A focused port of the run path of ``simple_tensorflow_tpu/client/
session.py``:

- ``BaseSession.run`` (:1422) with ``_FetchMapper`` (:667; nested lists,
  tuples, dicts and namedtuples of Tensors, Operations, Variables and names
  such as ``"loss:0"``) and ``_normalize_feeds`` (:2077; a feed of the
  wrong shape raises ``ValueError``);
- the plan cache (``_cache_key`` :2149, ``_get_or_plan`` :2174): a plan is
  made once per (fetches, fed tensors) signature by ``_plan`` (:2894):
  prune, then the op list, which every later run executes as it stands;
- the ``VariableStore`` (:491) of device tensors;
- the RNG chain (``_ensure_base_key``/``_rng_args``, :2646-2679): a run
  whose plan draws randomness advances the run counter ``c`` and draws
  from ``fold_in(key(graph seed or 0), c)``; a plan in which no op
  declares an RNG effect does not advance it (``_plan_uses_rng``, :300);
- ``close``, the context manager and ``as_default``.

Device rule: ``Session()`` runs on ``"cuda"`` through
:func:`..models.common.resolve_device` (which pins f32 matrix products and
convolutions to full f32, no TF32) and raises when there is no card;
``ConfigProto(device_count={"GPU": 0})`` selects the CPU.

Where the JAX package compiles a planned run into one XLA program, the
port dispatches the plan's op lowerings from Python on every run: that
host cost is measured in ``chip_smoke.py`` and written down in PERF.md. A
run updates the store as its ops execute (the JAX package commits the new
state when the program returns), so a run that raises midway may leave
some variables updated. Left out: the graph optimizer, sharding, analysis,
telemetry, ``run_steps``, ``partial_run``, ``make_callable``, handles and
``RunOptions`` tracing.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import numpy as np
import torch

from ..framework import constant_op
from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import gradients as gradients_mod
from ..framework import lowering as lowering_mod
from ..framework import prng
from ..models.common import resolve_device

Operation = ops_mod.Operation
Tensor = ops_mod.Tensor

_default_session_stack = threading.local()


def get_default_session():
    stack = getattr(_default_session_stack, "stack", None)
    return stack[-1] if stack else None


class VariableStore:
    """Variable state: store name -> tensor on the session's device."""

    def __init__(self, device):
        self.values: Dict[str, torch.Tensor] = {}
        self.device = device

    def load(self, name: str, value, variable=None):
        """Set ``name`` to a copy of ``value`` (numpy or tensor), in the
        variable's declared dtype (64-bit narrowed) when one is given."""
        dt = variable.dtype.base_dtype.torch_dtype \
            if variable is not None else None
        if isinstance(value, torch.Tensor):
            value = value.detach().to(device=self.device,
                                      dtype=dt or value.dtype, copy=True)
        else:
            value = constant_op.to_torch(value, self.device, dt)
        self.values[name] = value

    def as_numpy(self, name: str) -> np.ndarray:
        return _to_numpy(self.values[name])


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor the store may update in
    place)."""
    v = v.detach()
    if v.dtype == torch.bfloat16:
        return v.float().cpu().numpy().astype(dtypes_mod.bfloat16.np_dtype)
    return v.cpu().numpy().copy() if v.device.type == "cpu" \
        else v.cpu().numpy()


class _FetchMapper:
    """Nested fetch structures (ref: python/client/session.py:182)."""

    def __init__(self, graph, fetches):
        self.elements: List[Any] = []
        self._index: Dict[Any, int] = {}
        self.structure = self._build(graph, fetches)

    def _register(self, el):
        if el not in self._index:
            self._index[el] = len(self.elements)
            self.elements.append(el)
        return self._index[el]

    def _build(self, g, f):
        if isinstance(f, (list, tuple)):
            kids = [self._build(g, x) for x in f]
            if hasattr(f, "_fields"):
                return ("namedtuple", type(f), kids)
            return ("list", type(f), kids)
        if isinstance(f, dict):
            return ("dict", type(f),
                    [(k, self._build(g, v)) for k, v in f.items()])
        el = g.as_graph_element(f, allow_tensor=True, allow_operation=True)
        return ("leaf", None, self._register(el))

    def rebuild(self, values, node=None):
        kind, typ, payload = node or self.structure
        if kind == "leaf":
            return values[payload]
        if kind == "dict":
            return typ((k, self.rebuild(values, v)) for k, v in payload)
        kids = [self.rebuild(values, k) for k in payload]
        if kind == "namedtuple":
            return typ(*kids)
        return tuple(kids) if typ is tuple else kids


class _Plan:
    """A planned run: the pruned op list in execution order and what its
    execution needs (whether it draws randomness, the gradient leaves, the
    values to keep across an in-place update)."""

    def __init__(self, ops, fetch_tensors):
        self.ops = ops
        self.uses_rng = any(op.op_def.effects.rng for op in ops)
        grads = [op for op in ops if op.type == "SymbolicGradient"]
        self.grad_leaves = frozenset(
            x for op in grads for x in gradients_mod.symbolic_gradient_xs(op))
        self.needs_grad = bool(grads)
        self.retain_graph = len(grads) > 1
        self.preserve = self._preserve(ops, fetch_tensors)

    @staticmethod
    def _preserve(ops, fetch_tensors):
        """Per in-place op: the tensors made before it and read after it
        (by a later op or as a fetch)."""
        in_place = [i for i, op in enumerate(ops) if op.op_def.in_place]
        if not in_place:
            return {}
        pos = {op: i for i, op in enumerate(ops)}
        last_use: Dict[Tensor, float] = {}
        for i, op in enumerate(ops):
            for t in op.inputs:
                if t.op in pos:
                    last_use[t] = max(last_use.get(t, -1), i)
        for t in fetch_tensors:
            last_use[t] = float("inf")
        return {ops[i]: [t for t, last in last_use.items()
                         if t.op in pos and pos[t.op] < i < last]
                for i in in_place}


class BaseSession:
    def __init__(self, target="", graph=None, config=None):
        self._graph = graph or ops_mod.get_default_graph()
        self._config = config
        self._device = resolve_device(
            config.device() if config is not None else "cuda")
        self._variable_store = VariableStore(self._device)
        self._cache: Dict[Any, _Plan] = {}
        self._const_cache: Dict[Operation, torch.Tensor] = {}
        self._flat_groups: Dict[tuple, torch.Tensor] = {}
        self._closed = False
        self._run_counter = 0
        self._base_key = None
        self._lock = threading.RLock()
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0

    @property
    def graph(self):
        return self._graph

    @property
    def device(self) -> torch.device:
        return self._device

    def close(self):
        self._closed = True
        self._cache.clear()
        self._const_cache.clear()
        self._flat_groups.clear()
        self._variable_store.values.clear()

    def __enter__(self):
        if not hasattr(_default_session_stack, "stack"):
            _default_session_stack.stack = []
        _default_session_stack.stack.append(self)
        return self

    def __exit__(self, *exc):
        _default_session_stack.stack.pop()
        self.close()
        return False

    def as_default(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            if not hasattr(_default_session_stack, "stack"):
                _default_session_stack.stack = []
            _default_session_stack.stack.append(self)
            try:
                yield self
            finally:
                _default_session_stack.stack.pop()

        return ctx()

    # -- run -----------------------------------------------------------------
    def run(self, fetches, feed_dict=None, options=None, run_metadata=None):
        """(ref: python/client/session.py:767 ``BaseSession.run``):
        numpy arrays for Tensors, None for Operations, in the structure of
        ``fetches``."""
        if self._closed:
            raise RuntimeError("Attempted to use a closed Session.")
        with self._lock:
            mapper = _FetchMapper(self._graph, fetches)
            feeds = self._normalize_feeds(feed_dict)
            plan = self._get_or_plan(mapper.elements, feeds)
            values = self._execute_plan(plan, mapper.elements, feeds)
        return mapper.rebuild(values)

    def _normalize_feeds(self, feed_dict) -> Dict[Tensor, Any]:
        feeds: Dict[Tensor, Any] = {}
        for k, v in (feed_dict or {}).items():
            t = self._graph.as_graph_element(k, allow_tensor=True,
                                             allow_operation=False)
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v, dtype=t.dtype.base_dtype.np_dtype)
            if not t.shape.is_compatible_with(tuple(v.shape)):
                raise ValueError(
                    f"Cannot feed value of shape {tuple(v.shape)} for "
                    f"tensor {t.name} with shape {t.shape}")
            feeds[t] = v
        return feeds

    @staticmethod
    def _cache_key(elements, feed_tensors):
        return (tuple(e.name if isinstance(e, Tensor) else "(op)" + e.name
                      for e in elements),
                tuple(sorted(t.name for t in feed_tensors)))

    def _get_or_plan(self, elements, feeds) -> _Plan:
        key = self._cache_key(elements, feeds)
        plan = self._cache.get(key)
        if plan is None:
            self.plan_cache_misses += 1
            plan = self._cache[key] = self._plan(elements, feeds)
        else:
            self.plan_cache_hits += 1
        return plan

    def _plan(self, elements, feeds) -> _Plan:
        fed = set(feeds)
        target_ops: List[Operation] = []
        fetch_tensors: List[Tensor] = []
        for e in elements:
            if isinstance(e, Operation):
                target_ops.append(e)
            else:
                fetch_tensors.append(e)
                if e not in fed:
                    target_ops.append(e.op)
        return _Plan(lowering_mod.prune(target_ops, fed), fetch_tensors)

    def _rng_root(self, consume: bool):
        """The run's root key, advancing the run counter, or None for a
        plan that draws nothing (the counter stays)."""
        if not consume:
            return None
        if self._base_key is None:
            seed = self._graph.seed if self._graph.seed is not None else 0
            self._base_key = prng.key(seed)
        self._run_counter += 1
        return prng.fold_in(self._base_key, self._run_counter)

    def _execute_plan(self, plan: _Plan, elements, feeds):
        ctx = lowering_mod.LoweringContext(
            self._variable_store.values, self._device,
            rng_root=self._rng_root(plan.uses_rng), feeds=feeds,
            session=self, grad_leaves=plan.grad_leaves,
            retain_graph=plan.retain_graph, preserve=plan.preserve)
        with torch.set_grad_enabled(plan.needs_grad):
            lowering_mod.execute_ops(ctx, plan.ops)
        out = []
        for e in elements:
            if isinstance(e, Operation):
                out.append(None)
            elif e in feeds and not isinstance(feeds[e], torch.Tensor):
                out.append(np.asarray(feeds[e]).astype(
                    dtypes_mod.narrowed_if_no_x64(e.dtype).np_dtype))
            else:
                out.append(_to_numpy(ctx.value_of(e)))
        return out


class Session(BaseSession):
    """(ref: python/client/session.py ``Session``)."""

