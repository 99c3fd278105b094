"""``stf.Session`` of the port: run a graph on the card (or the CPU).

A focused port of the run path of ``simple_tensorflow_tpu/client/
session.py``:

- ``BaseSession.run`` (:1422) with ``_FetchMapper`` (:667; nested lists,
  tuples, dicts and namedtuples of Tensors, Operations, Variables and names
  such as ``"loss:0"``) and ``_normalize_feeds`` (:2077; a feed of the
  wrong shape raises ``ValueError``);
- the plan cache (``_cache_key`` :2149, ``_get_or_plan`` :2174): a plan is
  made once per (fetches, fed tensors) signature by ``_plan`` (:2894):
  prune, the variable-hazard check (``analysis.check_plan``, :2944; modes
  ``off|warn|raise|auto_deps``, ``ConfigProto(variable_hazard_mode=)``),
  then the op list;
- ``Session.plan`` (:1512) and ``ExecutionPlan`` (:820: ``execute``,
  ``compile``, ``compiled_buckets``, ``device_op_count``) and
  ``make_callable`` (:3342);
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

A run is atomic, as the JAX program is: before any op executes, every
variable the plan reads first is checked against the store
(``FailedPreconditionError`` otherwise), and writes are staged and
committed when every op has run (``LoweringContext.commit``); the one
write made mid-run is the fused optimizer update, in place, the last op of
every optimizer plan.

Where the JAX package compiles a planned run into one XLA program per
feed-shape bucket, the port captures one CUDA graph (``compiler/aot.py``)
per plan and executable key: the feed signature, the host scalars the run
reads (a fed ``keep_prob``) and whether the kernels' plain versions are
on. As with JAX's jit, a (plan, key) runs eagerly the first time (the
warm-up, on a side stream), is captured on its second run and replayed
from then on; a replay stages the feeds and the random ops' keys (still
derived on the host from the run counter) and the dropout seeds drawn
from them (``prng.randint``, for the flash and dropout-residual kernels'
seed-pointer entries) into the graph's static buffers. A store whose
tensors moved since a capture (a load, a new variable, a rebuilt flat
buffer; ``VariableStore.version``) makes the next run of that key a
warm-up again. On the CPU the same executable runs the op list eagerly
into its static buffers. ``ExecutionPlan.compile`` warms up (dry:
nothing committed) and captures ahead of traffic. The private ``_capture
= False`` runs every step eagerly (the reference the smoke and the tests
hold the graphs against).

Left out: the graph optimizer, sharding, verification, telemetry,
``run_steps``, ``partial_run``, handles and ``RunOptions`` tracing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import analysis
from .. import compiler
from ..framework import constant_op
from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import gradients as gradients_mod
from ..framework import lowering as lowering_mod
from ..framework import prng
from ..framework import random_seed
from ..framework.errors import (FailedPreconditionError,
                                InvalidArgumentError)
from ..models.common import resolve_device
from ..ops.fused_ops import using_plain_versions

Operation = ops_mod.Operation
Tensor = ops_mod.Tensor

_default_session_stack = threading.local()


def get_default_session():
    stack = getattr(_default_session_stack, "stack", None)
    return stack[-1] if stack else None


_log = logging.getLogger(__name__)


class VariableStore:
    """Variable state: store name -> tensor on the session's device.
    ``version`` moves on whenever an entry is replaced by another tensor
    (a new address), which a captured step would not see."""

    def __init__(self, device):
        self.values: Dict[str, torch.Tensor] = {}
        self.device = device
        self.version = 0

    def set(self, name: str, value: torch.Tensor):
        """Make ``value`` the entry ``name``."""
        self.values[name] = value
        self.version += 1

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
        self.set(name, value)

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
    execution needs (whether it draws randomness and the slot of each
    random op in a compiled step's key buffer, the variables it reads
    before writing them, the gradient leaves, the values to keep across an
    in-place update), and its compiled executables."""

    def __init__(self, ops, fetch_tensors, feed_tensors):
        self.ops = ops
        self.rng_ops = [op for op in ops if op.op_def.effects.rng]
        self.uses_rng = bool(self.rng_ops)
        self.rng_slots = {op: i for i, op in enumerate(self.rng_ops)}
        self.rng_folds = np.array(
            [random_seed.fold_in_value(op) for op in self.rng_ops],
            dtype=np.uint32)
        self.must_exist = self._first_reads(ops)
        grads = [op for op in ops if op.type == "SymbolicGradient"]
        self.grad_leaves = frozenset(
            x for op in grads for x in gradients_mod.symbolic_gradient_xs(op))
        self.needs_grad = bool(grads)
        self.retain_graph = len(grads) > 1
        self.preserve = self._preserve(ops, fetch_tensors)
        self.feed_tensors = list(feed_tensors)
        fed = set(feed_tensors)
        # the fetched tensors a step computes (a fed fetch is its feed)
        self.computed = [t for t in fetch_tensors if t not in fed]
        # the tensors whose host value the run read (Dropout's fed
        # keep_prob), learned at the first run: their values key the
        # executables
        self.host_reads: Optional[List[Tensor]] = None
        self.executables: Dict[tuple, compiler.StepExecutable] = {}
        self.warm: set = set()   # executable keys that have run eagerly

    @staticmethod
    def _first_reads(ops):
        """``[(variable name, op)]``: each variable an op reads before any
        op of the plan writes it, in plan order (a read-modify-write
        assign reads)."""
        written, seen, out = set(), set(), []
        for op in ops:
            eff = op.op_def.effects
            if not (eff.reads or eff.writes):
                continue
            writes = _var_names(eff.resolved_writes(op))
            reads = _var_names(eff.resolved_reads(op))
            if eff.update in ("add", "sub"):
                reads += writes
            for n in reads:
                if n not in written and n not in seen:
                    seen.add(n)
                    out.append((n, op))
            written.update(writes)
        return out

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


def _var_names(resources) -> List[str]:
    return sorted(r.split("=", 1)[1] for r in resources
                  if r.startswith("var_name="))


class ExecutionPlan:
    """The plan half of ``Session.run`` as a handle (ref: the JAX
    package's ``ExecutionPlan``, client/session.py:820). ``Session.plan``
    resolves the fetch structure and plans once; :meth:`execute` runs it
    with the planned feeds (the same cache entry and executables as a
    ``run`` of the same signature); :meth:`compile` captures its CUDA
    graph for one feed-shape bucket ahead of traffic."""

    def __init__(self, session, mapper, feed_tensors, plan):
        self._session = session
        self._mapper = mapper
        self._plan = plan
        self.feed_tensors: List[Tensor] = list(feed_tensors)
        self._planned_set = frozenset(self.feed_tensors)

    @property
    def session(self):
        return self._session

    @property
    def device_op_count(self) -> int:
        """The ops a run dispatches (placeholders, constants and no-ops
        aside)."""
        return sum(1 for op in self._plan.ops if op.type not in (
            "Placeholder", "PlaceholderWithDefault", "Const", "NoOp"))

    def compiled_buckets(self) -> List[tuple]:
        """The feed signatures with a compiled executable."""
        return sorted({exe.feed_signature
                       for exe in self._plan.executables.values()})

    def _feeds(self, feed_dict):
        sess = self._session
        feeds = sess._normalize_feeds(feed_dict)
        if feeds.keys() != self._planned_set:
            missing = sorted(t.name for t in self._planned_set - set(feeds))
            extra = sorted(t.name for t in set(feeds) - self._planned_set)
            raise InvalidArgumentError(
                None, None,
                "ExecutionPlan.execute: feeds must match the planned "
                f"signature (missing: {missing}, unplanned: {extra}); "
                "build a new plan for a different feed set")
        return feeds

    def execute(self, feed_dict=None):
        """Run the planned step: stage feeds, replay (or warm up or
        capture), assemble; no fetch mapping, cache lookup or re-plan."""
        sess = self._session
        sess._check_open()
        with sess._lock:
            values = sess._run_plan(self._plan, self._mapper.elements,
                                    self._feeds(feed_dict))
        return self._mapper.rebuild(values)

    __call__ = execute

    def compile(self, feed_shapes=None, feed_dict=None):
        """Capture the planned step for one feed-shape bucket, ahead of
        traffic: a dry warm-up (the op list run eagerly on a side stream,
        nothing committed, no RNG run consumed, in-place updates on
        copies), then the capture. ``feed_shapes``: ``{tensor or name:
        shape}`` of the bucket; a feed it does not name keeps its static
        shape. ``feed_dict``: values for feeds the step reads on the host
        (a fed ``keep_prob``: its value keys the executable) or any other
        feed; every other feed warms up as zeros. Variables must be
        initialized. Returns the :class:`..compiler.StepExecutable`."""
        sess = self._session
        sess._check_open()
        shapes = {sess._graph.as_graph_element(k, True, False): tuple(v)
                  for k, v in (feed_shapes or {}).items()}
        given = sess._normalize_feeds(feed_dict)
        values = {}
        for t in self.feed_tensors:
            if t in given:
                values[t] = given[t]
                continue
            shape = shapes.get(t)
            if shape is None:
                if not t.shape.is_fully_defined():
                    raise ValueError(
                        f"compile: feed {t.name} has dynamic shape "
                        f"{t.shape}; pass its bucket shape in feed_shapes")
                shape = tuple(t.shape.as_list())
            values[t] = np.zeros(shape, dtypes_mod.narrowed_if_no_x64(
                t.dtype.base_dtype).np_dtype)
        feeds = self._feeds(values)
        with sess._lock:
            return sess._compile(self._plan, feeds)


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
        self.captures = 0   # CUDA graphs captured (executables compiled)
        # private: False runs every step eagerly (the reference compiled
        # steps are held against); _refresh_keys / _refresh_seeds False
        # skip the key / seed buffer's refill before a replay (planted
        # faults: the replay draws stale masks); _timings, a dict,
        # collects host seconds by kind (execute_ops, _replay)
        self._capture = True
        self._refresh_keys = True
        self._refresh_seeds = True
        self._timings = None

    @property
    def graph(self):
        return self._graph

    @property
    def device(self) -> torch.device:
        return self._device

    def close(self):
        self._closed = True
        for plan in self._cache.values():
            for exe in plan.executables.values():
                exe.release()
        self._cache.clear()
        self._const_cache.clear()
        self._flat_groups.clear()
        self._variable_store.values.clear()

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Attempted to use a closed Session.")

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
        self._check_open()
        with self._lock:
            mapper = _FetchMapper(self._graph, fetches)
            feeds = self._normalize_feeds(feed_dict)
            plan = self._get_or_plan(mapper.elements, feeds)
            values = self._run_plan(plan, mapper.elements, feeds)
        return mapper.rebuild(values)

    def plan(self, fetches, feeds=None) -> ExecutionPlan:
        """Plan ``fetches`` against the declared ``feeds`` (tensors or
        names) without running: the :class:`ExecutionPlan` a ``run`` of
        the same signature would use (the same cache entry)."""
        self._check_open()
        mapper = _FetchMapper(self._graph, fetches)
        feed_ts = [self._graph.as_graph_element(f, allow_tensor=True,
                                                allow_operation=False)
                   for f in (feeds or [])]
        with self._lock:
            plan = self._get_or_plan(mapper.elements,
                                     {t: None for t in feed_ts})
        return ExecutionPlan(self, mapper, feed_ts, plan)

    def make_callable(self, fetches, feed_list=None):
        """A function running ``fetches`` with positional feeds
        (``feed_list`` order): the fetch structure and feed tensors are
        resolved once here; each call runs the cached plan (ref:
        session.py make_callable)."""
        feed_ts = [self._graph.as_graph_element(f, True, False)
                   for f in (feed_list or [])]
        mapper = _FetchMapper(self._graph, fetches)

        def call(*args):
            if len(args) != len(feed_ts):
                raise ValueError(f"Expected {len(feed_ts)} feed values")
            self._check_open()
            with self._lock:
                feeds = self._normalize_feeds(dict(zip(feed_ts, args)))
                plan = self._get_or_plan(mapper.elements, feeds)
                values = self._run_plan(plan, mapper.elements, feeds)
            return mapper.rebuild(values)

        return call

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

    def _hazard_mode(self) -> str:
        mode = getattr(self._config, "variable_hazard_mode", None) \
            if self._config is not None else None
        return mode or analysis.get_hazard_mode()

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
        ops = lowering_mod.prune(target_ops, fed)
        ops, diags = analysis.check_plan(ops, mode=self._hazard_mode())
        for d in diags:
            if d.severity == analysis.WARNING:
                _log.warning("plan analysis: %s", d.format())
        return _Plan(ops, fetch_tensors, list(feeds))

    def _rng_root(self, consume: bool, dry: bool = False):
        """The run's root key, advancing the run counter, or None for a
        plan that draws nothing (the counter stays). A ``dry`` run draws
        from the next counter without advancing it."""
        if not consume:
            return None
        if self._base_key is None:
            seed = self._graph.seed if self._graph.seed is not None else 0
            self._base_key = prng.key(seed)
        if dry:
            return prng.fold_in(self._base_key, self._run_counter + 1)
        self._run_counter += 1
        return prng.fold_in(self._base_key, self._run_counter)

    def _check_initialized(self, plan: _Plan):
        """Fail the run before any op executes when a variable it reads
        first is not in the store (as the JAX program fails while it is
        traced, before anything commits)."""
        for name, op in plan.must_exist:
            if name not in self._variable_store.values:
                raise FailedPreconditionError(
                    None, op, lowering_mod.uninitialized_message(name))

    def _context(self, plan: _Plan, feeds, rng_root):
        return lowering_mod.LoweringContext(
            self._variable_store, self._device, rng_root=rng_root,
            feeds=feeds, session=self, grad_leaves=plan.grad_leaves,
            retain_graph=plan.retain_graph, preserve=plan.preserve)

    def _step(self, plan: _Plan, ctx) -> list:
        """Run the plan's ops in ``ctx``, then commit: the computed fetch
        values (a value aliasing a store tensor the commit writes into is
        copied first)."""
        with torch.set_grad_enabled(plan.needs_grad):
            lowering_mod.execute_ops(ctx, plan.ops)
        outs = [ctx.value_of(t) for t in plan.computed]
        targets = ctx.commit_targets()
        if targets:
            outs = [o.detach().clone()
                    if o.untyped_storage().data_ptr() in targets else o
                    for o in outs]
        ctx.commit()
        return outs

    def _exe_key(self, plan: _Plan, feeds) -> tuple:
        host = tuple(lowering_mod.host_scalar(t, feeds)
                     for t in plan.host_reads or ())
        return (compiler.feed_signature(feeds), host,
                using_plain_versions())

    def _run_plan(self, plan: _Plan, elements, feeds):
        """One run of ``plan``: eagerly (the first run of an executable
        key, or with ``_capture`` off), captured (its second run) or
        replayed (module docstring)."""
        self._check_initialized(plan)
        if not (self._capture and plan.ops):
            outs = self._run_eager(plan, feeds)
            return self._values(plan, elements, feeds, outs)
        key = self._exe_key(plan, feeds)
        exe = plan.executables.get(key)
        if exe is not None and \
                exe.store_version != self._variable_store.version:
            del plan.executables[key]
            exe.release()
            plan.warm.discard(key)
            exe = None
        if exe is None and key not in plan.warm:
            outs = self._run_eager(plan, feeds, warm_up=True)
            plan.warm.add(self._exe_key(plan, feeds))
            return self._values(plan, elements, feeds, outs)
        if exe is None:
            exe = self._capture_step(plan, key, feeds)
        return self._values(plan, elements, feeds,
                            self._replay(plan, exe, feeds))

    def _run_eager(self, plan: _Plan, feeds, warm_up=False, dry=False):
        """The op list dispatched eagerly (a warm-up on a side stream);
        records the host scalars the run read."""
        ctx = self._context(plan, feeds, self._rng_root(plan.uses_rng, dry))
        ctx.dry = dry
        ctx.timings = self._timings
        if warm_up:
            outs = compiler.on_side_stream(lambda: self._step(plan, ctx),
                                           self._device)
        else:
            outs = self._step(plan, ctx)
        plan.host_reads = list(dict.fromkeys(ctx.host_reads))
        return outs

    def _capture_step(self, plan: _Plan, key, feeds):
        """Compile ``plan`` for this run's executable key: capture its op
        list against the executable's static feed and key buffers."""
        # the scalars host_value may read (the rest live in the buffers)
        host_feeds = {t: v for t, v in feeds.items() if np.size(v) == 1}

        def step_fn(exe):
            ctx = self._context(plan, host_feeds, None)
            ctx.compiled = True
            ctx.key_buffer = exe.key_buffer
            ctx.seed_buffer = exe.seed_buffer
            ctx.rng_slots = plan.rng_slots
            for t, buf in exe.feeds.items():
                ctx.env[t] = ctx._maybe_leaf(t, buf.static)
            outs = self._step(plan, ctx)
            exe.seeded = ctx.seeds_read
            return outs

        specs = {t: (tuple(np.shape(feeds[t])),
                     t.dtype.base_dtype.torch_dtype)
                 for t in plan.feed_tensors}
        exe = compiler.compile_step(
            step_fn, specs, len(plan.rng_ops), self._device, key[0], key[1],
            self._variable_store.version)
        plan.executables[key] = exe
        self.captures += 1
        return exe

    def _replay(self, plan: _Plan, exe, feeds):
        """Stage the feeds and this run's keys, replay. With ``_timings``
        a dict, adds the host seconds of both (``"stage"``,
        ``"replay"``)."""
        t0 = time.perf_counter()
        keys = seeds = None
        if plan.uses_rng:
            root = self._rng_root(True)
            op_keys = prng.fold_in(root, plan.rng_folds)
            if self._refresh_keys:
                keys = op_keys
            if exe.seeded is not False and self._refresh_seeds:
                seeds = prng.randint(op_keys, (1,), 0, prng.INT32_MAX)
        exe.stage(feeds, keys, seeds)
        t1 = time.perf_counter()
        outs = exe.replay()
        if self._timings is not None:
            for k, dt in (("stage", t1 - t0),
                          ("replay", time.perf_counter() - t1)):
                self._timings[k] = self._timings.get(k, 0.0) + dt
        return outs

    def _compile(self, plan: _Plan, feeds):
        """:meth:`ExecutionPlan.compile` under the lock."""
        self._check_initialized(plan)
        self._run_eager(plan, feeds, warm_up=True, dry=True)
        key = self._exe_key(plan, feeds)
        exe = self._capture_step(plan, key, feeds)
        plan.warm.add(key)
        return exe

    def _values(self, plan: _Plan, elements, feeds, outs):
        computed = dict(zip(plan.computed, outs))
        out = []
        for e in elements:
            if isinstance(e, Operation):
                out.append(None)
            elif e in feeds and not isinstance(feeds[e], torch.Tensor):
                out.append(np.asarray(feeds[e]).astype(
                    dtypes_mod.narrowed_if_no_x64(e.dtype).np_dtype))
            elif e in feeds:
                out.append(_to_numpy(feeds[e].to(
                    e.dtype.base_dtype.torch_dtype)))
            else:
                out.append(_to_numpy(computed[e]))
        return out


class Session(BaseSession):
    """(ref: python/client/session.py ``Session``)."""

