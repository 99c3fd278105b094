"""Op registry of the port: op definitions, lowering rules, shape and dtype
inference.

Port of ``simple_tensorflow_tpu/framework/op_registry.py``: ``Effects``
(:35), ``OpDef`` (:118), ``register`` (:248) and ``register_pure`` (:271).
An op registers a lowering that emits torch ops on the Session's device;
a pure op registers ``pure_fn(*inputs, **attrs)``. Inference runs the pure
function on ``torch.device("meta")`` tensors in place of ``jax.eval_shape``,
so it can never disagree with execution, with the JAX package's two-probe
rule for partial shapes (``_PROBE_A``/``_PROBE_B`` :31-32,
``_spec_with_subst`` :191): unknown dims are replaced by two different
primes, and an output dim that differs between the two runs is unknown.
Kernel-backed ops (the softmax-xent and Dropout wrappers test the device)
pass an ``infer_fn`` or explicit output specs, never a meta launch.
Effects resolve against an op's attrs into concrete resources
(``Effects._resolve`` :75) for the variable-hazard detector
(``analysis/hazards.py``). ``runs_on_host`` ops run on host values in
the Session's host stages: before the device step when they read no
device output (``IteratorGetNext``, ``ParseExample``: their outputs feed
the step), after it otherwise (the summary ops, the JAX package's
post-host stage); ``host_sink_pure`` marks those that only observe device
values, which ``Session.run_steps`` under ``"last"`` defers to once a
window (``analysis/loop_safety.py``). Left out: sharding rules.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch

from . import dtypes as dtypes_mod
from . import tensor_shape as shape_mod

_PROBE_A = 13
_PROBE_B = 17


class Effects:
    """Declared effect set of an op type.

    ``reads``/``writes``: resource selectors, each the name of an attr
    holding the resource id (``"var_name"`` resolves to
    ``"var_name=<name>"``, a list-valued attr to one resource per element)
    or a literal resource prefixed with ``=``. ``update``: how a write
    combines with the previous value: None overwrites (Assign),
    ``"add"``/``"sub"``/... mark read-modify-write updates, which the
    hazard detector lets commute. ``rng``: draws from the per-step random
    stream (the Session advances its run counter only for plans with such
    an op). ``io``: an observable host-side effect."""

    __slots__ = ("reads", "writes", "rng", "io", "update")

    def __init__(self, reads=(), writes=(), rng=False, io=False,
                 update=None):
        self.reads = (reads,) if isinstance(reads, str) else tuple(reads)
        self.writes = (writes,) if isinstance(writes, str) else tuple(writes)
        self.rng = bool(rng)
        self.io = bool(io)
        self.update = update

    def __bool__(self):
        return bool(self.reads or self.writes or self.rng or self.io)

    @staticmethod
    def _resolve(selectors, op) -> frozenset:
        out = set()
        for sel in selectors:
            if sel.startswith("="):
                out.add(sel[1:])
                continue
            v = op.attrs.get(sel)
            if v is None:
                # a resource unique to this op: it aliases nothing
                out.add(f"{sel}@{op.name}")
            elif isinstance(v, (list, tuple)):
                out.update(f"{sel}={x}" for x in v)
            else:
                out.add(f"{sel}={v}")
        return frozenset(out)

    def resolved_reads(self, op) -> frozenset:
        return self._resolve(self.reads, op)

    def resolved_writes(self, op) -> frozenset:
        return self._resolve(self.writes, op)

    def __repr__(self):
        parts = [f"{k}={getattr(self, k)!r}" for k in ("reads", "writes")
                 if getattr(self, k)]
        if self.update:
            parts.append(f"update={self.update!r}")
        parts += ["rng"] * self.rng + ["io"] * self.io
        return "Effects(" + ", ".join(parts) + ")"


NO_EFFECTS = Effects()


class OpDef:
    """Definition of one op type.

    ``lower(ctx, op, input_values) -> [output values]``; for pure ops it
    is synthesized from ``pure_fn(*input_values, **attrs)`` (attrs whose
    name starts with ``_`` are not passed). ``infer_fn(graph, attrs,
    input_tensors) -> [(TensorShape, DType)]`` overrides the meta-tensor
    inference. ``in_place``: the lowering updates variable storage in
    place (the fused Adam update), so the Session keeps a copy of any value
    aliasing that storage that the run still needs afterwards.
    ``runs_on_host``: lowered on numpy values after the device step;
    ``host_sink_pure``: such an op only observes its inputs."""

    __slots__ = ("name", "lower", "pure_fn", "infer_fn", "is_stateful",
                 "effects", "in_place", "runs_on_host", "host_sink_pure")

    def __init__(self, name, lower=None, pure_fn=None, infer_fn=None,
                 is_stateful=False, effects=None, in_place=False,
                 runs_on_host=False, host_sink_pure=False):
        self.name = name
        self.pure_fn = pure_fn
        self.infer_fn = infer_fn
        self.effects = effects if effects is not None else NO_EFFECTS
        self.is_stateful = bool(is_stateful or self.effects)
        self.in_place = bool(in_place)
        self.runs_on_host = bool(runs_on_host)
        self.host_sink_pure = bool(host_sink_pure)
        if lower is None:
            if pure_fn is None:
                raise ValueError(f"Op {name}: need lower or pure_fn")
            lower = self._lower_from_pure
        self.lower = lower

    def _lower_from_pure(self, ctx, op, input_values):
        attrs = {k: v for k, v in op.attrs.items() if not k.startswith("_")}
        out = self.pure_fn(*input_values, **attrs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def infer(self, graph, attrs, input_tensors) -> List[Tuple[Any, Any]]:
        if self.infer_fn is not None:
            return self.infer_fn(graph, attrs, input_tensors)
        if self.pure_fn is None:
            raise ValueError(f"Op {self.name} is stateful and must pass "
                             "output_specs or infer_fn")
        return _generic_infer(self.pure_fn, attrs, input_tensors)


def _meta_with_subst(t, subst: int) -> torch.Tensor:
    """A meta tensor of ``t``'s dtype with unknown dims replaced by
    ``subst`` (unknown rank: 1-D, so the probe mostly fails)."""
    sh = t.shape
    if sh.rank is None:
        dims = (subst,)
    else:
        dims = tuple(subst if d.value is None else d.value for d in sh.dims)
    return torch.empty(dims, dtype=t.dtype.torch_dtype, device="meta")


def _generic_infer(pure_fn, attrs, input_tensors):
    unknown_rank = any(t.shape.rank is None for t in input_tensors)
    fully = all(t.shape.is_fully_defined() for t in input_tensors)
    fn = functools.partial(pure_fn, **{k: v for k, v in attrs.items()
                                       if not k.startswith("_")})

    def run(subst):
        out = fn(*[_meta_with_subst(t, subst) for t in input_tensors])
        return list(out) if isinstance(out, (list, tuple)) else [out]

    try:
        outs_a = run(_PROBE_A)
        if fully and not unknown_rank:
            return [(shape_mod.TensorShape(list(o.shape)),
                     dtypes_mod.as_dtype(o.dtype)) for o in outs_a]
        outs_b = run(_PROBE_B)
        specs = []
        for oa, ob in zip(outs_a, outs_b):
            if unknown_rank or oa.dim() != ob.dim():
                specs.append((shape_mod.TensorShape(None),
                              dtypes_mod.as_dtype(oa.dtype)))
            else:
                dims = [da if da == db else None
                        for da, db in zip(oa.shape, ob.shape)]
                specs.append((shape_mod.TensorShape(dims),
                              dtypes_mod.as_dtype(oa.dtype)))
        return specs
    except (RuntimeError, ValueError, TypeError, IndexError,
            NotImplementedError):
        # the probe failed (a shape-sensitive op with partial inputs):
        # dtype from attrs or inputs, shape unknown; the run computes it
        dt = attrs.get("dtype")
        if dt is None and input_tensors:
            dt = input_tensors[0].dtype
        return [(shape_mod.TensorShape(None),
                 dtypes_mod.as_dtype(dt or dtypes_mod.float32))]


_REGISTRY: Dict[str, OpDef] = {}


def register(name, lower=None, pure_fn=None, infer_fn=None,
             is_stateful=False, effects=None, in_place=False,
             runs_on_host=False, host_sink_pure=False):
    if name in _REGISTRY:
        raise ValueError(f"Op {name} already registered")
    od = OpDef(name, lower=lower, pure_fn=pure_fn, infer_fn=infer_fn,
               is_stateful=is_stateful, effects=effects, in_place=in_place,
               runs_on_host=runs_on_host, host_sink_pure=host_sink_pure)
    _REGISTRY[name] = od
    return od


def register_pure(name, pure_fn, **kw):
    """Register a stateless op whose lowering is a torch function of
    ``(*input_values, **attrs)``."""
    return register(name, pure_fn=pure_fn, **kw)


def get(name) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"Op type {name!r} is not registered "
                       f"({len(_REGISTRY)} ops known)") from None


def exists(name) -> bool:
    return name in _REGISTRY
