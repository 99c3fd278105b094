"""Graph functions: ``@Defun`` and ``recompute_grad``.

Port of ``simple_tensorflow_tpu/framework/function.py``. A defined
function is a ``FuncGraph`` traced per input signature (``_trace_body``),
and each call site is one op whose inputs are the call's arguments and
then the body's captures (``_emit_call``):

- ``GraphFunctionCall`` (``Defun``): the lowering runs the body inline
  (``lowering.lower_func_graph``); autograd records through it as through
  any other op.
- ``RecomputeGradCall`` (``recompute_grad``): the JAX lowering runs the
  body under ``jax.checkpoint``; here :class:`_Recompute` is an
  ``autograd.Function`` whose forward runs the body with autograd off and
  saves only the call's inputs and captures, and whose backward runs the
  body again under autograd and takes the vector-Jacobian product through
  it. The random ops of the body read the same keys and dropout seeds in
  both runs: on the host ``LoweringContext.rng_for`` derives one key per
  op and run, and in a captured step the Session gives every body op
  that draws its own row of the key and seed buffers
  (``client/session.py``), which a replay refills before it starts. (JAX
  derives the keys before the checkpoint's trace, ``_prefetch_rng_keys``
  :148-160.) A ``Dropout`` of the body keeps the mask bits of the second
  run for its backward, and they are the first run's.

The trace caches live on the graph the function is called in, keyed on
the function object (``function.py:95-109``, ``:198-214``). Body ops are
named within the body (``layer_0/attention/dropout``, not
``bert/encoder/layer_0/...``), as JAX names them; an unseeded random op's
stream comes from its name, so a body's masks differ from those of the
same code built inline, in both packages. Left out: the plan-time
optimizer's function-op registration, ``grad_func`` and
``python_grad_func`` (kept, unused, as in JAX), and sharding rules.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Sequence

import torch

from . import dtypes as dtypes_mod
from . import graph as ops_mod
from . import lowering as lowering_mod
from . import op_registry
from ..ops import fused_ops

CALL_OPS = ("GraphFunctionCall", "RecomputeGradCall")
# the loop ops of ``ops/functional_ops.py``: their body is the ``body``
# attr, run once per element
LOOP_OPS = ("Scan", "MapFn", "Foldl")
# the control flow ops of ``ops/control_flow_ops.py`` and the attrs of
# their graphs: a Cond's two branches, a While's cond and body
CONTROL_OPS = {"Cond": ("true_graph", "false_graph"),
               "While": ("cond_graph", "body_graph")}
BODY_OPS = CALL_OPS + LOOP_OPS + tuple(CONTROL_OPS)


def _lower_function_call(ctx, op, inputs):
    n = op.attrs["n_args"]
    return lowering_mod.lower_func_graph(ctx, op.attrs["func_graph"],
                                         inputs[:n], inputs[n:])


op_registry.register("GraphFunctionCall", lower=_lower_function_call)


def _trace_body(g, func, name, arg_specs):
    """Trace ``func`` into a FuncGraph of ``g`` for the given input specs
    (shared by @Defun and recompute_grad)."""
    fg = ops_mod.FuncGraph(name, outer_graph=g)
    with ops_mod._as_current(fg):
        args = [fg.add_input(dtype, shape, f"arg{i}")
                for i, (shape, dtype) in enumerate(arg_specs)]
        res = func(*args)
        if res is None:
            raise ValueError(f"graph function {name} returned None")
        flat = list(res) if isinstance(res, (list, tuple)) else [res]
        fg.outputs = [ops_mod.convert_to_tensor(t) for t in flat]
    return fg


def _emit_call(g, op_type, fg, tensors, name):
    """Create the call node for a traced FuncGraph (captures appended)."""
    captures = [outer for outer, _ in fg.captures]
    op = g.create_op(
        op_type, list(tensors) + captures,
        attrs={"func_graph": fg, "n_args": len(tensors),
               "func_name": fg.func_name},
        name=name or fg.func_name,
        output_specs=[(t.shape, t.dtype) for t in fg.outputs])
    outs = list(op.outputs)
    return outs[0] if len(outs) == 1 else outs


class _DefinedFunction:
    """A callable graph function (ref function.py:255
    ``_DefinedFunction``): the body re-traces per (shape, dtype)
    signature; each call site becomes one ``GraphFunctionCall`` op."""

    def __init__(self, func, input_types: Sequence[Any], func_name=None,
                 grad_func=None, python_grad_func=None, out_names=None):
        self._func = func
        self._input_types = [dtypes_mod.as_dtype(t) for t in input_types]
        self._name = func_name or getattr(func, "__name__", "function")
        self._grad_func = grad_func
        self._python_grad_func = python_grad_func
        self._out_names = out_names

    @property
    def name(self):
        return self._name

    @property
    def declared_input_types(self):
        return list(self._input_types)

    def _trace(self, arg_specs) -> ops_mod.FuncGraph:
        # the cache lives on the graph current at trace time (a traced body
        # captures that graph's tensors), weakly keyed on this function
        g = ops_mod.get_default_graph()
        by_defun = g._scoped_state.setdefault(
            "__defun_cache__", weakref.WeakKeyDictionary())
        per_graph = by_defun.setdefault(self, {})
        key = tuple(arg_specs)
        if key not in per_graph:
            per_graph[key] = _trace_body(g, self._func, self._name,
                                         arg_specs)
        return per_graph[key]

    def __call__(self, *args, name=None):
        if len(args) != len(self._input_types):
            raise ValueError(
                f"{self._name} takes {len(self._input_types)} arguments, "
                f"got {len(args)}")
        g = ops_mod.get_default_graph()
        tensors = [ops_mod.convert_to_tensor(a, dtype=t)
                   for a, t in zip(args, self._input_types)]
        fg = self._trace([(t.shape, t.dtype) for t in tensors])
        return _emit_call(g, "GraphFunctionCall", fg, tensors, name)


class Defun:
    """Decorator: ``@Defun(stf.float32, stf.float32)`` (ref
    function.py:41)."""

    def __init__(self, *input_types, **kwargs):
        self._input_types = input_types
        self._kwargs = kwargs

    def __call__(self, func):
        return _DefinedFunction(
            func, self._input_types,
            func_name=self._kwargs.get("func_name"),
            grad_func=self._kwargs.get("grad_func"),
            python_grad_func=self._kwargs.get("python_grad_func"),
            out_names=self._kwargs.get("out_names"))


class _Recompute(torch.autograd.Function):
    """``body(*inputs)`` that saves only ``inputs`` for the backward and
    runs the body again there. ``plain``: whether the fused ops ran their
    plain versions in the forward (a thread-local mode, and the backward
    may run on autograd's device thread)."""

    @staticmethod
    def forward(fctx, body, plain, *inputs):
        fctx.body = body
        fctx.plain = plain
        fctx.save_for_backward(*inputs)
        outs = body(*inputs)
        fctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(fctx, *grads):
        saved = fctx.saved_tensors
        needs = fctx.needs_input_grad[2:]
        inputs = [x.detach().requires_grad_(r) for x, r in zip(saved, needs)]
        mode = fused_ops.plain_versions() if fctx.plain \
            else contextlib.nullcontext()
        with torch.enable_grad(), mode:
            outs = fctx.body(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, r in zip(inputs, needs) if r]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return (None, None) + tuple(next(got) if r else None for r in needs)


_state = threading.local()


@contextlib.contextmanager
def without_rematerialization():
    """Within the block, on this thread, a ``RecomputeGradCall`` runs its
    body as a ``GraphFunctionCall`` does: autograd keeps the body's
    intermediates and the backward re-runs nothing. The same graph, so the
    same op names and masks: the reference a recompute is held against."""
    prev = rematerializing()
    _state.off = True
    try:
        yield
    finally:
        _state.off = not prev


def rematerializing() -> bool:
    """Whether a ``RecomputeGradCall`` rematerializes (it does, outside
    :func:`without_rematerialization`)."""
    return not getattr(_state, "off", False)


def _lower_recompute_call(ctx, op, inputs):
    """The body, rematerialized in the backward (:class:`_Recompute`);
    without autograd recording (no gradient in the plan), or under
    :func:`without_rematerialization`, it just runs."""
    fg = op.attrs["func_graph"]
    n = op.attrs["n_args"]
    # weakly: the autograd node keeps ``body`` and the run's values keep
    # the node, so a strong reference to the run's context would make a
    # cycle that holds the whole step's graph until the collector runs
    # (the backward runs inside the run, while the context lives)
    run = weakref.ref(ctx)

    def body(*vals):
        return lowering_mod.lower_func_graph(run(), fg, vals[:n], vals[n:])

    if not (rematerializing() and torch.is_grad_enabled()
            and any(isinstance(v, torch.Tensor) and v.requires_grad
                    for v in inputs)):
        return body(*inputs)
    return list(_Recompute.apply(body, fused_ops.using_plain_versions(),
                                 *inputs))


op_registry.register("RecomputeGradCall", lower=_lower_recompute_call)


def recompute_grad(func, name=None):
    """Wrap ``func`` so that the gradient rematerializes its intermediates
    instead of saving them. Usage::

        block = stf.recompute_grad(lambda x: expensive_block(x))
        y = block(x)

    The body is traced per input signature (like @Defun); variables it
    reads are captured and re-read on the recompute."""

    def wrapper(*args, **kwargs):
        if kwargs:
            raise TypeError("recompute_grad functions take positional "
                            "tensor arguments only")
        g = ops_mod.get_default_graph()
        tensors = [ops_mod.convert_to_tensor(a) for a in args]
        specs = tuple((t.shape, t.dtype) for t in tensors)
        cache = g._scoped_state.setdefault("__recompute_cache__", {})
        # keyed on the function OBJECT (the dict holds it): a discarded
        # lambda's recycled id can never alias another body
        key = (func, specs)
        fg = cache.get(key)
        if fg is None:
            fg = cache[key] = _trace_body(
                g, func, name or getattr(func, "__name__", "recompute"),
                specs)
        return _emit_call(g, "RecomputeGradCall", fg, tensors,
                          name or "recompute_grad")

    return wrapper


def body_graphs(op):
    """The FuncGraph bodies of a call, loop or control flow op, or [] for
    another op."""
    if op.type in CALL_OPS:
        names = ("func_graph",)
    elif op.type in LOOP_OPS:
        names = ("body",)
    else:
        names = CONTROL_OPS.get(op.type, ())
    return [op.attrs[n] for n in names if op.attrs.get(n) is not None]


def body_ops(op):
    """The ops of a call, loop or control flow op's bodies (every op of
    each FuncGraph, nested bodies included), or [] for another op."""
    out = []
    for fg in body_graphs(op):
        for inner in fg.get_operations():
            out.append(inner)
            out.extend(body_ops(inner))
    return out
