"""Loops of a static trip count: ``scan``, ``map_fn``, ``foldl`` and
``foldr``.

Port of ``simple_tensorflow_tpu/ops/functional_ops.py:55-269``. Each
builds one op (``Scan``, ``MapFn``, ``Foldl``) over a ``FuncGraph`` body
traced once (``_build_fn_graph``), with JAX's inputs (carries, then the
elems, then the body's captures), attrs (``body``, ``n_carry``,
``n_elems``), names and output specs. Where the JAX lowering is one
``lax.scan``, the port's is a host loop over the static trip count that
runs the body once a step (``lowering.lower_func_graph``) and
``torch.stack``s the outputs: a captured Session step unrolls every
iteration into its CUDA graph, and ``torch.autograd`` differentiates
through the unrolled loop, to the captured variables too (integer carries
carry no gradient).

As in JAX (``_lower_scan`` returns the body's outputs as both the carry
and the step output), every carry of a ``Scan`` is emitted at every step:
its outputs are ``[T, ...]`` stacks of each carry. A random op of the
body draws from the key of its fold value (``LoweringContext.rng_for``,
cached by fold), so a body ``Dropout`` applies the same mask at every
step, as a ``lax.scan`` body keyed once per run does; in a captured step
it reads one row of the key buffer at every step. A body that assigns a
variable raises ``InvalidArgumentError``. Left out: the plan-time
optimizer's loop-body registration, the sharding rules and ``py_func``,
which raises ``NotImplementedError``.
"""

from __future__ import annotations

import builtins

import torch

from ..framework import graph as ops_mod
from ..framework import lowering as lowering_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from .control_flow_ops import _flatten, _pack_like

Tensor = ops_mod.Tensor
FuncGraph = ops_mod.FuncGraph


def _build_fn_graph(fn, arg_specs, name):
    """Trace ``fn`` into a FuncGraph with inputs given by (shape, dtype)."""
    g = ops_mod.get_default_graph()
    fg = FuncGraph(name, outer_graph=g)
    with ops_mod._as_current(fg):
        args = [fg.add_input(dt, sh, f"arg{i}")
                for i, (sh, dt) in enumerate(arg_specs)]
        res = fn(*args) if len(args) > 1 else fn(args[0])
        flat = [ops_mod.convert_to_tensor(t) for t in _flatten(res)]
        fg.outputs = flat
    return fg, res


def _elem_spec(t: Tensor):
    if t.shape.rank is None:
        raise ValueError(f"map/scan input {t.name} needs known rank")
    return (shape_mod.TensorShape(t.shape.as_list()[1:]), t.dtype)


def _loop(ctx, op, inputs, n_carry):
    """Run ``op``'s body over its elems: ``[(outputs of step t)]``."""
    ne = op.attrs["n_elems"]
    fg = op.attrs["body"]
    carry = builtins.list(inputs[:n_carry])
    # unbind, not x[t]: its backward is one stack, where T selects would
    # each scatter into a zero tensor of x's size
    xs = [x.unbind(0) for x in inputs[n_carry:n_carry + ne]]
    caps = inputs[n_carry + ne:]
    steps = []
    for t in builtins.range(len(xs[0])):
        outs = lowering_mod.lower_func_graph(
            ctx, fg, carry + [x[t] for x in xs], caps)
        steps.append(outs)
        if n_carry:
            carry = outs
    return steps


def _stack(steps):
    return [torch.stack(col) for col in zip(*steps)]


def map_fn(fn, elems, dtype=None, parallel_iterations=None, back_prop=True,
           swap_memory=False, infer_shape=True, name=None):
    """(ref: functional_ops.py ``map_fn``): ``fn`` of each element along
    the leading axis, stacked."""
    single = not isinstance(elems, (list, builtins.tuple))
    elems_flat = [ops_mod.convert_to_tensor(e) for e in _flatten(elems)]
    g = ops_mod.get_default_graph()
    with g.name_scope(name or "map"):
        def wrapper(*args):
            packed = args[0] if single else _pack_like(elems,
                                                       builtins.list(args))
            return fn(packed)

        fg, res_struct = _build_fn_graph(
            wrapper, [_elem_spec(e) for e in elems_flat], "map_body")
        caps = [outer for outer, _ in fg.captures]
        n = elems_flat[0].shape[0].value
        if n is None:
            raise ValueError("map_fn needs a static leading dim")
        out_specs = [(shape_mod.TensorShape([n] + o.shape.as_list()),
                      o.dtype) for o in fg.outputs]
        op = g.create_op("MapFn", elems_flat + caps,
                         attrs={"body": fg, "n_elems": len(elems_flat)},
                         name="map_op", output_specs=out_specs)
    outs = builtins.list(op.outputs)
    if len(outs) == 1 and not isinstance(res_struct,
                                         (list, builtins.tuple, dict)):
        return outs[0]
    return _pack_like(res_struct, outs)


op_registry.register(
    "MapFn", lower=lambda ctx, op, inputs: _stack(_loop(ctx, op, inputs, 0)))


def scan(fn, elems, initializer=None, parallel_iterations=10, back_prop=True,
         swap_memory=False, infer_shape=True, name=None):
    """(ref: functional_ops.py ``scan``): ``fn(carry, x)`` over the
    leading axis of ``elems``; returns every step's carry, stacked."""
    single = not isinstance(elems, (list, builtins.tuple))
    elems_flat = [ops_mod.convert_to_tensor(e) for e in _flatten(elems)]
    n = elems_flat[0].shape[0].value
    if n is None:
        raise ValueError("scan needs a static leading dim")
    g = ops_mod.get_default_graph()
    with g.name_scope(name or "scan"):
        if initializer is None:
            # the first element is the initial accumulator (the reference's
            # semantics)
            from . import array_ops

            init_struct = _pack_like(
                elems, [e[0] for e in elems_flat]) if not single \
                else elems_flat[0][0]
            rest = [e[1:] for e in elems_flat]
            out = scan(fn, _pack_like(elems, rest) if not single else rest[0],
                       initializer=init_struct, name="scan_rest")
            flat_out = _flatten(out)
            full = [array_ops.concat(
                [array_ops.expand_dims(i, 0), o], axis=0)
                for i, o in zip(_flatten(init_struct), flat_out)]
            return _pack_like(out, full) \
                if isinstance(out, (list, builtins.tuple)) else full[0]
        init_flat = [ops_mod.convert_to_tensor(i)
                     for i in _flatten(initializer)]
        n_carry = len(init_flat)

        def wrapper(*args):
            carry = _pack_like(initializer, builtins.list(args[:n_carry]))
            x = args[n_carry] if single else _pack_like(
                elems, builtins.list(args[n_carry:]))
            return fn(carry, x)

        specs = [(i.shape, i.dtype) for i in init_flat] + \
                [_elem_spec(e) for e in elems_flat]
        fg, _ = _build_fn_graph(wrapper, specs, "scan_body")
        if len(fg.outputs) != n_carry:
            raise ValueError("scan fn must return a structure like "
                             "initializer")
        caps = [outer for outer, _ in fg.captures]
        out_specs = [(shape_mod.TensorShape([n] + o.shape.as_list()),
                      o.dtype) for o in fg.outputs]
        op = g.create_op("Scan", init_flat + elems_flat + caps,
                         attrs={"body": fg, "n_carry": n_carry,
                                "n_elems": len(elems_flat)},
                         name="scan_op", output_specs=out_specs)
    outs = builtins.list(op.outputs)
    return _pack_like(initializer, outs) if len(outs) > 1 else outs[0]


op_registry.register("Scan", lower=lambda ctx, op, inputs: _stack(
    _loop(ctx, op, inputs, op.attrs["n_carry"])))


def foldl(fn, elems, initializer=None, parallel_iterations=10, back_prop=True,
          swap_memory=False, name=None):
    """(ref: functional_ops.py ``foldl``): the last carry of
    ``fn(carry, x)`` over the leading axis of ``elems``."""
    single = not isinstance(elems, (list, builtins.tuple))
    elems_flat = [ops_mod.convert_to_tensor(e) for e in _flatten(elems)]
    if initializer is None:
        init = elems_flat[0][0] if single else _pack_like(
            elems, [e[0] for e in elems_flat])
        rest = [e[1:] for e in elems_flat]
        return foldl(fn, _pack_like(elems, rest) if not single else rest[0],
                     initializer=init, name=name)
    init_flat = [ops_mod.convert_to_tensor(i) for i in _flatten(initializer)]
    n_carry = len(init_flat)
    g = ops_mod.get_default_graph()
    with g.name_scope(name or "foldl"):
        def wrapper(*args):
            carry = _pack_like(initializer, builtins.list(args[:n_carry]))
            x = args[n_carry] if single else _pack_like(
                elems, builtins.list(args[n_carry:]))
            return fn(carry, x)

        specs = [(i.shape, i.dtype) for i in init_flat] + \
                [_elem_spec(e) for e in elems_flat]
        fg, _ = _build_fn_graph(wrapper, specs, "foldl_body")
        caps = [outer for outer, _ in fg.captures]
        out_specs = [(o.shape, o.dtype) for o in fg.outputs]
        op = g.create_op("Foldl", init_flat + elems_flat + caps,
                         attrs={"body": fg, "n_carry": n_carry,
                                "n_elems": len(elems_flat)},
                         name="foldl_op", output_specs=out_specs)
    outs = builtins.list(op.outputs)
    return _pack_like(initializer, outs) if len(outs) > 1 else outs[0]


op_registry.register("Foldl", lower=lambda ctx, op, inputs: _loop(
    ctx, op, inputs, op.attrs["n_carry"])[-1])


def foldr(fn, elems, initializer=None, parallel_iterations=10, back_prop=True,
          swap_memory=False, name=None):
    """(ref: functional_ops.py ``foldr``): ``foldl`` over the elems
    reversed along the leading axis."""
    from . import array_ops

    single = not isinstance(elems, (list, builtins.tuple))
    rev = [array_ops.reverse(ops_mod.convert_to_tensor(e), [0])
           for e in _flatten(elems)]
    return foldl(fn, _pack_like(elems, rev) if not single else rev[0],
                 initializer=initializer, name=name or "foldr")


def py_func(func, inp, Tout, stateful=True, name=None):
    """Not ported: a host function called in the middle of the device
    step, which one CUDA graph replay cannot hold."""
    raise NotImplementedError(
        "py_func is not ported: a host callback in the middle of the "
        "device step is ROADMAP Queue 1, front-end item 2")
