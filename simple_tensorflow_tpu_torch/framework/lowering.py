"""Graph execution of the port: prune the graph to the fetches and run the
op list on the Session's device.

Port of ``simple_tensorflow_tpu/framework/lowering.py``: ``prune`` (:65,
the Python DFS; its postorder is the JAX package's, so ops run in the same
order and a variable read that no edge orders against a write sees the
same value), ``ancestors_between`` (the gradient builder's path), the
``LoweringContext`` (:186) with the variable state, the value environment,
``read_var``/``write_var`` and ``rng_for`` (:283, one key per op and step)
and ``execute_ops`` (:326). Where the JAX package traces the op list into
one XLA program, the port dispatches each op's lowering eagerly: the torch
ops go to the device as they are issued. Left out: the native C++ pruner,
``FuncGraph`` bodies and the plan-time CSE alias map.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from . import constant_op
from . import graph as ops_mod
from . import prng
from . import random_seed
from .errors import FailedPreconditionError, InvalidArgumentError

Operation = ops_mod.Operation
Tensor = ops_mod.Tensor


def prune(target_ops: Sequence[Operation],
          fed_tensors: Set[Tensor]) -> List[Operation]:
    """The ops needed to compute ``target_ops`` when ``fed_tensors`` are
    given, in the JAX package's deterministic topological order (an
    iterative DFS postorder over data and control edges)."""
    order: List[Operation] = []
    state: Dict[Operation, int] = {}  # 0 = visiting, 1 = done

    def deps(op: Operation):
        for t in op.inputs:
            if t not in fed_tensors:
                yield t.op
        yield from op.control_inputs

    for root in target_ops:
        if state.get(root) == 1:
            continue
        stack: List[Tuple[Operation, Any]] = [(root, None)]
        while stack:
            op, it = stack[-1]
            if it is None:
                if state.get(op) is not None:
                    stack.pop()
                    continue
                state[op] = 0
                it = iter(list(deps(op)))
                stack[-1] = (op, it)
            advanced = False
            for d in it:
                if state.get(d) is None:
                    stack.append((d, None))
                    advanced = True
                    break
                if state.get(d) == 0 and d is not op:
                    cycle = " -> ".join(o.name for o, _ in stack[-5:])
                    raise InvalidArgumentError(
                        None, op, f"Graph cycle detected near: {cycle}")
            if not advanced:
                state[op] = 1
                order.append(op)
                stack.pop()
    return order


def ancestors_between(xs: Sequence[Tensor], ys: Sequence[Tensor]
                      ) -> Tuple[List[Operation], Set[Tensor]]:
    """Ops on a data path from any x to any y, in topological order, and
    the subset of ``xs`` connected to ``ys``."""
    desc: Set[Operation] = set()
    work: List[Operation] = []
    for t in xs:
        work.extend(t.consumers())
    while work:
        op = work.pop()
        if op in desc:
            continue
        desc.add(op)
        for out in op.outputs:
            work.extend(out.consumers())
    anc_order = prune([y.op for y in ys], fed_tensors=set(xs))
    path = [op for op in anc_order if op in desc]
    path_set = set(path)
    connected = {x for x in xs
                 if any(y is x for y in ys)
                 or any(c in path_set for c in x.consumers())}
    return path, connected


class LoweringContext:
    """The state of one run while its ops execute.

    ``state``: variable name -> device tensor (the Session's store,
    written through). ``env``: Tensor -> value. ``feeds``: the fed tensors'
    numpy values, staged to the device on first use. ``rng_root``: the
    run's threefry key (None when no op of the plan draws). ``grad_leaves``:
    tensors whose values become ``requires_grad`` leaves as they are made,
    so a ``SymbolicGradient`` can take ``torch.autograd.grad`` of its ys
    against them. ``preserve``: per in-place op, the values made before it
    that the run reads after it (copied if they alias what it updates)."""

    def __init__(self, state: Dict[str, Any], device, rng_root=None,
                 feeds=None, session=None, grad_leaves=(),
                 retain_graph=False, preserve=None):
        self.state = state
        self.device = device
        self.rng_root = rng_root
        self.feeds: Dict[Tensor, np.ndarray] = dict(feeds or {})
        self.env: Dict[Tensor, Any] = {}
        self.session = session
        self.grad_leaves = frozenset(grad_leaves)
        self.retain_graph = retain_graph
        self.preserve = preserve or {}
        self._rng_cache: Dict[int, np.ndarray] = {}
        self._const_cache = (session._const_cache if session is not None
                             else {})

    # -- state ---------------------------------------------------------------
    def read_var(self, name: str, op=None):
        if name not in self.state:
            raise FailedPreconditionError(
                None, op,
                f"Attempting to use uninitialized variable {name!r}. "
                "Run stf.global_variables_initializer() first.")
        return self.state[name]

    def write_var(self, name: str, value):
        self.state[name] = value.detach()

    def var_exists(self, name: str) -> bool:
        return name in self.state

    # -- rng -----------------------------------------------------------------
    def rng_for(self, op: Operation) -> np.ndarray:
        """The op's threefry key this run: ``fold_in(root,
        fold_in_value(op))``, the same for every use within the run."""
        fold = random_seed.fold_in_value(op)
        if fold not in self._rng_cache:
            if self.rng_root is None:
                raise RuntimeError(
                    f"{op.name} draws random numbers in a plan that "
                    "declared no RNG effect")
            self._rng_cache[fold] = prng.fold_in(self.rng_root, fold)
        return self._rng_cache[fold]

    # -- values --------------------------------------------------------------
    def constant(self, op: Operation) -> torch.Tensor:
        """A Const op's value on the device, copied there once per
        session."""
        t = self._const_cache.get(op)
        if t is None:
            t = constant_op.to_torch(op.attrs["value"], self.device,
                                     op.attrs["dtype"].torch_dtype)
            self._const_cache[op] = t
        return t

    def value_of(self, tensor: Tensor):
        if tensor in self.env:
            return self.env[tensor]
        if tensor in self.feeds:
            v = self.feeds[tensor]
            dt = tensor.dtype.base_dtype.torch_dtype
            if isinstance(v, torch.Tensor):
                v = v.to(device=self.device, dtype=dt)
            else:
                v = constant_op.to_torch(v, self.device, dt)
            v = self._maybe_leaf(tensor, v)
            self.env[tensor] = v
            return v
        raise RuntimeError(f"Tensor {tensor.name} has no value in the run "
                           "— pruning/ordering bug.")

    def host_value(self, tensor: Tensor) -> float:
        """A scalar's value on the host without a device sync where it is
        known there: a feed, a constant, a ``PlaceholderWithDefault`` or
        ``Identity``/``Cast`` of one. Else ``.item()`` (a device sync)."""
        t = tensor
        while True:
            if t in self.feeds:
                v = self.feeds[t]
                return float(v.item() if isinstance(v, torch.Tensor)
                             else np.asarray(v).reshape(()))
            if t.op.type == "Const":
                return float(np.asarray(t.op.attrs["value"]).reshape(()))
            if t.op.type in ("PlaceholderWithDefault", "Identity", "Cast"):
                t = t.op.inputs[0]
                continue
            return float(self.value_of(tensor).item())

    def _maybe_leaf(self, tensor, value):
        if tensor in self.grad_leaves:
            return value.detach().requires_grad_(True)
        return value


def _storages(ctx, op) -> Set[int]:
    """Storage addresses of the variables an in-place op writes."""
    names = op.attrs.get("var_name", ())
    if isinstance(names, str):
        names = (names,)
    return {ctx.state[n].untyped_storage().data_ptr()
            for n in names if n in ctx.state}


def execute_ops(ctx: LoweringContext, op_list: Sequence[Operation]):
    """Run ``op_list`` in order, filling ``ctx.env``."""
    env = ctx.env
    for op in op_list:
        opdef = op.op_def
        if op.outputs and not opdef.is_stateful and \
                all(o in env for o in op.outputs):
            continue
        if opdef.in_place and op in ctx.preserve:
            written = _storages(ctx, op)
            for t in ctx.preserve[op]:
                v = env.get(t)
                if isinstance(v, torch.Tensor) and \
                        v.untyped_storage().data_ptr() in written:
                    env[t] = v.detach().clone()
        inputs = [env[t] if t in env else ctx.value_of(t)
                  for t in op.inputs]
        outputs = opdef.lower(ctx, op, inputs)
        if len(outputs) != len(op.outputs):
            raise RuntimeError(
                f"Op {op.name} ({op.type}) lowered to {len(outputs)} "
                f"outputs, graph says {len(op.outputs)}")
        for t, v in zip(op.outputs, outputs):
            env[t] = ctx._maybe_leaf(t, v) if ctx.grad_leaves else v
