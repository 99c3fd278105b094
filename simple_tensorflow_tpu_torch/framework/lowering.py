"""Graph execution of the port: prune the graph to the fetches and run the
op list on the Session's device.

Port of ``simple_tensorflow_tpu/framework/lowering.py``: ``prune`` (:65,
the Python DFS; its postorder is the JAX package's, so ops run in the same
order and a variable read that no edge orders against a write sees the
same value), ``ancestors_between`` (the gradient builder's path), the
``LoweringContext`` (:186) with the variable state, the value environment,
``read_var``/``write_var`` (staged, committed when the run ends, as the
JAX program returns its new state), ``rng_for`` (:283, one key per op and
step) and the dropout seed drawn from it (``seed_for``), ``host_value`` (:184) and ``execute_ops`` (:326). Where the JAX
package traces the op list into one XLA program, the port dispatches each
op's lowering eagerly; the Session captures a repeated run's dispatch into
a CUDA graph (``compiler/aot.py``), for which the context has a compiled
mode (no host reads of the device, keys from a device buffer).
``lower_func_graph`` (:368) runs a ``FuncGraph`` body (a graph function
call, ``framework/function.py``, or one iteration of a loop op,
``ops/functional_ops.py``) in a child context: its args and captures
bound, pruned to its outputs; a body that assigns a variable raises, as
the JAX context's ``in_control_flow`` does (:268-276). ``ZerosLike`` and
``OnesLike`` of a fully static shape are :func:`shape_only`: the pruner
does not follow their input, as XLA drops a value that only gives a
shape (``dynamic_rnn``'s probe cell step, ``rnn.py:45-46``). Left out:
the native C++ pruner and the plan-time optimizer's body plans and CSE
alias map.
"""

from __future__ import annotations

import time
import weakref
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


_SHAPE_ONLY = ("ZerosLike", "OnesLike")


def shape_only(op: Operation) -> bool:
    """Whether ``op`` needs no input value: a ``ZerosLike``/``OnesLike``
    whose output shape is fully static."""
    return op.type in _SHAPE_ONLY and \
        op.outputs[0].shape.is_fully_defined()


def prune(target_ops: Sequence[Operation],
          fed_tensors: Set[Tensor],
          follow_shape_only: bool = False) -> List[Operation]:
    """The ops needed to compute ``target_ops`` when ``fed_tensors`` are
    given, in the JAX package's deterministic topological order (an
    iterative DFS postorder over data and control edges).
    ``follow_shape_only``: follow the inputs of :func:`shape_only` ops
    too, as the JAX pruner does (the cost model prices that op list)."""
    order: List[Operation] = []
    state: Dict[Operation, int] = {}  # 0 = visiting, 1 = done

    def deps(op: Operation):
        if follow_shape_only or not shape_only(op):
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


def ancestors_between(xs: Sequence[Tensor], ys: Sequence[Tensor],
                      follow_shape_only: bool = False
                      ) -> Tuple[List[Operation], Set[Tensor]]:
    """Ops on a data path from any x to any y, in topological order, and
    the subset of ``xs`` connected to ``ys`` (``follow_shape_only`` as in
    :func:`prune`)."""
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
    anc_order = prune([y.op for y in ys], fed_tensors=set(xs),
                      follow_shape_only=follow_shape_only)
    path = [op for op in anc_order if op in desc]
    path_set = set(path)
    connected = {x for x in xs
                 if any(y is x for y in ys)
                 or any(c in path_set for c in x.consumers())}
    return path, connected


class LoweringContext:
    """The state of one run while its ops execute.

    ``store``: the Session's ``VariableStore``; ``state`` its name ->
    tensor dict. Writes are staged (``staged``): a read later in the run
    sees the staged value, and :meth:`commit` writes them into the store
    when the run has executed every op, so a run that raises midway
    leaves the store as it was. The one write made mid-run is an
    in-place kernel update (the fused Adam update, the last op of every
    optimizer plan). ``env``: Tensor -> value. ``feeds``: the fed
    tensors' values, staged to the device on first use (a compiled run
    puts its static feed buffers in ``env`` instead). ``rng_root``: the
    run's threefry key (None when no op of the plan draws).
    ``grad_leaves``: tensors whose values become ``requires_grad`` leaves
    as they are made, so a ``SymbolicGradient`` can take
    ``torch.autograd.grad`` of its ys against them. ``preserve``: per
    in-place op, the values made before it that the run reads after it
    (copied if they alias what it updates).

    A compiled run (``compiled``: captured into a CUDA graph, or its CPU
    replay) may not read the device from the host: :meth:`host_value`
    takes only values known on the host, a random op draws its key from
    row ``rng_slots[op]`` of the device ``key_buffer`` (:meth:`rng_key`)
    or its dropout seed from the same row of ``seed_buffer``
    (:meth:`seed_for`), and the commit copies into the store's tensors in place. A ``dry``
    run (the warm-up of ``ExecutionPlan.compile``) commits nothing and
    runs in-place updates on copies."""

    def __init__(self, store, device, rng_root=None, feeds=None,
                 session=None, grad_leaves=(), retain_graph=False,
                 preserve=None):
        self.store = store
        self.state = store.values
        self.staged: Dict[str, torch.Tensor] = {}
        self.device = device
        self.rng_root = rng_root
        self.feeds: Dict[Tensor, Any] = dict(feeds or {})
        self.env: Dict[Tensor, Any] = {}
        self.session = session
        self.grad_leaves = frozenset(grad_leaves)
        self.retain_graph = retain_graph
        self.preserve = preserve or {}
        self.compiled = False
        self.dry = False
        self.key_buffer = None
        self.seed_buffer = None
        self.seeds_read = False
        self.rng_slots: Dict[Operation, int] = {}
        self.host_reads: List[Tensor] = []
        self.timings = None  # {category: host seconds} when measured
        self._rng_cache: Dict[int, np.ndarray] = {}
        self._const_cache = (session._const_cache if session is not None
                             else {})

    # -- state ---------------------------------------------------------------
    def read_var(self, name: str, op=None):
        v = self.staged.get(name)
        if v is not None:
            return v
        if name not in self.state:
            raise FailedPreconditionError(
                None, op, uninitialized_message(name))
        return self.state[name]

    def write_var(self, name: str, value):
        self.staged[name] = value.detach()

    def var_exists(self, name: str) -> bool:
        return name in self.staged or name in self.state

    def commit_targets(self) -> Set[int]:
        """Storage addresses the commit will copy into."""
        return {self.state[n].untyped_storage().data_ptr()
                for n in self.staged if n in self.state}

    def commit(self, names=None):
        """Write the staged values (those of ``names``, or all) into the
        store: by ``copy_`` into the store's tensor where its shape and
        dtype stay (the address stays), else as a new entry (the store's
        version moves on), which a compiled run refuses."""
        for name in list(self.staged if names is None else names):
            v = self.staged.pop(name, None)
            if v is None or self.dry:
                continue
            cur = self.state.get(name)
            if cur is not None and cur.shape == v.shape and \
                    cur.dtype == v.dtype:
                cur.copy_(v)
            elif self.compiled:
                raise InvalidArgumentError(
                    None, None,
                    f"variable {name!r} changes shape, dtype or is created "
                    "inside a compiled step; its store tensor must keep "
                    "its address across replays")
            else:
                self.store.set(name, v)

    # -- rng -----------------------------------------------------------------
    def rng_for(self, op: Operation) -> np.ndarray:
        """The op's threefry key this run on the host: ``fold_in(root,
        fold_in_value(op))``, the same for every use within the run. A
        compiled run has no host key (it would be baked into the graph):
        use :meth:`rng_key`."""
        if self.compiled:
            raise InvalidArgumentError(
                None, op, f"{op.name} ({op.type}) draws with a host key, "
                "which a compiled step would replay unchanged")
        fold = random_seed.fold_in_value(op)
        if fold not in self._rng_cache:
            if self.rng_root is None:
                raise RuntimeError(
                    f"{op.name} draws random numbers in a plan that "
                    "declared no RNG effect")
            self._rng_cache[fold] = prng.fold_in(self.rng_root, fold)
        return self._rng_cache[fold]

    def rng_key(self, op: Operation):
        """The op's key for a lowering that takes it on the device too: in
        a compiled run the ``(2,)`` int32 row of the device key buffer the
        Session refills before every replay (the uint32 words' bits),
        else the host key of :meth:`rng_for`."""
        if self.compiled:
            return self.key_buffer[self.rng_slots[op]]
        return self.rng_for(op)

    def seed_for(self, op: Operation):
        """The op's int32 dropout seed, as the JAX lowerings of
        ``FlashAttentionDropout`` and ``FusedDropoutBiasResidual`` draw it:
        ``randint(rng_for(op), (1,), 0, 2**31 - 1)``. In a compiled run the
        ``(1,)`` int32 row of the device ``seed_buffer`` the Session
        refills before every replay (the kernels' seed-pointer entries read
        it there), else the host int."""
        if self.compiled:
            self.seeds_read = True
            return self.seed_buffer[self.rng_slots[op]]
        return int(prng.randint(self.rng_for(op), (1,), 0,
                                prng.INT32_MAX)[0])

    def child(self, env) -> "LoweringContext":
        """A context for a graph function body: this run's state, keys,
        staged writes and host reads, over its own value environment
        ``env`` (the body's bound args and captures)."""
        return _BodyContext(self, env)

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

    def host_value(self, tensor: Tensor, op=None) -> float:
        """A scalar's value on the host, without a device sync where it is
        known there: a feed, a constant, a ``PlaceholderWithDefault`` or
        ``Identity``/``Cast`` of one (:func:`host_scalar`). Else
        ``.item()`` (a device sync), which a compiled run refuses. The
        tensor is recorded in ``host_reads``: its value keys the
        compiled executables of the plan."""
        self.host_reads.append(tensor)
        v = host_scalar(tensor, self.feeds)
        if v is not None:
            return v
        if self.compiled:
            raise InvalidArgumentError(
                None, op,
                f"{op.name if op is not None else tensor.name} reads "
                f"{tensor.name} on the host, which is not known there "
                "(a feed or a constant); a compiled step cannot sync")
        return float(self.value_of(tensor).item())

    def _maybe_leaf(self, tensor, value):
        if tensor in self.grad_leaves:
            return value.detach().requires_grad_(True)
        return value


def stage_constants(ctx: LoweringContext, ops: Sequence[Operation]) -> None:
    """Copy every ``Const`` of ``ops`` and of their bodies (nested
    included) to the device, into the Session's cache: a capture runs
    branches that the eager run before it did not take, and a constant
    first made inside a capture would be a copy from pageable host
    memory, which a capture refuses."""
    from . import function as function_mod

    for op in ops:
        if op.type == "Const":
            ctx.constant(op)
        for inner in function_mod.body_ops(op):
            if inner.type == "Const":
                ctx.constant(inner)


def uninitialized_message(name: str) -> str:
    return (f"Attempting to use uninitialized variable {name!r}. "
            "Run stf.global_variables_initializer() first.")


def host_scalar(tensor: Tensor, feeds) -> Any:
    """``tensor``'s value as a float when the host knows it without the
    device (a feed, a constant, or a ``PlaceholderWithDefault``,
    ``Identity`` or ``Cast`` of one), else None."""
    t = tensor
    while True:
        if t in feeds:
            v = feeds[t]
            if isinstance(v, torch.Tensor):
                if v.device.type != "cpu":
                    return None
                return float(v.item())
            return float(np.asarray(v).reshape(()))
        if t.op.type == "Const":
            return float(np.asarray(t.op.attrs["value"]).reshape(()))
        if t.op.type in ("PlaceholderWithDefault", "Identity", "Cast"):
            t = t.op.inputs[0]
            continue
        return None


def _storages(ctx, op) -> Set[int]:
    """Storage addresses of the variables an in-place op writes."""
    names = op.attrs.get("var_name", ())
    if isinstance(names, str):
        names = (names,)
    return {ctx.state[n].untyped_storage().data_ptr()
            for n in names if n in ctx.state}


def last_uses(op_list: Sequence[Operation], keep) -> Dict[Operation,
                                                          List[Tensor]]:
    """``{op: [tensor]}``: the values the run no longer needs once ``op``
    has run (their last consumer in ``op_list``, or their producer when
    nothing consumes them), the tensors of ``keep`` (the fetches) aside,
    so that :func:`execute_ops` can drop them, as XLA frees a buffer
    after its last use (what autograd saved for the backward stays alive
    through its graph). A call or loop op's captures are its inputs, so
    every iteration of a loop body reads them before they can go."""
    pos = {op: i for i, op in enumerate(op_list)}
    last: Dict[Tensor, int] = {}
    for i, op in enumerate(op_list):
        for t in op.outputs:
            last.setdefault(t, i)
        for t in op.inputs:
            if t.op in pos:
                last[t] = max(last.get(t, -1), i)
    keep = set(keep)
    out: Dict[Operation, List[Tensor]] = {}
    for t, i in last.items():
        if t not in keep:
            out.setdefault(op_list[i], []).append(t)
    return out


def execute_ops(ctx: LoweringContext, op_list: Sequence[Operation],
                frees=None):
    """Run ``op_list`` in order, filling ``ctx.env``; with ``frees``
    (:func:`last_uses`), dropping each value from it after its last use.
    With ``ctx.timings`` a dict, adds the host seconds spent staging
    inputs (``"feeds"``: the fed values' copies to the device), in
    ``SymbolicGradient`` (``"autograd"``) and in every other lowering
    (``"dispatch"``)."""
    env = ctx.env
    timings = ctx.timings
    for op in op_list:
        _run_op(ctx, op, env, timings)
        if frees:
            for t in frees.get(op, ()):
                env.pop(t, None)


class _BodyContext(LoweringContext):
    """A graph function body's context: its own ``env``, no grad leaves,
    and every other attribute its parent's, read and written through, so
    a flag a body op sets (``seeds_read``) is the run's."""

    _OWN = frozenset({"parent", "env", "grad_leaves"})

    def __init__(self, parent, env):
        object.__setattr__(self, "parent", parent)
        object.__setattr__(self, "env", env)
        object.__setattr__(self, "grad_leaves", frozenset())

    def __getattr__(self, name):
        return getattr(self.parent, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.parent, name, value)

    def write_var(self, name: str, value):
        raise InvalidArgumentError(
            None, None,
            f"Variable {name!r} is assigned inside a graph function or "
            "loop body, which cannot write state across steps; carry the "
            "value as a loop variable and assign it after the loop.")


def lower_func_graph(ctx: LoweringContext, fg, arg_values,
                     capture_values) -> list:
    """Run a FuncGraph body given values for its declared inputs and its
    captures, in a child context (its own environment; a second run of
    the body, as a recompute's, computes everything anew); returns the
    values of ``fg.outputs``. Only the ops the outputs need run."""
    if len(arg_values) != len(fg.inputs):
        raise RuntimeError(
            f"FuncGraph {fg.func_name}: {len(arg_values)} args for "
            f"{len(fg.inputs)} inputs")
    env: Dict[Tensor, Any] = {}
    for t, v in zip(fg.inputs, arg_values):
        env[t] = v
    for (_, inner), v in zip(fg.captures, capture_values):
        env[inner] = v
    child = ctx.child(env)
    execute_ops(child, func_graph_ops(fg))
    return [child.value_of(t) for t in fg.outputs]


_BODY_OPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def func_graph_ops(fg) -> List[Operation]:
    """The ops of a FuncGraph body that its outputs need, in execution
    order, its bound args and captures aside (pruned once per body)."""
    ops = _BODY_OPS.get(fg)
    if ops is None:
        bound = set(fg.inputs) | {inner for _, inner in fg.captures}
        ops = _BODY_OPS[fg] = [
            op for op in prune([t.op for t in fg.outputs], bound)
            if op.type not in ("FuncArg", "CapturedInput")]
    return ops


def _run_op(ctx: LoweringContext, op: Operation, env, timings):
    if timings is not None:
        t0 = time.perf_counter()
    opdef = op.op_def
    if op.outputs and not opdef.is_stateful and \
            all(o in env for o in op.outputs):
        return
    if opdef.in_place and op in ctx.preserve:
        written = _storages(ctx, op)
        for t in ctx.preserve[op]:
            v = env.get(t)
            if isinstance(v, torch.Tensor) and \
                    v.untyped_storage().data_ptr() in written:
                env[t] = v.detach().clone()
    inputs = [] if shape_only(op) else \
        [env[t] if t in env else ctx.value_of(t) for t in op.inputs]
    if timings is not None:
        t1 = time.perf_counter()
        timings["feeds"] = timings.get("feeds", 0.0) + t1 - t0
    outputs = opdef.lower(ctx, op, inputs)
    if timings is not None:
        cat = "autograd" if op.type == "SymbolicGradient" else "dispatch"
        timings[cat] = timings.get(cat, 0.0) + time.perf_counter() - t1
    if len(outputs) != len(op.outputs):
        raise RuntimeError(
            f"Op {op.name} ({op.type}) lowered to {len(outputs)} "
            f"outputs, graph says {len(op.outputs)}")
    for t, v in zip(op.outputs, outputs):
        env[t] = ctx._maybe_leaf(t, v) if ctx.grad_leaves else v
