"""Per-op effect resolution (port of ``simple_tensorflow_tpu/analysis/
effects.py``): an op's declared ``Effects`` (``framework/op_registry.py``)
resolved against its attrs, e.g. an ``Assign`` with ``var_name == "w"``
writes ``{"var_name=w"}``. A graph function call (``framework/
function.py``), a loop op (``Scan``, ``MapFn``, ``Foldl``) or a control
flow op (``Cond``, ``While``) has the effects of the body ops its outputs
run, in every branch. A captured variable is read by
the op that made the captured value, in the outer graph at its own place
in the run, not by the call: so fetching the greedy decoder's output
beside ``train_op`` is no hazard when the same reads feed the loss, as in
JAX, whose call and loop ops declare no effect. :func:`rng_ops` lists a
plan's random ops with those of every body, as the JAX Session's
``_plan_uses_rng`` (``client/session.py:300``) recurses into bodies."""

from __future__ import annotations

from typing import FrozenSet, List, Optional

from ..framework import function as function_mod
from ..framework import lowering as lowering_mod
from ..framework import op_registry

_EMPTY: FrozenSet[str] = frozenset()


class ResolvedEffects:
    """The concrete effects of one Operation."""

    __slots__ = ("reads", "writes", "rng", "io", "update")

    def __init__(self, reads: FrozenSet[str], writes: FrozenSet[str],
                 rng: bool, io: bool, update: Optional[str]):
        self.reads = reads
        self.writes = writes
        self.rng = rng
        self.io = io
        self.update = update


def _call_effects(op) -> ResolvedEffects:
    reads, writes, rng, io = set(), set(), False, False
    for fg in function_mod.body_graphs(op):
        for inner in lowering_mod.func_graph_ops(fg):
            e = op_effects(inner)
            reads |= e.reads
            writes |= e.writes
            rng, io = rng or e.rng, io or e.io
    return ResolvedEffects(frozenset(reads), frozenset(writes), rng, io,
                           None)


def rng_ops(ops) -> List:
    """The ops of ``ops`` that draw randomness, followed, at each call or
    loop op, by every op of its body that draws (nested bodies too), in
    order: one row each of a compiled step's key and seed buffers, which
    every iteration of a loop body reads."""
    out = []
    for op in ops:
        if op.type in function_mod.BODY_OPS:
            out.extend(inner for inner in function_mod.body_ops(op)
                       if inner.op_def.effects.rng)
        elif op.op_def.effects.rng:
            out.append(op)
    return list(dict.fromkeys(out))


def op_effects(op) -> ResolvedEffects:
    """The resolved effect set of one Operation (an unregistered op type
    resolves as pure)."""
    if op.type in function_mod.BODY_OPS:
        return _call_effects(op)
    try:
        eff = op_registry.get(op.type).effects
    except KeyError:
        return ResolvedEffects(_EMPTY, _EMPTY, False, False, None)
    if not eff:
        return ResolvedEffects(_EMPTY, _EMPTY, False, False, None)
    return ResolvedEffects(eff.resolved_reads(op), eff.resolved_writes(op),
                           eff.rng, eff.io, eff.update)


def commuting_writes(a: ResolvedEffects, b: ResolvedEffects) -> bool:
    """Whether two writes to one resource are order-independent: additive
    updates commute, as do multiplicative ones and same-kind min/max;
    overwrites (``update`` None or ``"update"``) commute with nothing."""
    if a.update in ("add", "sub") and b.update in ("add", "sub"):
        return True
    if a.update in ("mul", "div") and b.update in ("mul", "div"):
        return True
    return a.update in ("min", "max") and a.update == b.update
