"""Per-op effect resolution (port of ``simple_tensorflow_tpu/analysis/
effects.py``): an op's declared ``Effects`` (``framework/op_registry.py``)
resolved against its attrs, e.g. an ``Assign`` with ``var_name == "w"``
writes ``{"var_name=w"}``."""

from __future__ import annotations

from typing import FrozenSet, Optional

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


def op_effects(op) -> ResolvedEffects:
    """The resolved effect set of one Operation (an unregistered op type
    resolves as pure)."""
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
