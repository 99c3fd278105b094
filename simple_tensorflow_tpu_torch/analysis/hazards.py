"""Variable-hazard detector over one Session plan (port of
``simple_tensorflow_tpu/analysis/hazards.py``).

Within one pruned step, two effectful ops touching the same resource with
no data or control path between them run in an arbitrary topological
tie-break order, so what is observed depends on that order. From the
declared effect sets (``framework/op_registry.py`` ``Effects``) every
unordered conflicting pair is classified:

  RAW: a write precedes a read in program order, nothing orders them
  WAR: a read precedes a write in program order, nothing orders them
  WAW: two non-commuting writes to one resource are unordered

Modes (``set_hazard_mode``, env ``STF_HAZARD_MODE``, per session
``ConfigProto(variable_hazard_mode=...)``):

  off       detector disabled
  warn      hazards become WARNING diagnostics
  raise     RAW/WAR on a variable raise ``InvalidArgumentError`` at plan
            time; WAW pairs stay warnings (the default)
  auto_deps the op list is re-sorted by op id (creation order, always a
            topological order of the append-only graph), so every pair
            runs in the order the user wrote it

Only ``var_name=`` resources are enforced. Reads whose outputs feed
nothing inside the step (bare fetches) are exempt: they observe the
variable at their place in the order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..framework.errors import InvalidArgumentError
from . import diagnostics as diag_mod
from .effects import commuting_writes, op_effects

RAW = "raw"
WAR = "war"
WAW = "waw"

MODES = ("off", "warn", "raise", "auto_deps")

_ENFORCED_PREFIX = "var_name="

_mode = os.environ.get("STF_HAZARD_MODE", "raise")
if _mode not in MODES:  # a typo'd env var must not disable the detector
    _mode = "raise"


def set_hazard_mode(mode: str) -> str:
    """Set the process-default hazard mode; returns the previous one."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"hazard mode must be one of {MODES}, got {mode!r}")
    prev = _mode
    _mode = mode
    return prev


def get_hazard_mode() -> str:
    return _mode


class Hazard:
    """One unordered conflicting pair; ``first``/``second`` in program
    (creation) order, the order auto_deps enforces."""

    __slots__ = ("kind", "resource", "first", "second")

    def __init__(self, kind: str, resource: str, first: Any, second: Any):
        self.kind = kind
        self.resource = resource
        self.first = first
        self.second = second

    @property
    def enforced(self) -> bool:
        return self.resource.startswith(_ENFORCED_PREFIX)

    def describe(self) -> str:
        def at(op):
            src = getattr(op, "source_site", None)
            return f"{op.name!r} ({op.type}" + (f" at {src})" if src
                                                else ")")
        res = self.resource.split("=", 1)[-1]
        return (f"{self.kind.upper()} hazard on {res!r}: {at(self.first)} "
                f"and {at(self.second)} have no data or control-dependency "
                f"path between them, so the value observed depends on an "
                f"arbitrary execution order")

    def guidance(self) -> str:
        return ("Order them explicitly — e.g. `with stf.control_"
                "dependencies([write_op]): v.read_value()` (read-after-"
                "write) or `with stf.control_dependencies([read]): "
                "v.assign(...)` (write-after-read) — or opt into program-"
                "order auto control dependencies with hazard mode "
                "'auto_deps' (stf.analysis.set_hazard_mode or "
                "ConfigProto(variable_hazard_mode='auto_deps')).")

    def to_diagnostic(self, severity: str) -> diag_mod.Diagnostic:
        return diag_mod.Diagnostic(severity, f"hazard/{self.kind}",
                                   self.describe(), op=self.second)

    def __repr__(self):
        return (f"<Hazard {self.kind} {self.resource} "
                f"{self.first.name}~{self.second.name}>")


def find_hazards(op_list: Sequence[Any]) -> List[Hazard]:
    """Every RAW/WAR/WAW hazard of one topologically ordered,
    ancestor-closed plan: one forward sweep computes, per op, the bitmask
    of tracked effectful ops among its ancestors."""
    readers: Dict[str, List[Any]] = {}
    writers: Dict[str, List[Any]] = {}
    eff_of: Dict[Any, Any] = {}
    for op in op_list:
        eff = op_effects(op)
        if not (eff.reads or eff.writes):
            continue
        eff_of[op] = eff
        for r in eff.reads:
            readers.setdefault(r, []).append(op)
        for w in eff.writes:
            writers.setdefault(w, []).append(op)

    # resources that can conflict: a writer and at least two accessors
    interesting = [res for res, ws in writers.items()
                   if len(ws) + len([r for r in readers.get(res, ())
                                     if r not in ws]) >= 2]
    if not interesting:
        return []
    step_set = set(op_list)

    def consumed_in_step(r) -> bool:
        return any(c in step_set for out in r.outputs
                   for c in out.consumers())

    tracked: List[Any] = []
    seen: Set[int] = set()
    for res in interesting:
        for op in writers.get(res, ()):
            if id(op) not in seen:
                seen.add(id(op))
                tracked.append(op)
        for op in readers.get(res, ()):
            if id(op) not in seen and consumed_in_step(op):
                seen.add(id(op))
                tracked.append(op)
    if len(tracked) < 2:
        return []
    bit = {op: 1 << i for i, op in enumerate(tracked)}
    reach: Dict[Any, int] = {}
    for op in op_list:
        m = 0
        for t in op.inputs:
            p = t.op
            m |= reach.get(p, 0) | bit.get(p, 0)
        for p in op.control_inputs:
            m |= reach.get(p, 0) | bit.get(p, 0)
        reach[op] = m

    def unordered(a, b) -> bool:
        return not (reach[b] & bit[a] or reach[a] & bit[b])

    hazards: List[Hazard] = []
    emitted: Set[Tuple[int, int, str]] = set()

    def emit(kind, res, a, b):
        first, second = (a, b) if a._id <= b._id else (b, a)
        key = (id(first), id(second), res)
        if key not in emitted:
            emitted.add(key)
            hazards.append(Hazard(kind, res, first, second))

    for res in interesting:
        ws = writers.get(res, ())
        rs = [r for r in readers.get(res, ()) if r in bit and r not in ws]
        for i, w1 in enumerate(ws):
            for w2 in ws[i + 1:]:
                if w2 is w1 or not unordered(w1, w2):
                    continue
                if not commuting_writes(eff_of[w1], eff_of[w2]):
                    emit(WAW, res, w1, w2)
            for r in rs:
                if unordered(w1, r):
                    emit(RAW if w1._id <= r._id else WAR, res, w1, r)
    return hazards


def check_plan(op_list: Sequence[Any], mode: Optional[str] = None
               ) -> Tuple[List[Any], List[diag_mod.Diagnostic]]:
    """Apply the hazard policy to one plan: the (in auto_deps mode
    re-ordered) op list and the diagnostics. Raises
    ``InvalidArgumentError`` in "raise" mode on a RAW or WAR hazard on a
    variable."""
    mode = mode or _mode
    if mode not in MODES:
        raise ValueError(f"hazard mode must be one of {MODES}, got {mode!r}")
    out_list = list(op_list)
    if mode == "off":
        return out_list, []
    hazards = find_hazards(op_list)
    diags = [h.to_diagnostic(diag_mod.WARNING) for h in hazards
             if not h.enforced]
    enforced = [h for h in hazards if h.enforced]
    if mode == "auto_deps" and enforced:
        out_list = sorted(op_list, key=lambda op: op._id)
        for h in enforced:
            d = h.to_diagnostic(diag_mod.NOTE)
            d.message += (" — ordered by program order "
                          f"({h.first.name!r} before {h.second.name!r}, "
                          "auto_deps)")
            diags.append(d)
        return out_list, diags
    raising = [h for h in enforced if h.kind != WAW] \
        if mode == "raise" else []
    if raising:
        h = raising[0]
        raise InvalidArgumentError(
            None, h.second,
            h.describe() + ". " + h.guidance()
            + (f" ({len(raising) - 1} further hazard(s) in this plan.)"
               if len(raising) > 1 else ""))
    for h in enforced:  # warn mode, and WAW pairs under "raise"
        d = h.to_diagnostic(diag_mod.WARNING)
        d.message += ". " + h.guidance()
        diags.append(d)
    return out_list, diags
