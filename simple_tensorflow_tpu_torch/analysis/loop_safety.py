"""Loop-safety certification of a ``Session.run_steps`` window; the port of
``simple_tensorflow_tpu/analysis/loop_safety.py`` (the same reasons,
codes and messages).

A window runs n steps of one plan with no host work between them (the
JAX package: one ``lax.scan``; the port: n replays of one CUDA graph).
That holds only when the whole step lives on the device: an op of the
host stage would need Python between steps, an effectful host sink a
per-step device-to-host read, and an op with a declared ``io`` effect
(``Print``) must fire once a step on the host. Pure host sinks (the
summary ops, ``host_sink_pure``) only observe device values: under
``output_mode="last"`` the Session runs them once a window, on the last
step's values; ``"stacked"`` still falls back (:func:`
stacked_host_sink_diag`).

:func:`certify_plan` returns one ERROR ``Diagnostic`` per blocking op
(code ``loop_fusion/<reason>``); the reasons label the Session's
``loop_fusion_fallbacks`` counts (:func:`fallback_reasons`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

from . import diagnostics as diag_mod
from .effects import op_effects

HOST_STAGE_OP = "host_stage_op"
HOST_SINK_OP = "host_sink_op"
HOST_EFFECTFUL_OP = "host_effectful_op"
NO_DEVICE_STAGE = "no_device_stage"
UNINITIALIZED_WRITE = "uninitialized_write"


def written_var_names(device_ops: Sequence[Any]) -> Set[str]:
    """The store names of the variables the plan assigns (from the
    declared effects)."""
    names: Set[str] = set()
    for op in device_ops:
        for w in op_effects(op).writes:
            if w.startswith("var_name="):
                names.add(w.split("=", 1)[1])
    return names


def uninitialized_write_diag(missing: Sequence[str]) -> diag_mod.Diagnostic:
    """The store-dependent failure: the plan assigns variables with no
    value in the store yet."""
    return diag_mod.Diagnostic(
        diag_mod.ERROR, f"loop_fusion/{UNINITIALIZED_WRITE}",
        "the plan assigns variable(s) not yet in the session's "
        f"variable store ({', '.join(list(missing)[:5])}): the loop "
        "carry needs an initial device value for every threaded "
        "variable (run the initializer unfused first)")


def certify_plan(device_ops: Sequence[Any],
                 host_plan: Sequence[Any],
                 post_host_plan: Sequence[Any],
                 variable_store: Optional[Iterable[str]] = (),
                 ) -> List[diag_mod.Diagnostic]:
    """Certify one plan for a window: an empty list when it may run as
    one, else one ERROR diagnostic per blocking op.
    ``variable_store=None`` skips the store-dependent check (the Session
    caches the plan-static result and re-checks that part with
    :func:`uninitialized_write_diag`)."""
    diags: List[diag_mod.Diagnostic] = []

    def block(reason: str, op: Any, why: str):
        diags.append(diag_mod.Diagnostic(
            diag_mod.ERROR, f"loop_fusion/{reason}",
            f"op {op.name!r} ({op.type}) prevents multi-step fusion: "
            f"{why}", op=op))

    if not device_ops:
        diags.append(diag_mod.Diagnostic(
            diag_mod.ERROR, f"loop_fusion/{NO_DEVICE_STAGE}",
            "the plan has no device stage — nothing to fuse (host-only "
            "or constant-folded fetches)"))
        return diags
    for op in host_plan:
        if op.type == "Const":
            continue
        block(HOST_STAGE_OP, op,
              "it runs in the host stage (Python) before the device "
              "program, so each iteration would need a host round-trip")
    for op in post_host_plan:
        if getattr(op.op_def, "host_sink_pure", False):
            continue  # deferred to once a window
        block(HOST_SINK_OP, op,
              "it is an effectful host sink consuming device results "
              "(handle-style op) and would need a per-step device->host "
              "transfer")
    missing: List[str] = []
    if variable_store is not None:
        store = set(variable_store)
        missing = sorted(n for n in written_var_names(device_ops)
                         if n not in store)
    for op in device_ops:
        if op_effects(op).io:
            block(HOST_EFFECTFUL_OP, op,
                  "it has a declared host-observable io effect that must "
                  "fire once per step")
    if missing:
        diags.append(uninitialized_write_diag(missing))
    return diags


def stacked_host_sink_diag(post_host_plan: Sequence[Any]
                           ) -> diag_mod.Diagnostic:
    """``output_mode="stacked"`` with pure host sinks falls back: each
    step's summary needs that step's values on the host."""
    names = [op.name for op in post_host_plan
             if getattr(op.op_def, "host_sink_pure", False)][:5]
    return diag_mod.Diagnostic(
        diag_mod.ERROR, f"loop_fusion/{HOST_SINK_OP}",
        "output_mode='stacked' needs host sink op(s) "
        f"({', '.join(names)}) to run once per step; pure sinks defer "
        "only under output_mode='last'")


def fallback_reasons(diags: Sequence[diag_mod.Diagnostic]) -> List[str]:
    """Distinct ``<reason>`` labels of certify_plan diagnostics, in
    first-seen order."""
    seen: Dict[str, None] = {}
    for d in diags:
        seen.setdefault(d.code.split("/", 1)[1], None)
    return list(seen)
