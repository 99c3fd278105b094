"""stf.debug.numerics: the training numerics-health plane; the port of
``simple_tensorflow_tpu/debug/numerics.py``.

A Session plan that looks like a training step (a device op writes a
variable) is instrumented with taps over its gradients, optimizer
updates, loss and any activation whose op name matches a
``ConfigProto(numerics_taps=)`` pattern (:func:`select_taps`, the JAX
package's selection, tap for tap). Each tap reduces to a float32
``[nonfinite_count, max_abs, l2_norm, zero_fraction]`` row on the device.

Where the JAX plane adds one ``NumericSummary`` op per tap and a ``Pack``
at the end of the plan, the port adds one ``NumericSummaries`` op, one
launch of the ``numeric_summary`` kernel for every tap, placed just
before the plan's first in-place op (the fused optimizer update): the
port updates variables in place and frees each value after its last use
(``lowering.last_uses``), so every tap is read before any in-place write
can reach its storage, and the summary counts as a use
(:func:`instrument_plan`). Its ``(T, 4)`` health tensor is fetched with
the step and read after the state commit; in a ``run_steps`` window each
replay's rows are copied into row i of an ``(n, T, 4)`` buffer on the
device and read once after the window, so every step is observed.

Modes (``ConfigProto(numerics=)`` > :func:`set_numerics_mode` >
``STF_NUMERICS`` > "off"):

- ``off``: no instrumentation.
- ``metrics``: every step feeds the ``/stf/train/*`` metrics and the
  process :class:`HealthPlane` (history ring, last anomaly;
  :func:`trainz_info`).
- ``raise``: metrics, and an ``InvalidArgumentError`` naming the first
  nonfinite tap and the op that made it, after the step's commit
  (recovery is a checkpoint restore, bit-exact for these plans).
- ``dump``: raise, and first the bisector: the store as it was before the
  run (or window) is retained as a device copy (a flat optimizer group
  copied once); the failing step is replayed eagerly from it, op by op,
  the first op whose output holds a nonfinite while its inputs are all
  finite is named (:func:`first_bad_op`), and its inputs and outputs are
  written as a dump directory (:func:`write_dump`: ``run_0/<tensor>.npy``,
  ``manifest.json`` and ``bisect_report.json``) that
  ``debug/analyzer.DebugDumpDir`` reads.

Left out (telemetry is not ported): the ``/trainz`` endpoint (its payload
is :func:`trainz_info`), the flight recorder's ``numeric`` event and the
ops' creation sites (a tap's ``site`` is None).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..framework import errors
from ..ops.numerics import STATS_WIDTH
from ..platform import monitoring
from ..platform import sync as _sync

_log = logging.getLogger(__name__)

MODES = ("off", "metrics", "raise", "dump")

# taps per plan at most: more are cut, with a log line
MAX_TAPS = 64

_process_mode: Optional[str] = None
_mode_lock = _sync.Lock("numerics/mode", rank=_sync.RANK_STATE)


def set_numerics_mode(mode: Optional[str]) -> Optional[str]:
    """Set the process-default mode (None: ``STF_NUMERICS`` decides);
    returns the previous setting."""
    global _process_mode
    if mode is not None and mode not in MODES:
        raise ValueError(f"numerics mode must be one of {MODES} or None, "
                         f"got {mode!r}")
    with _mode_lock:
        prev = _process_mode
        _process_mode = mode
    return prev


def get_numerics_mode() -> str:
    """The process default: :func:`set_numerics_mode`'s, else
    ``STF_NUMERICS``, else "off"."""
    with _mode_lock:
        if _process_mode is not None:
            return _process_mode
    env = os.environ.get("STF_NUMERICS", "").strip().lower()
    return env if env in MODES else "off"


def resolve_mode(config) -> str:
    """The mode a Session runs under: ``ConfigProto(numerics=)``, else
    the process default."""
    m = getattr(config, "numerics", None) if config is not None else None
    return m if m in MODES else get_numerics_mode()


# -- /stf/train/* (the JAX package's names) -----------------------------------

_metric_health_steps = monitoring.Counter(
    "/stf/train/health_steps",
    "training steps observed by the numerics-health plane (one count "
    "per step, fused or not)")
_metric_nonfinite = monitoring.Counter(
    "/stf/train/nonfinite_events",
    "tap observations containing NaN/Inf, by tap kind "
    "(gradient|update|loss|activation)", "kind")
_metric_grad_norm = monitoring.Sampler(
    "/stf/train/grad_norm",
    monitoring.ExponentialBuckets(1e-8, 10.0, 20),
    "global gradient L2 norm per observed step (sqrt of the sum of "
    "squared per-tap norms over gradient taps)")
_metric_update_ratio = monitoring.Sampler(
    "/stf/train/update_ratio",
    monitoring.ExponentialBuckets(1e-8, 10.0, 20),
    "global optimizer-update norm / global gradient norm per observed "
    "step (recorded only when both tap kinds exist)")


class HealthPlane:
    """The process's training-health state: a bounded per-step history
    ring and the last anomaly."""

    HISTORY = 256

    def __init__(self):
        self._lock = _sync.Lock("numerics/health_plane",
                                rank=_sync.RANK_TELEMETRY)
        self._history = collections.deque(maxlen=self.HISTORY)
        self._steps = 0
        self._anomalies = 0
        self.last_anomaly: Optional[Dict[str, Any]] = None
        self.taps: List[Dict[str, Any]] = []

    def set_taps(self, tap_table: List[Dict[str, Any]]) -> None:
        with self._lock:
            self.taps = list(tap_table)

    def record_step(self, tap_table: Sequence[Dict[str, Any]], stats,
                    step: int, window_index: Optional[int] = None
                    ) -> Optional[Dict[str, Any]]:
        """Observe one step's ``(T, 4)`` rows: metrics and history; the
        anomaly record when a tap saw a nonfinite, else None."""
        stats = np.asarray(stats, dtype=np.float64).reshape(
            len(tap_table), STATS_WIDTH)
        grad_sq = upd_sq = 0.0
        has_grad = has_upd = False
        bad: List[Dict[str, Any]] = []
        for tap, row in zip(tap_table, stats):
            if tap["kind"] == "gradient":
                grad_sq += row[2] ** 2
                has_grad = True
            elif tap["kind"] == "update":
                upd_sq += row[2] ** 2
                has_upd = True
            if row[0] > 0:
                bad.append({**tap, "nonfinite_count": int(row[0]),
                            "max_abs": float(row[1]),
                            "l2_norm": float(row[2]),
                            "zero_fraction": float(row[3])})
        _metric_health_steps.get_cell().increase_by(1)
        grad_norm = float(np.sqrt(grad_sq)) if has_grad else None
        if grad_norm is not None:
            _metric_grad_norm.get_cell().add(grad_norm)
        upd_norm = float(np.sqrt(upd_sq)) if has_upd else None
        ratio = None
        if grad_norm is not None and upd_norm is not None:
            ratio = upd_norm / max(grad_norm, 1e-12)
            _metric_update_ratio.get_cell().add(ratio)
        entry = {"step": int(step), "time": time.time(),
                 "nonfinite_taps": len(bad), "grad_norm": grad_norm,
                 "update_norm": upd_norm, "update_ratio": ratio,
                 "max_abs": float(np.max(stats[:, 1])) if stats.size
                 else 0.0}
        if window_index is not None:
            entry["window_index"] = int(window_index)
        anomaly = None
        if bad:
            for b in bad:
                _metric_nonfinite.get_cell(b["kind"]).increase_by(1)
            anomaly = {"step": int(step), "time": entry["time"],
                       "taps": bad}
            if window_index is not None:
                anomaly["window_index"] = int(window_index)
        with self._lock:
            self._steps += 1
            self._history.append(entry)
            if anomaly is not None:
                self._anomalies += 1
                self.last_anomaly = anomaly
        return anomaly

    def note_forensics(self, **fields) -> None:
        """Attach the bisector's findings to the last anomaly."""
        with self._lock:
            if self.last_anomaly is not None:
                self.last_anomaly.update(fields)

    def info(self) -> Dict[str, Any]:
        with self._lock:
            return {"mode": get_numerics_mode(),
                    "steps_observed": self._steps,
                    "anomalies": self._anomalies,
                    "taps": list(self.taps),
                    "history": list(self._history),
                    "last_anomaly": self.last_anomaly}

    def reset(self) -> None:
        with self._lock:
            self._history.clear()
            self._steps = 0
            self._anomalies = 0
            self.last_anomaly = None
            self.taps = []


_plane: Optional[HealthPlane] = None
_plane_lock = _sync.Lock("numerics/plane_init", rank=_sync.RANK_STATE)


def get_plane() -> HealthPlane:
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = HealthPlane()
        return _plane


def trainz_info() -> Dict[str, Any]:
    """What the JAX package's ``/trainz`` endpoint serves."""
    return get_plane().info()


# -- tap selection and instrumentation ----------------------------------------

# the JAX plan optimizer's folding rules (``framework/optimizer.py``
# ``optimize_pruned``), which decide which tensors are plan constants
_FOLD_BLOCKLIST = {"Placeholder", "PlaceholderWithDefault", "Const",
                   "VariableV2", "VarRead", "Assign"}
_SHAPE_OPS = {"Shape", "Size", "Rank"}
_FOLD_MAX_BYTES = 1 << 20


def _writes_variable(op) -> bool:
    from ..analysis import op_effects

    return any(w.startswith("var_name=") for w in op_effects(op).writes)


def _float_tensor(t) -> bool:
    return t.dtype.is_floating


def _nbytes(t) -> int:
    if not t.shape.is_fully_defined():
        return 0
    return int(np.prod(t.shape.as_list() or [1])) * t.dtype.size


def plan_constants(pruned, fed_set) -> Tuple[Dict[Any, Any], Set[Any]]:
    """``(alias, constants)`` of a pruned plan as the JAX plan optimizer
    sees them: a pure op whose inputs are all constants (at most 1 MiB of
    outputs), a ``Shape``/``Size``/``Rank`` of a static shape and a
    ``Const`` give constants; a pure op equal to an earlier one (type,
    inputs, attrs) aliases it. The port runs the plan as it is; this
    only keeps its taps the JAX plane's."""
    const: Set[Any] = set()
    alias: Dict[Any, Any] = {}
    sigs: Dict[str, Any] = {}
    for op in pruned:
        od = op.op_def
        if op.type == "Const":
            const.update(op.outputs)
            continue
        pure = (od.pure_fn is not None and not od.is_stateful
                and not od.runs_on_host and not op.control_inputs
                and op.type not in _FOLD_BLOCKLIST)
        if not pure:
            continue
        ins = [alias.get(t, t) for t in op.inputs]
        if op.type in _SHAPE_OPS and op.inputs and \
                op.inputs[0].shape.is_fully_defined():
            const.update(op.outputs)
            continue
        if ins and all(t in const and t not in fed_set for t in ins) and \
                sum(_nbytes(o) for o in op.outputs) <= _FOLD_MAX_BYTES:
            const.update(op.outputs)
            continue
        sig = repr((op.type, tuple(id(t) for t in ins),
                    sorted((k, repr(v)) for k, v in op.attrs.items()
                           if not k.startswith("_"))))
        canon = sigs.get(sig)
        if canon is not None:
            for dup, c in zip(op.outputs, canon.outputs):
                alias[dup] = alias.get(c, c)
            continue
        sigs[sig] = op
    return alias, const


def select_taps(pruned, fed_set, fetch_tensors, alias, const_env,
                patterns=()) -> List[Tuple[Any, str]]:
    """The tensors the plane watches, ``(tensor, kind)`` in plan order:
    ``gradient`` (``SymbolicGradient`` outputs), ``update`` (float inputs
    of variable-writing device ops), ``loss`` (scalar float fetches),
    ``activation`` (outputs of ops whose name matches a pattern)."""
    def rsv(t):
        return alias.get(t, t)

    taps: List[Tuple[Any, str]] = []
    seen = set()

    def add(t, kind):
        t = rsv(t)
        if (t in seen or t in fed_set or t in const_env
                or not _float_tensor(t) or t.op.op_def.runs_on_host
                or t.op.type in ("NumericSummary", "NumericSummaries",
                                 "Const")
                or t.op.name.startswith("numerics_health")):
            return
        seen.add(t)
        taps.append((t, kind))

    compiled = [re.compile(p) for p in (patterns or ())]
    for op in pruned:
        if op.op_def.runs_on_host:
            continue
        if op.type == "SymbolicGradient":
            for o in op.outputs:
                add(o, "gradient")
        if _writes_variable(op):
            for t in op.inputs:
                if rsv(t).op.type != "VariableV2":
                    add(t, "update")
        if compiled and any(p.search(op.name) for p in compiled):
            for o in op.outputs:
                add(o, "activation")
    for t in fetch_tensors:
        r = rsv(t)
        if r.shape.rank == 0 and not r.op.op_def.runs_on_host:
            add(r, "loss")
    return taps


def instrument_plan(graph, pruned, fed_set, fetch_tensors, patterns=()):
    """The instrumentation pass over one planned op list: ``(ops,
    tap_table, health_tensor)``, or ``(pruned, None, None)`` when the plan
    is not training-shaped (no device op writes a variable) or has no
    tappable tensor. The ``NumericSummaries`` op is made once per tap set
    and kept in the graph's scoped state, so a plan made again reuses
    it."""
    if not any(not op.op_def.runs_on_host and _writes_variable(op)
               for op in pruned):
        return pruned, None, None
    alias, const = plan_constants(pruned, fed_set)
    taps = select_taps(pruned, fed_set, fetch_tensors, alias, const,
                       patterns)
    if not taps:
        return pruned, None, None
    if len(taps) > MAX_TAPS:
        _log.warning(
            "numerics: plan has %d tappable tensors; watching the first %d "
            "(raise debug.numerics.MAX_TAPS or narrow numerics_taps "
            "patterns to change the set)", len(taps), MAX_TAPS)
        taps = taps[:MAX_TAPS]
    from ..framework import dtypes as dtypes_mod
    from ..framework import graph as ops_mod
    from ..framework import tensor_shape as shape_mod

    reg = graph._scoped_state.setdefault("__numerics_packs__", {})
    key = tuple(t.name for t, _ in taps)
    op = reg.get(key)
    if op is None:
        with ops_mod._as_current(graph), graph.name_scope(None), \
                graph.control_dependencies(None):
            op = reg[key] = graph.create_op(
                "NumericSummaries", [t for t, _ in taps], attrs={},
                name="numerics_health/pack",
                output_specs=[(shape_mod.TensorShape([len(taps),
                                                      STATS_WIDTH]),
                               dtypes_mod.float32)])
    table = [{"name": t.name, "kind": kind, "op": t.op.name,
              "op_type": t.op.type, "site": None} for t, kind in taps]
    ops = [o for o in pruned if o is not op]
    pos = next((i for i, o in enumerate(ops) if o.op_def.in_place),
               len(ops))
    made = {o: i for i, o in enumerate(ops)}
    last_tap = max(made.get(t.op, -1) for t, _ in taps)
    # before the first in-place op, unless a tap is made after it (then
    # the plan's preserve list copies any earlier tap it would overwrite)
    pos = max(pos, last_tap + 1)
    return ops[:pos] + [op] + ops[pos:], table, op.outputs[0]


# -- anomalies: the raise, the bisector, the dump -----------------------------

def format_anomaly(anomaly: Dict[str, Any], extra: str = "") -> str:
    lines = [f"numerics: nonfinite values detected at step "
             f"{anomaly['step']}"
             + (f" (fused window index {anomaly['window_index']})"
                if "window_index" in anomaly else "") + ":"]
    for b in anomaly["taps"][:8]:
        lines.append(
            f"  tap {b['name']} [{b['kind']}] from op {b['op']} "
            f"({b['op_type']}): {b['nonfinite_count']} nonfinite, "
            f"max_abs={b['max_abs']:.6g}")
    if len(anomaly["taps"]) > 8:
        lines.append(f"  ... and {len(anomaly['taps']) - 8} more taps")
    lines.append("state through this step is committed; restore the "
                 "last checkpoint to recover")
    if extra:
        lines.append(extra)
    return "\n".join(lines)


def raise_anomaly(anomaly, bad_op=None, dump_root=None):
    extra = ""
    if bad_op is not None:
        extra = f"first bad op: {bad_op.name} ({bad_op.type})"
    if dump_root:
        extra += (f"\ndump written to {dump_root}: read it with "
                  "debug.analyzer.DebugDumpDir")
    raise errors.InvalidArgumentError(None, None,
                                      format_anomaly(anomaly, extra))


def _to_float_np(v) -> Optional[np.ndarray]:
    """A floating value as a host array (bf16 and f16 widened to f32),
    None for any other value."""
    if isinstance(v, torch.Tensor):
        if not v.is_floating_point():
            return None
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.cpu().numpy()
    if v is None:
        return None
    arr = np.asarray(v)
    return arr if arr.dtype.kind == "f" else None


def _all_finite(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not v.is_floating_point() or bool(torch.isfinite(v).all())
    arr = _to_float_np(v)
    return arr is None or bool(np.all(np.isfinite(arr)))


def _host(v):
    arr = _to_float_np(v)
    if arr is not None:
        return arr
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def first_bad_op(ctx, device_ops, feed_tensors=()):
    """Run ``device_ops`` in ``ctx`` one at a time and stop at the first
    op whose float output holds a nonfinite while every float input is
    finite, checked as it runs (before a later in-place update can change
    a value). A nonfinite feed names its placeholder. Returns ``(op,
    [(tensor, value)] inputs, outputs)`` on the host, or ``(None, [],
    [])``."""
    from ..framework import lowering as lowering_mod

    for t in feed_tensors:
        v = ctx.value_of(t)
        if not _all_finite(v):
            return t.op, [], [(t, _host(v))]
    for op in device_ops:
        ins = [] if lowering_mod.shape_only(op) else [
            (t, ctx.env[t] if t in ctx.env else ctx.value_of(t))
            for t in op.inputs]
        ins_finite = all(_all_finite(v) for _, v in ins)
        ins_host = [(t, _host(v)) for t, v in ins] if ins_finite else None
        lowering_mod.execute_ops(ctx, [op])
        outs = [(o, ctx.env[o]) for o in op.outputs if o in ctx.env]
        if ins_finite and outs and \
                not all(_all_finite(v) for _, v in outs):
            return op, ins_host, [(o, _host(v)) for o, v in outs]
    return None, [], []


def default_dump_root() -> str:
    root = os.environ.get("STF_NUMERICS_DUMP_ROOT")
    if root:
        os.makedirs(root, exist_ok=True)
        return tempfile.mkdtemp(prefix="numerics_", dir=root)
    return tempfile.mkdtemp(prefix="stf_numerics_")


def write_dump(dump_root, bad_op, ins, outs, anomaly,
               window_index=None) -> str:
    """The bisector's findings as a dump directory: ``run_0/<tensor>.npy``
    and ``manifest.json`` (``debug/analyzer.DebugDumpDir``'s layout) and
    ``bisect_report.json``."""
    from .io_utils import FileSink

    sink = FileSink(dump_root)
    for t, v in list(ins) + list(outs):
        if v is None:
            continue
        arr = np.asarray(v)
        flagged = arr.dtype.kind == "f" and not bool(np.all(np.isfinite(
            arr)))
        sink.publish(0, t.name, arr, has_inf_or_nan=flagged)
    report = {
        "first_bad_op": bad_op.name if bad_op is not None else None,
        "op_type": bad_op.type if bad_op is not None else None,
        "site": None, "traceback": [],
        "inputs": [t.name for t, _ in ins],
        "outputs": [t.name for t, _ in outs],
        "anomaly": anomaly,
    }
    if window_index is not None:
        report["window_index"] = int(window_index)
    with open(os.path.join(dump_root, "bisect_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    return dump_root


def bisect_and_dump(session, plan, steps, pre_state, counters, bad_index,
                    anomaly, window_index=None):
    """``dump`` forensics: replay steps ``0 .. bad_index`` of ``steps``
    (each step's feeds; ``counters`` their RNG run counters) eagerly from
    ``pre_state`` (the retained device copy of the store), in a scratch
    store, the steps before the bad one committed there, then
    :func:`first_bad_op` over the bad one; write the dump. Returns
    ``(bad_op, dump_root)``."""
    ctx = None
    scratch = session._scratch_replay(pre_state)
    for i in range(int(bad_index) + 1):
        ctx = scratch.context(plan, steps[i], counters[i])
        if i < int(bad_index):
            scratch.step(plan, ctx)
    with torch.set_grad_enabled(plan.needs_grad):
        bad_op, ins, outs = first_bad_op(ctx, plan.ops, plan.feed_tensors)
    root = default_dump_root()
    write_dump(root, bad_op, ins, outs, anomaly, window_index=window_index)
    return bad_op, root


def bisect_window_and_dump(session, plan, steps, pre_state, counters,
                           bad_index, anomaly):
    """:func:`bisect_and_dump` for a ``run_steps`` window: the steps
    before the bad one replayed from the window's entry state."""
    return bisect_and_dump(session, plan, steps, pre_state, counters,
                           bad_index, anomaly, window_index=bad_index)
