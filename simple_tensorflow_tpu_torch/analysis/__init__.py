"""Plan analysis of the port: the variable-hazard detector.

Port of the part of ``simple_tensorflow_tpu/analysis/`` a Session plan
runs: ``effects`` (per-op effect resolution), ``hazards`` (RAW/WAR/WAW
between unordered effectful ops, modes ``off|warn|raise|auto_deps``) and
the ``Diagnostic`` record of ``diagnostics``; ``loop_safety``, the
``Session.run_steps`` certification. Left out: the verifier, the linters,
the sharding analyses and the monitoring counters.
"""

from . import loop_safety
from .diagnostics import ERROR, NOTE, WARNING, Diagnostic
from .effects import (ResolvedEffects, commuting_writes, op_effects,
                      rng_ops)
from .hazards import (MODES, Hazard, check_plan, find_hazards,
                      get_hazard_mode, set_hazard_mode)

__all__ = ["loop_safety", "ERROR", "NOTE", "WARNING", "Diagnostic", "ResolvedEffects",
           "commuting_writes", "op_effects", "rng_ops", "MODES", "Hazard",
           "check_plan", "find_hazards", "get_hazard_mode",
           "set_hazard_mode"]
