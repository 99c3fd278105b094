"""Session configuration (ref: tensorflow/core/protos/config.proto
``ConfigProto``).

Port of the part of ``simple_tensorflow_tpu/framework/config_pb.py`` the
port's Session reads: ``device_count``, where ``{"GPU": 0}`` is the TF-1
idiom for a CPU session (the JAX package's ``ConfigProto`` accepts it too,
:157, so the same user code runs on either package), and
``variable_hazard_mode`` (:57, :193): None (the process default of
``stf.analysis``, ``"raise"`` unless ``STF_HAZARD_MODE`` or
``set_hazard_mode`` says otherwise) or one of ``off|warn|raise|
auto_deps``. Left out: the other fields (thread pools, GPU options,
transfer guards, graph analysis, kernel registry, telemetry, memory
budget).
"""

from __future__ import annotations

_HAZARD_MODES = ("off", "warn", "raise", "auto_deps")


class ConfigProto:
    def __init__(self, device_count=None, variable_hazard_mode=None,
                 loop_fusion_steps=1, numerics=None):
        self.device_count = dict(device_count or {})
        if variable_hazard_mode is not None and \
                variable_hazard_mode not in _HAZARD_MODES:
            raise ValueError(
                "variable_hazard_mode must be None|off|warn|raise|"
                f"auto_deps, got {variable_hazard_mode!r}")
        self.variable_hazard_mode = variable_hazard_mode
        loop_fusion_steps = int(loop_fusion_steps)
        if loop_fusion_steps < 1:
            raise ValueError(
                f"loop_fusion_steps must be >= 1, got {loop_fusion_steps}")
        self.loop_fusion_steps = loop_fusion_steps
        self.numerics = numerics

    def device(self) -> str:
        """``"cpu"`` when ``device_count`` asks for no GPU, else
        ``"cuda"``."""
        return "cpu" if self.device_count.get("GPU", 1) == 0 else "cuda"
