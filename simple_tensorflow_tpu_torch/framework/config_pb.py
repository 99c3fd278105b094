"""Session configuration (ref: tensorflow/core/protos/config.proto
``ConfigProto``).

Port of the part of ``simple_tensorflow_tpu/framework/config_pb.py`` the
port's Session reads: ``device_count``, where ``{"GPU": 0}`` is the TF-1
idiom for a CPU session (the JAX package's ``ConfigProto`` accepts it too,
:157, so the same user code runs on either package). Left out: the other
fields (thread pools, GPU options, transfer guards, analysis, kernel
registry, telemetry, memory budget).
"""

from __future__ import annotations


class ConfigProto:
    def __init__(self, device_count=None):
        self.device_count = dict(device_count or {})

    def device(self) -> str:
        """``"cpu"`` when ``device_count`` asks for no GPU, else
        ``"cuda"``."""
        return "cpu" if self.device_count.get("GPU", 1) == 0 else "cuda"
