"""The card's peak rates and memory, MFU and the roofline.

Port of ``simple_tensorflow_tpu/utils/perf.py``: ``chip_spec`` (:43),
``chip_hbm_bytes`` (:57), ``mfu`` (:293) and ``roofline`` (:301). The
table holds the NVIDIA H100 and no TPU: its dense bf16 tensor-core peak
and its HBM3 rate, both from the H100 SXM data sheet (spec figures, not
measured). The capacity is the card's own, from
``torch.cuda.get_device_properties``. A CUDA card that is not in the table
raises, naming the card: it never borrows another chip's figures. On the
CPU the figures are the JAX package's nominal ones, so that the decisions
made from them (``cost_model.resolve_recompute``) are the same there.
Left out: ``StepTimer``, ``cost_of``, ``PerfReport`` and the profiler
helpers (they read XLA's compiled executables).
"""

from __future__ import annotations

from typing import Dict

import torch

# per-card peaks: (dense bf16 FLOP/s, HBM bytes/s), H100 SXM data sheet
_CHIP_SPECS = {
    "h100": (989e12, 3.35e12),
}
# the JAX package's nominal CPU figures, for the CPU decisions
_CPU_SPEC = (1e12, 100e9)
_CPU_HBM = 4e9


def _device(device=None) -> torch.device:
    """``device`` as a torch device; None is the attached one: the current
    card, else the CPU."""
    if device is None:
        if torch.cuda.is_available():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    if isinstance(device, int):
        return torch.device("cuda", device)
    return torch.device(device)


def chip_spec(device=None):
    """(peak_flops, peak_hbm_bw) for the attached device."""
    d = _device(device)
    if d.type == "cpu":
        return _CPU_SPEC
    name = torch.cuda.get_device_name(d)
    for key, spec in _CHIP_SPECS.items():
        if key in name.lower():
            return spec
    raise ValueError(f"no peak rates are known for the card {name!r}; "
                     f"utils/perf.py has {sorted(_CHIP_SPECS)}")


def chip_hbm_bytes(device=None):
    """The device's memory capacity in bytes (remat decisions)."""
    d = _device(device)
    if d.type == "cpu":
        return _CPU_HBM
    chip_spec(d)  # an unknown card raises here too
    return float(torch.cuda.get_device_properties(d).total_memory)


def mfu(step_flops: float, step_seconds: float, device=None) -> float:
    """Model FLOPs Utilization: achieved/peak."""
    peak, _ = chip_spec(device)
    if step_seconds <= 0 or peak <= 0:
        return 0.0
    return step_flops / step_seconds / peak


def roofline(step_flops: float, step_bytes: float, device=None
             ) -> Dict[str, float]:
    """Arithmetic intensity vs the machine ridge point: above the ridge
    the step is compute-bound, below it bandwidth-bound."""
    peak_flops, peak_bw = chip_spec(device)
    intensity = step_flops / step_bytes if step_bytes else float("inf")
    ridge = peak_flops / peak_bw
    attainable = min(peak_flops, intensity * peak_bw)
    return {"intensity_flops_per_byte": intensity,
            "ridge_point": ridge,
            "compute_bound": intensity >= ridge,
            "attainable_flops": attainable,
            "roofline_fraction_of_peak": attainable / peak_flops}
