"""Shared helpers for the port's hand-written CUDA kernels.

Counterpart of ``simple_tensorflow_tpu/ops/pallas/common.py`` (``round_up``,
``cdiv``, ``NEG_INF``), plus what every wrapper here shares: the launch
counters, the dtype codes of the C entry points, and the argument checks
that run before a pointer is handed to native code.

Every wrapper follows one rule: a tensor on the CPU goes through the
kernel's plain PyTorch version (the CPU tests run that), a CUDA tensor
launches the kernel or raises. No wrapper falls back inside a ``try``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite "minus infinity" — avoids NaN from (-inf) - (-inf)

# dtype codes of the C entry points (csrc/common.cuh ``DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, nowhere else (chip_smoke.py reads them to prove the serving and
# training paths went through the kernels)
_LAUNCHES = {
    "layer_norm": 0,
    "layer_norm_bwd": 0,
    "decode_attention": 0,
    "decode_attention_block": 0,
    "quant_matmul": 0,
    "flash_attention_fwd": 0,
    "flash_attention_dkdv": 0,
    "flash_attention_dq": 0,
    "softmax_xent_fwd": 0,
    "softmax_xent_bwd": 0,
    "adam_update": 0,
}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    """A copy of the per-kernel launch counters."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they all lie on the CPU (run the plain version). Mixed
    devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def check_cuda_arg(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_status(kernel: str, status: int) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{status}")
