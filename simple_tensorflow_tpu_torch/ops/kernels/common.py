"""Shared helpers for the port's hand-written CUDA kernels.

Counterpart of ``simple_tensorflow_tpu/ops/pallas/common.py`` (``round_up``,
``cdiv``, ``NEG_INF``, and the counter-hash keep mask ``mix32``,
``keep_threshold``, ``counter_keep_mask`` as plain versions of
``csrc/common.cuh``), plus what every wrapper here shares: the launch
counters, the dtype codes of the C entry points, and the argument checks
that run before a pointer is handed to native code.

Every wrapper follows one rule: a tensor on the CPU goes through the
kernel's plain PyTorch version (the CPU tests run that), a CUDA tensor
launches the kernel or raises. No wrapper falls back inside a ``try``.
"""

from __future__ import annotations

import numpy as np
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
    # the seed-pointer entries of the flash and K4 kernels (the seed read
    # on the device: what a captured Session step launches)
    "flash_attention_fwd_device_seed": 0,
    "flash_attention_dkdv_device_seed": 0,
    "flash_attention_dq_device_seed": 0,
    "softmax_xent_fwd": 0,
    "softmax_xent_bwd": 0,
    "adam_update": 0,
    "momentum_update": 0,
    # the same launches by parameter dtype (a graph MomentumOptimizer
    # launches once per dtype group a step)
    "momentum_update_bfloat16": 0,
    "momentum_update_float32": 0,
    "dropout_residual": 0,
    "dropout_residual_bwd": 0,
    "dropout_residual_device_seed": 0,
    "dropout_residual_bwd_device_seed": 0,
    "dropout": 0,
    "dropout_device_key": 0,
    "dropout_bwd": 0,
    # the conditional-node predicate setter (csrc/control_flow.cu): once
    # a node and once at the end of every WHILE body, per capture
    "cond_set": 0,
    # the numerics-health plane's multi-tensor summary (csrc/
    # numeric_summary.cu): once a step of an instrumented plan
    "numeric_summary": 0,
}

_M32 = 0xFFFFFFFF


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


# -- K0: the counter-hash dropout keep mask (common.py:44-79) ----------------
# The CUDA twin is csrc/common.cuh (mix32, counter_keep). Here uint32 values
# ride int64 tensors; the products are split in 16-bit halves so no
# intermediate leaves int64's range.

def _mul32(h, c: int):
    """``h * c mod 2**32`` for uint32 values ``h`` and a constant ``c``."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32_plain(h):
    """murmur3 finalizer over uint32 values held in an int64 tensor."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(keep_prob: float) -> int:
    """uint32 compare threshold of a keep mask, in Python doubles as JAX
    forms it."""
    return min(int(keep_prob * 4294967296.0), 4294967295)


def counter_keep_mask_plain(seed: int, salt, rows, cols, keep_prob: float):
    """Keep mask ``mix32(mix32(mix32(seed ^ salt * 0x9E3779B9) ^ row) ^
    col) < keep_threshold`` from GLOBAL indices: ``salt``, ``rows`` and
    ``cols`` int64 tensors (broadcast), ``seed`` an int (an int32 seed
    wraps to uint32) or a one-element int32 tensor holding its bits (read
    on its device without a sync)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).to(torch.int64) & _M32
    else:
        seed = int(seed) & _M32
    h0 = mix32_plain(seed ^ _mul32(salt & _M32, 0x9E3779B9))
    h = mix32_plain(h0 ^ (rows & _M32))
    h = mix32_plain(h ^ (cols & _M32))
    return h < keep_threshold(keep_prob)


def scale_kept(v, keep, keep_prob: float):
    """``where(keep, v * f32(1 / keep_prob), 0)`` for f32 ``v``: the
    kernels' dropout scaling, the scale a device tensor as their f32
    constant."""
    scale = torch.full((), 1.0 / keep_prob, dtype=torch.float32,
                       device=v.device)
    return torch.where(keep, v * scale, torch.zeros_like(v))


def seed_word(seed):
    """An int32 dropout seed (int, numpy or CPU tensor scalar, or a
    one-element array) as the uint32 word the kernels take. A one-element
    int32 tensor (a row of the seed buffer a compiled Session step reads,
    on the kernels' device) comes back as a ``(1,)`` view: the kernels'
    seed-pointer entries read it on the device, so a CUDA graph replays
    with the buffer's current seed."""
    if isinstance(seed, torch.Tensor) and seed.dtype == torch.int32:
        if seed.numel() != 1:
            raise ValueError(f"a seed tensor holds one int32, got "
                             f"{tuple(seed.shape)}")
        return seed.reshape(1)
    return int(np.asarray(seed).reshape(-1)[0]) & _M32


def device_seed(seed, device):
    """True when ``seed`` (a :func:`seed_word`) is a tensor, which must
    lie on ``device``: launch the seed-pointer entry."""
    if not isinstance(seed, torch.Tensor):
        return False
    if seed.device != device:
        raise ValueError(f"the seed tensor lies on {seed.device}, the "
                         f"kernel's tensors on {device}")
    return True


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


# callables that add the launches replays made but the counters do not
# hold yet (kernels in a conditional node's body run as often as the node
# runs its body, which the device counts): ``compiler.aot`` registers one
_SETTLERS: list = []


def _settle() -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return  # a capture under way: nothing may sync
    for settle in _SETTLERS:
        settle()


def launch_counts() -> dict:
    """A copy of the per-kernel launch counters (the launches of replayed
    loop and branch bodies settled first)."""
    _settle()
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _settle()
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def counts_now() -> dict:
    """A copy of the counters as they stand, nothing settled (inside a
    capture)."""
    return dict(_LAUNCHES)


def take_launches(before: dict) -> dict:
    """The launches counted since the snapshot ``before`` (a
    :func:`launch_counts`), taken off the counters: a CUDA graph's capture
    counts launches that run only when it is replayed, so the capture
    hands them to the graph, whose every replay adds them back
    (:func:`add_launches`)."""
    made = {k: _LAUNCHES[k] - before.get(k, 0) for k in _LAUNCHES}
    for k, v in made.items():
        _LAUNCHES[k] -= v
    return {k: v for k, v in made.items() if v}


def add_launches(counts: dict) -> None:
    """Count ``counts`` (kernel -> launches): one replay of a CUDA graph
    that captured them."""
    for k, v in counts.items():
        _LAUNCHES[k] += v


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


def check_cuda_arg(name: str, t: torch.Tensor, dtypes, ndim: int,
                   k_major: bool = False) -> None:
    """Validate a tensor before its pointer goes to a kernel: contiguous,
    or with ``k_major`` a ``(k, n)`` matrix with strides ``(1, k)``."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if k_major:
        if not t.t().is_contiguous():
            k = t.shape[0]
            raise ValueError(
                f"{name}: the kernel takes a K-major (k, n) = "
                f"{tuple(t.shape)} matrix, strides (1, {k}); got strides "
                f"{t.stride()}. Build it as w_km.t() from a contiguous "
                f"(n, k) tensor (e.g. w.t().contiguous().t(), once, where "
                f"the weight is made)")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_status(kernel: str, status: int) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{status}")
