"""NumericSummary of many tensors in one launch: the CUDA kernel
``csrc/numeric_summary.cu`` and its plain PyTorch version.

No Pallas kernel is replaced: the JAX package's ``NumericSummary``
(``simple_tensorflow_tpu/ops/numerics.py:23``) is jnp ops that XLA
fuses. Per tensor, a float32 row ``[nonfinite_count, max_abs, l2_norm,
zero_fraction]``: each element read as f32, nonfinites masked out of the
magnitude stats, the zero fraction over all ``n`` elements; a tensor of
no elements gives zeros. ``numeric_summary(tensors)`` returns the
``(len(tensors), 4)`` rows; the kernel takes contiguous f32, bf16 and f16
tensors on one card, at most :data:`MAX_TAPS_PER_LAUNCH` a launch (more
take several launches). Its reduction order is fixed, without float
atomics: the same bits at every run (``csrc/numeric_summary.cu``). Bytes
bound it: one read of every element.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import _build
from .common import cdiv, check_status, count_launch, uses_kernel

STATS_WIDTH = 4
MAX_TAPS_PER_LAUNCH = 128      # kMaxSummaryTaps
THREADS = 256                  # kSummaryThreads
ELEMS_PER_BLOCK = 8192         # a block per 8192 elements of a tap ...
MAX_BLOCKS_PER_TAP = 1024      # ... at most this many
PARTIAL_BYTES = 24             # SummaryPartial
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# per device: the kernel's done counters (zeroed once; each launch leaves
# them at zero), made outside any CUDA graph capture
_done: Dict[torch.device, torch.Tensor] = {}


def blocks_for(n: int) -> int:
    """The blocks the kernel gives a tap of ``n`` elements."""
    return max(1, min(MAX_BLOCKS_PER_TAP, cdiv(n, ELEMS_PER_BLOCK)))


def numeric_summary_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the JAX package's
    ``_numeric_summary_pure`` per tensor (the zero fraction as a double
    quotient rounded to f32, as the kernel forms it)."""
    rows = []
    for x in tensors:
        xf = x.detach().to(torch.float32)
        if xf.numel() == 0:
            rows.append(torch.zeros(STATS_WIDTH, dtype=torch.float32,
                                    device=x.device))
            continue
        finite = torch.isfinite(xf)
        safe = torch.where(finite, xf, torch.zeros_like(xf))
        absx = safe.abs()
        zeros = ((safe == 0) & finite).sum()
        rows.append(torch.stack([
            (~finite).sum().to(torch.float32), absx.max(),
            torch.sqrt((absx * absx).sum()),
            (zeros.to(torch.float64) / xf.numel()).to(torch.float32)]))
    if not rows:
        return torch.zeros((0, STATS_WIDTH), dtype=torch.float32)
    return torch.stack(rows)


def _done_counters(device: torch.device) -> torch.Tensor:
    done = _done.get(device)
    if done is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "numeric_summary: first launch inside a CUDA graph "
                "capture; its counters must be made outside one (run the "
                "step eagerly first)")
        with torch.inference_mode(False):
            done = _done[device] = torch.zeros(
                MAX_TAPS_PER_LAUNCH, dtype=torch.int32, device=device)
    return done


def numeric_summary(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(len(tensors), 4)`` float32 rows (module docstring). CPU tensors
    take the plain version; CUDA tensors launch the kernel, once per
    :data:`MAX_TAPS_PER_LAUNCH` tensors."""
    tensors = list(tensors)
    if not tensors or not uses_kernel(*tensors):
        return numeric_summary_plain(tensors)
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"numeric_summary: tensor {i} is {t.dtype}, "
                            "not float32, bfloat16 or float16")
        if t.device != dev:
            raise ValueError(f"numeric_summary: tensor {i} lies on "
                             f"{t.device}, tensor 0 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"numeric_summary: tensor {i} must be "
                             "contiguous")
    lib = _build.library()
    done = _done_counters(dev)
    out = torch.empty((len(tensors), STATS_WIDTH), dtype=torch.float32,
                      device=dev)
    stream = _build.stream_handle(dev)
    for lo in range(0, len(tensors), MAX_TAPS_PER_LAUNCH):
        chunk = tensors[lo:lo + MAX_TAPS_PER_LAUNCH]
        ptrs = np.array([t.data_ptr() for t in chunk], np.uint64)
        lengths = np.array([t.numel() for t in chunk], np.int64)
        codes = np.array([DTYPE_CODES[t.dtype] for t in chunk], np.int32)
        blocks = np.array([blocks_for(int(n)) for n in lengths], np.int32)
        partials = torch.empty(int(blocks.sum()) * PARTIAL_BYTES,
                               dtype=torch.uint8, device=dev)
        status = lib.stf_numeric_summary(
            ptrs.ctypes.data, lengths.ctypes.data, codes.ctypes.data,
            blocks.ctypes.data, len(chunk), out[lo:].data_ptr(),
            partials.data_ptr(), done.data_ptr(), stream)
        check_status("numeric_summary", status)
        count_launch("numeric_summary")
    return out
