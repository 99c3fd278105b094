"""Int8 quantized matmul: the CUDA kernel ``csrc/quant_matmul.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``simple_tensorflow_tpu/ops/pallas/quant_matmul.py:
_qmm_kernel`` (:45) and its activation quantizer ``quantize_rowwise``
(:27), forward only (inference). ``x (m, k)`` float is quantized per row
on the fly, ``wq (k, n)`` int8 carries per-column scales ``w_scale (n,)``,
the product accumulates in int32 and the epilogue is
``acc * (x_scale[m] * w_scale[n])``. Given identical inputs the kernel is
bit-exact with the plain version. The kernel takes ``wq`` K-major (strides
``(1, k)``: ``wq_km.t()`` of a contiguous ``(n, k)`` int8 tensor, as
``models.transformer.build_int8_logits_weights`` builds it); the public
function keeps the JAX package's logical ``(k, n)``. Bounded by the
weight's bytes on the card; ``csrc/quant_matmul.cu`` says what its design
does about it.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (DTYPE_CODES, check_cuda_arg, check_status, count_launch,
                     uses_kernel)


def div127(a):
    """``a / 127`` as a correctly rounded f32 division. (On CUDA,
    PyTorch divides a tensor by a Python scalar as a product with the
    scalar's reciprocal, which rounds differently for some values; a
    tensor divisor keeps the true division the kernels do.)"""
    return a / torch.full_like(a, 127.0)


def quantize_rowwise_plain(x):
    """Symmetric per-row int8 quantization: returns (q int8, scale f32).
    ``scale = amax / 127`` (1 where ``amax == 0``); ``x / scale`` rounds
    half to even and clamps to [-127, 127]. Both divisions are true
    divisions, as the kernel's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), div127(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def quant_matmul_plain(x, wq, w_scale):
    """The kernel's function in PyTorch ops. The int8 product runs as a
    float64 matmul: every product and partial sum is an integer below
    2**53, so it is exact (PyTorch has no int32 matmul on CUDA)."""
    xq, xs = quantize_rowwise_plain(x)
    acc = torch.matmul(xq.double(), wq.double()).float()
    return (acc * (xs[:, None] * w_scale.float()[None, :])).to(x.dtype)


def quant_matmul(x, wq, w_scale):
    """``x (m, k) @ dequant(wq (k, n) int8, w_scale (n,) f32)`` with int8
    accumulation; output in x's dtype. CPU tensors take the plain
    version (``wq`` in either layout); CUDA tensors launch the kernel,
    which takes a K-major ``wq`` (strides ``(1, k)``) and raises on
    another layout."""
    if not uses_kernel(x, wq, w_scale):
        return quant_matmul_plain(x, wq, w_scale)
    check_cuda_arg("x", x, DTYPE_CODES, 2)
    check_cuda_arg("wq", wq, (torch.int8,), 2, k_major=True)
    check_cuda_arg("w_scale", w_scale, (torch.float32,), 1)
    m, k = x.shape
    n = wq.shape[1]
    if wq.shape[0] != k or w_scale.shape[0] != n:
        raise ValueError(f"wq must be ({k}, n) and w_scale (n,), got "
                         f"{tuple(wq.shape)}, {tuple(w_scale.shape)}")
    if k % 4 or n % 4:
        raise ValueError(f"kernel takes k and n divisible by 4, got "
                         f"k={k}, n={n}")
    if x.data_ptr() % (4 * x.element_size()) or wq.data_ptr() % 4:
        raise ValueError("quant_matmul: x must start on a 4-element and wq "
                         "on a 4-byte boundary")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = _build.library().stf_quant_matmul(
        x.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), out.data_ptr(), m,
        k, n, DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    check_status("quant_matmul", status)
    count_launch("quant_matmul")
    return out
