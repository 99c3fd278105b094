"""Dropout with JAX's threefry bits: the CUDA kernels ``csrc/dropout.cu``
and their plain PyTorch versions.

Replaces the JAX package's ``Dropout`` op (``simple_tensorflow_tpu/ops/
nn_ops.py:_dropout_lower``, :388-398), which is composed XLA rather than
Pallas: ``u = jax.random.uniform(key, x.shape)``, ``keep = u <
keep_prob``, ``out = where(keep, x / kp, 0)`` with ``kp = keep_prob`` in
``x``'s dtype (0.8984375 for 0.9 in bf16) and a true division. Given the
same raw threefry key (two uint32 words), both versions here draw JAX's
bits (:mod:`...framework.prng`), so they drop what the JAX program drops.

The forward also returns the keep mask as bits: a ``uint8`` tensor of
``ceil(n / 8)`` bytes, bit ``e`` of byte ``j`` the element ``8j + e`` of
the flattened input, the tail of the last byte zero
(:func:`pack_keep_bits_plain`; 2 MiB at 16 x 256 x 4096). The backward
applies those bits, ``dx = bit ? g / kp : 0``, and draws nothing: the VJP
of ``where(mask, x / kp, 0)`` with the mask kept as its residual, as the
JAX program keeps it. The forward is bound by integer instruction issue on
the card (the threefry rounds), the backward by bytes; the source note in
``csrc/dropout.cu`` says more.

A key is two uint32 words given on the host (a tuple or array), or a
``(2,)`` int32 tensor holding their bits on the tensor's device: the
Session's compiled steps read each random op's key from a device buffer
they refill before every CUDA-graph replay. A CUDA forward with a tensor
key launches the kernels' device-key entry (``stf_dropout_key``, counted
as ``dropout_device_key``), which reads the words through a pointer; the
plain versions take either form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import prng
from . import _build
from .common import (DTYPE_CODES, check_cuda_arg, check_status,
                     count_launch, uses_kernel)

# elements a thread on the kernels' vector path
VEC = 8


def _kp(keep_prob: float, dtype) -> float:
    """``keep_prob`` rounded to ``dtype``, as ``jnp.asarray(keep_prob,
    dtype)``."""
    return float(torch.tensor(keep_prob, dtype=torch.float64).to(dtype))


def keep_bits_limit(keep_prob: float) -> int:
    """The kernels' integer keep test: for 32 random bits ``r``, JAX's
    ``bitcast(r >> 9 | 0x3F800000) - 1 < f32(keep_prob)`` holds exactly
    when ``r <= keep_bits_limit(keep_prob)``. The uniform is ``m *
    2**-23`` exactly for ``m = r >> 9``, so it is below ``p`` exactly when
    ``m < ceil(p * 2**23)``; ``p`` has 24 significant bits, so ``p *
    2**23`` is exact in a double. A ``keep_prob`` whose f32 is 0 keeps
    nothing, which no limit expresses: it is refused."""
    p = float(np.float32(keep_prob))
    if p <= 0.0:
        raise ValueError(f"keep_prob {keep_prob} is 0 in f32: no keep "
                         f"limit keeps nothing")
    return min(math.ceil(p * 2 ** 23), 2 ** 23) * 512 - 1


def keep_mask_plain(shape, keep_prob, key, device):
    """JAX's keep mask: the uniform draw from :func:`prng.uniform_torch`
    against the f32 ``keep_prob``."""
    u = prng.uniform_torch(key, shape, device)
    return u < torch.full((), np.float32(keep_prob), dtype=torch.float32,
                          device=device)


def _scaled(x, keep, keep_prob):
    """``where(keep, x / kp, 0)``, dividing by a device tensor (a
    Python-scalar divisor would become a product with its reciprocal on
    CUDA)."""
    kp = torch.full((), _kp(keep_prob, x.dtype), dtype=x.dtype,
                    device=x.device)
    return torch.where(keep, x / kp, torch.zeros_like(x))


def dropout_plain(x, keep_prob, key):
    """The op in PyTorch ops: ``where(u < keep_prob, x / kp, 0)``."""
    return _scaled(x, keep_mask_plain(x.shape, keep_prob, key, x.device),
                   keep_prob)


def pack_keep_bits_plain(keep):
    """A keep mask of any shape as the kernels' bit layout: ``uint8
    (ceil(n / 8),)``, bit ``e`` of byte ``j`` the flat element ``8j + e``,
    the last byte's tail zero."""
    flat = keep.reshape(-1)
    pad = -flat.numel() % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    # made on the device (no host copy, so a CUDA graph can capture it)
    weights = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.int32, device=keep.device),
        torch.arange(8, dtype=torch.int32, device=keep.device))
    return (flat.view(-1, 8).to(torch.int32) * weights).sum(
        dim=1, dtype=torch.int32).to(torch.uint8)


def unpack_keep_bits_plain(bits, shape):
    """The keep mask of ``shape`` that :func:`pack_keep_bits_plain`
    packed into ``bits``."""
    n = math.prod(shape)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    keep = (bits.to(torch.int32)[:, None] >> shifts) & 1
    return keep.reshape(-1)[:n].reshape(shape).bool()


def dropout_bwd_bits_plain(g, bits, keep_prob):
    """The backward from the saved bits: ``where(bit, g / kp, 0)``."""
    return _scaled(g, unpack_keep_bits_plain(bits, g.shape), keep_prob)


def vector_path(n: int, *tensors) -> bool:
    """Whether the kernels take ``n`` elements on their vector path (8 a
    thread): ``n`` a multiple of 8 no larger than ``2**32`` and every
    tensor's data 16-byte aligned. Else the general path, one element a
    thread (the C entry points refuse the vector path otherwise)."""
    return n % VEC == 0 and n <= 2 ** 32 and \
        all(t.data_ptr() % 16 == 0 for t in tensors)


def launch_fwd(x, keep_prob, key, vec):
    """One forward launch on a checked contiguous CUDA ``x``: the vector
    path or, with ``vec`` False, the general one; a tensor ``key`` (a
    checked ``(2,)`` int32 on ``x``'s device) through the device-key
    entry. Returns ``(out, bits)``."""
    n = x.numel()
    out = torch.empty_like(x)
    bits = torch.empty(-(-n // 8), dtype=torch.uint8, device=x.device)
    lib = _build.library()
    args = (keep_bits_limit(keep_prob), _kp(keep_prob, x.dtype), int(vec),
            DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    if isinstance(key, torch.Tensor):
        status = lib.stf_dropout_key(x.data_ptr(), out.data_ptr(),
                                     bits.data_ptr(), n, key.data_ptr(),
                                     *args)
        name = "dropout_device_key"
    else:
        k0, k1 = (int(w) for w in np.asarray(key, np.uint32))
        status = lib.stf_dropout(x.data_ptr(), out.data_ptr(),
                                 bits.data_ptr(), n, k0, k1, *args)
        name = "dropout"
    check_status(name, status)
    count_launch(name)
    return out, bits


def launch_bwd(g, bits, keep_prob, vec):
    """One backward launch on a checked contiguous CUDA ``g`` and the
    forward's ``bits``: the vector path or the general one."""
    out = torch.empty_like(g)
    status = _build.library().stf_dropout_bwd(
        g.data_ptr(), bits.data_ptr(), out.data_ptr(), g.numel(),
        _kp(keep_prob, g.dtype), int(vec), DTYPE_CODES[g.dtype],
        _build.stream_handle(g.device))
    check_status("dropout_bwd", status)
    count_launch("dropout_bwd")
    return out


def dropout_fwd(x, keep_prob, key, *, return_bits=False):
    """``where(u < keep_prob, x / kp, 0)`` for any contiguous shape, and
    with ``return_bits`` the keep bits beside it. CPU tensors take the
    plain versions, CUDA tensors launch the kernel of the path
    :func:`vector_path` picks, by the entry the key's form picks (module
    docstring)."""
    key_t = (key,) if isinstance(key, torch.Tensor) else ()
    if not uses_kernel(x, *key_t):
        keep = keep_mask_plain(x.shape, keep_prob, key, x.device)
        out = _scaled(x, keep, keep_prob)
        return (out, pack_keep_bits_plain(keep)) if return_bits else out
    check_cuda_arg("x", x, DTYPE_CODES, x.dim())
    if key_t:
        check_cuda_arg("key", key, (torch.int32,), 1)
        if key.numel() != 2 or key.device != x.device:
            raise ValueError(f"key must be (2,) on {x.device}, got "
                             f"{tuple(key.shape)} on {key.device}")
    out, bits = launch_fwd(x, keep_prob, key, vector_path(x.numel(), x))
    return (out, bits) if return_bits else out


def dropout_bwd(g, keep_prob, bits):
    """The backward from the forward's keep ``bits``: ``where(bit, g / kp,
    0)``, counted as ``dropout_bwd``. CPU tensors take
    :func:`dropout_bwd_bits_plain`."""
    if not uses_kernel(g, bits):
        return dropout_bwd_bits_plain(g, bits, keep_prob)
    check_cuda_arg("g", g, DTYPE_CODES, g.dim())
    check_cuda_arg("bits", bits, (torch.uint8,), 1)
    if bits.numel() != -(-g.numel() // 8):
        raise ValueError(f"bits ({bits.numel()},) must hold the "
                         f"{g.numel()} elements of g")
    return launch_bwd(g, bits, keep_prob, vector_path(g.numel(), g))


class DropoutFunction(torch.autograd.Function):
    """Forward and backward of :func:`dropout_fwd`: the forward saves the
    keep bits, the backward applies them and draws nothing.
    ``plain=True`` runs the plain versions of the same split on any
    device."""

    @staticmethod
    def forward(ctx, x, keep_prob, key, plain):
        ctx.args = (keep_prob, plain)
        if plain:
            keep = keep_mask_plain(x.shape, keep_prob, key, x.device)
            out, bits = _scaled(x, keep, keep_prob), \
                pack_keep_bits_plain(keep)
        else:
            out, bits = dropout_fwd(x.contiguous(), keep_prob, key,
                                    return_bits=True)
        ctx.save_for_backward(bits)
        return out

    @staticmethod
    def backward(ctx, g):
        keep_prob, plain = ctx.args
        (bits,) = ctx.saved_tensors
        if plain:
            return dropout_bwd_bits_plain(g, bits, keep_prob), None, None, \
                None
        return dropout_bwd(g.contiguous(), keep_prob, bits), None, None, None
