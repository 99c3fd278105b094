"""Fused Adam and Momentum over one flat parameter group: the CUDA
kernels ``csrc/fused_update.cu`` and their plain PyTorch versions.

Replace the TPU kernels ``simple_tensorflow_tpu/ops/pallas/
fused_update.py:_adam_kernel`` (called at :96) and ``_momentum_kernel``
(called at :159). Inputs are 1-D flat vectors: ``p`` and ``g`` in the
parameter dtype (f32 or bf16), the slots (``m``/``v``, ``acc``) in the
update dtype (f32), the hyperparameters (``alpha``; ``lr``, ``mu``) f32
device scalars. Unlike the JAX functions, which return new arrays, both
versions update ``p`` and the slots IN PLACE (the port's optimizers keep
parameters as views into the flat ``p``) and return them. Bounded by bytes
on the card; the source note in ``csrc/fused_update.cu`` says what the
design does about it.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (DTYPE_CODES, check_cuda_arg, check_status, count_launch,
                     uses_kernel)


def adam_update_plain(p, m, v, g, alpha, *, beta1, beta2, eps):
    """The kernel's arithmetic in PyTorch ops, in ``_adam_kernel``'s
    order, each step one rounded f32 operation; constants are f32 tensors
    (a Python-scalar divisor would become a product with its reciprocal
    on CUDA). The square root is the correctly rounded one (taken in f64,
    then rounded), as the kernel's ``__fsqrt_rn`` and XLA's: PyTorch's CPU
    f32 ``torch.sqrt`` is not (torch 2.13; ``tests/host_spread.py``
    counts the inputs it rounds 1 ulp off)."""
    ud = m.dtype
    # filled on the device (no host copy: the call may be graph-captured)
    b1, b2, e = (torch.full((), c, dtype=ud, device=m.device)
                 for c in (beta1, beta2, eps))
    gu = g.to(ud)
    new_m = b1 * m + (1 - b1) * gu
    new_v = b2 * v + (1 - b2) * (gu * gu)
    root = torch.sqrt(new_v.double()).to(ud)
    upd = alpha.to(ud) * new_m / (root + e)
    p.copy_(p - upd.to(p.dtype))
    m.copy_(new_m)
    v.copy_(new_v)
    return p, m, v


def adam_update(p, m, v, g, alpha, *, beta1, beta2, eps):
    """Adam over a flat group, in place (module docstring). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if not uses_kernel(p, m, v, g, alpha):
        return adam_update_plain(p, m, v, g, alpha, beta1=beta1, beta2=beta2,
                                 eps=eps)
    check_cuda_arg("p", p, DTYPE_CODES, 1)
    check_cuda_arg("g", g, (p.dtype,), 1)
    check_cuda_arg("m", m, (torch.float32,), 1)
    check_cuda_arg("v", v, (torch.float32,), 1)
    check_cuda_arg("alpha", alpha, (torch.float32,), 0)
    n = p.shape[0]
    if g.shape[0] != n or m.shape[0] != n or v.shape[0] != n:
        raise ValueError(f"adam_update: p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                         f"{tuple(v.shape)} differ")
    lib = _build.library()
    status = lib.stf_adam_update(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
        alpha.data_ptr(), n, float(beta1), float(beta2), float(eps),
        DTYPE_CODES[p.dtype], _build.stream_handle(p.device))
    check_status("adam_update", status)
    count_launch("adam_update")
    return p, m, v


def momentum_update_plain(p, acc, g, lr, mu, *, use_nesterov=False):
    """The kernel's arithmetic in PyTorch ops, in ``_momentum_kernel``'s
    order, each step one rounded f32 operation."""
    ud = acc.dtype
    gu, lr_u, mu_u = g.to(ud), lr.to(ud), mu.to(ud)
    new_acc = mu_u * acc + gu
    if use_nesterov:
        upd = lr_u * (gu + mu_u * new_acc)
    else:
        upd = lr_u * new_acc
    p.copy_(p - upd.to(p.dtype))
    acc.copy_(new_acc)
    return p, acc


def momentum_update(p, acc, g, lr, mu, *, use_nesterov=False):
    """Momentum (or Nesterov) over a flat group, in place (module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if not uses_kernel(p, acc, g, lr, mu):
        return momentum_update_plain(p, acc, g, lr, mu,
                                     use_nesterov=use_nesterov)
    check_cuda_arg("p", p, DTYPE_CODES, 1)
    check_cuda_arg("g", g, (p.dtype,), 1)
    check_cuda_arg("acc", acc, (torch.float32,), 1)
    check_cuda_arg("lr", lr, (torch.float32,), 0)
    check_cuda_arg("mu", mu, (torch.float32,), 0)
    n = p.shape[0]
    if g.shape[0] != n or acc.shape[0] != n:
        raise ValueError(f"momentum_update: p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, acc {tuple(acc.shape)} differ")
    lib = _build.library()
    status = lib.stf_momentum_update(
        p.data_ptr(), acc.data_ptr(), g.data_ptr(), lr.data_ptr(),
        mu.data_ptr(), n, int(bool(use_nesterov)), DTYPE_CODES[p.dtype],
        _build.stream_handle(p.device))
    check_status("momentum_update", status)
    count_launch("momentum_update")
    count_launch("momentum_update_" + str(p.dtype)[len("torch."):])
    return p, acc
