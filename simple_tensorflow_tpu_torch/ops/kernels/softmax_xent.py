"""Sparse softmax cross-entropy with label smoothing, forward and backward:
the CUDA kernels ``csrc/softmax_xent.cu`` and their plain PyTorch
versions.

Replaces the TPU kernels ``simple_tensorflow_tpu/ops/pallas/
softmax_xent.py:_fwd_kernel`` (called at :110) and ``_bwd_kernel`` (called
at :151), and the public ``softmax_cross_entropy`` (:170) with its custom
VJP. Smoothing follows the TPU kernel: soft targets ``q = low + (conf -
low) * onehot`` with ``conf = 1 - smoothing`` and ``low = smoothing / (V -
1)`` — not PyTorch's ``F.cross_entropy(label_smoothing=)`` convention.
Bounded by bytes on the card; the source note in ``csrc/softmax_xent.cu``
says what the design does about it.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (DTYPE_CODES, check_cuda_arg, check_status, count_launch,
                     uses_kernel)


# threads a block of the forward kernel (csrc/softmax_xent.cu kXeBlock)
FWD_BLOCK = 256


def fwd_threads_per_row(vocab, dtype):
    """Threads of the forward kernel a row of ``vocab`` logits of ``dtype``
    takes (csrc/softmax_xent.cu ``xent_fwd_threads``): a warp, one column a
    lane, up to 32 columns; past them one thread a 16-byte vector of the
    row, as a power of two from 8 to ``FWD_BLOCK``. Up to 32 a row is a
    group of a warp's lanes, above it warps of one block."""
    if vocab <= 32:
        return 32
    vecs = -(-vocab * (2 if dtype == torch.bfloat16 else 4) // 16)
    tpr = 8
    while tpr < FWD_BLOCK and tpr < vecs:
        tpr *= 2
    return tpr


def _constants(smoothing, vocab):
    """``(conf, low, conf - low)`` as the TPU kernel forms them: Python
    floats, each rounded to f32 where it meets the f32 math."""
    conf = 1.0 - smoothing
    low = smoothing / (vocab - 1) if vocab > 1 else 0.0
    return conf, low, conf - low


def softmax_xent_fwd_plain(logits, labels, *, smoothing=0.0):
    """``(loss, lse)`` (f32, ``(rows,)``) of ``_fwd_kernel`` for ``logits
    (rows, V)`` and int ``labels (rows,)``."""
    x = logits.float()
    vocab = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    lab = labels.long()
    ok = (lab >= 0) & (lab < vocab)
    xy = torch.where(ok, x.gather(-1, lab.clamp(0, vocab - 1)[:, None])[:, 0],
                     torch.zeros_like(lse))
    if smoothing > 0.0:
        conf, low, _ = _constants(smoothing, vocab)
        loss = lse - conf * xy - low * (x.sum(dim=-1) - xy)
    else:
        loss = lse - xy
    return loss, lse


def softmax_xent_bwd_plain(logits, labels, lse, g, *, smoothing=0.0):
    """``dx = (softmax - q) * g`` of ``_bwd_kernel``, in the logits'
    dtype."""
    x = logits.float()
    vocab = x.shape[-1]
    p = torch.exp(x - lse[:, None])
    cols = torch.arange(vocab, device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    if smoothing > 0.0:
        _, low, cml = _constants(smoothing, vocab)
        q = low + cml * onehot
    else:
        q = onehot
    return ((p - q) * g[:, None]).to(logits.dtype)


def _check(logits, labels):
    check_cuda_arg("logits", logits, DTYPE_CODES, 2)
    check_cuda_arg("labels", labels, (torch.int32,), 1)
    if labels.shape[0] != logits.shape[0]:
        raise ValueError(f"labels must be ({logits.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    return logits.shape


def softmax_xent_fwd(logits, labels, *, smoothing=0.0):
    """``(loss, lse)``; CPU tensors take the plain version, CUDA tensors
    launch the kernel (int32 labels)."""
    if not uses_kernel(logits, labels):
        return softmax_xent_fwd_plain(logits, labels, smoothing=smoothing)
    rows, vocab = _check(logits, labels)
    conf, low, _ = _constants(smoothing, vocab)
    loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lib = _build.library()
    status = lib.stf_softmax_xent_fwd(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), rows, vocab, conf, low, int(smoothing > 0.0),
        DTYPE_CODES[logits.dtype], _build.stream_handle(logits.device))
    check_status("softmax_xent_fwd", status)
    count_launch("softmax_xent_fwd")
    return loss, lse


def softmax_xent_bwd(logits, labels, lse, g, *, smoothing=0.0):
    """``dx``; CPU tensors take the plain version, CUDA tensors launch the
    kernel."""
    if not uses_kernel(logits, labels, lse, g):
        return softmax_xent_bwd_plain(logits, labels, lse, g,
                                      smoothing=smoothing)
    rows, vocab = _check(logits, labels)
    for name, t in (("lse", lse), ("g", g)):
        check_cuda_arg(name, t, (torch.float32,), 1)
        if t.shape[0] != rows:
            raise ValueError(f"{name} must be ({rows},), got "
                             f"{tuple(t.shape)}")
    _, low, cml = _constants(smoothing, vocab)
    dx = torch.empty_like(logits)
    lib = _build.library()
    status = lib.stf_softmax_xent_bwd(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), rows, vocab, low, cml, int(smoothing > 0.0),
        DTYPE_CODES[logits.dtype], _build.stream_handle(logits.device))
    check_status("softmax_xent_bwd", status)
    count_launch("softmax_xent_bwd")
    return dx


class SoftmaxXentFunction(torch.autograd.Function):
    """Per-row loss with the backward kernel as its gradient (the JAX
    ``_xent_2d`` custom VJP); labels get no gradient. ``plain=True`` runs
    the plain versions on any device (the reference the kernels are held
    against)."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, plain):
        fwd = softmax_xent_fwd_plain if plain else softmax_xent_fwd
        loss, lse = fwd(logits, labels, smoothing=smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        ctx.plain = plain
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        bwd = softmax_xent_bwd_plain if ctx.plain else softmax_xent_bwd
        dx = bwd(logits, labels, lse, g.contiguous(),
                 smoothing=ctx.smoothing)
        return dx, None, None, None


def softmax_cross_entropy(logits, labels, *, label_smoothing=0.0,
                          plain=False):
    """Per-example sparse softmax xent: ``logits (..., vocab)``, int
    ``labels (...)``; returns the f32 loss of shape ``(...)``. CPU tensors
    take the plain versions; CUDA tensors launch the kernels;
    ``plain=True`` runs the plain versions on any device."""
    vocab = logits.shape[-1]
    lead = logits.shape[:-1]
    l2 = logits.reshape(-1, vocab).contiguous()
    lab = labels.reshape(-1).to(torch.int32).contiguous()
    loss = SoftmaxXentFunction.apply(l2, lab, float(label_smoothing),
                                     bool(plain))
    return loss.reshape(lead)
