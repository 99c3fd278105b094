"""Decode attention over a gathered paged cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Replaces the TPU kernels ``simple_tensorflow_tpu/ops/pallas/
decode_attention.py:_decode_kernel`` (:57, one query per sequence) and
``_decode_block_kernel`` (:108, a query block, the page-block prefill).
The contract is the JAX one: ``q (B, H, D)`` or ``(B, Kq, H, D)``,
``k_cache``/``v_cache (B, L, H, D)`` — the logical view that
:meth:`..kv_cache.KVCache.gather` builds — ``lengths (B,)`` int32, an
optional additive ``bias (B, L)`` f32. Positions ``>= lengths[b]`` are
masked; with ``causal_offset`` query ``j`` sees ``< lengths[b] + j + 1``.
Bounded by bytes on the card; ``csrc/decode_attention.cu`` says what its
design does about it. The one-query kernel (the serving decode step) gives
a (b, h) a block of 8 warps, each its own slice of the cache, merged once
in shared memory; where ``B * H`` blocks leave SMs idle it also splits the
cache axis over blocks (:func:`one_split_len`) and merges the splits in a
second pass. The query-block kernel splits the cache axis into chunks of
``SPLIT_L`` positions, one block each, and merges the chunks' partial
softmax sums in a second pass. The wrapper allocates the f32 workspace of
the partials (:func:`split_workspace_floats`); one count a call either
way.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .common import (DTYPE_CODES, NEG_INF, cdiv, check_cuda_arg,
                     check_status, count_launch, round_up, uses_kernel)

MAX_KQ = 64
MAX_HEAD_DIM = 256
# cache positions a block of the query-block kernel (csrc kSplitL)
SPLIT_L = 32
# the Kq = 1 kernel splits the cache axis over blocks only while B * H
# blocks leave SMs idle, into chunks of a multiple of this many positions
# (one step of its 8 warps at f32 D = 64)
ONE_MIN_SPLIT = 64


def one_split_len(b, h, L, sms):
    """Cache positions one block of the Kq = 1 kernel walks: all of ``L``
    (one block per (b, h)) when ``b * h`` blocks fill the ``sms`` SMs;
    else ``L`` cut into about ``sms / (b * h)`` splits of a multiple of
    ``ONE_MIN_SPLIT`` positions, one block each, merged in a second
    pass."""
    blocks = b * h
    splits = min(cdiv(sms, blocks), cdiv(L, ONE_MIN_SPLIT))
    if blocks >= sms or splits <= 1:
        return L
    return round_up(cdiv(L, splits), ONE_MIN_SPLIT)


def split_workspace_floats(b, kq, L, h, d, split_l=SPLIT_L):
    """f32 elements of the split kernels' partials: per (b, h, chunk of
    ``split_l`` positions, query) the accumulator (``d`` rounded up to 4)
    and (m, l); 0 when one chunk covers ``L`` at ``kq == 1`` (the Kq = 1
    kernel then writes its output directly)."""
    chunks = cdiv(L, split_l)
    if kq == 1 and chunks == 1:
        return 0
    return b * h * chunks * kq * (round_up(d, 4) + 2)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_plain(q, k_cache, v_cache, lengths, *, bias=None,
                           sm_scale=None, causal_offset=False):
    """The kernel's function, written out with a materialised f32 score
    tensor: bias before the mask, NEG_INF masking, max-subtracted
    softmax whose sum is guarded to 1 when 0. A query with no live
    position returns zeros, as the kernel (and the TPU kernel) do."""
    single = q.dim() == 3
    q4 = q.unsqueeze(1) if single else q
    b, kq, h, d = q4.shape
    L = k_cache.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,blhd->bqhl", q4.float(),
                     k_cache.float()) * sm_scale
    if bias is not None:
        s = s + bias.float().reshape(b, 1, 1, L)
    allowed = lengths.to(torch.int64).reshape(b, 1, 1, 1)
    if causal_offset:
        allowed = allowed + 1 + torch.arange(
            kq, device=q.device).reshape(1, kq, 1, 1)
    span = torch.arange(L, device=q.device).reshape(1, 1, 1, L)
    s = torch.where(span < allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (allowed > 0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (torch.einsum("bqhl,blhd->bqhd", p, v_cache.float()) / l).to(q.dtype)
    return o[:, 0] if single else o


def decode_attention(q, k_cache, v_cache, lengths, *, bias=None,
                     sm_scale=None, causal_offset=False):
    """One-position (``q (B, H, D)``) or query-block (``q (B, Kq, H, D)``)
    attention against a gathered cache (module docstring). Returns q's
    shape in q's dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    tensors = [q, k_cache, v_cache, lengths]
    if bias is not None:
        tensors.append(bias)
    if not uses_kernel(*tensors):
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      bias=bias, sm_scale=sm_scale,
                                      causal_offset=causal_offset)
    single = q.dim() == 3
    q4 = q.unsqueeze(1) if single else q
    check_cuda_arg("q", q4, DTYPE_CODES, 4)
    check_cuda_arg("k_cache", k_cache, (q.dtype,), 4)
    check_cuda_arg("v_cache", v_cache, (q.dtype,), 4)
    check_cuda_arg("lengths", lengths, (torch.int32,), 1)
    b, kq, h, d = q4.shape
    L = k_cache.shape[1]
    if tuple(k_cache.shape) != (b, L, h, d) or \
            tuple(v_cache.shape) != (b, L, h, d):
        raise ValueError(f"k/v cache must be {(b, L, h, d)}, got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if lengths.shape[0] != b:
        raise ValueError(f"lengths must be ({b},), got "
                         f"{tuple(lengths.shape)}")
    if not 1 <= kq <= MAX_KQ or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes Kq <= {MAX_KQ} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got Kq={kq}, head_dim={d}")
    if bias is not None:
        bias = bias.reshape(b, L)
        check_cuda_arg("bias", bias, (torch.float32,), 2)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q4)
    split_l = (one_split_len(b, h, L, _sm_count(q4.device.index))
               if single else SPLIT_L)
    n_ws = split_workspace_floats(b, kq, L, h, d, split_l)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=q4.device)
          if n_ws else None)
    lib = _build.library()
    status = lib.stf_decode_attention(
        q4.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), ws.data_ptr() if ws is not None else None, b, kq, L,
        h, d, float(sm_scale), int(bool(causal_offset)), split_l,
        DTYPE_CODES[q4.dtype], _build.stream_handle(q4.device))
    check_status("decode_attention", status)
    count_launch("decode_attention" if single else "decode_attention_block")
    return out[:, 0] if single else out
