"""FlashAttention forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` and their plain PyTorch versions.

Replaces the TPU kernels ``simple_tensorflow_tpu/ops/pallas/
flash_attention.py:_fwd_kernel`` (called at :180), ``_bwd_dkdv_kernel``
(:352) and ``_bwd_dq_kernel`` (:383), and the public ``flash_attention``
(:470) with its custom VJP, dropout branch included. Layout ``(batch,
heads, seq, head_dim)``; an optional additive key bias ``(batch, kv_seq)``
(any squeezable ``(batch, 1, 1, kv_seq)`` form) is a constant under
differentiation. Ragged sequence lengths are masked inside the kernels;
nothing is padded.

Attention-probability dropout (``dropout_rate > 0`` with an int32
``dropout_seed``: a host int, or a one-element int32 tensor on the card,
which the kernels' seed-pointer entries read there, counted as
``flash_attention_*_device_seed``: what a CUDA graph replays) keeps the TPU kernels' order: the keep mask is K0, the
counter hash of (seed, salt = flattened head ``b * H + h``, global query
row, global key column), so it does not depend on tiling and the backward
regenerates it; the softmax denominator sums the undropped ``p``, only the
``p`` of ``P.V`` (and of ``dV``) is ``where(keep, p * f32(1/kp), 0)``,
``dP`` is dropped the same way, and ``dS = p * (dP - delta) * sm_scale``
with the undropped ``p``.

The kernel-level functions work on ``(B*H, S, D)``-contiguous tensors:
``flash_attention_fwd`` -> ``(o, lse)``, ``flash_attention_dkdv`` ->
``(dk, dv)``, ``flash_attention_dq`` -> ``dq``, each beside its
``*_plain`` version. ``delta = rowsum(dO * O)`` (minus the lse cotangent)
is plain PyTorch, as it sits outside Pallas in JAX. bf16 runs on tensor
cores: the forward in ``csrc/flash_fwd_mma.cu``, dK/dV and dQ in
``csrc/flash_bwd_mma.cu``; f32 runs the CUDA-core kernels of
``csrc/flash_attention.cu``. The source notes of the three files say what
bounds each kernel and what its design does about it.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .common import (DTYPE_CODES, NEG_INF, check_cuda_arg, check_status,
                     count_launch, counter_keep_mask_plain, device_seed,
                     keep_threshold, scale_kept, seed_word, uses_kernel)

HEAD_DIMS = (16, 32, 64, 128)


def _scores(q, k, bias, heads, sm_scale, causal):
    """f32 masked scores ``(BH, Sq, Sk)``: scale, the bias BEFORE the
    mask, then NEG_INF where the causal mask refuses (the kernels'
    ``masked_score``)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    sq, sk = s.shape[1], s.shape[2]
    if bias is not None:
        s = s + bias.float().repeat_interleave(heads, dim=0)[:, None, :]
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _dropped(t, keep, dropout_rate):
    """The kernels' dropped ``t`` (f32), or ``t`` itself without
    dropout."""
    return t if keep is None else scale_kept(t, keep, 1.0 - dropout_rate)


def keep_mask_plain(bh, sq, sk, dropout_rate, dropout_seed, device):
    """The ``(BH, Sq, Sk)`` keep mask of the kernels, or None at rate 0."""
    if dropout_rate == 0.0:
        return None
    idx = [torch.arange(n, dtype=torch.int64, device=device)
           for n in (bh, sq, sk)]
    return counter_keep_mask_plain(
        seed_word(dropout_seed), idx[0][:, None, None], idx[1][None, :, None],
        idx[2][None, None, :], 1.0 - dropout_rate)


def keep_mask_readoff(bwd, bh, s, d, dtype, device):
    """The dropout masks a backward applied, read off its outputs: ``(from
    dV, from dK, from dQ)``, each ``(bh, s, s)`` bool over (query, key),
    True where the pair was live and kept. ``bwd(q, k, v, dout, lse,
    delta)`` returns ``(dk, dv, dq)`` for ``(bh, s, d)`` inputs (causal or
    not, dropout on, ``d`` the head dim). With lse = delta = 0 and a zero
    q (dV, dQ) or k (dK) every live p is 1; per block of ``d`` rows:
    dO one-hot over the block's queries makes ``dV[key, i]`` the dropped
    p of (query blk*d + i, key); with every row of dO and V e0 (dP = 1), Q
    one-hot over the block makes ``dK[key, i]`` the dS of (blk*d + i,
    key) and K one-hot over the block's keys makes ``dQ[query, i]`` the
    dS of (query, blk*d + i). So each nonzero element is one live, kept
    pair."""
    zeros = torch.zeros((bh, s, d), dtype=dtype, device=device)
    e0 = zeros.clone()
    e0[..., 0] = 1
    stats = torch.zeros((bh, s), dtype=torch.float32, device=device)
    parts = ([], [], [])
    for blk in range(-(-s // d)):
        rows = torch.arange(s, device=device)[:, None] - blk * d
        onehot = (rows == torch.arange(d, device=device)[None, :]).to(
            dtype).expand(bh, s, d).contiguous()
        dv = bwd(zeros, e0, e0, onehot, stats, stats)[1]
        dk = bwd(onehot, zeros, e0, e0, stats, stats)[0]
        dq = bwd(zeros, onehot, e0, e0, stats, stats)[2]
        parts[0].append(dv.transpose(1, 2) != 0)
        parts[1].append(dk.transpose(1, 2) != 0)
        parts[2].append(dq != 0)
    return (torch.cat(parts[0], dim=1)[:, :s],
            torch.cat(parts[1], dim=1)[:, :s],
            torch.cat(parts[2], dim=2)[:, :, :s])


def flash_attention_fwd_plain(q, k, v, *, heads, sm_scale, causal,
                              bias=None, dropout_rate=0.0,
                              dropout_seed=None):
    """``(o, lse)`` of ``_fwd_kernel`` with a materialised score tensor:
    ``q (BH, Sq, D)``, ``k``/``v (BH, Sk, D)``, ``bias (B, Sk)`` f32 or
    None with ``B = BH / heads``. ``l`` sums the undropped ``p``; the
    (dropped) ``p`` is cast to the input dtype before ``P.V``; ``l == 0
    -> 1``; lse is f32."""
    s = _scores(q, k, bias, heads, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    keep = keep_mask_plain(*s.shape, dropout_rate, dropout_seed, q.device)
    p = _dropped(p, keep, dropout_rate)
    acc = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float())
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def _p_ds(q, k, v, dout, lse, delta, heads, sm_scale, causal, bias,
          dropout_rate, dropout_seed):
    """The (dropped) ``p`` of ``dV`` and ``dS`` of the backward kernels."""
    s = _scores(q, k, bias, heads, sm_scale, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    keep = keep_mask_plain(*s.shape, dropout_rate, dropout_seed, q.device)
    dp = _dropped(dp, keep, dropout_rate)
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype)
    return _dropped(p, keep, dropout_rate), ds


def flash_attention_dkdv_plain(q, k, v, dout, lse, delta, *, heads,
                               sm_scale, causal, bias=None, dropout_rate=0.0,
                               dropout_seed=None):
    """``(dk, dv)`` of ``_bwd_dkdv_kernel``: ``p = exp(s - lse)``,
    ``dV = p_dropped(cast)^T dO``, ``dS = (p (dP_dropped - delta)
    sm_scale)(cast)``, ``dK = dS^T Q``, summed in f32, in the inputs'
    dtype."""
    p, ds = _p_ds(q, k, v, dout, lse, delta, heads, sm_scale, causal, bias,
                  dropout_rate, dropout_seed)
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(), dout.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(q, k, v, dout, lse, delta, *, heads, sm_scale,
                             causal, bias=None, dropout_rate=0.0,
                             dropout_seed=None):
    """``dq`` of ``_bwd_dq_kernel``: ``dQ = dS K`` summed in f32."""
    _, ds = _p_ds(q, k, v, dout, lse, delta, heads, sm_scale, causal, bias,
                  dropout_rate, dropout_seed)
    return torch.einsum("bqk,bkd->bqd", ds.float(), k.float()).to(q.dtype)


def _check(q, k, v, bias, heads, extra=()):
    check_cuda_arg("q", q, DTYPE_CODES, 3)
    check_cuda_arg("k", k, (q.dtype,), 3)
    check_cuda_arg("v", v, (q.dtype,), 3)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (bh, sk, d) or tuple(v.shape) != (bh, sk, d):
        raise ValueError(f"k/v must be {(bh, sk, d)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if bh % heads:
        raise ValueError(f"B*H={bh} is not a multiple of heads={heads}")
    if bias is not None:
        check_cuda_arg("bias", bias, (torch.float32,), 2)
        if tuple(bias.shape) != (bh // heads, sk):
            raise ValueError(f"bias must be {(bh // heads, sk)}, got "
                             f"{tuple(bias.shape)}")
    for name, t, dtypes, shape in extra:
        check_cuda_arg(name, t, dtypes, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return bh, sq, sk, d


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _drop_args(dropout_rate, dropout_seed, device):
    """The kernels' dropout arguments and the entry to launch: ``(entry
    suffix, (on, seed word, keep threshold, f32(1/keep_prob)))``, or, for
    a seed tensor (:func:`.common.seed_word`), the seed-pointer entry
    ``_seed_ptr`` with ``(seed pointer, threshold, f32(1/keep_prob))``."""
    if dropout_rate == 0.0:
        return "", (0, 0, 0, 1.0)
    if dropout_seed is None:
        raise ValueError("flash attention dropout needs dropout_seed")
    keep_prob = 1.0 - dropout_rate
    seed = seed_word(dropout_seed)
    if device_seed(seed, device):
        return "_seed_ptr", (seed.data_ptr(), keep_threshold(keep_prob),
                             1.0 / keep_prob)
    return "", (1, seed, keep_threshold(keep_prob), 1.0 / keep_prob)


def _entry(name, suffix, status_args):
    """Launch the C entry ``stf_{name}{suffix}`` and count it
    (``{name}_device_seed`` for the seed-pointer entry)."""
    status = getattr(_build.library(), f"stf_{name}{suffix}")(*status_args)
    check_status(name + suffix, status)
    count_launch(name + ("_device_seed" if suffix else ""))


def flash_attention_fwd(q, k, v, *, heads, sm_scale, causal, bias=None,
                        dropout_rate=0.0, dropout_seed=None):
    """``(o, lse)`` for ``q (BH, Sq, D)``, ``k``/``v (BH, Sk, D)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    if not uses_kernel(*tensors):
        return flash_attention_fwd_plain(q, k, v, heads=heads,
                                         sm_scale=sm_scale, causal=causal,
                                         bias=bias, dropout_rate=dropout_rate,
                                         dropout_seed=dropout_seed)
    bh, sq, sk, d = _check(q, k, v, bias, heads)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    suffix, drop = _drop_args(dropout_rate, dropout_seed, q.device)
    _entry("flash_attention_fwd", suffix, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(),
        lse.data_ptr(), bh, sq, sk, heads, d, float(sm_scale),
        int(bool(causal)), *drop, DTYPE_CODES[q.dtype],
        _build.stream_handle(q.device)))
    return o, lse


def _bwd_extra(q, dout, lse, delta):
    bh, sq, d = q.shape
    return (("dout", dout, (q.dtype,), (bh, sq, d)),
            ("lse", lse, (torch.float32,), (bh, sq)),
            ("delta", delta, (torch.float32,), (bh, sq)))


def flash_attention_dkdv(q, k, v, dout, lse, delta, *, heads, sm_scale,
                         causal, bias=None, dropout_rate=0.0,
                         dropout_seed=None):
    """``(dk, dv)``; CPU tensors take the plain version, CUDA tensors
    launch the kernel."""
    tensors = [q, k, v, dout, lse, delta] + (
        [bias] if bias is not None else [])
    if not uses_kernel(*tensors):
        return flash_attention_dkdv_plain(
            q, k, v, dout, lse, delta, heads=heads, sm_scale=sm_scale,
            causal=causal, bias=bias, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed)
    bh, sq, sk, d = _check(q, k, v, bias, heads,
                           _bwd_extra(q, dout, lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    suffix, drop = _drop_args(dropout_rate, dropout_seed, q.device)
    _entry("flash_attention_dkdv", suffix, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(bias), dk.data_ptr(),
        dv.data_ptr(), bh, sq, sk, heads, d, float(sm_scale),
        int(bool(causal)), *drop, DTYPE_CODES[q.dtype],
        _build.stream_handle(q.device)))
    return dk, dv


def flash_attention_dq(q, k, v, dout, lse, delta, *, heads, sm_scale,
                       causal, bias=None, dropout_rate=0.0,
                       dropout_seed=None):
    """``dq``; CPU tensors take the plain version, CUDA tensors launch the
    kernel."""
    tensors = [q, k, v, dout, lse, delta] + (
        [bias] if bias is not None else [])
    if not uses_kernel(*tensors):
        return flash_attention_dq_plain(
            q, k, v, dout, lse, delta, heads=heads, sm_scale=sm_scale,
            causal=causal, bias=bias, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed)
    bh, sq, sk, d = _check(q, k, v, bias, heads,
                           _bwd_extra(q, dout, lse, delta))
    dq = torch.empty_like(q)
    suffix, drop = _drop_args(dropout_rate, dropout_seed, q.device)
    _entry("flash_attention_dq", suffix, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(bias), dq.data_ptr(), bh, sq,
        sk, heads, d, float(sm_scale), int(bool(causal)), *drop,
        DTYPE_CODES[q.dtype], _build.stream_handle(q.device)))
    return dq


class FlashAttentionFunction(torch.autograd.Function):
    """``(o, lse)`` over ``(BH, S, D)`` with the two backward kernels as
    its gradient (the JAX ``_flash_bhsd_lse`` custom VJP): the lse
    cotangent folds into ``delta = rowsum(dO * O) - dlse`` (O the dropped
    output). The bias gets no gradient; the dropout mask is regenerated
    from the seed. ``plain=True`` runs the plain versions of the three
    kernels on any device (the reference the kernels are held against)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, sm_scale, causal, dropout_rate,
                dropout_seed, plain):
        fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
        ctx.args = dict(heads=heads, sm_scale=sm_scale, causal=causal,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        o, lse = fwd(q, k, v, bias=bias, **ctx.args)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        dkdv = flash_attention_dkdv_plain if ctx.plain else \
            flash_attention_dkdv
        dqf = flash_attention_dq_plain if ctx.plain else flash_attention_dq
        dk, dv = dkdv(q, k, v, do, lse, delta, bias=bias, **ctx.args)
        dq = dqf(q, k, v, do, lse, delta, bias=bias, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def _key_bias(bias, b, kv_len):
    """Squeeze a broadcast key bias to ``(batch, kv_seq)`` f32 (as the
    JAX wrapper does at :521-540)."""
    bb = bias.float()
    while bb.dim() > 2:
        sq = next((i for i in range(1, bb.dim() - 1) if bb.shape[i] == 1),
                  None)
        if sq is None:
            raise NotImplementedError(
                "flash attention bias must broadcast over heads and query "
                f"positions (got shape {tuple(bias.shape)})")
        bb = bb.squeeze(sq)
    if tuple(bb.shape) != (b, kv_len):
        raise ValueError(f"flash attention bias: expected (batch, kv_seq)="
                         f"({b}, {kv_len}) after squeezing, got "
                         f"{tuple(bb.shape)}")
    return bb.detach().contiguous()


def flash_attention(q, k, v, *, causal=False, sm_scale=None, bias=None,
                    dropout_rate=0.0, dropout_seed=None, return_lse=False,
                    plain=False):
    """Fused attention over ``(batch, heads, seq, head_dim)``; the kv seq
    may differ from the q seq unless ``causal``. Returns ``(batch, heads,
    q_seq, head_dim)`` in q's dtype, and with ``return_lse`` also the f32
    ``(batch, heads, q_seq)`` log-sum-exp (differentiable). Gradients run
    the backward kernels. ``dropout_rate > 0`` needs an int32
    ``dropout_seed`` (module docstring). CPU tensors take the plain
    versions; CUDA tensors launch the kernels; ``plain=True`` runs the
    plain versions on any device."""
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if causal and q_len != kv_len:
        raise ValueError("causal flash attention needs q_len == kv_len")
    if dropout_rate < 0.0 or dropout_rate >= 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1): {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("flash attention dropout needs dropout_seed")
    seed = seed_word(dropout_seed) if dropout_rate > 0.0 else None
    bb = _key_bias(bias, b, kv_len) if bias is not None else None
    o, lse = FlashAttentionFunction.apply(
        q.reshape(b * h, q_len, d).contiguous(),
        k.reshape(b * h, kv_len, d).contiguous(),
        v.reshape(b * h, kv_len, d).contiguous(), bb, h, float(sm_scale),
        bool(causal), float(dropout_rate), seed, bool(plain))
    o = o.reshape(b, h, q_len, d)
    if return_lse:
        return o, lse.reshape(b, h, q_len)
    return o
