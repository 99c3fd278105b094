"""The Transformer of ``simple_tensorflow_tpu/models/transformer.py``:
the seq2seq training graph, the eager encoder-decoder and its serving
model, and the decoder-only eager pieces of causal-LM serving and
training.

**The training graph** (TF-1 front end), the JAX file's ``_init``,
``_ln``, ``_dense`` (:63-72), ``_residual`` (:142), ``_attention`` (:152),
``_ffn`` (:181), ``_embed`` (:189), ``_pad_bias`` (:206), ``encode``,
``decode``, ``smoothed_xent`` (:263) and ``transformer_train_model``
(:282), the beam search (``_BeamCaches`` :348, ``_decode_cross_kv`` :416,
the graph ``_incremental_decode`` :438 with cross-attention and
``beam_search_decode`` :584, naive and KV-cached on DecodeAttention, one
``stf.while_loop``), ``synthetic_wmt_batch`` (:1407) and
``transformer_flops_per_token`` (:1417): the same user code builds the
same graph op for op (names, types, inputs, seeds) and the same variables
(``transformer/encoder/layer_0/self_attn/q/kernel``, …; Dense variables
in the compute dtype, the embedding and the LayerNorm parameters f32),
trained by ``stf.Session``. ``recompute=True`` puts every layer under
``stf.recompute_grad`` (``common.maybe_recompute``);
``transformer_train_model(recompute="auto")`` resolves it from the static
cost model against the attached device (``framework/cost_model.py``).
Not ported: ``data_parallel=True``; it raises ``NotImplementedError``.

**The eager pieces**: ``TransformerConfig`` (:35),
``sinusoidal_position_encoding`` (:131), ``incremental_decode`` (the
JAX ``_incremental_decode`` :438) and ``block_decode`` (:512), whose
``cross_kv, cross_bias, cross_len`` add the cross-attention sublayer and
its ``ln2`` (``None``: the decoder-only step), ``build_int8_logits_weights``
(:743), and the causal-LM training sublayers. Where a private name of the
JAX file is both, the graph function keeps it and the eager sublayer is
``_eager_residual``, ``_eager_attention``, ``_eager_ffn``,
``_eager_embed``, ``_eager_encode`` (``encode`` :214 at eval, with
``_pad_bias`` :207) or ``_eager_decode_cross_kv`` (:416);
``smoothed_xent`` takes either (it builds graph ops for graph tensors).
``_ln`` is :class:`.common.LayerNorm` in the eager models.

**Serving** (JAX :770-1405): :class:`TransformerGenerativeModel` on slot
caches (:class:`..ops.kv_cache.SlotKVCache`, ``_SlotCaches`` :373),
with the speculative verify and draft programs, ``generative_cache_bytes``
(:1047), and :func:`seq2seq_hidden_plain` / :func:`seq2seq_logits_plain`,
the plain full re-forward the engine's tokens are checked against (on
neither path).

In eager training with ``cfg.dropout > 0`` the sublayers drop as the JAX
graph does, each random op drawing from a per-step
:class:`..framework.random_seed.StepRNG` under its JAX op name (``scope``
is the op's variable scope): the embedding and the FFN activation through
``nn_ops._dropout_impl`` (threefry keys), the attention probabilities
inside the flash kernels and the attention tail through the fused
dropout-residual kernel (int32 seeds of the counter-hash mask).

A :class:`DecoderStack`'s (and a :class:`Seq2SeqStack`'s) ``state_dict``
keys are the JAX variable paths under the model scope with ``.`` for
``/`` (``shared_embedding``, ``decoder.layer_0.self_attn.q.kernel``,
``encoder.layer_0.ln2.gamma``, …); :mod:`..convert` maps between the
two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

import simple_tensorflow_tpu_torch as stf

from ..framework import graph as ops_mod
from ..layers.core import DenseModule
from ..ops import fused_ops, nn_ops
from ..ops.embedding_ops import embedding_lookup
from ..ops.kernels.common import NEG_INF
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.layer_norm import layer_norm_plain
from ..ops.kernels.quant_matmul import (div127, quant_matmul,
                                        quant_matmul_plain)
from ..ops.kv_cache import SlotKVCache
from . import common
from .common import (BucketProgram, LayerNorm, greedy_emit, merge_heads,
                     split_heads)


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    num_heads: int = 16
    d_ff: int = 4096
    num_layers: int = 6
    dropout: float = 0.1
    label_smoothing: float = 0.1
    max_len: int = 256
    layer_norm_eps: float = 1e-6
    pad_id: int = 0
    eos_id: int = 1

    @staticmethod
    def big():
        return TransformerConfig()

    @staticmethod
    def base():
        return TransformerConfig(d_model=512, num_heads=8, d_ff=2048)

    @staticmethod
    def tiny():
        return TransformerConfig(vocab_size=64, d_model=32, num_heads=2,
                                 d_ff=64, num_layers=2, dropout=0.0,
                                 max_len=32)


def sinusoidal_position_encoding(max_len, d_model):
    """Classic sin/cos table as a numpy constant (host-computed once)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(d_model // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2.0 * dim / d_model)
    enc = np.zeros((max_len, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


def _attention_denses(d, dtype, device):
    return nn.ModuleDict({name: DenseModule(d, d, dtype=dtype, device=device)
                          for name in ("q", "k", "v", "out")})


def _ffn_denses(cfg: TransformerConfig, dtype, device):
    return nn.ModuleDict({
        "in": DenseModule(cfg.d_model, cfg.d_ff, activation=torch.relu,
                          dtype=dtype, device=device),
        "out": DenseModule(cfg.d_ff, cfg.d_model, dtype=dtype,
                           device=device)})


class EncoderLayer(nn.Module):
    """Self-attention (q, k, v, out), ``ln1``, FFN (in with ReLU, out),
    ``ln2``: the encoder layer, named as in the JAX graph."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _attention_denses(d, dtype, device)
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.ffn = _ffn_denses(cfg, dtype, device)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps, device=device)


class DecoderLayer(nn.Module):
    """Self-attention (q, k, v, out), ``ln1``, with ``cross`` the
    cross-attention (q, k, v, out) and ``ln2``, then FFN (in with ReLU,
    out), ``ln3`` — named as in the JAX graph; without ``cross`` the
    causal-LM layer. ``dtype`` is the Dense parameters' dtype (the compute
    dtype); the LayerNorm parameters stay f32."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None, cross=False):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _attention_denses(d, dtype, device)
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, device=device)
        if cross:
            self.cross_attn = _attention_denses(d, dtype, device)
            self.ln2 = LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.ffn = _ffn_denses(cfg, dtype, device)
        self.ln3 = LayerNorm(d, cfg.layer_norm_eps, device=device)


class DecoderStack(nn.Module):
    """The tied embedding (f32), the sinusoidal position table and the
    decoder layers of one causal LM (``cross=True``: the encoder-decoder's
    decoder, see :class:`Seq2SeqStack`); ``dtype`` as in
    :class:`DecoderLayer`, kept as :attr:`compute_dtype`."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None, cross=False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.shared_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.d_model, device=device))
        self.decoder = nn.ModuleDict(
            {f"layer_{i}": DecoderLayer(cfg, dtype=dtype, device=device,
                                        cross=cross)
             for i in range(cfg.num_layers)})
        # one row of NaN past the table: what the JAX gather (jnp.take)
        # reads at an out-of-bounds position
        table = np.concatenate([
            sinusoidal_position_encoding(cfg.max_len, cfg.d_model),
            np.full((1, cfg.d_model), np.nan, np.float32)])
        self.register_buffer("pos_table", torch.from_numpy(table).to(device),
                             persistent=False)
        self.register_buffer(
            "emb_scale", torch.tensor(math.sqrt(cfg.d_model),
                                      dtype=torch.float32, device=device),
            persistent=False)

    @property
    def layers(self):
        return list(self.decoder.values())

    def embed(self, tok, positions):
        """Scaled embedding rows plus position encodings in the compute
        dtype (f32: the JAX f32 step's values; else the lookup, the scale
        and the position rows each cast to it, as the JAX step casts them).
        A position at or past ``cfg.max_len`` reads NaN, as the JAX gather
        does there."""
        rows = self.pos_table[positions.clamp(max=self.cfg.max_len)]
        dt = self.compute_dtype
        if dt == torch.float32:
            return self.shared_embedding[tok] * self.emb_scale + rows
        return (embedding_lookup(self.shared_embedding, tok,
                                 compute_dtype=dt)
                * self.emb_scale.to(dt) + rows.to(dt))


class Seq2SeqStack(DecoderStack):
    """The encoder-decoder: the tied ``shared_embedding``, ``encoder.
    layer_i`` (:class:`EncoderLayer`) and ``decoder.layer_i``
    (:class:`DecoderLayer` with cross-attention)."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None):
        super().__init__(cfg, dtype=dtype, device=device, cross=True)
        self.encoder = nn.ModuleDict(
            {f"layer_{i}": EncoderLayer(cfg, dtype=dtype, device=device)
             for i in range(cfg.num_layers)})


def _self_attention_out(layer, a, shape):
    return layer.self_attn["out"](a.reshape(shape))


def _cross_attention(layer, h, q_shape, out_shape, kv, bias, lengths):
    """The cross-attention sublayer and its ``ln2``: the queries of ``h``
    over one layer's cached source K/V ``kv`` with the source's pad
    ``bias``, every position below ``lengths`` visible (decode attention,
    no causal offset)."""
    att = layer.cross_attn
    ck, cv = kv
    c = decode_attention(att["q"](h).reshape(q_shape), ck, cv, lengths,
                         bias=bias)
    return layer.ln2(h + att["out"](c.reshape(out_shape)))


def _ffn_tail(layer, h):
    f = layer.ffn["out"](layer.ffn["in"](h))
    return layer.ln3(h + f)


def incremental_decode(stack: DecoderStack, tok, pos, caches, cross_kv=None,
                       cross_bias=None, cross_len=None):
    """ONE decoder position for B sequences against cached state.

    ``tok (B,)`` int input tokens at absolute positions ``pos (B,)``;
    ``caches``: an accessor with ``append_and_gather(layer, k_new,
    v_new) -> (k_all, v_all, lengths)``. ``cross_kv`` (a ``(ck, cv)``
    pair ``(B, S_src, H, hd)`` per layer), ``cross_bias (B, S_src)`` f32
    and ``cross_len (B,)`` int32 add the cross-attention sublayer of the
    encoder-decoder; ``None`` builds the decoder-only step. Returns the
    hidden state ``h (B, d_model)``; the caller owns the logits head."""
    cfg = stack.cfg
    b = tok.shape[0]
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    h = stack.embed(tok, pos)
    for i, layer in enumerate(stack.layers):
        att = layer.self_attn
        q = att["q"](h).reshape(b, heads, hd)
        k_new = att["k"](h).reshape(b, 1, heads, hd)
        v_new = att["v"](h).reshape(b, 1, heads, hd)
        k_all, v_all, lengths = caches.append_and_gather(i, k_new, v_new)
        a = decode_attention(q, k_all, v_all, lengths)
        h = layer.ln1(h + _self_attention_out(layer, a, (b, d)))
        if cross_kv is not None:
            h = _cross_attention(layer, h, (b, heads, hd), (b, d),
                                 cross_kv[i], cross_bias, cross_len)
        h = _ffn_tail(layer, h)
    return h


def block_decode(stack: DecoderStack, tok_block, pos, caches, cross_kv=None,
                 cross_bias=None, cross_len=None):
    """A BLOCK of Kq consecutive positions for B sequences: ``tok_block
    (B, Kq)`` at positions ``pos[b] .. pos[b] + Kq - 1``; ``caches``: an
    accessor with ``append_and_gather_block`` returning the committed
    prefix BEFORE the block as lengths (query-block decode attention with
    ``causal_offset=True``); the cross arguments as in
    :func:`incremental_decode` (every query of the block sees the whole
    source). The speculative verify shape and the page-block prefill.
    Returns ``h (B, Kq, d_model)``."""
    cfg = stack.cfg
    b, kq = tok_block.shape
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    positions = pos.reshape(b, 1) + torch.arange(kq, device=pos.device)
    h = stack.embed(tok_block, positions)
    for i, layer in enumerate(stack.layers):
        att = layer.self_attn
        q = att["q"](h).reshape(b, kq, heads, hd)
        k_new = att["k"](h).reshape(b, kq, heads, hd)
        v_new = att["v"](h).reshape(b, kq, heads, hd)
        k_all, v_all, base = caches.append_and_gather_block(i, k_new, v_new)
        a = decode_attention(q, k_all, v_all, base, causal_offset=True)
        h = layer.ln1(h + _self_attention_out(layer, a, (b, kq, d)))
        if cross_kv is not None:
            h = _cross_attention(layer, h, (b, kq, heads, hd), (b, kq, d),
                                 cross_kv[i], cross_bias, cross_len)
        h = _ffn_tail(layer, h)
    return h


def build_int8_logits_weights(emb):
    """Column-wise int8 quantization of the tied softmax weights:
    ``emb (vocab, d)`` -> ``wq (d, vocab)`` int8 + ``scale (vocab,)``
    f32, with ``scale = max(amax, 1e-8) / 127`` and round half to even —
    exactly the JAX program (which differs from ``quantize_colwise``'s
    ``amax == 0 -> 1``). ``wq`` is K-major, strides ``(1, d)``: the
    ``.t()`` of the contiguous ``(vocab, d)`` rows quantized against each
    vocab entry's scale, the layout the QuantMatMul kernel reads."""
    e = emb.float()
    scale = div127(torch.clamp_min(e.abs().amax(dim=1), 1e-8))
    wq_km = torch.round(e / scale[:, None]).to(torch.int8)
    return wq_km.t(), scale.contiguous()


# ---------------------------------------------------------------------------
# Training sublayers
# ---------------------------------------------------------------------------

def _dropping(cfg: TransformerConfig, training) -> bool:
    return bool(training) and cfg.dropout > 0


def _eager_residual(sub_out, h, cfg: TransformerConfig, training, rng=None,
              scope=""):
    """Sublayer tail ``h + dropout(sub_out)`` through the fused op (JAX op
    ``{scope}/fused_dropout_residual``); rate 0 is the plain add."""
    if not _dropping(cfg, training):
        return fused_ops.fused_bias_dropout_residual(sub_out, h, rate=0.0)
    return fused_ops.fused_bias_dropout_residual(
        sub_out, h, rate=cfg.dropout,
        seed=rng.seed_for(f"{scope}/fused_dropout_residual"))


def _eager_attention(layer: DecoderLayer, x, cfg: TransformerConfig, training,
               causal=True, rng=None, scope="", bias=None):
    """Self-attention of ``x (B, S, D)``: q/k/v projections, heads split
    to ``(B, H, S, hd)``, the flash-attention kernels (an additive ``(B,
    S)`` key ``bias``; probability dropout from JAX op
    ``{scope}/flash_attention``), heads merged, the output projection."""
    b, s, d = x.shape
    heads = cfg.num_heads
    hd = d // heads
    att = layer.self_attn
    q = split_heads(att["q"](x), b, s, heads, hd)
    k = split_heads(att["k"](x), b, s, heads, hd)
    v = split_heads(att["v"](x), b, s, heads, hd)
    rate, seed = 0.0, None
    if _dropping(cfg, training):
        rate, seed = cfg.dropout, rng.seed_for(f"{scope}/flash_attention")
    ctx = fused_ops.fused_attention(q, k, v, bias=bias, causal=causal,
                                    dropout_rate=rate, seed=seed)
    return att["out"](merge_heads(ctx, b, s, d))


def _eager_ffn(layer: DecoderLayer, x, cfg: TransformerConfig, training, rng=None,
         scope=""):
    """FFN in (ReLU), dropout of the activation (JAX op
    ``{scope}/dropout``), FFN out."""
    h = layer.ffn["in"](x)
    if _dropping(cfg, training):
        h = nn_ops._dropout_impl(h, 1.0 - cfg.dropout,
                                 rng.key_for(f"{scope}/dropout"))
    return layer.ffn["out"](h)


def _eager_embed(stack: DecoderStack, ids, compute_dtype, training, rng=None,
           scope=""):
    """Scaled shared-embedding rows plus sinusoidal positions, in the
    compute dtype: the lookup gathers in ``compute_dtype`` and its
    gradient scatter-adds into the f32 table; the scale and the position
    table are f32 constants cast to the compute dtype. Then dropout (JAX
    op ``{scope}/dropout``)."""
    cfg = stack.cfg
    s = ids.shape[1]
    h = embedding_lookup(stack.shared_embedding, ids,
                         compute_dtype=compute_dtype) \
        * stack.emb_scale.to(compute_dtype)
    h = h + stack.pos_table[:s].to(compute_dtype)
    if _dropping(cfg, training):
        h = nn_ops._dropout_impl(h, 1.0 - cfg.dropout,
                                 rng.key_for(f"{scope}/dropout"))
    return h


def smoothed_xent(logits, labels, weights, cfg: TransformerConfig):
    """Label-smoothed cross entropy minus the smoothed target's entropy,
    weight-masked mean (f32 loss math), through the fused xent kernels;
    graph ops for graph tensors (the JAX function's ops)."""
    vocab = cfg.vocab_size
    conf = 1.0 - cfg.label_smoothing
    low = cfg.label_smoothing / (vocab - 1)
    per_tok = fused_ops.fused_softmax_cross_entropy(
        logits, labels, label_smoothing=cfg.label_smoothing)
    norm = -(conf * math.log(conf) +
             (vocab - 1) * low * math.log(low + 1e-20))
    per_tok = per_tok - norm
    if isinstance(per_tok, ops_mod.Tensor):
        w = stf.cast(weights, stf.float32)
        return stf.reduce_sum(per_tok * w) / (stf.reduce_sum(w) + 1e-9)
    w = weights.float()
    return (per_tok * w).sum() / (w.sum() + 1e-9)


# ---------------------------------------------------------------------------
# The training graph (TF-1 front end)
# ---------------------------------------------------------------------------

def _init(cfg):
    return stf.variance_scaling_initializer(1.0, "fan_avg", "uniform")


def _ln(x, cfg, name):
    return common.layer_norm(x, name, eps=cfg.layer_norm_eps)


def _dense(x, units, cfg, name, activation=None):
    return common.dense(x, units, _init(cfg), name, activation=activation)


def _residual(sub_out, h, cfg, training):
    """Sublayer tail ``h + dropout(sub_out)`` through the fused op; rate 0
    builds the plain add."""
    rate = cfg.dropout if training else 0.0
    return stf.nn.fused_bias_dropout_residual(sub_out, h, rate=rate)


def _attention(q_in, kv_in, bias, cfg, training, compute_dtype, name,
               causal=False):
    """q_in (B,Sq,D) attends over kv_in (B,Sk,D); ``bias`` the additive
    (B,1,1,Sk) pad bias or None; the flash-attention op, probability
    dropout inside it."""
    b = int(q_in.shape[0])
    sq, sk = int(q_in.shape[1]), int(kv_in.shape[1])
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    with stf.variable_scope(name):
        q = _dense(q_in, d, cfg, "q")
        k = _dense(kv_in, d, cfg, "k")
        v = _dense(kv_in, d, cfg, "v")
        q = common.split_heads(q, b, sq, heads, hd)
        k = common.split_heads(k, b, sk, heads, hd)
        v = common.split_heads(v, b, sk, heads, hd)
        key_bias = stf.reshape(bias, [b, sk]) if bias is not None else None
        ctx = stf.nn.fused_attention(
            q, k, v, bias=key_bias, causal=causal,
            dropout_rate=cfg.dropout if training else 0.0)
        out = _dense(common.merge_heads(ctx, b, sq, d), d, cfg, "out")
    return out


def _ffn(x, cfg, training, name):
    with stf.variable_scope(name):
        h = _dense(x, cfg.d_ff, cfg, "in", activation=stf.nn.relu)
        if training and cfg.dropout > 0:
            h = stf.nn.dropout(h, keep_prob=1.0 - cfg.dropout)
        return _dense(h, cfg.d_model, cfg, "out")


def _embed(ids, cfg, compute_dtype, training):
    """Shared embedding table (f32), scaled, plus sinusoidal positions, in
    the compute dtype; then dropout."""
    emb = stf.get_variable(
        "shared_embedding", [cfg.vocab_size, cfg.d_model],
        initializer=stf.random_normal_initializer(
            stddev=cfg.d_model ** -0.5))
    s = int(ids.shape[1])
    h = stf.nn.embedding_lookup(emb, ids, compute_dtype=compute_dtype) \
        * stf.cast(stf.constant(cfg.d_model ** 0.5), compute_dtype)
    pos = sinusoidal_position_encoding(cfg.max_len, cfg.d_model)[:s]
    h = h + stf.cast(stf.constant(pos[None, :, :]), compute_dtype)
    if training and cfg.dropout > 0:
        h = stf.nn.dropout(h, keep_prob=1.0 - cfg.dropout)
    return h, emb


def _pad_bias(ids, cfg):
    """(B,S) ids -> additive bias (B,1,1,S): -1e9 on pad positions."""
    b, s = int(ids.shape[0]), int(ids.shape[1])
    is_pad = stf.cast(stf.equal(ids, cfg.pad_id), stf.float32)
    return stf.reshape(is_pad, [b, 1, 1, s]) * -1e9


def encode(src_ids, cfg, training=True, compute_dtype=stf.bfloat16,
           scope="transformer", recompute=False):
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        h, _ = _embed(src_ids, cfg, compute_dtype, training)
        bias = _pad_bias(src_ids, cfg)
        with stf.variable_scope("encoder"):
            def enc_layer(hh, i):
                with stf.variable_scope(f"layer_{i}"):
                    a = _attention(hh, hh, bias, cfg, training,
                                   compute_dtype, "self_attn")
                    hh = _ln(_residual(a, hh, cfg, training), cfg, "ln1")
                    f = _ffn(hh, cfg, training, "ffn")
                    return _ln(hh + f, cfg, "ln2")

            for i in range(cfg.num_layers):
                h = common.maybe_recompute(enc_layer, h, i, recompute, "enc")
    return h, bias


def decode(tgt_ids, enc_out, enc_bias, cfg, training=True,
           compute_dtype=stf.bfloat16, scope="transformer",
           recompute=False):
    """Returns logits (B, St, vocab); causal self-attention over
    tgt_ids, cross-attention over ``enc_out``; the tied softmax weights in
    the compute dtype."""
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        h, emb = _embed(tgt_ids, cfg, compute_dtype, training)
        with stf.variable_scope("decoder"):
            def dec_layer(hh, i):
                with stf.variable_scope(f"layer_{i}"):
                    a = _attention(hh, hh, None, cfg, training,
                                   compute_dtype, "self_attn", causal=True)
                    hh = _ln(_residual(a, hh, cfg, training), cfg, "ln1")
                    c = _attention(hh, enc_out, enc_bias, cfg, training,
                                   compute_dtype, "cross_attn")
                    hh = _ln(_residual(c, hh, cfg, training), cfg, "ln2")
                    f = _ffn(hh, cfg, training, "ffn")
                    return _ln(hh + f, cfg, "ln3")

            for i in range(cfg.num_layers):
                h = common.maybe_recompute(dec_layer, h, i, recompute, "dec")
        b, s = int(tgt_ids.shape[0]), int(tgt_ids.shape[1])
        flat = stf.reshape(h, [b * s, cfg.d_model])
        logits = stf.matmul(flat, stf.cast(emb, h.dtype.base_dtype),
                            transpose_b=True)
        return stf.reshape(logits, [b, s, cfg.vocab_size])


def transformer_train_model(batch_size=64, src_len=64, tgt_len=64,
                            cfg: TransformerConfig | None = None,
                            learning_rate=1.0, warmup_steps=4000,
                            compute_dtype=stf.bfloat16, data_parallel=False,
                            recompute=False):
    """Training graph: src/tgt -> label-smoothed loss -> Adam (beta2
    0.997, eps 1e-9) with the noam learning rate on the global step.
    recompute="auto" resolves against the attached device's memory via the
    static cost model (framework/cost_model.py resolve_recompute)."""
    cfg = cfg or TransformerConfig.big()
    if data_parallel:
        raise NotImplementedError("data_parallel is not ported")
    from ..framework import cost_model as _cm

    # encoder layers see src_len, decoder layers tgt_len (cross-attn
    # keys add a little on top; the heuristic ignores it)
    _shards = _cm.mesh_shard_factor(["dp"] if data_parallel else [])
    _act = (_cm.transformer_activation_bytes(
                batch_size, src_len, cfg.d_model, cfg.num_layers,
                dtype_bytes=compute_dtype.size)
            + _cm.transformer_activation_bytes(
                batch_size, tgt_len, cfg.d_model, cfg.num_layers,
                dtype_bytes=compute_dtype.size))
    _flops = (_cm.transformer_forward_flops(
                  batch_size, src_len, cfg.d_model, cfg.num_layers,
                  d_ff=cfg.d_ff)
              + _cm.transformer_forward_flops(
                  batch_size, tgt_len, cfg.d_model, cfg.num_layers,
                  d_ff=cfg.d_ff))
    recompute = _cm.resolve_recompute(recompute, _act / _shards,
                                      forward_flops=_flops / _shards)
    src = stf.placeholder(stf.int32, [batch_size, src_len], "src_ids")
    tgt_in = stf.placeholder(stf.int32, [batch_size, tgt_len], "tgt_in")
    tgt_out = stf.placeholder(stf.int32, [batch_size, tgt_len], "tgt_out")
    enc_out, enc_bias = encode(src, cfg, training=True,
                               compute_dtype=compute_dtype,
                               recompute=recompute)
    logits = decode(tgt_in, enc_out, enc_bias, cfg, training=True,
                    compute_dtype=compute_dtype, recompute=recompute)
    weights = stf.cast(stf.not_equal(tgt_out, cfg.pad_id), stf.float32)
    loss = smoothed_xent(logits, tgt_out, weights, cfg)

    gs = stf.train.get_or_create_global_step()
    # noam schedule: d^-0.5 * min(step^-0.5, step*warmup^-1.5)
    step = stf.cast(gs, stf.float32) + 1.0
    lr = (learning_rate * cfg.d_model ** -0.5 *
          stf.minimum(stf.pow(step, -0.5), step * warmup_steps ** -1.5))
    opt = stf.train.AdamOptimizer(lr, beta1=0.9, beta2=0.997, epsilon=1e-9)
    train_op = opt.minimize(loss, global_step=gs)
    acc = stf.reduce_sum(stf.cast(stf.equal(
        stf.cast(stf.argmax(logits, -1, output_type=stf.int32), stf.int32),
        tgt_out), stf.float32) * weights) / (stf.reduce_sum(weights) + 1e-9)
    return {"src_ids": src, "tgt_in": tgt_in, "tgt_out": tgt_out,
            "loss": loss, "train_op": train_op, "accuracy": acc,
            "learning_rate": lr, "global_step": gs}


# ---------------------------------------------------------------------------
# Beam search (graph): the naive re-forward and the KV-cached decode
# ---------------------------------------------------------------------------

class _BeamCaches:
    """Loop-carried caches of the cached beam search: one (k, v) pair per
    decoder layer, each (B, L, H, hd), updated functionally through a
    one-hot position mask (static shapes: the whole search is one loop)."""

    def __init__(self, flat_arrays, i, b, max_len):
        self._arrays = list(flat_arrays)
        self._i = i
        self._b = b
        self._L = max_len
        self.updated = list(flat_arrays)

    def append_and_gather(self, layer, k_new, v_new):
        mask = stf.cast(stf.reshape(
            stf.one_hot(self._i, self._L, dtype=stf.float32),
            [1, self._L, 1, 1]), k_new.dtype.base_dtype)
        k_all = self._arrays[2 * layer] * (1.0 - mask) + k_new * mask
        v_all = self._arrays[2 * layer + 1] * (1.0 - mask) + v_new * mask
        self.updated[2 * layer] = k_all
        self.updated[2 * layer + 1] = v_all
        lengths = stf.fill([self._b], self._i + 1)
        return k_all, v_all, lengths


def _decode_cross_kv(enc_out, cfg, compute_dtype, scope):
    """Per-layer cross-attention K/V projections of the encoder output,
    made once per sequence: [(ck, cv)] each (B, S_src, H, hd), the
    DecodeAttention cache layout."""
    b, s = int(enc_out.shape[0]), int(enc_out.shape[1])
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    out = []
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        with stf.variable_scope("decoder"):
            for i in range(cfg.num_layers):
                with stf.variable_scope(f"layer_{i}"):
                    with stf.variable_scope("cross_attn"):
                        ck = stf.reshape(_dense(enc_out, d, cfg, "k"),
                                         [b, s, heads, hd])
                        cv = stf.reshape(_dense(enc_out, d, cfg, "v"),
                                         [b, s, heads, hd])
                out.append((ck, cv))
    return out


def _incremental_decode(tok, pos, caches, cross_kv, cross_bias, cross_len,
                        cfg, compute_dtype, scope):
    """ONE decoder position for B sequences against cached state (graph):
    tok (B,) int32, pos a scalar int32 position, caches a
    :class:`_BeamCaches`, cross_kv [(ck, cv)] per layer, cross_bias (B,
    S_src) f32, cross_len (B,) int32. Returns (h (B, d_model), emb); the
    caller owns the logits. Self-attention reads the cache through
    ``stf.nn.decode_attention`` (the single-query kernel), and so does
    the cross-attention, with the pad bias."""
    b = int(tok.shape[0])
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        emb = stf.get_variable(
            "shared_embedding", [cfg.vocab_size, cfg.d_model],
            initializer=stf.random_normal_initializer(
                stddev=cfg.d_model ** -0.5))
        h = stf.nn.embedding_lookup(emb, tok, compute_dtype=compute_dtype) \
            * stf.cast(stf.constant(cfg.d_model ** 0.5), compute_dtype)
        pos_table = stf.constant(
            sinusoidal_position_encoding(cfg.max_len, cfg.d_model))
        h = h + stf.cast(stf.gather(pos_table, pos), compute_dtype)
        with stf.variable_scope("decoder"):
            for i in range(cfg.num_layers):
                with stf.variable_scope(f"layer_{i}"):
                    with stf.variable_scope("self_attn"):
                        q = stf.reshape(_dense(h, d, cfg, "q"),
                                        [b, heads, hd])
                        k_new = stf.reshape(_dense(h, d, cfg, "k"),
                                            [b, 1, heads, hd])
                        v_new = stf.reshape(_dense(h, d, cfg, "v"),
                                            [b, 1, heads, hd])
                        k_all, v_all, lengths = caches.append_and_gather(
                            i, k_new, v_new)
                        a = stf.nn.decode_attention(q, k_all, v_all,
                                                    lengths)
                        a = _dense(stf.reshape(a, [b, d]), d, cfg, "out")
                    h = _ln(_residual(a, h, cfg, False), cfg, "ln1")
                    with stf.variable_scope("cross_attn"):
                        qc = stf.reshape(_dense(h, d, cfg, "q"),
                                         [b, heads, hd])
                        ck, cv = cross_kv[i]
                        c = stf.nn.decode_attention(
                            qc, ck, cv, cross_len, bias=cross_bias)
                        c = _dense(stf.reshape(c, [b, d]), d, cfg, "out")
                    h = _ln(_residual(c, h, cfg, False), cfg, "ln2")
                    f = _ffn(h, cfg, False, "ffn")
                    h = _ln(h + f, cfg, "ln3")
    return h, emb


def beam_search_decode(src, cfg: TransformerConfig | None = None,
                       beam_size=4, decode_len=None, alpha=0.6,
                       compute_dtype=stf.bfloat16, scope="transformer",
                       use_cache=False):
    """Beam search over the decoder; returns (ids (B, beam, L), scores
    (B, beam)).

    ``decode_len - 1`` iterations of one ``stf.while_loop``; finished
    beams (EOS emitted) are extended only by EOS at zero cost, so their
    scores freeze. ``use_cache=False`` re-scores the full prefix each step
    (the flash kernels over (B*beam, L)); ``use_cache=True`` carries
    per-layer KV caches through the loop and decodes ONE position a step
    through the DecodeAttention kernel: token for token the same search
    (int-exact ids, scores to float round-off)."""
    cfg = cfg or TransformerConfig.big()
    b = int(src.shape[0])
    L = decode_len or cfg.max_len
    if L > cfg.max_len:
        # the position table has cfg.max_len rows; a longer decode would
        # clamp the gather silently on the cached path
        raise ValueError(
            f"decode_len={L} exceeds cfg.max_len={cfg.max_len}")
    k = beam_size
    vocab = cfg.vocab_size
    neg_inf = -1e9
    heads = cfg.num_heads
    hd = cfg.d_model // heads

    enc_out, enc_bias = encode(src, cfg, training=False,
                               compute_dtype=compute_dtype, scope=scope)
    # encoder outputs tiled over beams: (B,S,D) -> (B*k,S,D)
    s_src, d = int(enc_out.shape[1]), int(enc_out.shape[2])
    enc_tiled = stf.reshape(
        stf.tile(stf.expand_dims(enc_out, 1), [1, k, 1, 1]),
        [b * k, s_src, d])
    bias_tiled = stf.reshape(
        stf.tile(stf.expand_dims(enc_bias, 1), [1, k, 1, 1, 1]),
        [b * k, 1, 1, s_src])

    # state: i, seq (B,k,L) started with EOS column 0, logp (B,k)
    seq0 = stf.concat([
        stf.fill([b, k, 1], cfg.eos_id),
        stf.fill([b, k, L - 1], cfg.pad_id)], axis=2)
    # only beam 0 alive at first, so the k first expansions differ
    logp0 = stf.constant(
        np.tile(np.array([[0.0] + [neg_inf] * (k - 1)], np.float32), (b, 1)))
    i0 = stf.constant(0)

    eos_row = stf.constant(
        np.array([0.0 if t == cfg.eos_id else neg_inf
                  for t in range(vocab)], np.float32).reshape(1, 1, vocab))
    offs = stf.reshape(stf.constant(
        np.arange(b, dtype=np.int32) * k), [b, 1])

    def select(i, seq, logp, step_logits):
        """Beam expansion shared by both paths: score position ``i``'s
        logits, pick the top-k continuations, write the token at column
        i+1. Returns (new_seq, new_logp, parent (B*k,) row indices)."""
        logprobs = stf.nn.log_softmax(step_logits, axis=-1)
        logprobs = stf.reshape(logprobs, [b, k, vocab])

        # finished beams (EOS emitted after t=0) extend only with EOS at
        # zero cost
        emitted = stf.reduce_sum(stf.cast(stf.equal(
            stf.slice(seq, [0, 0, 1], [b, k, L - 1]), cfg.eos_id),
            stf.float32), axis=2)
        finished = stf.greater(emitted, 0.0)  # (B,k)
        fin_f = stf.reshape(stf.cast(finished, stf.float32), [b, k, 1])
        logprobs = logprobs * (1.0 - fin_f) + eos_row * fin_f

        total = stf.reshape(logp, [b, k, 1]) + logprobs  # (B,k,vocab)
        flat_total = stf.reshape(total, [b, k * vocab])
        new_logp, flat_idx = stf.nn.top_k(flat_total, k=k)  # (B,k)
        beam_idx = stf.cast(flat_idx // vocab, stf.int32)  # (B,k)
        tok = stf.cast(flat_idx % vocab, stf.int32)  # (B,k)

        # parent rows: batch offsets into (B*k, L)
        parent = stf.reshape(beam_idx + offs, [-1])
        new_seq = stf.gather(stf.reshape(seq, [b * k, L]), parent)
        # the token written at column i+1 through a one_hot mask
        col = stf.one_hot(i + 1, L, dtype=stf.int32)  # (L,)
        new_seq = (new_seq * (1 - stf.reshape(col, [1, L])) +
                   stf.reshape(tok, [-1, 1]) * stf.reshape(col, [1, L]))
        return stf.reshape(new_seq, [b, k, L]), new_logp, parent

    def cond(i, seq, logp, *caches):
        return stf.less(i, L - 1)

    def body_naive(i, seq, logp):
        flat = stf.reshape(seq, [b * k, L])
        # decode() gives logits in the compute dtype; beam math is f32
        logits = stf.cast(
            decode(flat, enc_tiled, bias_tiled, cfg, training=False,
                   compute_dtype=compute_dtype, scope=scope), stf.float32)
        # the logits at position i predict token i+1: a one_hot select
        sel = stf.one_hot(i, L, dtype=stf.float32)  # (L,)
        step_logits = stf.reduce_sum(
            logits * stf.reshape(sel, [1, L, 1]), axis=1)  # (B*k, vocab)
        new_seq, new_logp, _ = select(i, seq, logp, step_logits)
        return i + 1, new_seq, new_logp

    if use_cache:
        cross_kv = _decode_cross_kv(enc_tiled, cfg, compute_dtype, scope)
        cross_bias = stf.reshape(bias_tiled, [b * k, s_src])
        cross_len = stf.fill([b * k], s_src)
        caches0 = []
        for _ in range(cfg.num_layers):
            caches0.append(stf.zeros([b * k, L, heads, hd],
                                     dtype=compute_dtype))
            caches0.append(stf.zeros([b * k, L, heads, hd],
                                     dtype=compute_dtype))

        def body_cached(i, seq, logp, *flat_caches):
            # the current input token: column i of every beam row
            coli = stf.one_hot(i, L, dtype=stf.int32)
            tok = stf.reduce_sum(seq * stf.reshape(coli, [1, 1, L]),
                                 axis=2)  # (B,k)
            flat_tok = stf.reshape(tok, [b * k])
            cache = _BeamCaches(flat_caches, i, b * k, L)
            h, emb = _incremental_decode(
                flat_tok, i, cache, cross_kv, cross_bias, cross_len,
                cfg, compute_dtype, scope)
            logits = stf.matmul(h, stf.cast(emb, h.dtype.base_dtype),
                                transpose_b=True)
            step_logits = stf.cast(logits, stf.float32)
            new_seq, new_logp, parent = select(i, seq, logp, step_logits)
            # the caches reorder with their beams
            new_caches = [stf.gather(c, parent) for c in cache.updated]
            return (i + 1, new_seq, new_logp, *new_caches)

        out = stf.while_loop(cond, body_cached,
                             [i0, seq0, logp0] + caches0)
        _, seq, logp = out[0], out[1], out[2]
    else:
        _, seq, logp = stf.while_loop(cond, body_naive, [i0, seq0, logp0])
    # GNMT length penalty, then a re-sort: penalties vary with beam
    # length, so the raw-logp order need not be the penalized order
    lengths = stf.reduce_sum(stf.cast(stf.logical_and(
        stf.not_equal(seq, cfg.pad_id), stf.not_equal(seq, cfg.eos_id)),
        stf.float32), axis=2) + 1.0
    penalty = stf.pow((5.0 + lengths) / 6.0, alpha)
    scores = logp / penalty
    scores, order = stf.nn.top_k(scores, k=k)  # (B,k) descending
    offs = stf.reshape(stf.constant(np.arange(b, dtype=np.int32) * k),
                       [b, 1])
    flat_order = stf.reshape(stf.cast(order, stf.int32) + offs, [-1])
    seq = stf.reshape(stf.gather(stf.reshape(seq, [b * k, L]), flat_order),
                      [b, k, L])
    return seq, scores


# ---------------------------------------------------------------------------
# Encoder-decoder serving on slot caches (eager)
# ---------------------------------------------------------------------------

def _eager_encode(stack: Seq2SeqStack, src, compute_dtype=torch.float32):
    """The encoder at eval (JAX ``encode`` :214, ``training=False``):
    ``(enc_out (B, S, d_model), bias (B, S))``, the f32 pad bias -1e9 on
    pad tokens (``_pad_bias`` :207), which every layer's flash
    self-attention reads as its key bias (non-causal, rate 0)."""
    cfg = stack.cfg
    h = _eager_embed(stack, src, compute_dtype, False)
    bias = (src == cfg.pad_id).to(torch.float32) * -1e9
    for layer in stack.encoder.values():
        a = _eager_attention(layer, h, cfg, False, causal=False, bias=bias)
        h = layer.ln1(_eager_residual(a, h, cfg, False))
        h = layer.ln2(h + _eager_ffn(layer, h, cfg, False))
    return h, bias


def _eager_decode_cross_kv(stack: Seq2SeqStack, enc_out):
    """Per-layer cross-attention K/V of the encoder output, made once a
    sequence (JAX :416): ``[(ck, cv)]`` each ``(B, S_src, H, hd)``."""
    b, s, d = enc_out.shape
    heads = stack.cfg.num_heads
    return [(layer.cross_attn["k"](enc_out).reshape(b, s, heads, d // heads),
             layer.cross_attn["v"](enc_out).reshape(b, s, heads, d // heads))
            for layer in stack.layers]


class _SlotCaches:
    """Cache accessor for one decode, verify or draft step (JAX :373):
    appends land at ``(slots[b], positions[b] + j)`` of each layer's
    :class:`..ops.kv_cache.SlotKVCache`, the gather reads the slots'
    rows."""

    def __init__(self, caches, slots, positions):
        self._caches = caches        # [(SlotKVCache k, SlotKVCache v)]
        self._slots = slots
        self._pos = positions

    def _one(self, cache, new):
        cache.append(new, self._slots, self._pos)
        return cache.gather(self._slots)

    def append_and_gather(self, layer, k_new, v_new):
        kc, vc = self._caches[layer]
        return (self._one(kc, k_new), self._one(vc, v_new),
                self._pos + 1)

    def append_and_gather_block(self, layer, k_new, v_new):
        """The block's ``(B, Kq, H, hd)`` at ``pos .. pos + Kq - 1``;
        the lengths returned are the committed prefix BEFORE the block
        (``causal_offset=True``)."""
        kc, vc = self._caches[layer]
        return self._one(kc, k_new), self._one(vc, v_new), self._pos


def _torch_dtype(dtype):
    """A torch dtype from a torch or a port dtype."""
    return getattr(dtype, "torch_dtype", dtype)


def generative_cache_bytes(cfg, src_len, num_slots, max_decode_len,
                           compute_dtype, cross=True):
    """(total_bytes, unsharded_bytes) of the generative cache set (JAX
    :1047): the self-attention K/V, with ``cross`` the source K/V and the
    f32 source-bias cache (the unsharded part), each with the scratch
    slot."""
    heads = cfg.num_heads
    hd = cfg.d_model // heads
    ts = int(num_slots) + 1
    per = torch.empty((), dtype=_torch_dtype(compute_dtype)).element_size()
    total = 2 * cfg.num_layers * ts * max_decode_len * heads * hd * per
    unsharded = 0
    if cross:
        total += 2 * cfg.num_layers * ts * src_len * heads * hd * per
        unsharded = ts * src_len * 4          # src-bias cache, rank 2
    return total + unsharded, unsharded


# the staged inputs of the bucket programs, by name
_INPUT_DTYPES = {"tok": torch.int64, "pos": torch.int32,
                 "slots": torch.int64, "src": torch.int64}


class TransformerGenerativeModel:
    """The encoder-decoder's decode programs for the serving engine's slot
    path (JAX :1132-1405).

    Interface: ``prefill(src_rows, slots)``, ``decode(tokens, positions,
    slots) -> (next_tok, logp, bucket)``, with ``speculative_k`` the
    target's ``verify(tok_blocks, positions, slots) -> (toks, logps,
    bucket)``, with ``draft_steps`` the draft's ``decode_k(tokens,
    positions, slots) -> (props, bucket)``, ``close()``, and the
    ``eos_id / pad_id / num_slots / max_decode_len / src_len / spec_k /
    draft_steps / decode_buckets / prefill_buckets / scratch_slot``
    attributes the engine schedules against.

    State: per decoder layer a self-attention K and V
    :class:`..ops.kv_cache.SlotKVCache` ``(num_slots + 1, max_decode_len,
    H, hd)`` and a cross-attention K and V ``(num_slots + 1, src_len, H,
    hd)``, and one f32 source-bias cache ``(num_slots + 1, src_len)``, in
    the compute dtype; the last row of each is the scratch slot that bucket
    padding writes into and reads. Programs, one a bucket (JAX
    ``build_generative_program`` :770-1044):

    - prefill ``(pb, src_len)``: the encoder (flash attention with the pad
      bias), the cross K/V and the bias written at position 0 of the slots;
    - decode: one position (self-attention over the slot cache, then
      cross-attention over the source with its bias), the logits head and
      the greedy pick;
    - verify ``(sb, speculative_k)``: the block through
      :func:`block_decode`, every position's greedy pick;
    - draft: ``draft_steps`` chained greedy decode positions in one
      program, each step reading the appends of the one before.

    Weights come from ``checkpoint=`` (a JAX ``.stfz`` prefix, read by
    :func:`..convert.load_stfz`), ``params=`` (a ``state_dict``), or
    ``init_fresh=True`` (:func:`..convert.init_seq2seq_params` with
    ``seed``). ``device`` defaults to ``"cuda"`` and raises without a
    card; pass ``device="cpu"`` to run the kernels' plain versions on the
    CPU. ``aot_warmup`` (default True) captures every program as a CUDA
    graph at build, after a warm-up on all-padding rows aimed at the
    scratch slot; False dispatches every call eagerly. Sampling and decode
    tensor parallelism (``mesh``, ``tp``) come in later slices and
    raise."""

    def __init__(self, cfg: TransformerConfig, src_len, *, num_slots=8,
                 max_decode_len=32, decode_bucket_sizes=None,
                 prefill_bucket_sizes=(1,), compute_dtype=torch.float32,
                 int8=False, checkpoint=None, params=None, init_fresh=False,
                 scope="transformer", aot_warmup=True, seed=0,
                 sampling=None, speculative_k=None, draft_steps=None,
                 mesh=None, tp=None, device="cuda"):
        from .. import convert
        from ..serving.policy import _pow2_buckets

        if sampling is not None:
            raise NotImplementedError(
                "sampling decode comes in a later slice of the PyTorch "
                "port; this slice serves greedy decode")
        if mesh is not None or tp not in (None, 0, 1):
            raise NotImplementedError(
                "decode tensor parallelism (mesh=, tp=) comes in a later "
                "slice of the PyTorch port")
        if checkpoint is None and params is None and not init_fresh:
            raise ValueError("pass checkpoint=..., params=... or "
                             "init_fresh=True")
        if max_decode_len > cfg.max_len:
            raise ValueError(
                f"max_decode_len={max_decode_len} exceeds "
                f"cfg.max_len={cfg.max_len} (the position-encoding table); "
                "raise cfg.max_len or shorten the cache")
        if src_len > cfg.max_len:
            raise ValueError(f"src_len={src_len} exceeds cfg.max_len="
                             f"{cfg.max_len} (the position-encoding table)")
        self.device = common.resolve_device(device)
        self.cfg = cfg
        self.src_len = int(src_len)
        self.num_slots = int(num_slots)
        self.max_decode_len = int(max_decode_len)
        self.eos_id = cfg.eos_id
        self.pad_id = cfg.pad_id
        self.int8 = bool(int8)
        self.sampling = None
        self.spec_k = int(speculative_k) if speculative_k else 0
        self.draft_steps = int(draft_steps) if draft_steps else 0
        self.tp_degree = 1
        self.compute_dtype = _torch_dtype(compute_dtype)
        self._scratch = self.num_slots
        self._decode_buckets = sorted(set(int(x) for x in (
            decode_bucket_sizes or _pow2_buckets(self.num_slots))))
        self._prefill_buckets = sorted(set(
            int(x) for x in prefill_bucket_sizes))

        if checkpoint is not None:
            state = convert.seq2seq_params_from_jax(
                convert.load_stfz(checkpoint), cfg, scope=scope)
        elif params is not None:
            state = params
        else:
            state = convert.init_seq2seq_params(cfg, seed)
        self.stack = Seq2SeqStack(cfg, dtype=self.compute_dtype,
                                  device=self.device)
        self.stack.load_state_dict(state)
        self.stack.requires_grad_(False)
        self.stack.eval()
        heads = cfg.num_heads
        inner = (heads, cfg.d_model // heads)

        def cache(length, shape=inner, dtype=self.compute_dtype):
            return SlotKVCache(self.num_slots, length, shape, dtype=dtype,
                               device=self.device)

        self.self_caches = [(cache(self.max_decode_len),
                             cache(self.max_decode_len))
                            for _ in range(cfg.num_layers)]
        self.cross_caches = [(cache(self.src_len), cache(self.src_len))
                             for _ in range(cfg.num_layers)]
        self.bias_cache = cache(self.src_len, (), torch.float32)
        self.wq = self.w_scale = None
        if self.int8:
            with torch.inference_mode():
                self.wq, self.w_scale = build_int8_logits_weights(
                    self.stack.shared_embedding)
        self.aot_warmup = bool(aot_warmup)
        self._programs = {}          # (kind, bucket) -> BucketProgram
        if self.aot_warmup:
            self._build_programs()

    # -- programs --------------------------------------------------------------
    def _kinds(self):
        """(kind, function, bucket sizes, {input: shape at bucket n})."""
        out = [("decode", self._decode_step, self._decode_buckets,
                lambda n: {"tok": (n,), "pos": (n,), "slots": (n,)}),
               ("prefill", self._prefill_step, self._prefill_buckets,
                lambda n: {"src": (n, self.src_len), "slots": (n,)})]
        if self.spec_k:
            out.append(("verify", self._verify_step, self._decode_buckets,
                        lambda n: {"tok": (n, self.spec_k), "pos": (n,),
                                   "slots": (n,)}))
        if self.draft_steps:
            out.append(("draft", self._draft_step, self._decode_buckets,
                        lambda n: {"tok": (n,), "pos": (n,), "slots": (n,)}))
        return out

    def _padding(self, shapes):
        """All-padding rows: the pad token (a pad source), position 0, the
        scratch slot."""
        fill = {"tok": self.pad_id, "src": self.pad_id, "pos": 0,
                "slots": self._scratch}
        return {k: np.full(shape, fill[k], np.int32)
                for k, shape in shapes.items()}

    @torch.inference_mode()
    def _build_programs(self):
        """Warm up and capture every bucket's program on all-padding rows
        (which write only the scratch slot)."""
        for kind, fn, buckets, shapes_of in self._kinds():
            for n in buckets:
                shapes = shapes_of(n)
                prog = BucketProgram(fn, {
                    k: (shape, _INPUT_DTYPES[k])
                    for k, shape in shapes.items()}, self.device)
                prog.build(self._padding(shapes))
                self._programs[(kind, n)] = prog

    def _cross(self, slots):
        """The slots' source K/V, pad bias and lengths (every source
        position visible; the bias masks the pads)."""
        cross_kv = [(ck.gather(slots), cv.gather(slots))
                    for ck, cv in self.cross_caches]
        lengths = torch.full((slots.shape[0],), self.src_len,
                             dtype=torch.int32, device=slots.device)
        return cross_kv, self.bias_cache.gather(slots), lengths

    def _prefill_step(self, src, slots):
        enc_out, bias = _eager_encode(self.stack, src, self.compute_dtype)
        zeros = torch.zeros_like(slots)
        for (ckc, cvc), (ck, cv) in zip(
                self.cross_caches,
                _eager_decode_cross_kv(self.stack, enc_out)):
            ckc.append(ck, slots, zeros)
            cvc.append(cv, slots, zeros)
        self.bias_cache.append(bias, slots, zeros)
        return ()

    def _decode_hidden(self, tok, pos, slots):
        return incremental_decode(
            self.stack, tok, pos, _SlotCaches(self.self_caches, slots, pos),
            *self._cross(slots))

    def _verify_hidden(self, tok, pos, slots):
        return block_decode(
            self.stack, tok, pos, _SlotCaches(self.self_caches, slots, pos),
            *self._cross(slots))

    def _decode_step(self, tok, pos, slots):
        return greedy_emit(self.logits_head(
            self._decode_hidden(tok, pos, slots)))

    def _verify_step(self, tok, pos, slots):
        sb, k = tok.shape
        h = self._verify_hidden(tok, pos, slots)
        t, lp = greedy_emit(self.logits_head(
            h.reshape(sb * k, self.cfg.d_model)))
        return t.reshape(sb, k), lp.reshape(sb, k)

    def _draft_step(self, tok, pos, slots):
        """``draft_steps`` chained greedy steps: step j + 1 reads step j's
        appends (stream order) and takes its argmax as input."""
        cross = self._cross(slots)
        cur, props = tok, []
        for j in range(self.draft_steps):
            at = pos + j
            h = incremental_decode(
                self.stack, cur, at,
                _SlotCaches(self.self_caches, slots, at), *cross)
            cur = torch.argmax(self.logits_head(h), dim=-1)
            props.append(cur)
        return (torch.stack(props, dim=1),)

    def logits_head(self, h):
        """Tied-softmax logits, f32: the int8 QuantMatMul kernel when built
        with ``int8=True``, else a matmul against the table in the compute
        dtype."""
        if self.int8:
            logits = quant_matmul(h, self.wq, self.w_scale)
        else:
            logits = torch.matmul(
                h, self.stack.shared_embedding.to(h.dtype).t())
        return logits.float()

    # -- engine interface ------------------------------------------------------
    @property
    def decode_buckets(self):
        return list(self._decode_buckets)

    @property
    def prefill_buckets(self):
        return list(self._prefill_buckets)

    @property
    def scratch_slot(self):
        return self._scratch

    def _bucket(self, buckets, n):
        for b in buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} rows exceed the largest bucket "
                         f"{buckets[-1]}")

    def _run(self, kind, fn, bucket, rows):
        """One bucket program on padded numpy rows: its captured graph, or
        the function dispatched eagerly."""
        prog = self._programs.get((kind, bucket))
        if prog is not None:
            return prog.run(rows)
        return fn(**self._tensors(rows))

    def _tensors(self, rows):
        return {k: torch.as_tensor(v, dtype=_INPUT_DTYPES[k]).to(self.device)
                for k, v in rows.items()}

    def _rows(self, bucket, width, tokens, positions, slots):
        """Live rows padded to ``bucket``: pad tokens, position 0, the
        scratch slot."""
        n = len(slots)
        tok = np.full((bucket,) + width, self.pad_id, np.int32)
        pos = np.zeros((bucket,), np.int32)
        slt = np.full((bucket,), self._scratch, np.int32)
        tok[:n], pos[:n], slt[:n] = tokens, positions, slots
        return {"tok": tok, "pos": pos, "slots": slt}

    @staticmethod
    def _host(t, n, dtype=None):
        # copies: on the CPU a static output would be returned as a view
        return t[:n].to("cpu", dtype, copy=True).numpy()

    @torch.inference_mode()
    def prefill(self, src_rows, slots):
        """Encode ``src_rows (n, src_len)`` into cache rows ``slots``: the
        rows covered by buckets, largest first."""
        src_rows = np.asarray(src_rows, np.int32).reshape(-1, self.src_len)
        slots = np.asarray(slots, np.int32)
        n = len(slots)
        done = 0
        while done < n:
            take = min(n - done, self._prefill_buckets[-1])
            pb = self._bucket(self._prefill_buckets, take)
            src = np.full((pb, self.src_len), self.pad_id, np.int32)
            slt = np.full((pb,), self._scratch, np.int32)
            src[:take] = src_rows[done:done + take]
            slt[:take] = slots[done:done + take]
            self._run("prefill", self._prefill_step, pb,
                      {"src": src, "slots": slt})
            done += take

    @torch.inference_mode()
    def decode(self, tokens, positions, slots):
        """One decode position for n live sequences; returns (next_tok
        (n,), logp (n,), bucket)."""
        n = len(slots)
        sb = self._bucket(self._decode_buckets, n)
        tok, lp = self._run("decode", self._decode_step, sb,
                            self._rows(sb, (), tokens, positions, slots))
        return self._host(tok, n, torch.int32), self._host(lp, n), sb

    @torch.inference_mode()
    def verify(self, tok_blocks, positions, slots):
        """Score ``tok_blocks (n, spec_k)`` starting at the committed
        ``positions``: the target's choice at each of the K positions,
        (toks (n, K), logps (n, K), bucket). The block's cache rows are
        written; rows of rejected proposals stay unread (the lengths mask
        them) until the next append at that position overwrites them."""
        if not self.spec_k:
            raise RuntimeError("model built without speculative_k")
        n = len(slots)
        sb = self._bucket(self._decode_buckets, n)
        tok, lp = self._run("verify", self._verify_step, sb,
                            self._rows(sb, (self.spec_k,), tok_blocks,
                                       positions, slots))
        return self._host(tok, n, torch.int32), self._host(lp, n), sb

    @torch.inference_mode()
    def decode_k(self, tokens, positions, slots):
        """Draft side: ``draft_steps`` greedy positions in one program;
        returns (props (n, draft_steps), bucket)."""
        if not self.draft_steps:
            raise RuntimeError("model built without draft_steps")
        n = len(slots)
        sb = self._bucket(self._decode_buckets, n)
        (props,) = self._run("draft", self._draft_step, sb,
                             self._rows(sb, (), tokens, positions, slots))
        return self._host(props, n, torch.int32), sb

    @torch.inference_mode()
    def decode_hidden(self, tokens, positions, slots):
        """The decode step's hidden state ``(sb, d_model)`` for one
        bucket-padded batch (numpy rows), appending K/V on the way."""
        return self._decode_hidden(**self._tensors(
            self._rows(len(slots), (), tokens, positions, slots)))

    @torch.inference_mode()
    def verify_hidden(self, tok_blocks, positions, slots):
        """The verify block's hidden state ``(sb, K, d_model)`` for one
        bucket-padded batch, appending K/V on the way."""
        tok_blocks = np.asarray(tok_blocks, np.int32)
        return self._verify_hidden(**self._tensors(self._rows(
            len(slots), tok_blocks.shape[1:], tok_blocks, positions, slots)))

    def close(self):
        for prog in self._programs.values():
            prog.graph.release()
        self._programs.clear()
        self.self_caches, self.cross_caches = [], []

    def statusz_info(self):
        return {"decode_buckets": self.decode_buckets,
                "prefill_buckets": self.prefill_buckets,
                "num_slots": self.num_slots,
                "max_decode_len": self.max_decode_len,
                "src_len": self.src_len, "int8": self.int8,
                "sampling": self.sampling, "spec_k": self.spec_k,
                "draft_steps": self.draft_steps,
                "aot_warmup": self.aot_warmup, "device": str(self.device)}


@torch.inference_mode()
def seq2seq_hidden_plain(stack: Seq2SeqStack, src, tgt_in):
    """Plain full re-forward of the encoder-decoder: the last decoder
    layer's hidden state ``(B, T, d_model)`` for source ids ``(B, S)`` and
    decoder inputs ``(B, T)``. Softmax attention (the pad bias on the
    source keys, the causal mask on the decoder's) and LayerNorm in
    PyTorch ops only: no kernel of the port runs here."""
    cfg = stack.cfg
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    dt = stack.compute_dtype

    def ln(mod, x):
        return layer_norm_plain(x, mod.gamma, mod.beta, eps=mod.eps)

    def attend(att, x, kv, bias=None, causal=False):
        b, sq, _ = x.shape
        sk = kv.shape[1]
        q = att["q"](x).reshape(b, sq, heads, hd).float()
        k = att["k"](kv).reshape(b, sk, heads, hd).float()
        v = att["v"](kv).reshape(b, sk, heads, hd).float()
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if bias is not None:
            sc = sc + bias[:, None, None, :]
        if causal:
            keep = torch.ones(sq, sk, dtype=torch.bool,
                              device=x.device).tril()
            sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, sq, d)
        return att["out"](a.to(dt))

    def embed(ids):
        return stack.embed(ids, torch.arange(ids.shape[1], device=ids.device))

    bias = (src == cfg.pad_id).to(torch.float32) * -1e9
    e = embed(src)
    for layer in stack.encoder.values():
        e = ln(layer.ln1, e + attend(layer.self_attn, e, e, bias))
        e = ln(layer.ln2, e + layer.ffn["out"](layer.ffn["in"](e)))
    h = embed(tgt_in)
    for layer in stack.layers:
        h = ln(layer.ln1, h + attend(layer.self_attn, h, h, causal=True))
        h = ln(layer.ln2, h + attend(layer.cross_attn, h, e, bias))
        h = ln(layer.ln3, h + layer.ffn["out"](layer.ffn["in"](h)))
    return h


@torch.inference_mode()
def seq2seq_logits_plain(stack: Seq2SeqStack, src, tgt_in, *,
                         int8_weights: Optional[tuple] = None):
    """Next-token logits ``(B, T, vocab)`` (f32) of the plain re-forward
    (:func:`seq2seq_hidden_plain`) and the logits head
    (``int8_weights=(wq, w_scale)`` for the int8 head) in PyTorch ops
    only; what the engine's tokens are checked against."""
    h = seq2seq_hidden_plain(stack, src, tgt_in)
    b, t, d = h.shape
    flat = h.reshape(b * t, d)
    if int8_weights is not None:
        logits = quant_matmul_plain(flat, *int8_weights)
    else:
        logits = torch.matmul(flat,
                              stack.shared_embedding.to(flat.dtype).t())
    return logits.float().reshape(b, t, stack.cfg.vocab_size)


def synthetic_wmt_batch(batch_size, src_len, tgt_len, vocab_size=32768,
                        seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(2, vocab_size, (batch_size, src_len)).astype(np.int32)
    tgt = rng.randint(2, vocab_size, (batch_size, tgt_len)).astype(np.int32)
    tgt_in = np.concatenate(
        [np.full((batch_size, 1), 1, np.int32), tgt[:, :-1]], axis=1)
    return {"src_ids": src, "tgt_in": tgt_in, "tgt_out": tgt}


def transformer_flops_per_token(cfg: TransformerConfig, src_len, tgt_len):
    d, ffn, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    enc = L * 2 * (4 * d * d + 2 * d * ffn + 2 * src_len * d)
    dec = L * 2 * (8 * d * d + 2 * d * ffn + 2 * (src_len + tgt_len) * d)
    emb = 2 * d * cfg.vocab_size
    return (enc + dec) / 2 + emb  # rough per-token average
