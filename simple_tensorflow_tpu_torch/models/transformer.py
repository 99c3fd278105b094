"""The Transformer of ``simple_tensorflow_tpu/models/transformer.py``:
the seq2seq training graph, and the decoder-only eager pieces of
serving and causal-LM training.

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
JAX ``_incremental_decode`` :438) and ``block_decode`` (:512) with
``cross_kv=None`` (no cross-attention
sublayer, no ``ln2``), ``build_int8_logits_weights`` (:743), and the
causal-LM training sublayers. Where a private name of the JAX file is
both, the graph function keeps it and the eager sublayer is
``_eager_residual``, ``_eager_attention``, ``_eager_ffn`` or
``_eager_embed``; ``smoothed_xent`` takes either (it builds graph ops for
graph tensors). ``_ln`` is :class:`.common.LayerNorm` in the eager
models.

In eager training with ``cfg.dropout > 0`` the sublayers drop as the JAX
graph does, each random op drawing from a per-step
:class:`..framework.random_seed.StepRNG` under its JAX op name (``scope``
is the op's variable scope): the embedding and the FFN activation through
``nn_ops._dropout_impl`` (threefry keys), the attention probabilities
inside the flash kernels and the attention tail through the fused
dropout-residual kernel (int32 seeds of the counter-hash mask).

A :class:`DecoderStack`'s ``state_dict`` keys are the JAX variable paths
under the model scope with ``.`` for ``/`` (``shared_embedding``,
``decoder.layer_0.self_attn.q.kernel``, ``decoder.layer_0.ln1.gamma``, …);
:mod:`..convert` maps between the two.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

import simple_tensorflow_tpu_torch as stf

from ..framework import graph as ops_mod
from ..layers.core import DenseModule
from ..ops import fused_ops, nn_ops
from ..ops.embedding_ops import embedding_lookup
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.quant_matmul import div127
from . import common
from .common import LayerNorm, merge_heads, split_heads


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


class DecoderLayer(nn.Module):
    """Self-attention (q, k, v, out), ``ln1``, FFN (in with ReLU, out),
    ``ln3`` — the causal-LM layer, named as in the JAX graph. ``dtype`` is
    the Dense parameters' dtype (the compute dtype in training); the
    LayerNorm parameters stay f32."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = nn.ModuleDict(
            {name: DenseModule(d, d, dtype=dtype, device=device)
             for name in ("q", "k", "v", "out")})
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.ffn = nn.ModuleDict({
            "in": DenseModule(d, cfg.d_ff, activation=torch.relu,
                              dtype=dtype, device=device),
            "out": DenseModule(cfg.d_ff, d, dtype=dtype, device=device)})
        self.ln3 = LayerNorm(d, cfg.layer_norm_eps, device=device)


class DecoderStack(nn.Module):
    """The tied embedding (f32), the sinusoidal position table and the
    decoder layers of one causal LM; ``dtype`` as in
    :class:`DecoderLayer`."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.shared_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.d_model, device=device))
        self.decoder = nn.ModuleDict(
            {f"layer_{i}": DecoderLayer(cfg, dtype=dtype, device=device)
             for i in range(cfg.num_layers)})
        self.register_buffer(
            "pos_table",
            torch.from_numpy(sinusoidal_position_encoding(
                cfg.max_len, cfg.d_model)).to(device),
            persistent=False)
        self.register_buffer(
            "emb_scale", torch.tensor(math.sqrt(cfg.d_model),
                                      dtype=torch.float32, device=device),
            persistent=False)

    @property
    def layers(self):
        return list(self.decoder.values())

    def embed(self, tok, positions):
        """Scaled embedding rows plus position encodings (f32)."""
        return (self.shared_embedding[tok] * self.emb_scale
                + self.pos_table[positions])


def _self_attention_out(layer, a, shape):
    return layer.self_attn["out"](a.reshape(shape))


def _ffn_tail(layer, h):
    f = layer.ffn["out"](layer.ffn["in"](h))
    return layer.ln3(h + f)


def incremental_decode(stack: DecoderStack, tok, pos, caches):
    """ONE decoder position for B sequences against cached state.

    ``tok (B,)`` int input tokens at absolute positions ``pos (B,)``;
    ``caches``: an accessor with ``append_and_gather(layer, k_new,
    v_new) -> (k_all, v_all, lengths)``. Returns the hidden state
    ``h (B, d_model)``; the caller owns the logits head."""
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
        h = _ffn_tail(layer, h)
    return h


def block_decode(stack: DecoderStack, tok_block, pos, caches):
    """A BLOCK of Kq consecutive positions for B sequences: ``tok_block
    (B, Kq)`` at positions ``pos[b] .. pos[b] + Kq - 1``; ``caches``: an
    accessor with ``append_and_gather_block`` returning the committed
    prefix BEFORE the block as lengths (query-block decode attention with
    ``causal_offset=True``). Returns ``h (B, Kq, d_model)``."""
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
               causal=True, rng=None, scope=""):
    """Self-attention of ``x (B, S, D)``: q/k/v projections, heads split
    to ``(B, H, S, hd)``, the flash-attention kernels (probability
    dropout from JAX op ``{scope}/flash_attention``), heads merged, the
    output projection."""
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
    ctx = fused_ops.fused_attention(q, k, v, causal=causal,
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
