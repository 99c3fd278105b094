"""The decoder-only pieces of the Transformer: serving and training.

Port of the parts of ``simple_tensorflow_tpu/models/transformer.py`` that
paged causal-LM serving and causal-LM training run:
``TransformerConfig`` (:35), ``sinusoidal_position_encoding`` (:131),
``_incremental_decode`` (:438) and ``_block_decode`` (:512) with
``cross_kv=None`` (no cross-attention sublayer, no ``ln2``),
``build_int8_logits_weights`` (:743), and the training sublayers
``_residual`` (:142), ``_attention`` (:152), ``_ffn`` (:181), ``_embed``
(:189) and ``smoothed_xent`` (:263); ``_ln`` (:67) is the
:class:`.common.LayerNorm` module. The seq2seq model and beam search come
in later slices.

In training with ``cfg.dropout > 0`` the sublayers drop as the JAX graph
does, each random op drawing from a per-step
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

from ..layers.core import DenseModule
from ..ops import fused_ops, nn_ops
from ..ops.embedding_ops import embedding_lookup
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.quant_matmul import div127
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


def _residual(sub_out, h, cfg: TransformerConfig, training, rng=None,
              scope=""):
    """Sublayer tail ``h + dropout(sub_out)`` through the fused op (JAX op
    ``{scope}/fused_dropout_residual``); rate 0 is the plain add."""
    if not _dropping(cfg, training):
        return fused_ops.fused_bias_dropout_residual(sub_out, h, rate=0.0)
    return fused_ops.fused_bias_dropout_residual(
        sub_out, h, rate=cfg.dropout,
        seed=rng.seed_for(f"{scope}/fused_dropout_residual"))


def _attention(layer: DecoderLayer, x, cfg: TransformerConfig, training,
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


def _ffn(layer: DecoderLayer, x, cfg: TransformerConfig, training, rng=None,
         scope=""):
    """FFN in (ReLU), dropout of the activation (JAX op
    ``{scope}/dropout``), FFN out."""
    h = layer.ffn["in"](x)
    if _dropping(cfg, training):
        h = nn_ops._dropout_impl(h, 1.0 - cfg.dropout,
                                 rng.key_for(f"{scope}/dropout"))
    return layer.ffn["out"](h)


def _embed(stack: DecoderStack, ids, compute_dtype, training, rng=None,
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
    weight-masked mean (f32 loss math), through the fused xent kernels."""
    vocab = cfg.vocab_size
    conf = 1.0 - cfg.label_smoothing
    low = cfg.label_smoothing / (vocab - 1)
    per_tok = fused_ops.fused_softmax_cross_entropy(
        logits, labels, label_smoothing=cfg.label_smoothing)
    norm = -(conf * math.log(conf) +
             (vocab - 1) * low * math.log(low + 1e-20))
    per_tok = per_tok - norm
    w = weights.float()
    return (per_tok * w).sum() / (w.sum() + 1e-9)
