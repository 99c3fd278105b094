"""Long-context decoder-only LM: port of
``simple_tensorflow_tpu/models/long_context.py``.

The JAX code with the port's imports, so ``lm_train_model`` builds the
JAX graph op for op, with the JAX variable names, and ``stf.Session``
trains it on the card: pre-norm GPT-style blocks with RoPE (host-computed
sin/cos constants, rotate-half with stf ops), the mixed-precision
embedding lookup (``EmbeddingLookupMixed``: rows gathered in the compute
dtype, the gradient summed into the f32 table), every LayerNorm a
``FusedLayerNorm``, attention a ``RingAttention`` op, which with no mesh
(always, in the port: ``parallel/mesh.py``) is causal flash attention at
rate 0 (``parallel/ring_attention.py``), the tied vocab projection in the
compute dtype, the loss a ``FusedSoftmaxXent`` over the (B*S, vocab)
logits, and Adam one fused f32 group. At ``LongContextConfig()`` the head
dim is 128: the flash kernels' D = 128 instantiation.
``recompute="auto"`` resolves against the attached device through the
static cost model (``framework/cost_model.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import simple_tensorflow_tpu_torch as stf
from simple_tensorflow_tpu_torch import parallel
from . import common


@dataclasses.dataclass
class LongContextConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    num_heads: int = 8
    d_ff: int = 4096
    num_layers: int = 8
    max_len: int = 32768
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-6

    @staticmethod
    def tiny():
        return LongContextConfig(vocab_size=64, d_model=32, num_heads=2,
                                 d_ff=64, num_layers=2, max_len=128)


def _ln(x, cfg, name):
    return common.layer_norm(x, name, eps=cfg.layer_norm_eps)


def _dense(x, units, name, activation=None):
    init = stf.variance_scaling_initializer(1.0, "fan_in", "truncated_normal")
    return common.dense(x, units, init, name, activation=activation)


def rope_tables(seq_len, head_dim, theta=10000.0):
    """Host-computed RoPE cos/sin tables, shape (seq_len, head_dim)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    t = np.arange(seq_len)[:, None] * inv[None, :]  # (S, hd/2)
    cos = np.repeat(np.cos(t), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(t), 2, axis=1).astype(np.float32)
    return cos, sin


def _rotate_half(x, b, h, s, hd):
    """(..., 2i, 2i+1) -> (-x[2i+1], x[2i]) via reshape/stack (static)."""
    x2 = stf.reshape(x, [b, h, s, hd // 2, 2])
    x_even = stf.slice(x2, [0, 0, 0, 0, 0], [b, h, s, hd // 2, 1])
    x_odd = stf.slice(x2, [0, 0, 0, 0, 1], [b, h, s, hd // 2, 1])
    rot = stf.concat([-x_odd, x_even], axis=4)
    return stf.reshape(rot, [b, h, s, hd])


def apply_rope(x, cos, sin):
    """x (B,H,S,hd); cos/sin constants (S,hd)."""
    b, h = int(x.shape[0]), int(x.shape[1])
    s, hd = int(x.shape[2]), int(x.shape[3])
    c = stf.cast(stf.reshape(cos, [1, 1, s, hd]), x.dtype)
    sn = stf.cast(stf.reshape(sin, [1, 1, s, hd]), x.dtype)
    return x * c + _rotate_half(x, b, h, s, hd) * sn


def block(h, cfg, cos, sin, sp_axis, name):
    b, s = int(h.shape[0]), int(h.shape[1])
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    with stf.variable_scope(name):
        x = _ln(h, cfg, "ln_attn")
        qkv = _dense(x, 3 * d, "qkv")
        qkv = stf.transpose(stf.reshape(qkv, [b, s, 3, heads, hd]),
                            [2, 0, 3, 1, 4])  # (3,B,H,S,hd)
        q = stf.squeeze(stf.slice(qkv, [0, 0, 0, 0, 0],
                                  [1, b, heads, s, hd]), axis=[0])
        k = stf.squeeze(stf.slice(qkv, [1, 0, 0, 0, 0],
                                  [1, b, heads, s, hd]), axis=[0])
        v = stf.squeeze(stf.slice(qkv, [2, 0, 0, 0, 0],
                                  [1, b, heads, s, hd]), axis=[0])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ctx = parallel.ring_attention(q, k, v, axis=sp_axis, causal=True)
        ctx = stf.reshape(stf.transpose(ctx, [0, 2, 1, 3]), [b, s, d])
        h = h + _dense(ctx, d, "attn_out")
        x = _ln(h, cfg, "ln_mlp")
        m = _dense(x, cfg.d_ff, "mlp_in", activation=stf.nn.gelu)
        h = h + _dense(m, d, "mlp_out")
    return h


def lm_forward(ids, cfg, compute_dtype=stf.bfloat16, sp_axis="sp",
               scope="long_lm", recompute=False):
    """ids (B,S) -> logits (B,S,vocab)."""
    b, s = int(ids.shape[0]), int(ids.shape[1])
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        emb = stf.get_variable(
            "embedding", [cfg.vocab_size, cfg.d_model],
            initializer=stf.random_normal_initializer(
                stddev=cfg.d_model ** -0.5))
        # mixed-precision lookup: [B,S,D] activations in compute dtype,
        # gradient scatter-add accumulates into the f32 table
        h = stf.nn.embedding_lookup(emb, ids, compute_dtype=compute_dtype)
        cos, sin = rope_tables(s, cfg.d_model // cfg.num_heads,
                               cfg.rope_theta)
        cos, sin = stf.constant(cos), stf.constant(sin)

        def lm_layer(hh, i):
            return block(hh, cfg, cos, sin, sp_axis, f"layer_{i}")

        for i in range(cfg.num_layers):
            # at long context, per-layer activations ARE the memory budget
            h = common.maybe_recompute(lm_layer, h, i, recompute, "layer")
        h = _ln(h, cfg, "ln_final")
        # tied vocab projection in compute dtype — the [B*S, vocab] logits
        # are the largest tensor at long context; the fused xent kernel
        # does its softmax math in f32 blockwise
        flat = stf.reshape(h, [b * s, cfg.d_model])
        logits = stf.matmul(flat, stf.cast(emb, h.dtype.base_dtype),
                            transpose_b=True)
    return stf.reshape(logits, [b, s, cfg.vocab_size])


def lm_train_model(batch_size=1, seq_len=32768,
                   cfg: LongContextConfig | None = None,
                   learning_rate=3e-4, compute_dtype=stf.bfloat16,
                   sp_axis="sp", recompute=False):
    """Next-token LM training graph. recompute="auto" resolves against the
    attached device's memory via the static cost model
    (framework/cost_model.py resolve_recompute)."""
    cfg = cfg or LongContextConfig()
    from ..framework import cost_model as _cm

    # per-chip estimate: batch shards over dp, SEQUENCE over sp (1 and 1
    # without a mesh)
    _shards = _cm.mesh_shard_factor(["dp", sp_axis])
    recompute = _cm.resolve_recompute(
        recompute,
        _cm.transformer_activation_bytes(
            batch_size, seq_len, cfg.d_model, cfg.num_layers,
            dtype_bytes=compute_dtype.size) / _shards,
        forward_flops=_cm.transformer_forward_flops(
            batch_size, seq_len, cfg.d_model, cfg.num_layers,
            d_ff=cfg.d_ff) / _shards)
    ids = stf.placeholder(stf.int32, [batch_size, seq_len], "input_ids")
    targets = stf.placeholder(stf.int32, [batch_size, seq_len], "targets")
    mesh = parallel.current_mesh()
    if mesh is not None:
        spec = []
        if "dp" in mesh.axis_names:
            spec.append("dp")
        else:
            spec.append(None)
        if sp_axis in mesh.axis_names:
            spec.append(sp_axis)
        if len(spec) > 1 or spec[0] is not None:
            parallel.shard_feed(ids, *spec)
            parallel.shard_feed(targets, *spec)

    logits = lm_forward(ids, cfg, compute_dtype, sp_axis,
                        recompute=recompute)
    loss = stf.reduce_mean(stf.nn.fused_softmax_cross_entropy(
        stf.reshape(logits, [batch_size * seq_len, cfg.vocab_size]),
        stf.reshape(targets, [-1])))
    gs = stf.train.get_or_create_global_step()
    opt = stf.train.AdamOptimizer(learning_rate)
    train_op = opt.minimize(loss, global_step=gs)
    return {"input_ids": ids, "targets": targets, "loss": loss,
            "train_op": train_op, "global_step": gs}


def synthetic_lm_batch(batch_size, seq_len, vocab_size=32000, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab_size, (batch_size, seq_len + 1))
    return (ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
