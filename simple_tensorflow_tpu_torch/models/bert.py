"""BERT-base pretraining: MLM + NSP (BASELINE.json config 4).

Port of ``simple_tensorflow_tpu/models/bert.py``: the JAX code with the
port's imports, so ``bert_pretrain_model`` builds the JAX graph op for op
with the JAX variable names, and ``stf.Session`` trains it on the card.
Every attention layer is a ``FlashAttentionDropout`` op (the padding mask
rides the kernel's additive key bias; attention dropout is the kernel's
counter-hash mask), every LayerNorm a ``FusedLayerNorm``, the MLM loss a
``FusedSoftmaxXent`` over the gathered masked positions (the vocab
projection only at those rows), the NSP loss a sparse softmax
cross-entropy through the same kernels, and Adam one fused f32 group.
``recompute=True`` runs each encoder layer under ``stf.recompute_grad``
(``common.maybe_recompute``): the backward re-runs the layer's forward
from its input; ``recompute="auto"`` resolves it from the static cost
model against the attached device (``framework/cost_model.py``
``resolve_recompute``), as the JAX functions do. Not ported:
``data_parallel=True`` (it waits for the mesh of ``parallel/``); it raises
``NotImplementedError``.
:func:`synthetic_pretrain_batch` takes ``input_mask=True`` to add padded
rows (lengths from the seed), which the JAX function does not make.
:func:`write_pretrain_records` writes such batches as ``tf.Example``
TFRecord shards and :func:`pretrain_dataset` reads them back through
``stf.data`` (sharded parallel reads, one native parse a batch), the
batches fed to the model as they were written.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import simple_tensorflow_tpu_torch as stf
from . import common


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        """For tests: 2 layers, hidden 32."""
        return BertConfig(vocab_size=99, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64, max_position=64,
                          hidden_dropout=0.0, attention_dropout=0.0)


def _not_ported(data_parallel):
    if data_parallel:
        raise NotImplementedError(
            "data_parallel=True is not ported: it waits for the mesh and "
            "feed sharding of parallel/")


def _init(cfg):
    return stf.truncated_normal_initializer(stddev=cfg.initializer_range)


def _layer_norm(x, cfg, name):
    return common.layer_norm(x, name, eps=cfg.layer_norm_eps)


def _dense(x, units, cfg, name, activation=None):
    return common.dense(x, units, _init(cfg), name, activation=activation)


def attention_layer(h, attn_bias, cfg, training, compute_dtype,
                    name="attention"):
    """Multi-head self-attention. attn_bias: additive (B,1,1,S) or None.

    Always the flash-attention op: the padding bias passes through the
    kernel's additive key-bias input and attention dropout is applied
    inside the kernel (counter-hash mask, regenerated in the backward).
    """
    b = int(h.shape[0])
    s = int(h.shape[1])
    hidden = int(h.shape[2])
    heads = cfg.num_heads
    hd = hidden // heads
    with stf.variable_scope(name):
        q = _dense(h, hidden, cfg, "query")
        k = _dense(h, hidden, cfg, "key")
        v = _dense(h, hidden, cfg, "value")
        q = common.split_heads(q, b, s, heads, hd)
        k = common.split_heads(k, b, s, heads, hd)
        v = common.split_heads(v, b, s, heads, hd)
        key_bias = (stf.reshape(attn_bias, [b, s])
                    if attn_bias is not None else None)
        ctx = stf.nn.fused_attention(
            q, k, v, bias=key_bias, causal=False,
            dropout_rate=cfg.attention_dropout if training else 0.0)
        ctx = common.merge_heads(ctx, b, s, hidden)
        out = _dense(ctx, hidden, cfg, "output")
        if training and cfg.hidden_dropout > 0:
            out = stf.nn.dropout(out, keep_prob=1.0 - cfg.hidden_dropout)
    return out


def transformer_block(h, attn_bias, cfg, training, compute_dtype, name):
    with stf.variable_scope(name):
        attn = attention_layer(h, attn_bias, cfg, training, compute_dtype)
        h = _layer_norm(h + attn, cfg, "ln_attn")
        ffn = _dense(h, cfg.intermediate_size, cfg, "ffn_in",
                     activation=stf.nn.gelu)
        ffn = _dense(ffn, cfg.hidden_size, cfg, "ffn_out")
        if training and cfg.hidden_dropout > 0:
            ffn = stf.nn.dropout(ffn, keep_prob=1.0 - cfg.hidden_dropout)
        h = _layer_norm(h + ffn, cfg, "ln_ffn")
    return h


def bert_encoder(input_ids, token_type_ids, input_mask, cfg,
                 training=True, compute_dtype=stf.bfloat16,
                 scope="bert", recompute=False):
    """Returns (sequence_output [B,S,H], pooled_output [B,H],
    word_embeddings [V,H] — for MLM weight tying).

    recompute=True rematerializes each transformer block's activations in
    the backward pass (stf.recompute_grad): what a layer keeps for the
    backward shrinks from every intermediate to its [B,S,H] input, for
    one more forward of the layer.
    recompute="auto" resolves from the static cost model."""
    b = int(input_ids.shape[0])
    s = int(input_ids.shape[1])
    if recompute == "auto":
        # bert_encoder cannot know whether b is a per-chip or a global
        # batch (the caller's data_parallel decision: bert_pretrain_model
        # resolves "auto" before calling here), so the raw estimate treats
        # b as per-chip. No remat without a backward pass.
        from ..framework import cost_model as _cm

        recompute = training and _cm.resolve_recompute(
            "auto",
            _cm.transformer_activation_bytes(
                b, s, cfg.hidden_size, cfg.num_layers,
                dtype_bytes=compute_dtype.size),
            forward_flops=_cm.transformer_forward_flops(
                b, s, cfg.hidden_size, cfg.num_layers,
                d_ff=cfg.intermediate_size))
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        with stf.variable_scope("embeddings"):
            word_emb = stf.get_variable(
                "word_embeddings", [cfg.vocab_size, cfg.hidden_size],
                initializer=_init(cfg))
            pos_emb = stf.get_variable(
                "position_embeddings", [cfg.max_position, cfg.hidden_size],
                initializer=_init(cfg))
            type_emb = stf.get_variable(
                "token_type_embeddings",
                [cfg.type_vocab_size, cfg.hidden_size],
                initializer=_init(cfg))
            # mixed-precision lookups: the f32 tables are cast before the
            # gather (so the [B,S,H] activations, their LayerNorm, dropout,
            # and all VJPs move in compute dtype) while the gradient
            # scatter-add still accumulates into the table in f32
            h = stf.nn.embedding_lookup(word_emb, input_ids,
                                        compute_dtype=compute_dtype)
            h = h + stf.nn.embedding_lookup(type_emb, token_type_ids,
                                            compute_dtype=compute_dtype)
            h = h + stf.reshape(
                stf.cast(stf.slice(pos_emb, [0, 0], [s, cfg.hidden_size]),
                         compute_dtype),
                [1, s, cfg.hidden_size])
            h = _layer_norm(h, cfg, "ln")
            if training and cfg.hidden_dropout > 0:
                h = stf.nn.dropout(h, keep_prob=1.0 - cfg.hidden_dropout)

        if input_mask is not None:
            # additive bias: 0 where attendable, -1e9 where padded
            bias = (1.0 - stf.cast(stf.reshape(input_mask, [b, 1, 1, s]),
                                   stf.float32)) * -1e9
        else:
            bias = None
        with stf.variable_scope("encoder"):
            def enc_layer(hh, i):
                return transformer_block(hh, bias, cfg, training,
                                         compute_dtype, name=f"layer_{i}")

            for i in range(cfg.num_layers):
                h = common.maybe_recompute(enc_layer, h, i, recompute,
                                           "layer")
        # sequence_output stays in compute dtype: the MLM head reshapes and
        # gathers the full [B,S,H] tensor, and an early f32 cast here moved
        # it (plus its VJP) through memory at double width. Heads cast their
        # own SMALL slices up to f32 where the math wants it.
        sequence_output = h
        with stf.variable_scope("pooler"):
            first = stf.cast(stf.squeeze(
                stf.slice(sequence_output, [0, 0, 0],
                          [-1, 1, cfg.hidden_size]),
                axis=[1]), stf.float32)
            pooled = _dense(first, cfg.hidden_size, cfg, "dense",
                            activation=stf.tanh)
    return sequence_output, pooled, word_emb


def _gather_positions(seq_out, positions):
    """seq_out (B,S,H), positions (B,P) -> (B*P, H)."""
    b = int(seq_out.shape[0])
    s = int(seq_out.shape[1])
    hidden = int(seq_out.shape[2])
    flat_offsets = stf.reshape(stf.range(0, b) * s, [-1, 1])
    flat_pos = stf.reshape(positions + flat_offsets, [-1])
    flat_seq = stf.reshape(seq_out, [-1, hidden])
    return stf.gather(flat_seq, flat_pos)


def mlm_logits(seq_out, positions, word_emb, cfg, scope="cls/predictions"):
    """Masked-LM logits at ``positions``, vocab matrix tied to word_emb."""
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        x = _gather_positions(seq_out, positions)
        x = _dense(x, cfg.hidden_size, cfg, "transform",
                   activation=stf.nn.gelu)
        with stf.variable_scope("transform_ln"):
            gamma = stf.get_variable("gamma", [cfg.hidden_size],
                                     initializer=stf.ones_initializer())
            beta = stf.get_variable("beta", [cfg.hidden_size],
                                    initializer=stf.zeros_initializer())
            x = stf.nn.fused_layer_norm(x, gamma, beta, eps=cfg.layer_norm_eps)
        bias = stf.get_variable("output_bias", [cfg.vocab_size],
                                initializer=stf.zeros_initializer())
        # tied vocab matmul in compute dtype (accumulated in f32): the
        # [B*P, vocab] logits are the largest head tensor
        # (226 MB in f32 at base scale), and the fused xent kernel does its
        # max/logsumexp math in f32 blockwise regardless
        logits = stf.matmul(x, stf.cast(word_emb, x.dtype.base_dtype),
                            transpose_b=True) \
            + stf.cast(bias, x.dtype.base_dtype)
    return logits


def bert_pretrain_model(batch_size=32, seq_len=128, max_predictions=20,
                        cfg: BertConfig | None = None, learning_rate=1e-4,
                        compute_dtype=stf.bfloat16, use_input_mask=False,
                        data_parallel=False, recompute=False):
    """Full MLM+NSP pretraining graph (ref BERT pretraining recipe).
    recompute="auto" resolves here (where data_parallel is known) from
    the PER-CHIP activation estimate (one card: the global one)."""
    cfg = cfg or BertConfig.base()
    _not_ported(data_parallel)
    if recompute == "auto":
        from ..framework import cost_model as _cm

        _shards = _cm.mesh_shard_factor(["dp"] if data_parallel else [])
        recompute = _cm.resolve_recompute(
            "auto",
            _cm.transformer_activation_bytes(
                batch_size, seq_len, cfg.hidden_size, cfg.num_layers,
                dtype_bytes=compute_dtype.size) / _shards,
            forward_flops=_cm.transformer_forward_flops(
                batch_size, seq_len, cfg.hidden_size, cfg.num_layers,
                d_ff=cfg.intermediate_size) / _shards)
    input_ids = stf.placeholder(stf.int32, [batch_size, seq_len], "input_ids")
    token_type = stf.placeholder(stf.int32, [batch_size, seq_len],
                                 "token_type_ids")
    mlm_positions = stf.placeholder(stf.int32, [batch_size, max_predictions],
                                    "mlm_positions")
    mlm_ids = stf.placeholder(stf.int32, [batch_size, max_predictions],
                              "mlm_ids")
    mlm_weights = stf.placeholder(stf.float32, [batch_size, max_predictions],
                                  "mlm_weights")
    nsp_labels = stf.placeholder(stf.int32, [batch_size], "nsp_labels")
    feeds = dict(input_ids=input_ids, token_type_ids=token_type,
                 mlm_positions=mlm_positions, mlm_ids=mlm_ids,
                 mlm_weights=mlm_weights, nsp_labels=nsp_labels)
    input_mask = None
    if use_input_mask:
        input_mask = stf.placeholder(stf.int32, [batch_size, seq_len],
                                     "input_mask")
        feeds["input_mask"] = input_mask
    seq_out, pooled, word_emb = bert_encoder(
        input_ids, token_type, input_mask, cfg, training=True,
        compute_dtype=compute_dtype, recompute=recompute)

    # MLM loss over masked positions only, weight-normalized
    logits = mlm_logits(seq_out, mlm_positions, word_emb, cfg)
    per_ex = stf.nn.fused_softmax_cross_entropy(
        logits, stf.reshape(mlm_ids, [-1]))
    w = stf.reshape(mlm_weights, [-1])
    mlm_loss = stf.reduce_sum(per_ex * w) / (stf.reduce_sum(w) + 1e-5)

    # NSP
    with stf.variable_scope("cls/seq_relationship", reuse=stf.AUTO_REUSE):
        nsp_logits = stf.layers.dense(pooled, 2, kernel_initializer=_init(cfg),
                                      name="dense")
    nsp_loss = stf.reduce_mean(stf.nn.sparse_softmax_cross_entropy_with_logits(
        labels=nsp_labels, logits=nsp_logits))

    loss = mlm_loss + nsp_loss
    gs = stf.train.get_or_create_global_step()
    opt = stf.train.AdamOptimizer(learning_rate)
    train_op = opt.minimize(loss, global_step=gs)

    mlm_acc = stf.reduce_sum(stf.cast(stf.equal(
        stf.cast(stf.argmax(logits, 1, output_type=stf.int32), stf.int32),
        stf.reshape(mlm_ids, [-1])), stf.float32) * w) / (
            stf.reduce_sum(w) + 1e-5)
    return dict(feeds, loss=loss, mlm_loss=mlm_loss, nsp_loss=nsp_loss,
                train_op=train_op, mlm_accuracy=mlm_acc, global_step=gs)


def bert_flops_per_token(cfg: BertConfig, seq_len: int) -> float:
    """Analytic fwd FLOPs/token (6*params-ish + attention)."""
    h, L, ffn = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    per_layer = 2 * (4 * h * h + 2 * h * ffn)  # qkvo + ffn matmul MACs*2
    attn = 2 * 2 * seq_len * h  # scores + context per token
    emb = 2 * h * cfg.vocab_size / seq_len  # amortized mlm head
    return L * (per_layer + attn) + emb


def synthetic_pretrain_batch(batch_size, seq_len, max_predictions,
                             vocab_size=30522, seed=0, input_mask=False):
    """The JAX function's batch; with ``input_mask``, also an
    ``input_mask`` whose row lengths are drawn from the seed (after the
    JAX draws, which stay as they are) in ``[3 * seq_len // 4, seq_len]``,
    so the attention key bias masks real positions."""
    rng = np.random.RandomState(seed)
    batch = {
        "input_ids": rng.randint(0, vocab_size,
                                 (batch_size, seq_len)).astype(np.int32),
        "token_type_ids": rng.randint(0, 2,
                                      (batch_size, seq_len)).astype(np.int32),
        "mlm_positions": rng.randint(0, seq_len,
                                     (batch_size, max_predictions)
                                     ).astype(np.int32),
        "mlm_ids": rng.randint(0, vocab_size,
                               (batch_size, max_predictions)).astype(np.int32),
        "mlm_weights": np.ones((batch_size, max_predictions), np.float32),
        "nsp_labels": rng.randint(0, 2, batch_size).astype(np.int32),
    }
    if input_mask:
        lengths = rng.randint(3 * seq_len // 4, seq_len + 1, batch_size)
        batch["input_mask"] = (np.arange(seq_len)[None, :]
                               < lengths[:, None]).astype(np.int32)
    return batch


# the int features of a pretraining Example (int64 on the wire, int32
# placeholders), and the float one
PRETRAIN_INT_FEATURES = ("input_ids", "token_type_ids", "input_mask",
                         "mlm_positions", "mlm_ids", "nsp_labels")


def write_pretrain_records(prefix, n_batches, batch_size, seq_len,
                           max_predictions, vocab_size=30522, shards=8,
                           seed=0):
    """``n_batches`` batches ``synthetic_pretrain_batch(batch_size, seq_len,
    max_predictions, vocab_size, seed=seed + k, input_mask=True)`` as
    ``tf.Example`` records, one a row, in ``shards`` TFRecord files of
    consecutive records (a reader in strict shard order gives them back in
    the order written). Returns ``(files, batches)``."""
    from ..lib.example import make_example
    from ..lib.io.tf_record import TFRecordWriter

    batches = [synthetic_pretrain_batch(batch_size, seq_len,
                                        max_predictions, vocab_size,
                                        seed=seed + k, input_mask=True)
               for k in range(n_batches)]
    rows = [{k: v[i] for k, v in b.items()}
            for b in batches for i in range(batch_size)]
    per = -(-len(rows) // shards)
    files = [f"{prefix}-{s:05d}-of-{shards:05d}" for s in range(shards)]
    for s, f in enumerate(files):
        with TFRecordWriter(f) as w:
            for row in rows[s * per:(s + 1) * per]:
                feats = {k: np.ravel(row[k]).astype(np.int64).tolist()
                         for k in PRETRAIN_INT_FEATURES}
                feats["mlm_weights"] = np.ravel(
                    row["mlm_weights"]).astype(np.float32).tolist()
                w.write(make_example(**feats).SerializeToString())
    return files, batches


def pretrain_spec(seq_len, max_predictions):
    """The ``parse_example`` spec of :func:`write_pretrain_records`'s
    Examples."""
    width = {"input_ids": [seq_len], "token_type_ids": [seq_len],
             "input_mask": [seq_len], "mlm_positions": [max_predictions],
             "mlm_ids": [max_predictions], "nsp_labels": []}
    spec = {k: stf.FixedLenFeature(width[k], stf.int64)
            for k in PRETRAIN_INT_FEATURES}
    spec["mlm_weights"] = stf.FixedLenFeature([max_predictions],
                                              stf.float32)
    return spec


def to_feed_dtypes(batch):
    """A parsed batch in the model's feed dtypes: the int64 features as
    int32."""
    return {k: v.astype(np.int32) if k in PRETRAIN_INT_FEATURES else v
            for k, v in batch.items()}


def pretrain_dataset(files, batch_size, seq_len, max_predictions,
                     shuffle=None):
    """``TFRecordDataset(files, num_parallel_reads=AUTOTUNE)`` (with
    ``shuffle``, ``(buffer, seed)``, a seeded shuffle of the records),
    ``.repeat().batch(batch_size).parse_example(spec)`` and the casts of
    :func:`to_feed_dtypes`: an endless stream of feed dicts."""
    ds = stf.data.TFRecordDataset(files,
                                  num_parallel_reads=stf.data.AUTOTUNE)
    if shuffle is not None:
        ds = ds.shuffle(shuffle[0], seed=shuffle[1])
    return (ds.repeat().batch(batch_size)
            .parse_example(pretrain_spec(seq_len, max_predictions))
            .map(to_feed_dtypes))
