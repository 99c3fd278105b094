"""Attention seq2seq: an LSTM encoder and decoder with Luong dot
attention, trained with teacher forcing and decoded greedily (the TF-1
``translate`` tutorial's recipe).

Port of ``simple_tensorflow_tpu/models/rnn_seq2seq.py``: the JAX file
with the port's imports, so ``seq2seq_model`` builds the JAX graph op for
op: the encoder's ``dynamic_rnn`` (``sequence_length`` select-masking),
the teacher-forced decoder ``Scan`` (``dec_train``; the output projection
runs once on the stacked outputs) and the greedy one (``dec_greedy``,
its argmax fed back through the target embedding), the attention a
batched product (``BatchMatMul``) with a masked softmax. Static shapes
throughout.
"""

from __future__ import annotations

import numpy as np

import simple_tensorflow_tpu_torch as stf
from simple_tensorflow_tpu_torch.ops import rnn, rnn_cell


class Seq2SeqConfig:
    def __init__(self, src_vocab=120, tgt_vocab=120, hidden=64,
                 src_len=12, tgt_len=12, learning_rate=0.01,
                 max_grad_norm=5.0):
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.hidden = hidden
        self.src_len = src_len
        self.tgt_len = tgt_len
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm

    @staticmethod
    def tiny():
        return Seq2SeqConfig(src_vocab=24, tgt_vocab=24, hidden=32,
                             src_len=7, tgt_len=7, learning_rate=0.05)


GO_ID = 1  # decoder start symbol; 0 is padding


def _attention(query, memory, src_mask):
    """Luong dot attention. query [B,H], memory [B,Ts,H], src_mask
    [B,Ts] (1 = real token) -> context [B,H]."""
    # [B,Ts] scores: a batched matrix-vector product
    scores = stf.squeeze(stf.matmul(memory, stf.expand_dims(query, -1)),
                         axis=[-1])
    neg = stf.constant(np.float32(-1e9))
    scores = stf.where(stf.cast(src_mask, stf.bool), scores,
                       stf.ones_like(scores) * neg)
    probs = stf.nn.softmax(scores)
    return stf.squeeze(stf.matmul(stf.expand_dims(probs, 1), memory),
                       axis=[1])


def seq2seq_model(batch_size, config=None, training=True):
    """Build graph; returns the tensor dict (src, src_len, tgt_in,
    tgt_out, tgt_mask placeholders; loss, train_op, logits, decoded)."""
    cfg = config or Seq2SeqConfig()
    B, H = batch_size, cfg.hidden

    src = stf.placeholder(stf.int32, [B, cfg.src_len], name="src")
    src_len = stf.placeholder(stf.int32, [B], name="src_len")
    # teacher-forced decoder input (GO + shifted target) and target out
    tgt_in = stf.placeholder(stf.int32, [B, cfg.tgt_len], name="tgt_in")
    tgt_out = stf.placeholder(stf.int32, [B, cfg.tgt_len], name="tgt_out")

    with stf.variable_scope("seq2seq", reuse=stf.AUTO_REUSE):
        init = stf.random_uniform_initializer(-0.08, 0.08, seed=7)
        src_emb = stf.get_variable("src_emb", [cfg.src_vocab, H],
                                   initializer=init)
        tgt_emb = stf.get_variable("tgt_emb", [cfg.tgt_vocab, H],
                                   initializer=init)

        # ---- encoder ----------------------------------------------------
        enc_in = stf.nn.embedding_lookup(src_emb, src)
        with stf.variable_scope("encoder"):
            enc_cell = rnn_cell.BasicLSTMCell(H)
            memory, enc_state = rnn.dynamic_rnn(
                enc_cell, enc_in, sequence_length=src_len,
                dtype=stf.float32)
        src_mask = stf.sequence_mask(src_len, cfg.src_len,
                                     dtype=stf.float32)

        # ---- decoder scan (shared by train + greedy decode) -------------
        dec_cell = rnn_cell.BasicLSTMCell(H)

        # reference-scan semantics: fn returns the new ACCUMULATOR and
        # scan stacks every component per step — so the per-step outputs
        # (att_h, predicted id) ride in the carry alongside the state
        def make_step(feed_previous):
            def step(carry, elem):
                state, prev_ctx, prev_id, _prev_att = carry
                x_t = elem
                if feed_previous:
                    inp = stf.nn.embedding_lookup(tgt_emb, prev_id)
                else:
                    inp = x_t
                with stf.variable_scope("decoder", reuse=stf.AUTO_REUSE):
                    cell_in = stf.concat([inp, prev_ctx], 1)
                    h, new_state = dec_cell(cell_in, state)
                    ctx = _attention(h, memory, src_mask)
                    # Luong: attentional hidden = tanh(Wc [h; ctx])
                    att_h = stf.tanh(rnn_cell._linear(
                        [h, ctx], H, bias=False, scope_name="attn_mix"))
                    if feed_previous:
                        # only greedy decode needs the per-step vocab
                        # projection; the teacher-forced body carries the
                        # id through untouched so training pays the
                        # [T*B,H]@[H,V] matmul exactly once, outside the
                        # scan
                        logit = rnn_cell._linear([att_h], cfg.tgt_vocab,
                                                 bias=True,
                                                 scope_name="proj")
                        nxt = stf.argmax(logit, axis=-1,
                                         output_type=stf.int32)
                    else:
                        nxt = prev_id
                return (new_state, ctx, nxt, att_h)
            return step

        zero_ctx = stf.zeros([B, H])
        zero_att = stf.zeros([B, H])
        go_ids = stf.fill([B], stf.constant(np.int32(GO_ID)))

        # variables must exist in the ROOT graph before the scan body is
        # traced (FuncGraph-created variables would be lost); run one
        # throwaway feed_previous step (the variant that touches EVERY
        # variable incl. proj) — nothing fetches it, so it prunes away
        make_step(True)((enc_state, zero_ctx, go_ids, zero_att),
                        stf.nn.embedding_lookup(tgt_emb, go_ids))

        dec_in = stf.transpose(
            stf.nn.embedding_lookup(tgt_emb, tgt_in), [1, 0, 2])
        from simple_tensorflow_tpu_torch.ops import functional_ops

        init = (enc_state, zero_ctx, go_ids, zero_att)
        _, _, _, att_seq = functional_ops.scan(
            make_step(False), dec_in, initializer=init, name="dec_train")
        # one [T*B,H] @ [H,V] projection — re-run proj on stacked outputs
        with stf.variable_scope("decoder", reuse=True):
            flat = stf.reshape(att_seq, [cfg.tgt_len * B, H])
            logits_flat = rnn_cell._linear([flat], cfg.tgt_vocab,
                                           bias=True, scope_name="proj")
        logits = stf.transpose(
            stf.reshape(logits_flat, [cfg.tgt_len, B, cfg.tgt_vocab]),
            [1, 0, 2])

        # greedy decode path (feed_previous=True), same variables; the
        # elems tensor only supplies the trip count (the body feeds back
        # prev_id), so thread the smallest possible buffer
        dummy = stf.zeros([cfg.tgt_len, 1])
        _, _, ids_seq, _ = functional_ops.scan(
            make_step(True), dummy, initializer=init, name="dec_greedy")
        decoded = stf.transpose(ids_seq, [1, 0])

        # ---- loss: length-masked teacher-forced xent --------------------
        tgt_mask = stf.cast(stf.not_equal(tgt_out, 0), stf.float32)
        xent = stf.nn.sparse_softmax_cross_entropy_with_logits(
            labels=tgt_out, logits=logits)
        loss = stf.reduce_sum(xent * tgt_mask) / \
            stf.maximum(stf.reduce_sum(tgt_mask), 1.0)

    out = {"src": src, "src_len": src_len, "tgt_in": tgt_in,
           "tgt_out": tgt_out, "loss": loss, "logits": logits,
           "decoded": decoded}
    if training:
        tvars = stf.trainable_variables()
        grads = stf.gradients(loss, tvars)
        clipped, _ = stf.clip_by_global_norm(grads, cfg.max_grad_norm)
        opt = stf.train.AdamOptimizer(cfg.learning_rate)
        out["train_op"] = opt.apply_gradients(zip(clipped, tvars))
    return out


def synthetic_copy_batch(batch_size, cfg, seed=0):
    """The classic seq2seq sanity task: copy a random token sequence.
    Returns feeds for (src, src_len, tgt_in, tgt_out)."""
    rng = np.random.RandomState(seed)
    L = cfg.src_len
    lens = rng.randint(2, L + 1, size=batch_size).astype(np.int32)
    src = np.zeros((batch_size, L), np.int32)
    for i, n in enumerate(lens):
        src[i, :n] = rng.randint(2, cfg.src_vocab, size=n)
    tgt_out = np.zeros((batch_size, cfg.tgt_len), np.int32)
    tgt_out[:, :L] = src[:, :cfg.tgt_len]
    tgt_in = np.zeros_like(tgt_out)
    tgt_in[:, 0] = GO_ID
    tgt_in[:, 1:] = tgt_out[:, :-1]
    return src, lens, tgt_in, tgt_out
