"""PTB-style LSTM language model: the TF-1.0 ``ptb_word_lm`` recipe
(embedding, a stacked LSTM through ``dynamic_rnn``, a softmax over every
step's output, truncated BPTT with the state carried across
``Session.run`` calls, gradients clipped by global norm, SGD with an
assignable learning rate).

Port of ``simple_tensorflow_tpu/models/ptb_lstm.py``: the JAX file with
the port's imports, so ``ptb_lm_model`` builds the JAX graph op for op
(one ``Scan`` over the 35 steps, its body's two ``Dropout`` ops drawing
the same mask at every step). The carried state is fed through
``state_in`` placeholders and fetched from ``state_out``. f32 by default;
``compute_dtype`` sets the embedding's and the LSTM's dtype (the LSTM
kernels are made in it), the logits and the loss stay f32.
"""

from __future__ import annotations

import numpy as np

import simple_tensorflow_tpu_torch as stf


class PTBConfig:
    def __init__(self, vocab_size=10000, hidden=650, layers=2,
                 seq_len=35, keep_prob=0.5, max_grad_norm=5.0,
                 learning_rate=1.0):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.seq_len = seq_len
        self.keep_prob = keep_prob
        self.max_grad_norm = max_grad_norm
        self.learning_rate = learning_rate

    @staticmethod
    def medium():
        return PTBConfig()

    @staticmethod
    def tiny():
        return PTBConfig(vocab_size=200, hidden=32, layers=2, seq_len=8,
                         keep_prob=1.0)


def ptb_lm_model(batch_size, cfg: PTBConfig | None = None, training=True,
                 compute_dtype=stf.float32):
    """Build the training graph. Returns dict with input_ids/target_ids
    placeholders, state_in placeholders, state_out fetches, loss
    (per-word xent), train_op, and lr update handles.

    (ref recipe: tutorials/rnn/ptb/ptb_word_lm.py of the TF-1.0 era —
    reimplemented from the published architecture, not the file.)
    """
    from simple_tensorflow_tpu_torch.ops import rnn, rnn_cell

    cfg = cfg or PTBConfig.medium()
    B, T, H, V = batch_size, cfg.seq_len, cfg.hidden, cfg.vocab_size

    input_ids = stf.placeholder(stf.int32, [B, T], name="input_ids")
    target_ids = stf.placeholder(stf.int32, [B, T], name="target_ids")

    emb = stf.get_variable(
        "embedding", shape=(V, H),
        initializer=stf.random_uniform_initializer(-0.1, 0.1, seed=1))
    x = stf.nn.embedding_lookup(emb, input_ids,
                                compute_dtype=compute_dtype)
    if training and cfg.keep_prob < 1.0:
        x = stf.nn.dropout(x, keep_prob=cfg.keep_prob, seed=11)

    def make_cell(i):
        cell = rnn_cell.BasicLSTMCell(H, forget_bias=0.0)
        if training and cfg.keep_prob < 1.0:
            cell = rnn_cell.DropoutWrapper(
                cell, output_keep_prob=cfg.keep_prob, seed=100 + i)
        return cell

    cell = rnn_cell.MultiRNNCell([make_cell(i)
                                  for i in range(cfg.layers)])

    # truncated-BPTT state: placeholders in, fetch tensors out
    state_in = []
    for li in range(cfg.layers):
        c = stf.placeholder(compute_dtype, [B, H], name=f"state_c{li}")
        h = stf.placeholder(compute_dtype, [B, H], name=f"state_h{li}")
        state_in.append(rnn_cell.LSTMStateTuple(c, h))
    outputs, state_out = rnn.dynamic_rnn(
        cell, x, initial_state=tuple(state_in), dtype=compute_dtype,
        scope="ptb_rnn")

    softmax_w = stf.get_variable(
        "softmax_w", shape=(H, V),
        initializer=stf.random_uniform_initializer(-0.1, 0.1, seed=2))
    softmax_b = stf.get_variable(
        "softmax_b", shape=(V,), initializer=stf.zeros_initializer())
    flat = stf.reshape(outputs, [B * T, H])
    logits = stf.cast(stf.matmul(flat, stf.cast(softmax_w, compute_dtype))
                      + stf.cast(softmax_b, compute_dtype), stf.float32)
    loss = stf.reduce_mean(
        stf.nn.sparse_softmax_cross_entropy_with_logits(
            labels=stf.reshape(target_ids, [B * T]), logits=logits))

    model = {"input_ids": input_ids, "target_ids": target_ids,
             "state_in": state_in, "state_out": state_out,
             "loss": loss, "logits": logits}

    if training:
        # PTB recipe: clip by GLOBAL norm, plain SGD, assignable lr
        lr = stf.get_variable("lr", shape=(),
                              initializer=stf.constant_initializer(
                                  cfg.learning_rate), trainable=False)
        new_lr = stf.placeholder(stf.float32, [], name="new_lr")
        model["lr"] = lr
        model["new_lr"] = new_lr
        model["lr_update"] = lr.assign(new_lr)
        tvars = stf.trainable_variables()
        grads = stf.gradients(loss, tvars)
        clipped, _ = stf.clip_by_global_norm(grads, cfg.max_grad_norm)
        opt = stf.train.GradientDescentOptimizer(lr.value())
        gs = stf.train.get_or_create_global_step()
        model["train_op"] = opt.apply_gradients(
            list(zip(clipped, tvars)), global_step=gs)
        model["global_step"] = gs
    return model


def zero_state(batch_size, cfg: PTBConfig, dtype=np.float32):
    return [(np.zeros((batch_size, cfg.hidden), dtype),
             np.zeros((batch_size, cfg.hidden), dtype))
            for _ in range(cfg.layers)]


def state_feed(model, state_np):
    feed = {}
    for (c_ph, h_ph), (c, h) in zip(model["state_in"], state_np):
        feed[c_ph] = c
        feed[h_ph] = h
    return feed


def synthetic_ptb_batch(batch_size, seq_len, vocab_size, seed=0):
    rng = np.random.RandomState(seed)
    # a learnable synthetic language: next id = (id * 3 + 7) % V with noise
    start = rng.randint(0, vocab_size, size=(batch_size, 1))
    seqs = [start]
    for _ in range(seq_len):
        seqs.append((seqs[-1] * 3 + 7) % vocab_size)
    full = np.concatenate(seqs, axis=1)
    return full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
