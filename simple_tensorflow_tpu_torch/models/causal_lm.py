"""Decoder-only causal LM: training and paged serving.

Port of ``simple_tensorflow_tpu/models/causal_lm.py``. Two halves, as
there:

- training: :func:`causal_lm_logits` / :func:`causal_lm_train_model`
  (:50, :83), the JAX code with the port's imports, build the training
  graph for ``stf.Session`` (``transformer.py``'s graph helpers with
  causal flash attention; the variable scopes of JAX, ``ln3`` and not
  ``ln2`` after the FFN, which the serving model reads by name; Adam with
  the noam schedule). Beside them, the same step as eager PyTorch:
  :func:`causal_lm_trainer` and :class:`CausalLMTrainer` run the forward
  through the flash-attention, LayerNorm and softmax-xent kernels (and,
  at ``cfg.dropout > 0``, the dropout kernels with the JAX program's
  masks) and take one Adam step (the fused flat-group kernel) with the
  noam schedule per call.
- ``build_causal_lm_program`` (:146) and ``CausalLMGenerativeModel`` (:325)
  with greedy ``_emit`` (:248): paged serving. Each layer keeps a
K and a V :class:`..ops.kv_cache.KVCache` of ``(num_pages + 1, page_len,
H, hd)``; a sequence's state is its ordered page table, and attention
reads the logical view the page-table gather builds. The serving engine
(serving/generative.py) owns the page tables; this model runs the device
half:

- ``prefill_chunk``: one page-aligned block of ``page_len`` prompt tokens
  per row, through the query-block decode attention with
  ``causal_offset=True``, appended into each row's destination page;
- ``decode``: one position for the live rows, the write page and offset
  resolved here from the page table, greedy argmax and its log-prob;
- ``copy_page``: copy-on-write of one page across every layer cache.

Decode and prefill run at per-bucket batch shapes; padding rows feed the
pad token at position 0 and point every page-table entry and the write
target at the scratch page (:482-539 of the JAX module), so they never
touch a live page. With ``aot_warmup=True`` (the JAX name and default,
:343, :420-441) the model captures, when it is built, one CUDA graph per
decode bucket (``decode_hidden``, the logits head and ``greedy_emit``
over static ``tok/pos/tbl/dst/off`` inputs and static ``next_tok/logp``
outputs) and one per prefill bucket (``block_decode`` over static
``tok/base/tbl/dst``), each after an eager warm-up on all-padding rows
(which write only the scratch page); ``decode`` and ``prefill_chunk``
then stage their rows, padding included, through pinned host buffers and
replay (``compiler/aot.py``). On the CPU the same buckets run their
function eagerly into the static buffers. Copy-on-write stays eager.

:func:`causal_lm_logits_plain` is the plain full re-forward (causal
attention, LayerNorm and the logits head in PyTorch ops, no kernel): the
reference the engine's tokens are checked against. It is on neither path.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

import simple_tensorflow_tpu_torch as stf

from ..framework.random_seed import StepRNG, fold_in_value
from ..ops import fused_ops
from ..ops.kernels.common import NEG_INF
from ..ops.kernels.fused_update import adam_update, adam_update_plain
from ..ops.kernels.layer_norm import layer_norm_plain
from ..ops.kernels.quant_matmul import quant_matmul, quant_matmul_plain
from ..ops.kv_cache import KVCache
from ..train.optimizers import FlatAdam
from . import common
from .common import BucketProgram, greedy_emit, resolve_device
from .transformer import (DecoderStack, TransformerConfig, _attention,
                          _eager_attention, _eager_embed, _eager_ffn,
                          _eager_residual, _embed, _ffn, _ln,
                          _residual, block_decode,
                          build_int8_logits_weights, incremental_decode,
                          smoothed_xent)


# ---------------------------------------------------------------------------
# The training graph (TF-1 front end)
# ---------------------------------------------------------------------------

def causal_lm_logits(ids, cfg: TransformerConfig, training=True,
                     compute_dtype=stf.bfloat16, scope="causal_lm",
                     recompute=False):
    """Next-token logits (B, S, vocab) for token ids (B, S) (:50):
    causal flash self-attention + FFN per layer, tied-embedding softmax.
    Position ``j``'s logits predict token ``j+1``. ``recompute="auto"``
    is truthy here, as in the JAX function: every layer recomputes."""
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        h, emb = _embed(ids, cfg, compute_dtype, training)
        with stf.variable_scope("decoder"):
            def lm_layer(hh, i):
                with stf.variable_scope(f"layer_{i}"):
                    a = _attention(hh, hh, None, cfg, training,
                                   compute_dtype, "self_attn", causal=True)
                    hh = _ln(_residual(a, hh, cfg, training), cfg, "ln1")
                    f = _ffn(hh, cfg, training, "ffn")
                    # ln3, not ln2: the serving step reuses these
                    # variables by name
                    return _ln(hh + f, cfg, "ln3")

            for i in range(cfg.num_layers):
                h = common.maybe_recompute(lm_layer, h, i, recompute, "lm")
        b, s = int(ids.shape[0]), int(ids.shape[1])
        flat = stf.reshape(h, [b * s, cfg.d_model])
        logits = stf.matmul(flat, stf.cast(emb, h.dtype.base_dtype),
                            transpose_b=True)
        return stf.reshape(logits, [b, s, cfg.vocab_size])


def causal_lm_train_model(batch_size=8, seq_len=32,
                          cfg: TransformerConfig | None = None,
                          learning_rate=1.0, warmup_steps=4000,
                          compute_dtype=stf.bfloat16, recompute=False):
    """Training graph (:83): tok_in/tok_out -> label-smoothed LM loss ->
    Adam with the noam schedule (the seq2seq transformer's recipe)."""
    cfg = cfg or TransformerConfig.base()
    tok_in = stf.placeholder(stf.int32, [batch_size, seq_len], "tok_in")
    tok_out = stf.placeholder(stf.int32, [batch_size, seq_len], "tok_out")
    logits = causal_lm_logits(tok_in, cfg, training=True,
                              compute_dtype=compute_dtype,
                              recompute=recompute)
    weights = stf.cast(stf.not_equal(tok_out, cfg.pad_id), stf.float32)
    loss = smoothed_xent(logits, tok_out, weights, cfg)
    gs = stf.train.get_or_create_global_step()
    step = stf.cast(gs, stf.float32) + 1.0
    lr = (learning_rate * cfg.d_model ** -0.5 *
          stf.minimum(stf.pow(step, -0.5), step * warmup_steps ** -1.5))
    opt = stf.train.AdamOptimizer(lr, beta1=0.9, beta2=0.997,
                                  epsilon=1e-9)
    train_op = opt.minimize(loss, global_step=gs)
    return {"tok_in": tok_in, "tok_out": tok_out, "loss": loss,
            "train_op": train_op, "learning_rate": lr, "global_step": gs}


# ---------------------------------------------------------------------------
# Training, eager
# ---------------------------------------------------------------------------

def dropout_sites(cfg: TransformerConfig, scope="causal_lm"):
    """``[(JAX op name, kind)]`` of the training graph's random ops in
    graph order: ``"key"`` for a ``Dropout`` (threefry key), ``"seed"``
    for ``FlashAttentionDropout`` / ``FusedDropoutBiasResidual`` (int32
    seed). Empty at dropout 0."""
    if cfg.dropout <= 0:
        return []
    sites = [(f"{scope}/dropout", "key")]
    for i in range(cfg.num_layers):
        base = f"{scope}/decoder/layer_{i}"
        sites += [(f"{base}/self_attn/flash_attention", "seed"),
                  (f"{base}/fused_dropout_residual", "seed"),
                  (f"{base}/ffn/dropout", "key")]
    return sites


def _eager_causal_lm_logits(stack: DecoderStack, ids, *, training=True,
                            compute_dtype=torch.bfloat16, rng=None,
                            scope="causal_lm"):
    """Next-token logits ``(B, S, vocab)`` in ``compute_dtype`` for token
    ids ``(B, S)``: causal flash self-attention + FFN per layer, ``ln1``
    after attention and ``ln3`` after the FFN, and the tied softmax
    against the f32 table cast to the compute dtype. In training at
    ``cfg.dropout > 0``, ``rng`` (a :class:`StepRNG` over
    :func:`dropout_sites`) gives each random op its stream.
    Differentiable."""
    cfg = stack.cfg
    h = _eager_embed(stack, ids, compute_dtype, training, rng, scope)
    for i, layer in enumerate(stack.layers):
        at = f"{scope}/decoder/layer_{i}"
        a = _eager_attention(layer, h, cfg, training, causal=True, rng=rng,
                       scope=f"{at}/self_attn")
        h = layer.ln1(_eager_residual(a, h, cfg, training, rng, at))
        f = _eager_ffn(layer, h, cfg, training, rng, f"{at}/ffn")
        h = layer.ln3(h + f)
    b, s = ids.shape
    flat = h.reshape(b * s, cfg.d_model)
    logits = torch.matmul(flat, stack.shared_embedding.to(h.dtype).t())
    return logits.reshape(b, s, cfg.vocab_size)


# steps whose dropout streams the trainer derives in one host pass
RNG_BLOCK = 64


def _noam(step_t, learning_rate, d_model, warmup_steps):
    """The noam schedule as a function of the device step counter (a
    closure, not a bound method, so the optimizer holding it keeps no
    reference cycle to the trainer)."""
    scale = learning_rate * d_model ** -0.5
    warm = warmup_steps ** -1.5

    def lr():
        """The f32 noam learning rate of the next step, on the device."""
        step = step_t.to(torch.float32) + 1.0
        return scale * torch.minimum(torch.pow(step, -0.5), step * warm)

    return lr


class CausalLMTrainer:
    """The port's counterpart of the JAX training dict ``{"loss",
    "train_op", "learning_rate", "global_step"}``: the model
    (:attr:`stack`, Dense parameters in the compute dtype, the embedding
    and LayerNorm parameters f32), a :class:`..train.optimizers.
    FlatAdam` (beta1 0.9, beta2 0.997, epsilon 1e-9) and the global
    step. :meth:`step` runs forward, backward and the fused Adam update,
    then increments the global step. The learning rate is the noam
    schedule ``learning_rate * d_model^-0.5 * min(step^-0.5, step *
    warmup^-1.5)`` with ``step = global_step + 1``, formed in f32 on the
    device before the increment, as at ``causal_lm.py:97-100``.

    ``plain=True`` runs the whole step (the fused ops under
    :func:`..ops.fused_ops.plain_versions` and the plain Adam update)
    through the kernels' plain PyTorch versions on any device: the
    reference the kernel step is held against on the card.

    Dropout (``cfg.dropout > 0``) draws the JAX program's masks: the
    trainer keeps the session's RNG run counter (:attr:`rng_counter`),
    advances it on each :meth:`loss` as a session run that draws
    randomness does, and derives every site's key or seed of the step on
    the host (:class:`StepRNG`, unseeded graph: base key 0, stream id
    ``crc32(op name)``). :attr:`dropout_sites` maps each site's JAX op
    name to its stream id, in graph order."""

    def __init__(self, cfg: TransformerConfig, batch_size, seq_len,
                 learning_rate, warmup_steps, compute_dtype, state, device,
                 plain=False, scope="causal_lm"):
        if not 0.0 <= cfg.dropout < 1.0:
            raise ValueError(f"cfg.dropout must be in [0, 1): {cfg.dropout}")
        if seq_len > cfg.max_len:
            raise ValueError(f"seq_len={seq_len} exceeds cfg.max_len="
                             f"{cfg.max_len} (position-encoding table)")
        self.cfg = cfg
        self.device = device
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.compute_dtype = compute_dtype
        self.plain = bool(plain)
        self.stack = DecoderStack(cfg, dtype=compute_dtype, device=device)
        self.stack.load_state_dict(state)
        self.global_step = 0
        # the device copy of the global step the learning rate reads
        self._step_t = torch.zeros((), dtype=torch.int64, device=device)
        self.learning_rate = _noam(self._step_t, learning_rate, cfg.d_model,
                                   warmup_steps)
        self.optimizer = FlatAdam(
            self.stack.parameters(), learning_rate=self.learning_rate,
            beta1=0.9, beta2=0.997, epsilon=1e-9,
            update=adam_update_plain if self.plain else adam_update)
        self.scope = scope
        sites = dropout_sites(cfg, scope)
        self.dropout_sites = {name: fold_in_value(name) for name, _ in sites}
        self._key_sites = [n for n, kind in sites if kind == "key"]
        self._seed_sites = [n for n, kind in sites if kind == "seed"]
        self.rng_counter = 0
        self._rng_ahead = {}     # run counter -> StepRNG, derived ahead

    def _step_rng(self):
        """The next step's streams (advancing :attr:`rng_counter`), or
        None when the model draws no randomness. Streams are derived
        ``RNG_BLOCK`` steps at a time (one host pass amortised over the
        block); a counter set from a checkpoint starts a new block."""
        if not self.dropout_sites:
            return None
        self.rng_counter += 1
        rng = self._rng_ahead.pop(self.rng_counter, None)
        if rng is None:
            block = range(self.rng_counter, self.rng_counter + RNG_BLOCK)
            ahead = StepRNG.for_steps(block, self._key_sites,
                                      self._seed_sites)
            self._rng_ahead = dict(zip(block, ahead))
            rng = self._rng_ahead.pop(self.rng_counter)
        return rng

    def _batch(self, tok):
        tok = torch.as_tensor(tok).to(self.device, torch.int64)
        if tuple(tok.shape) != (self.batch_size, self.seq_len):
            raise ValueError(f"batch must be ({self.batch_size}, "
                             f"{self.seq_len}), got {tuple(tok.shape)}")
        return tok

    def loss(self, tok_in, tok_out):
        """The label-smoothed LM loss (f32 scalar) of one batch, recorded
        for autograd."""
        tok_in, tok_out = self._batch(tok_in), self._batch(tok_out)
        rng = self._step_rng()
        with (fused_ops.plain_versions() if self.plain
              else contextlib.nullcontext()):
            logits = _eager_causal_lm_logits(
                self.stack, tok_in, training=True,
                compute_dtype=self.compute_dtype, rng=rng, scope=self.scope)
            weights = (tok_out != self.cfg.pad_id).float()
            return smoothed_xent(logits, tok_out, weights, self.cfg)

    def loss_and_grads(self, tok_in, tok_out):
        """Forward and backward without an update: the loss, with the
        gradients left in the optimizer's flat buffers (each parameter's
        ``.grad``)."""
        self.optimizer.zero_grad()
        loss = self.loss(tok_in, tok_out)
        loss.backward()
        return loss.detach()

    def step(self, tok_in, tok_out):
        """One training step; returns the step's f32 loss (a device
        scalar: reading it waits for the step)."""
        loss = self.loss_and_grads(tok_in, tok_out)
        self.optimizer.step()
        self.global_step += 1
        self._step_t += 1
        return loss

    def set_global_step(self, step: int):
        self.global_step = int(step)
        self._step_t.fill_(int(step))


def causal_lm_trainer(batch_size=8, seq_len=32,
                      cfg: Optional[TransformerConfig] = None,
                      learning_rate=1.0, warmup_steps=4000,
                      compute_dtype=torch.bfloat16, *, params=None,
                      checkpoint=None, seed=0, scope="causal_lm",
                      device="cuda", plain=False):
    """The eager training model: a :class:`CausalLMTrainer` for
    ``(batch_size, seq_len)`` token batches with the JAX function's recipe
    (label-smoothed LM loss, Adam, noam schedule);
    :func:`causal_lm_train_model` builds the same step as a graph.

    Weights come from ``checkpoint=`` (a JAX ``.stfz`` prefix; a training
    checkpoint also carries the global step, the beta powers, the flat
    Adam slots and the session's RNG run counter across), ``params=`` (a
    ``state_dict``), or
    :func:`..convert.init_params` with ``seed``. ``device`` defaults to
    ``"cuda"`` and raises without a card; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU. ``plain=True`` runs them on any
    device (:class:`CausalLMTrainer`)."""
    from .. import convert

    cfg = cfg or TransformerConfig.base()
    device = resolve_device(device)
    named = None
    if checkpoint is not None:
        named = convert.load_stfz(checkpoint)
        state = convert.params_from_jax(named, cfg, scope=scope,
                                        compute_dtype=compute_dtype)
    elif params is not None:
        state = params
    else:
        state = convert.init_params(cfg, seed)
    trainer = CausalLMTrainer(cfg, batch_size, seq_len, learning_rate,
                              warmup_steps, compute_dtype, state, device,
                              plain=plain, scope=scope)
    if named is not None:
        convert.load_training_state(trainer, named,
                                    convert.load_host_state(checkpoint))
    return trainer


class _PagedCaches:
    """Cache accessor for one decode/prefill call: appends land at
    ``(dst_pages[b], offsets[b] + j)``, the gather reads the logical view
    through ``page_tables (B, n_blocks)``."""

    def __init__(self, caches, page_tables, dst_pages, offsets, base):
        self._caches = caches        # [(KVCache k, KVCache v)] per layer
        self._tables = page_tables   # (B, n_blocks)
        self._dst = dst_pages        # (B,) physical page written
        self._off = offsets          # (B,) in-page start offset
        self._base = base            # (B,) int32 committed length BEFORE

    def _one(self, cache, new):
        cache.append(new, self._dst, self._off)
        return cache.gather(self._tables)

    def append_and_gather(self, layer, k_new, v_new):
        kc, vc = self._caches[layer]
        return (self._one(kc, k_new), self._one(vc, v_new),
                self._base + 1)

    def append_and_gather_block(self, layer, k_new, v_new):
        kc, vc = self._caches[layer]
        return self._one(kc, k_new), self._one(vc, v_new), self._base


class CausalLMGenerativeModel:
    """Paged causal-LM decode programs for the engine's prefix-cache path
    (module docstring).

    Weights come from ``checkpoint=`` (a JAX ``.stfz`` prefix, read by
    :func:`..convert.load_stfz`), ``params=`` (a ``state_dict``), or
    ``init_fresh=True`` (:func:`..convert.init_params` with ``seed``).
    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    ``aot_warmup`` (default True) captures every decode and prefill
    bucket's CUDA graph at build (module docstring); False dispatches
    every step eagerly.
    """

    def __init__(self, cfg: TransformerConfig, *, page_len=8,
                 pages_per_seq=4, num_pages=32, max_live=8,
                 decode_bucket_sizes=None, prefill_bucket_sizes=None,
                 int8=False, sampling=None, checkpoint=None, params=None,
                 init_fresh=False, seed=0, scope="causal_lm",
                 aot_warmup=True, device="cuda"):
        from .. import convert

        if sampling is not None:
            raise NotImplementedError(
                "sampling decode comes in a later slice of the PyTorch "
                "port; this slice serves greedy decode")
        if checkpoint is None and params is None and not init_fresh:
            raise ValueError("pass checkpoint=..., params=... or "
                             "init_fresh=True")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_len = int(page_len)
        self.pages_per_seq = int(pages_per_seq)
        self.num_pages = int(num_pages)
        self.max_seq_len = self.page_len * self.pages_per_seq
        if self.max_seq_len > cfg.max_len:
            raise ValueError(
                f"page_len*pages_per_seq={self.max_seq_len} exceeds "
                f"cfg.max_len={cfg.max_len} (position-encoding table)")
        # engine-facing decode geometry (slot == live sequence)
        self.num_slots = int(max_live)
        self.max_decode_len = self.max_seq_len
        self.eos_id = cfg.eos_id
        self.pad_id = cfg.pad_id
        self.int8 = bool(int8)
        self.tp_degree = 1
        self.scratch_page = self.num_pages
        self._decode_buckets = sorted(set(int(x) for x in (
            decode_bucket_sizes or sorted({1, self.num_slots}))))
        self._prefill_buckets = sorted(set(int(x) for x in (
            prefill_bucket_sizes or (1,))))

        if checkpoint is not None:
            state = convert.params_from_jax(convert.load_stfz(checkpoint),
                                            cfg, scope=scope)
        elif params is not None:
            state = params
        else:
            state = convert.init_params(cfg, seed)
        self.stack = DecoderStack(cfg, device=self.device)
        self.stack.load_state_dict(state)
        self.stack.requires_grad_(False)
        self.stack.eval()
        heads = cfg.num_heads
        hd = cfg.d_model // heads
        self.caches = [
            (KVCache(self.num_pages, self.page_len, heads, hd,
                     device=self.device),
             KVCache(self.num_pages, self.page_len, heads, hd,
                     device=self.device))
            for _ in range(cfg.num_layers)]
        self.wq = self.w_scale = None
        if self.int8:
            with torch.inference_mode():
                self.wq, self.w_scale = build_int8_logits_weights(
                    self.stack.shared_embedding)
        self.aot_warmup = bool(aot_warmup)
        self._decode_programs = {}
        self._prefill_programs = {}
        if self.aot_warmup:
            self._build_programs()

    @torch.inference_mode()
    def _build_programs(self):
        """Warm up and capture every bucket's program (all-padding rows:
        pad token, position 0, scratch-page tables and targets)."""
        i64, i32 = torch.int64, torch.int32
        pps, pl = self.pages_per_seq, self.page_len
        for sb in self._decode_buckets:
            prog = BucketProgram(self._decode_step, {
                "tok": ((sb,), i64), "pos": ((sb,), i32),
                "tbl": ((sb, pps), i64), "dst": ((sb,), i64),
                "off": ((sb,), i64)}, self.device)
            prog.build(self._decode_rows(
                np.full((sb,), self.pad_id, np.int32),
                np.zeros((sb,), np.int32), self._scratch_tables(sb)))
            self._decode_programs[sb] = prog
        for pb in self._prefill_buckets:
            prog = BucketProgram(self._prefill_step, {
                "tok": ((pb, pl), i64), "base": ((pb,), i32),
                "tbl": ((pb, pps), i64), "dst": ((pb,), i64),
                "off": ((pb,), i64)}, self.device)
            prog.build({"tok": np.full((pb, pl), self.pad_id, np.int32),
                        "base": np.zeros((pb,), np.int32),
                        "tbl": self._scratch_tables(pb),
                        "dst": np.full((pb,), self.scratch_page, np.int32),
                        "off": np.zeros((pb,), np.int32)})
            self._prefill_programs[pb] = prog

    @property
    def decode_buckets(self):
        return list(self._decode_buckets)

    @property
    def prefill_buckets(self):
        return list(self._prefill_buckets)

    def _bucket(self, buckets, n):
        for b in buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} rows exceed the largest bucket "
                         f"{buckets[-1]}")

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _scratch_tables(self, n):
        return np.full((n, self.pages_per_seq), self.scratch_page, np.int32)

    def logits_head(self, h):
        """Tied-softmax logits (f32): the int8 QuantMatMul kernel when
        built with ``int8=True``, else an f32 ``torch.matmul``."""
        if self.int8:
            return quant_matmul(h, self.wq, self.w_scale)
        return torch.matmul(h, self.stack.shared_embedding.t())

    @torch.inference_mode()
    def prefill_chunk(self, tok_chunks, bases, page_tables, dst_pages):
        """Run ONE page-aligned prompt chunk for n rows: ``tok_chunks
        (n, page_len)`` (pad-padded past the real tail), ``bases (n,)``
        absolute chunk start, ``page_tables (n, pages_per_seq)``,
        ``dst_pages (n,)`` the physical page each row's chunk fills."""
        tok_chunks = np.asarray(tok_chunks, np.int32).reshape(
            -1, self.page_len)
        bases = np.asarray(bases, np.int32)
        page_tables = np.asarray(page_tables, np.int32).reshape(
            -1, self.pages_per_seq)
        dst_pages = np.asarray(dst_pages, np.int32)
        n = len(dst_pages)
        done = 0
        while done < n:
            take = min(n - done, self._prefill_buckets[-1])
            pb = self._bucket(self._prefill_buckets, take)
            tok = np.full((pb, self.page_len), self.pad_id, np.int32)
            base = np.zeros((pb,), np.int32)
            tbl = self._scratch_tables(pb)
            dst = np.full((pb,), self.scratch_page, np.int32)
            sl = slice(done, done + take)
            tok[:take] = tok_chunks[sl]
            base[:take] = bases[sl]
            tbl[:take] = page_tables[sl]
            dst[:take] = dst_pages[sl]
            # pad rows of a partial final chunk write K/V past the real
            # length: dead rows, masked by committed length and
            # overwritten in place by the next append
            prog = self._prefill_programs.get(pb)
            if prog is not None:
                prog.run({"tok": tok, "base": base, "tbl": tbl, "dst": dst})
            else:
                self._prefill_step(
                    self._tensor(tok), self._tensor(base, torch.int32),
                    self._tensor(tbl), self._tensor(dst),
                    torch.zeros(pb, dtype=torch.int64, device=self.device))
            done += take

    def _prefill_step(self, tok, base, tbl, dst, off):
        """One prefill bucket on device tensors: the block decode appends
        each row's chunk into its page (off: zeros)."""
        block_decode(self.stack, tok, base,
                     _PagedCaches(self.caches, tbl, dst, off, base))
        return ()

    def _decode_rows(self, tok, pos, tbl):
        """The decode program's host inputs of one padded batch: the write
        page and offset of each row resolved from its page table."""
        return {"tok": tok, "pos": pos, "tbl": tbl,
                "dst": tbl[np.arange(len(pos)), pos // self.page_len],
                "off": pos % self.page_len}

    def _decode_step(self, tok, pos, tbl, dst, off):
        """One decode bucket on device tensors: ``(next_tok, logp)``."""
        cache = _PagedCaches(self.caches, tbl, dst, off, pos)
        h = incremental_decode(self.stack, tok, pos, cache)
        return greedy_emit(self.logits_head(h).float())

    def decode_hidden(self, tok, pos, tbl):
        """The decode step's hidden state ``(sb, d_model)`` for one
        already bucket-padded batch (numpy ``tok``, ``pos``, ``tbl``);
        appends each row's K/V on the way."""
        rows = self._decode_rows(tok, pos, tbl)
        pos_t = self._tensor(pos, torch.int32)
        cache = _PagedCaches(self.caches, self._tensor(tbl),
                             self._tensor(rows["dst"]),
                             self._tensor(rows["off"]), pos_t)
        return incremental_decode(self.stack, self._tensor(tok), pos_t,
                                  cache)

    def pad_decode_batch(self, tokens, positions, page_tables):
        """Pad n live rows to their decode bucket: pad token, position 0,
        scratch-page tables. Returns ``(tok, pos, tbl, bucket)``."""
        tokens = np.asarray(tokens, np.int32)
        positions = np.asarray(positions, np.int32)
        page_tables = np.asarray(page_tables, np.int32).reshape(
            -1, self.pages_per_seq)
        n = len(tokens)
        sb = self._bucket(self._decode_buckets, n)
        tok = np.full((sb,), self.pad_id, np.int32)
        pos = np.zeros((sb,), np.int32)
        tbl = self._scratch_tables(sb)
        tok[:n], pos[:n], tbl[:n] = tokens, positions, page_tables
        return tok, pos, tbl, sb

    @torch.inference_mode()
    def decode(self, tokens, positions, page_tables):
        """One decode position for n live sequences; the physical write
        target is resolved from each row's page table: ``dst =
        page_tables[i, pos // page_len]``, ``off = pos % page_len``.
        Returns ``(next_tok (n,), logp (n,), bucket)`` as numpy."""
        n = len(tokens)
        tok, pos, tbl, sb = self.pad_decode_batch(tokens, positions,
                                                  page_tables)
        prog = self._decode_programs.get(sb)
        if prog is not None:
            next_tok, logp = prog.run(self._decode_rows(tok, pos, tbl))
        else:
            h = self.decode_hidden(tok, pos, tbl)
            next_tok, logp = greedy_emit(self.logits_head(h).float())
        # copies: on the CPU a static output would be returned as a view
        return (next_tok[:n].to("cpu", torch.int32, copy=True).numpy(),
                logp[:n].to("cpu", copy=True).numpy(), sb)

    @torch.inference_mode()
    def copy_page(self, dst, src):
        """Copy-on-write: duplicate physical page ``src`` into ``dst``
        across every layer cache."""
        for kc, vc in self.caches:
            kc.copy_page(int(dst), int(src))
            vc.copy_page(int(dst), int(src))

    def close(self):
        for progs in (self._decode_programs, self._prefill_programs):
            for prog in progs.values():
                prog.graph.release()
            progs.clear()
        self.caches = []

    def statusz_info(self):
        return {"decode_buckets": self.decode_buckets,
                "prefill_buckets": self.prefill_buckets,
                "page_len": self.page_len, "num_pages": self.num_pages,
                "pages_per_seq": self.pages_per_seq,
                "num_slots": self.num_slots, "int8": self.int8,
                "aot_warmup": self.aot_warmup,
                "device": str(self.device)}


@torch.inference_mode()
def causal_lm_hidden_plain(stack: DecoderStack, ids):
    """Plain full re-forward: the last layer's hidden state ``(B, S,
    d_model)`` for token ids ``(B, S)``. Causal softmax attention and
    LayerNorm in PyTorch ops only — no kernel of the port runs here."""
    cfg = stack.cfg
    b, s = ids.shape
    d, heads = cfg.d_model, cfg.num_heads
    hd = d // heads
    h = stack.embed(ids, torch.arange(s, device=ids.device))
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=ids.device).tril()
    for layer in stack.layers:
        att = layer.self_attn
        q = att["q"](h).reshape(b, s, heads, hd)
        k = att["k"](h).reshape(b, s, heads, hd)
        v = att["v"](h).reshape(b, s, heads, hd)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        sc = torch.where(causal, sc, torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d)
        h = layer_norm_plain(h + att["out"](a), layer.ln1.gamma,
                             layer.ln1.beta, eps=layer.ln1.eps)
        f = layer.ffn["out"](layer.ffn["in"](h))
        h = layer_norm_plain(h + f, layer.ln3.gamma, layer.ln3.beta,
                             eps=layer.ln3.eps)
    return h


@torch.inference_mode()
def causal_lm_logits_plain(stack: DecoderStack, ids, *,
                           int8_weights: Optional[tuple] = None):
    """Plain full re-forward: next-token logits ``(B, S, vocab)`` (f32) for
    token ids ``(B, S)``: :func:`causal_lm_hidden_plain` and the logits
    head (``int8_weights=(wq, w_scale)`` for the int8 head) in PyTorch ops
    only."""
    h = causal_lm_hidden_plain(stack, ids)
    b, s, d = h.shape
    flat = h.reshape(b * s, d)
    if int8_weights is not None:
        logits = quant_matmul_plain(flat, *int8_weights)
    else:
        logits = torch.matmul(flat, stack.shared_embedding.t())
    return logits.float().reshape(b, s, stack.cfg.vocab_size)
