"""The PyTorch port's causal-LM training slice against the JAX package's.

One JAX ``causal_lm_train_model`` (``TransformerConfig.tiny()``, dropout
0, batch 2 x 16, a 4-step warm-up so the learning rate is not tiny) runs in
a JAX ``Session``; its initial variables are saved through the JAX
``Saver``, and the port's trainer reads the same ``.stfz`` checkpoint
(``convert.load_stfz`` -> ``params_from_jax``). Both then train on the
same numpy-seeded batches, on the CPU (the port's kernels take their plain
versions on CPU tensors). Stated tolerances, f32:

- step-0 gradients (fetched with ``stf.gradients``): relative norm 1e-5
  per parameter, except the attention key biases, whose exact gradient is
  zero (a softmax does not change when the same ``q . b_k`` is added to
  every score of a row): there both sides hold roundoff, held below 1e-6
  of the key kernel's gradient norm;
- per-step losses over 3 steps: rtol 1e-5; the learning rate: rtol 1e-6;
- parameters after 3 steps: atol 1e-3 of the summed learning rates (Adam
  normalises each element's step, so an element with a small gradient
  carries that gradient's relative roundoff into its step), except the
  key biases: Adam with epsilon 1e-9 turns their roundoff gradients into
  steps of about +-lr, so both sides only stay within a few learning
  rates of where they began;
- a JAX checkpoint taken after 2 steps carries the global step, the beta
  powers and the flat Adam slots across, and the port's third step gives
  the JAX session's third loss (rtol 1e-5).

bf16 (Dense weights bf16, the embedding and LayerNorm f32, two Adam
groups): per-step losses within 2e-2 relative.

Dropout 0.1 (the shipped configs' rate): the JAX graph is built WITHOUT
``set_random_seed``, as users build it, so each random op's stream id is
the crc32 of its name and the session's base key is ``key(0)``; its
checkpoint after ``global_variables_initializer`` carries the session's
RNG run counter. The port's trainer derives the same keys and seeds, so
its masks are the JAX program's, and the same limits hold as at dropout
0: losses over 3 steps rtol 1e-5, step-0 gradients relative norm 1e-5
(key biases by norm), and the step-2 checkpoint continues to the JAX
third loss.
"""

import importlib
import zlib

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as stf
from simple_tensorflow_tpu.models import causal_lm as jclm
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import causal_lm as clm
from simple_tensorflow_tpu_torch.models import transformer as ptr
from torch_threads import one_torch_thread  # noqa: F401

B, S, WARMUP, STEPS = 2, 16, 4, 3


def _batches(vocab, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        tok_in = rng.randint(1, vocab, (B, S)).astype(np.int32)
        tok_out = rng.randint(1, vocab, (B, S)).astype(np.int32)
        tok_out[0, -3:] = 0                  # pad targets carry weight 0
        out.append((tok_in, tok_out))
    return out


RANDOM_OPS = ("Dropout", "FlashAttentionDropout", "FusedDropoutBiasResidual")


def _run_jax(dtype, ckpt_dir, dropout=0.0):
    """Train the JAX graph STEPS steps; save before the first step and
    after the second. Returns losses, learning rates, step-0 gradients,
    final parameters, the checkpoint prefixes, the flat slot sizes and
    the random ops' names. With dropout the graph takes no seed."""
    cfg = jtr.TransformerConfig.tiny()
    cfg.dropout = dropout
    g = stf.Graph()
    with g.as_default():
        if not dropout:
            stf.set_random_seed(3)
        m = jclm.causal_lm_train_model(batch_size=B, seq_len=S, cfg=cfg,
                                       compute_dtype=dtype,
                                       warmup_steps=WARMUP)
        random_ops = [op.name for op in g.get_operations()
                      if op.type in RANDOM_OPS]
        tvars = stf.trainable_variables()
        grads = stf.gradients(m["loss"], tvars)
        saver = stf.train.Saver()
        slots = {v.name.split(":")[0]: v.shape.as_list()[0]
                 for v in stf.global_variables() if "fused_m_g" in v.name}
        with stf.Session(graph=g) as sess:
            sess.run(stf.global_variables_initializer())
            ck0 = saver.save(sess, str(ckpt_dir / "step0"))
            losses, lrs, grads0, ck2 = [], [], None, None
            for i, (tok_in, tok_out) in enumerate(_batches(cfg.vocab_size)):
                if i == 2:
                    ck2 = saver.save(sess, str(ckpt_dir / "step2"))
                out = sess.run([m["loss"], m["learning_rate"]] + grads
                               + [m["train_op"]],
                               {m["tok_in"]: tok_in, m["tok_out"]: tok_out})
                losses.append(float(out[0]))
                lrs.append(float(out[1]))
                if i == 0:
                    grads0 = [np.asarray(x, np.float32) for x in out[2:-1]]
            params = {v.name.split(":")[0]:
                      np.asarray(sess.run(v)).astype(np.float32)
                      for v in tvars}
    names = [v.name.split(":")[0] for v in tvars]
    return dict(losses=losses, lrs=lrs, grads0=dict(zip(names, grads0)),
                params=params, ck0=ck0, ck2=ck2,
                slot_sizes=[slots[k] for k in sorted(slots)],
                random_ops=random_ops)


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    return _run_jax(stf.float32, tmp_path_factory.mktemp("clm_f32"))


@pytest.fixture(scope="module")
def jax_f32_dropout(tmp_path_factory):
    return _run_jax(stf.float32, tmp_path_factory.mktemp("clm_f32_drop"),
                    dropout=0.1)


def _trainer(ckpt, dtype=torch.float32, dropout=0.0):
    cfg = ptr.TransformerConfig.tiny()
    cfg.dropout = dropout
    return clm.causal_lm_trainer(
        batch_size=B, seq_len=S, cfg=cfg, warmup_steps=WARMUP,
        compute_dtype=dtype, checkpoint=ckpt, device="cpu")


def _jax_name(port_name):
    return "causal_lm/" + port_name.replace(".", "/")


def _is_key_bias(name):
    return name.endswith("self_attn.k.bias")


def _check_step0_gradients(tr, want):
    tok_in, tok_out = _batches(64)[0]
    loss = tr.loss_and_grads(tok_in, tok_out)
    np.testing.assert_allclose(float(loss), want["losses"][0], rtol=1e-5)
    params = dict(tr.stack.named_parameters())
    for name, p in params.items():
        got = p.grad.float().numpy()
        ref = want["grads0"][_jax_name(name)]
        if _is_key_bias(name):
            kernel = want["grads0"][_jax_name(name[:-4] + "kernel")]
            scale = np.linalg.norm(kernel)
            assert np.linalg.norm(got) <= 1e-6 * scale, name
            assert np.linalg.norm(ref) <= 1e-6 * scale, name
            continue
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 1e-5, (name, rel)


def test_step0_gradients_match_jax(jax_f32):
    _check_step0_gradients(_trainer(jax_f32["ck0"]), jax_f32)


def test_three_steps_match_jax(jax_f32):
    tr = _trainer(jax_f32["ck0"])
    assert tr.global_step == 0 and len(tr.optimizer.flat_groups) == 1
    losses, lrs = [], []
    for tok_in, tok_out in _batches(64):
        lrs.append(float(tr.learning_rate()))
        losses.append(float(tr.step(tok_in, tok_out)))
    assert tr.global_step == STEPS
    np.testing.assert_allclose(lrs, jax_f32["lrs"], rtol=1e-6)
    np.testing.assert_allclose(losses, jax_f32["losses"], rtol=1e-5)
    for name, p in tr.stack.named_parameters():
        got = p.detach().numpy()
        want = jax_f32["params"][_jax_name(name)]
        if _is_key_bias(name):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=4 * sum(lrs))
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-3 * sum(lrs), err_msg=name)


def test_checkpoint_after_two_steps_continues_like_jax(jax_f32):
    tr = _trainer(jax_f32["ck2"])
    named = convert.load_stfz(jax_f32["ck2"])
    assert tr.global_step == 2
    opt = tr.optimizer
    assert opt.beta1_power.item() == pytest.approx(0.9 ** 3, rel=1e-6)
    assert opt.beta2_power.item() == pytest.approx(0.997 ** 3, rel=1e-6)
    (grp,) = opt.flat_groups
    np.testing.assert_array_equal(grp.m.numpy(),
                                  named["Adam/Adam/fused_m_g0"])
    np.testing.assert_array_equal(grp.v.numpy(),
                                  named["Adam/Adam/fused_v_g0"])
    np.testing.assert_allclose(float(tr.learning_rate()),
                               jax_f32["lrs"][2], rtol=1e-6)
    loss = tr.step(*_batches(64)[2])
    np.testing.assert_allclose(float(loss), jax_f32["losses"][2], rtol=1e-5)
    # the port's own flat slots after two steps, element for element in
    # the JAX group order
    own = _trainer(jax_f32["ck0"])
    for batch in _batches(64)[:2]:
        own.step(*batch)
    (own_grp,) = own.optimizer.flat_groups
    for slot in ("m", "v"):
        want = named[f"Adam/Adam/fused_{slot}_g0"]
        np.testing.assert_allclose(getattr(own_grp, slot).numpy(), want,
                                   rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_bf16_training_matches_jax(tmp_path):
    want = _run_jax(stf.bfloat16, tmp_path)
    tr = _trainer(want["ck0"], torch.bfloat16)
    dtypes = {n: p.dtype for n, p in tr.stack.named_parameters()}
    assert dtypes["shared_embedding"] == torch.float32
    assert dtypes["decoder.layer_0.ln1.gamma"] == torch.float32
    assert dtypes["decoder.layer_0.self_attn.q.kernel"] == torch.bfloat16
    assert dtypes["decoder.layer_1.ffn.out.bias"] == torch.bfloat16
    # (f32, f32) then (bf16, f32), sized like the JAX flat slots
    groups = tr.optimizer.flat_groups
    assert [g.p.dtype for g in groups] == [torch.float32, torch.bfloat16]
    assert [len(g) for g in groups] == want["slot_sizes"]
    losses = [float(tr.step(*batch)) for batch in _batches(64)]
    np.testing.assert_allclose(losses, want["losses"], rtol=2e-2)
    assert all(np.isfinite(losses))


def test_dropout_sites_are_the_jax_random_ops(jax_f32_dropout):
    tr = _trainer(jax_f32_dropout["ck0"], dropout=0.1)
    assert list(tr.dropout_sites) == jax_f32_dropout["random_ops"]
    assert len(tr.dropout_sites) == 1 + 3 * 2
    assert tr.dropout_sites["causal_lm/dropout"] == \
        zlib.crc32(b"causal_lm/dropout") & 0x7FFFFFFF
    # the session ran the initializer: one run that drew randomness
    assert tr.rng_counter == 1
    big = clm.dropout_sites(ptr.TransformerConfig.big())
    assert len(big) == 19 and not clm.dropout_sites(
        ptr.TransformerConfig.tiny())


def test_dropout_step0_gradients_match_jax(jax_f32_dropout):
    tr = _trainer(jax_f32_dropout["ck0"], dropout=0.1)
    _check_step0_gradients(tr, jax_f32_dropout)
    assert tr.rng_counter == 2


def test_dropout_three_steps_match_jax(jax_f32_dropout, jax_f32):
    tr = _trainer(jax_f32_dropout["ck0"], dropout=0.1)
    losses = [float(tr.step(*batch)) for batch in _batches(64)]
    np.testing.assert_allclose(losses, jax_f32_dropout["losses"], rtol=1e-5)
    assert tr.rng_counter == 1 + STEPS
    # the masks matter: the same steps without dropout give other losses
    assert not np.allclose(losses[1:], jax_f32["losses"][1:], rtol=1e-3)


def test_dropout_checkpoint_after_two_steps_continues_like_jax(
        jax_f32_dropout):
    tr = _trainer(jax_f32_dropout["ck2"], dropout=0.1)
    assert tr.global_step == 2 and tr.rng_counter == 3
    loss = tr.step(*_batches(64)[2])
    np.testing.assert_allclose(float(loss), jax_f32_dropout["losses"][2],
                               rtol=1e-5)


def test_dropout_plain_trainer_never_calls_a_kernel_wrapper(
        jax_f32_dropout, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain trainer reached a kernel wrapper")

    for mod, names in (
            ("dropout", ("dropout_fwd", "dropout_bwd")),
            ("dropout_residual", ("dropout_residual_fwd",
                                  "dropout_residual_bwd")),
            ("flash_attention", ("flash_attention_fwd",
                                 "flash_attention_dkdv",
                                 "flash_attention_dq"))):
        module = importlib.import_module(
            f"simple_tensorflow_tpu_torch.ops.kernels.{mod}")
        for name in names:
            monkeypatch.setattr(module, name, refuse)
    cfg = ptr.TransformerConfig.tiny()
    cfg.dropout = 0.1
    plain = clm.causal_lm_trainer(
        batch_size=B, seq_len=S, cfg=cfg, warmup_steps=WARMUP,
        compute_dtype=torch.float32, checkpoint=jax_f32_dropout["ck0"],
        device="cpu", plain=True)
    loss = plain.step(*_batches(64)[0])
    np.testing.assert_allclose(float(loss), jax_f32_dropout["losses"][0],
                               rtol=1e-5)


def test_trainer_checks_its_batch_shape_and_position_table():
    tr = clm.causal_lm_trainer(batch_size=B, seq_len=S,
                               cfg=ptr.TransformerConfig.tiny(),
                               compute_dtype=torch.float32, seed=1,
                               device="cpu")
    with pytest.raises(ValueError, match="batch must be"):
        tr.step(np.ones((B, S + 1), np.int32), np.ones((B, S + 1), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        clm.causal_lm_trainer(batch_size=1, seq_len=33,
                              cfg=ptr.TransformerConfig.tiny(),
                              device="cpu")
