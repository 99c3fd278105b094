"""The PyTorch port's training kernels against the JAX package's.

Each training kernel module of ``simple_tensorflow_tpu_torch.ops.kernels``
holds a hand-written CUDA kernel and its plain PyTorch version; on CPU
tensors the wrappers (and their autograd Functions) run the plain
versions. Here the same numpy-seeded inputs go through the port and
through the JAX function as the JAX package's own tests run it on the CPU
(the Pallas kernels in interpret mode), forward values and ``jax.vjp``
gradients alike. Stated tolerances: forward values rtol 1e-5 (atol 1e-5
at unit scale), gradients rtol 1e-4 (f32: the two sides sum in other
orders); bf16 2e-2 (one bf16 rounding, placed alike on both sides); Adam
within 8 ulp (of the larger summand) of the JAX kernel, whose multiply-adds
the compiler may contract, and bit-exact with the JAX composed reference,
which rounds every operation as the port does.
``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tensorflow_tpu_torch.ops import fused_ops
from simple_tensorflow_tpu_torch.ops import kernels as K
from simple_tensorflow_tpu_torch.ops.embedding_ops import embedding_lookup
from simple_tensorflow_tpu_torch.train import optimizers as popt

# the package's __init__ re-exports functions under the modules' names
jfa = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "flash_attention")
jln = importlib.import_module("simple_tensorflow_tpu.ops.pallas.layer_norm")
jxe = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "softmax_xent")
jfu = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "fused_update")

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


# ---------------------------------------------------------------------------
# FlashAttention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal,biased", [
    (13, 13, True, False), (16, 16, True, True), (9, 13, False, True),
    (1, 1, False, "pad"), (64, 64, False, "pad")])
def test_flash_attention_and_vjp_match_jax(dtype, sq, sk, causal, biased):
    # 13 is no multiple of the 8-row interpret blocks: the ragged tails
    # are masked on both sides. "pad": the encoder prefill's -1e9 pad bias,
    # batch row 0 padded past half its keys, row 1 all padding (a uniform,
    # finite softmax on both sides)
    rng = np.random.RandomState(30 + sq + sk)
    b, h, d = 2, 2, 8
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    go = rng.randn(b, h, sq, d).astype(np.float32)
    glse = rng.randn(b, h, sq).astype(np.float32)
    bias = (rng.randn(b, sk) * 2).astype(np.float32) if biased else None
    if biased == "pad":
        bias = np.zeros((b, sk), np.float32)
        bias[0, sk // 2 + 1:] = -1e9
        bias[1, :] = -1e9
    jd = _jdt(dtype)

    def jfn(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, causal=causal, return_lse=True,
            bias=None if bias is None else jnp.asarray(bias))

    (jo, jlse), vjp = jax.vjp(jfn, *(jnp.asarray(a, jd) for a in (q, k, v)))
    jgrads = vjp((jnp.asarray(go, jd), jnp.asarray(glse)))

    tq, tk, tv = (_t(a).to(dtype).requires_grad_() for a in (q, k, v))
    o, lse = K.flash_attention(tq, tk, tv, causal=causal, return_lse=True,
                               bias=None if bias is None else _t(bias))
    grads = torch.autograd.grad(
        (o.float() * _t(go).to(dtype).float()).sum()
        + (lse * _t(glse)).sum(), (tq, tk, tv))
    f32 = dtype == torch.float32
    np.testing.assert_allclose(o.detach().float().numpy(), _np(jo),
                               **(FWD if f32 else BF16))
    np.testing.assert_allclose(lse.detach().numpy(), _np(jlse), **FWD)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   **(GRAD if f32 else BF16))


@pytest.mark.parametrize("sq,sk,causal,biased,rate", [
    pytest.param(13, 13, True, False, 0.0, id="13-13-True-False"),
    pytest.param(9, 13, False, True, 0.0, id="9-13-False-True"),
    pytest.param(16, 16, True, False, 0.1, id="16-16-True-False-dropout")])
def test_flash_attention_head_dim_128_matches_jax(sq, sk, causal, biased,
                                                  rate):
    # head_dim 128 in bf16, the shape class the wgmma kernels take on the
    # card (here the plain versions): forward, lse and the three gradients
    # against the Pallas kernels in interpret mode, with the K0 dropout
    # mask in the last case
    rng = np.random.RandomState(40 + sq + sk)
    b, h, d = 1, 2, 128
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32)
               for n in (sq, sk, sk))
    go = rng.randn(b, h, sq, d).astype(np.float32)
    bias = (rng.randn(b, sk) * 2).astype(np.float32) if biased else None
    jd = jnp.bfloat16
    seed = 31337
    drop = dict(dropout_rate=rate, dropout_seed=seed) if rate else {}

    def jfn(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, causal=causal,
            bias=None if bias is None else jnp.asarray(bias),
            **(dict(dropout_rate=rate,
                    dropout_seed=jnp.asarray([seed], jnp.int32))
               if rate else {}))

    jo, vjp = jax.vjp(jfn, *(jnp.asarray(a, jd) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(go, jd))
    tq, tk, tv = (_t(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    o = K.flash_attention(tq, tk, tv, causal=causal,
                          bias=None if bias is None else _t(bias), **drop)
    grads = torch.autograd.grad(
        (o.float() * _t(go).to(torch.bfloat16).float()).sum(), (tq, tk, tv))
    np.testing.assert_allclose(o.detach().float().numpy(), _np(jo), **BF16)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16)


def test_flash_kernel_routing_rule():
    # which CUDA kernel each (part, dtype, head dim) launches: bf16 at
    # head_dim 128 takes the wgmma forward, dK/dV and dQ; below 128 bf16
    # takes mma.sync throughout; f32 the CUDA-core
    # kernels at every head dim (test_torch_cuda.py holds a trace's kernel
    # names to this table on the card)
    fa = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                                 "flash_attention")
    for d in (16, 32, 64):
        assert [fa.kernel_name(p, torch.bfloat16, d)
                for p in ("fwd", "dkdv", "dq")] == [
            "flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
            "flash_bwd_dq_mma_kernel"]
    assert [fa.kernel_name(p, torch.bfloat16, 128)
            for p in ("fwd", "dkdv", "dq")] == [
        "flash_fwd_sm90_kernel", "flash_dkdv_sm90_kernel",
        "flash_dq_sm90_kernel"]
    for d in fa.HEAD_DIMS:
        assert [fa.kernel_name(p, torch.float32, d)
                for p in ("fwd", "dkdv", "dq")] == [
            "flash_fwd_kernel", "flash_dkdv_f32_kernel",
            "flash_dq_f32_kernel"]
    with pytest.raises(ValueError, match="head_dim"):
        fa.kernel_name("fwd", torch.bfloat16, 96)


def test_flash_attention_kernel_functions_match_the_pallas_pieces():
    """The three kernel-level plain versions against the Pallas forward
    and the two backward kernels, fed the same (o, lse, delta)."""
    rng = np.random.RandomState(31)
    bh, s, d, heads = 4, 16, 8, 2
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    bias = rng.randn(bh // heads, s).astype(np.float32)
    scale = d ** -0.5
    jb = jnp.asarray(bias).reshape(bh // heads, 1, s)
    jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                        None, scale, True, 8, 8, s, 0.0, heads)
    o, lse = K.flash_attention_fwd(_t(q), _t(k), _t(v), heads=heads,
                                   sm_scale=scale, causal=True,
                                   bias=_t(bias))
    np.testing.assert_allclose(o.numpy(), _np(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), _np(jlse)[..., 0], **FWD)
    delta = (_t(do) * o).sum(-1)
    jdq, jdk, jdv = jfa._bwd_with_delta(
        scale, True, 8, 8, s, 0.0, heads,
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, None, jlse),
        jnp.asarray(do), jnp.asarray(delta.numpy())[..., None])[:3]
    args = dict(heads=heads, sm_scale=scale, causal=True, bias=_t(bias))
    dk, dv = K.flash_attention_dkdv(_t(q), _t(k), _t(v), _t(do), lse,
                                    delta, **args)
    dq = K.flash_attention_dq(_t(q), _t(k), _t(v), _t(do), lse, delta,
                              **args)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _np(want), **GRAD)


def test_flash_attention_refuses_dropout_and_bad_shapes():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="dropout_seed"):
        K.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        K.flash_attention(q, q, q, dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="q_len == kv_len"):
        K.flash_attention(q, torch.zeros(1, 2, 5, 8), torch.zeros(1, 2, 5, 8),
                          causal=True)
    with pytest.raises(NotImplementedError, match="broadcast"):
        K.flash_attention(q, q, q, bias=torch.zeros(1, 2, 4, 4))


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 32), (2, 9, 48), (7, 96), (3, 1000)])
def test_layer_norm_vjp_matches_jax(dtype, shape):
    rng = np.random.RandomState(32)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    jd = _jdt(dtype)
    jy, vjp = jax.vjp(lambda x_, g_, b_: jln.layer_norm(x_, g_, b_,
                                                        block_rows=8),
                      jnp.asarray(x, jd), jnp.asarray(g), jnp.asarray(b))
    jdx, jdg, jdb = vjp(jnp.asarray(dy, jd))
    tx = _t(x).to(dtype).requires_grad_()
    tg, tb = _t(g).requires_grad_(), _t(b).requires_grad_()
    y = K.layer_norm(tx, tg, tb)
    dx, dg, db = torch.autograd.grad(y, (tx, tg, tb), _t(dy).to(dtype))
    f32 = dtype == torch.float32
    np.testing.assert_allclose(y.float().detach().numpy(), _np(jy),
                               **(FWD if f32 else BF16))
    np.testing.assert_allclose(dx.float().numpy(), _np(jdx),
                               **(GRAD if f32 else BF16))
    # dgamma/dbeta sum f32 terms of bf16 inputs on both sides
    np.testing.assert_allclose(dg.numpy(), _np(jdg), **GRAD)
    np.testing.assert_allclose(db.numpy(), _np(jdb), **GRAD)


def test_layer_norm_forward_statistics_match_the_pallas_forward():
    rng = np.random.RandomState(33)
    x = (rng.randn(16, 40) * 3 - 1).astype(np.float32)
    g = rng.randn(40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    jy, jmean, jrstd = jln._fwd(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), 1e-6, 8)
    y, mean, rstd = K.layer_norm_fwd(_t(x), _t(g), _t(b), return_stats=True)
    np.testing.assert_allclose(y.numpy(), _np(jy), **FWD)
    np.testing.assert_allclose(mean.numpy(), _np(jmean)[:, 0], **FWD)
    np.testing.assert_allclose(rstd.numpy(), _np(jrstd)[:, 0], **FWD)


# ---------------------------------------------------------------------------
# Softmax cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_xent_vjp_matches_jax(dtype, smoothing):
    rng = np.random.RandomState(34)
    rows, vocab = 10, 300            # 300: a ragged final vocab block
    x = (rng.randn(2, rows // 2, vocab) * 3).astype(np.float32)
    lab = rng.randint(0, vocab, (2, rows // 2)).astype(np.int32)
    gl = rng.rand(2, rows // 2).astype(np.float32)
    jd = _jdt(dtype)
    jl, vjp = jax.vjp(
        lambda x_: jxe.softmax_cross_entropy(x_, jnp.asarray(lab),
                                             label_smoothing=smoothing,
                                             block_vocab=128),
        jnp.asarray(x, jd))
    (jdx,) = vjp(jnp.asarray(gl))
    tx = _t(x).to(dtype).requires_grad_()
    loss = K.softmax_cross_entropy(tx, _t(lab), label_smoothing=smoothing)
    (dx,) = torch.autograd.grad(loss, tx, _t(gl))
    np.testing.assert_allclose(loss.detach().numpy(), _np(jl), **FWD)
    ref = np.asarray(jxe.softmax_cross_entropy_reference(
        jnp.asarray(x, jd), jnp.asarray(lab), label_smoothing=smoothing))
    np.testing.assert_allclose(loss.detach().numpy(), ref, **FWD)
    np.testing.assert_allclose(dx.float().numpy(), _np(jdx),
                               **(FWD if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab", [2, 10, 120])
def test_softmax_xent_forward_at_small_vocab_matches_jax(vocab, dtype):
    # the vocabularies the forward kernel gives a group of a warp's lanes a
    # row (NSP's 2 classes, MNIST's 10, seq2seq's 120), smoothing on, one
    # label past the vocabulary and one negative (matching no column): the
    # forward's loss and lse against the Pallas forward in interpret mode.
    # The label past the vocabulary lies past the Pallas kernel's 128-column
    # block too: one in [vocab, 128) meets a masked NEG_INF column there
    rng = np.random.RandomState(36 + vocab)
    rows, smoothing = 16, 0.1
    x = (rng.randn(rows, vocab) * 3).astype(np.float32)
    lab = rng.randint(0, vocab, rows).astype(np.int32)
    lab[2], lab[5] = vocab + 1000, -1
    jd = _jdt(dtype)
    jloss, jlse = jxe._fwd(jnp.asarray(x, jd), jnp.asarray(lab)[:, None], 8,
                           128, smoothing)
    loss, lse = K.softmax_xent_fwd(_t(x).to(dtype), _t(lab),
                                   smoothing=smoothing)
    np.testing.assert_allclose(loss.numpy(), _np(jloss)[:, 0], **FWD)
    np.testing.assert_allclose(lse.numpy(), _np(jlse)[:, 0], **FWD)


def test_softmax_xent_is_not_torch_label_smoothing():
    rng = np.random.RandomState(35)
    x = _t(rng.randn(4, 50).astype(np.float32))
    lab = _t(rng.randint(0, 50, 4).astype(np.int32))
    ours = K.softmax_cross_entropy(x, lab, label_smoothing=0.1)
    torch_ls = torch.nn.functional.cross_entropy(
        x, lab.long(), label_smoothing=0.1, reduction="none")
    assert not torch.allclose(ours, torch_ls, rtol=1e-4)
    plain = torch.nn.functional.cross_entropy(x, lab.long(),
                                              reduction="none")
    torch.testing.assert_close(K.softmax_cross_entropy(x, lab), plain)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def _within_ulp(got, want, scale, max_ulp):
    """|got - want| <= max_ulp ulp of ``scale`` (the larger summand: a
    contracted multiply-add moves a cancelling sum by more ulp of the
    result itself)."""
    bound = max_ulp * np.spacing(np.abs(scale).astype(np.float32))
    return bool(np.all(np.abs(got - want) <= bound))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_update_matches_jax(dtype):
    rng = np.random.RandomState(36)
    n = 1000                            # not a multiple of 128 lanes
    p = rng.randn(n).astype(np.float32)
    m = (rng.randn(n) * 0.1).astype(np.float32)
    v = (rng.rand(n) * 0.01).astype(np.float32)
    g = (rng.randn(n) * 0.1).astype(np.float32)
    g[:5] = [0.0, 1e-30, -1e-12, 3.0, -7.5]
    tp, tg = _t(p).to(dtype), _t(g).to(dtype)
    # the port takes g in the parameter dtype; JAX the f32 widening of it
    pw, gw = tp.float().numpy(), tg.float().numpy()
    jp = jnp.asarray(pw, _jdt(dtype))
    kw = dict(beta1=0.9, beta2=0.997, eps=1e-9)
    alpha = np.float32(0.00137)
    # the port updates in place: hand it copies
    got = K.adam_update(tp.clone(), _t(m.copy()), _t(v.copy()), tg,
                        torch.tensor(alpha), **kw)
    got = [t.float().numpy() for t in got]
    scales = (np.abs(pw) + 1e-3,
              np.abs(0.9 * m) + np.abs(0.1 * gw),
              np.abs(0.997 * v) + np.abs(0.003 * gw * gw))
    ref = jfu.adam_update_reference(jp, jnp.asarray(m), jnp.asarray(v),
                                    jnp.asarray(gw), jnp.asarray(alpha),
                                    **kw)
    pallas = jfu.adam_update(jp, jnp.asarray(m), jnp.asarray(v),
                             jnp.asarray(gw), jnp.asarray(alpha), **kw)
    for a, r, k, scale in zip(got, ref, pallas, scales):
        # every operation rounded on both sides: the same bits
        np.testing.assert_array_equal(a, _np(r))
        assert _within_ulp(a, _np(k), scale, 8)


def test_adam_optimizer_keeps_flat_groups_in_first_occurrence_order():
    a = torch.nn.Parameter(torch.ones(3))
    w = torch.nn.Parameter(torch.ones(2, 2, dtype=torch.bfloat16))
    c = torch.nn.Parameter(torch.full((2,), 2.0))
    opt = popt.FlatAdam([a, w, c], learning_rate=0.1)
    assert [len(grp) for grp in opt.flat_groups] == [5, 4]
    assert [grp.m.dtype for grp in opt.flat_groups] == [torch.float32] * 2
    f32, bf16 = opt.flat_groups
    # parameters and gradients are views into the flat buffers
    assert a.data_ptr() == f32.p.data_ptr()
    assert c.data_ptr() == f32.p.data_ptr() + 3 * 4
    assert w.grad.data_ptr() == bf16.g.data_ptr()
    ((a * 2).sum() + (w.float() ** 2).sum() + c.sum()).backward()
    assert torch.equal(f32.g, torch.tensor([2.0, 2, 2, 1, 1]))
    assert a.grad.data_ptr() == f32.g.data_ptr()
    opt.step()
    # first Adam step: alpha * m / sqrt(v) = lr * sign(g)
    torch.testing.assert_close(a.detach(), torch.full((3,), 0.9))
    assert opt.beta1_power.item() == pytest.approx(0.81)
    assert opt.beta2_power.item() == pytest.approx(0.999 ** 2)
    assert a.data_ptr() == f32.p.data_ptr()
    opt.zero_grad()
    assert not f32.g.any() and a.grad is not None


def test_plain_versions_reach_the_adam_update(monkeypatch):
    # the trainer's plain switch reaches both the fused ops (forward and
    # the autograd Functions' backward) and the optimizer's update
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.models import transformer as tr

    seen = []
    orig = fused_ops.layer_norm
    monkeypatch.setattr(fused_ops, "layer_norm", lambda *a, **k: (
        seen.append(k["plain"]), orig(*a, **k))[1])
    cfg = tr.TransformerConfig.tiny()
    tok = np.random.RandomState(0).randint(2, cfg.vocab_size, (2, 8))
    for plain in (False, True):
        trainer = clm.causal_lm_trainer(
            batch_size=2, seq_len=8, cfg=cfg, compute_dtype=torch.float32,
            device="cpu", plain=plain)
        want = K.adam_update_plain if plain else K.adam_update
        assert trainer.optimizer.update is want
        trainer.step(tok, tok)
        assert set(seen) == {plain} and not fused_ops.using_plain_versions()
        seen.clear()
    p = torch.nn.Parameter(torch.ones(4))
    assert popt.FlatAdam([p]).update is K.adam_update


def test_adam_refuses_parameters_cut_off_from_the_flat_buffers():
    lin = torch.nn.Linear(3, 2)
    opt = popt.FlatAdam(lin.parameters(), learning_rate=0.1)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    opt.zero_grad()
    lin.zero_grad()          # nn.Module's default sets every .grad to None
    lin(torch.ones(1, 3)).sum().backward()
    with pytest.raises(RuntimeError, match="no longer views"):
        opt.step()
    lin2 = torch.nn.Linear(3, 2)
    opt2 = popt.FlatAdam(lin2.parameters())
    lin2.weight.data = lin2.weight.data.clone()
    with pytest.raises(RuntimeError, match="no longer views"):
        opt2.step()


# ---------------------------------------------------------------------------
# Fused ops and the mixed-precision lookup
# ---------------------------------------------------------------------------

def test_fused_ops_raise_on_dropout_and_add_at_rate_zero():
    # rate > 0 without a seed raises: the mask is a function of the seed
    x, r = torch.ones(2, 3), torch.full((2, 3), 2.0)
    assert torch.equal(fused_ops.fused_bias_dropout_residual(x, r, rate=0.0),
                       x + r)
    for call in (lambda: fused_ops.fused_bias_dropout_residual(x, r,
                                                               rate=0.1),
                 lambda: fused_ops.fused_attention(
                     torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 2, 8),
                     torch.zeros(1, 1, 2, 8), dropout_rate=0.1)):
        with pytest.raises(ValueError, match="seed"):
            call()


def test_mixed_precision_lookup_gathers_low_and_accumulates_in_f32():
    table = torch.nn.Parameter(torch.randn(10, 4))
    ids = torch.tensor([[1, 3, 1], [1, 9, 0]], dtype=torch.int32)
    rows = embedding_lookup(table, ids, compute_dtype=torch.bfloat16)
    assert rows.dtype == torch.bfloat16
    assert torch.equal(rows, table.detach()[ids.long()].bfloat16())
    g = torch.full((2, 3, 4), 1.0 / 3, dtype=torch.bfloat16)
    rows.backward(g)
    assert table.grad.dtype == torch.float32
    # three bf16 cotangents of id 1 summed in f32
    torch.testing.assert_close(table.grad[1],
                               torch.full((4,), 3 * g[0, 0, 0].float()))
    assert not table.grad[2].any()
