"""The PyTorch port's dropout pieces against the JAX package's, on the CPU.

Every comparison here is bit for bit unless it says otherwise: the masks
are integer functions of a seed or key, and the arithmetic around them
rounds each operation alike on both sides.

- ``framework.prng`` (JAX's threefry, partitionable mode) against
  ``jax.random``: ``key``, ``fold_in``, ``split``, ``random_bits``,
  ``uniform`` and ``randint`` over many seeds and counters, shapes of one,
  an odd count and more than 65536 elements, and the uint32 edge values;
- K0 (``mix32``, ``counter_keep_mask``) against ``ops/pallas/common.py``;
- the fused dropout-residual kernel's plain version (K4) against the JAX
  ``dropout_bias_residual`` (Pallas, interpret mode) and its composed
  reference, f32 and bf16, with and without a bias, at row counts that
  are no multiple of 8 or 256, and its gradients against ``jax.vjp`` (dx
  and dres bit for bit; dbias, an f32 sum over rows that PyTorch and XLA
  take in other orders, within 1e-5 at f32 and one bf16 step at bf16);
- flash attention with ``dropout_rate=0.1`` against the JAX
  ``flash_attention`` (interpret mode) and ``attention_xla``: o within
  1e-5 and dq/dk/dv within 1e-4 (f32; the two sides sum in other orders);
  the backward's mask read off dV, dK and dQ (``keep_mask_readoff``, the
  construction the card's mask checks use) through the port's plain
  backward and the Pallas backward: the K0 mask exactly;
- ``nn_ops._dropout_impl`` against the JAX ``Dropout`` lowering given the same
  key, f32 and bf16, values and gradients;
- ``random_seed.fold_in_value`` against the JAX rule, and the step
  streams of ``StepRNG`` against a JAX session's key chain.
"""

import importlib
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tensorflow_tpu.ops import nn_ops as jnn
from simple_tensorflow_tpu_torch.framework import prng
from simple_tensorflow_tpu_torch.framework import random_seed as prs
from simple_tensorflow_tpu_torch.ops import kernels as K
from simple_tensorflow_tpu_torch.ops import nn_ops
from torch_threads import one_torch_thread  # noqa: F401

jcommon = importlib.import_module("simple_tensorflow_tpu.ops.pallas.common")
jdr = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "dropout_residual")
jfa = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "flash_attention")
jrs = importlib.import_module("simple_tensorflow_tpu.framework.random_seed")
pdr = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "dropout_residual")
pdo = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "dropout")
pfa = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "flash_attention")

U32_EDGES = [0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2,
             2 ** 32 - 1]
SEEDS = [0, 1, 2, 3, 7, 42, 1234, 87654321, 2 ** 31 - 1, -1, -2 ** 31,
         2 ** 32 - 1, 99991, 5, 11, 13, 17, 19, 23, 29, 31]
SHAPES = [(1,), (7,), (3, 5), (70001,), (2, 3, 4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _raw(key):
    return np.asarray(jax.random.key_data(key))


def _bits(a):
    """f32 values as their bit patterns (so -0.0 != 0.0 and NaNs compare)."""
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# prng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.key(seed), _raw(jax.random.key(seed)))


@pytest.mark.parametrize("data", U32_EDGES + list(range(3, 15)))
def test_fold_in_matches_jax(data):
    k = jax.random.key(1234)
    np.testing.assert_array_equal(prng.fold_in(prng.key(1234), data),
                                  _raw(jax.random.fold_in(k, data)))


def test_fold_in_broadcasts_over_sites():
    data = np.array(U32_EDGES, dtype=np.uint32)
    got = prng.fold_in(prng.key(3), data)
    want = [_raw(jax.random.fold_in(jax.random.key(3), int(d)))
            for d in data]
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split_matches_jax(num):
    k = jax.random.fold_in(jax.random.key(9), 77)
    np.testing.assert_array_equal(prng.split(_raw(k), num),
                                  _raw(jax.random.split(k, num)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 87654321, -1])
def test_random_bits_and_uniform_match_jax(shape, seed):
    k = jax.random.fold_in(jax.random.key(seed), 2 ** 32 - 1)
    raw = _raw(k)
    np.testing.assert_array_equal(
        prng.random_bits(raw, shape),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    want = _bits(jax.random.uniform(k, shape))
    np.testing.assert_array_equal(_bits(prng.uniform(raw, shape)), want)
    np.testing.assert_array_equal(
        _bits(prng.uniform_torch(raw, shape, "cpu").numpy()), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (-5, 1000),
                                   (-2 ** 31, 2 ** 31 - 1), (3, 3)])
def test_randint_matches_jax(shape, lo, hi):
    k = jax.random.fold_in(jax.random.key(0), 12345)
    got = prng.randint(_raw(k), shape, lo, hi)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.randint(k, shape, lo, hi, jnp.int32)))


def test_randint_over_a_batch_of_keys_matches_jax():
    counters = np.arange(1, 21, dtype=np.uint32)
    keys = prng.fold_in(prng.key(0), counters)
    got = prng.randint(keys, (1,), 0, prng.INT32_MAX)
    for c, g in zip(counters, got):
        k = jax.random.fold_in(jax.random.key(0), int(c))
        want = jax.random.randint(k, (1,), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)
        np.testing.assert_array_equal(g, np.asarray(want))


# ---------------------------------------------------------------------------
# stream ids and the step key chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,graph_seed,op_seed", [
    ("causal_lm/dropout", None, None),
    ("causal_lm/decoder/layer_5/ffn/dropout", None, None),
    ("x", 3, None), ("x", None, 7), ("x", 87654321, 2 ** 20)])
def test_fold_in_value_matches_the_jax_rule(name, graph_seed, op_seed):
    attrs = {"_graph_seed": graph_seed, "seed": op_seed}
    op = types.SimpleNamespace(name=name, attrs=attrs)
    assert prs.fold_in_value(name, graph_seed, op_seed) == \
        jrs.fold_in_value(op)
    if graph_seed is None and op_seed is None:
        assert prs.fold_in_value(name) == zlib.crc32(name.encode()) & \
            0x7FFFFFFF


def test_step_rng_is_the_session_key_chain():
    """A session's step ``c`` folds ``c`` into ``key(0)``, then the op's
    stream id; seed sites draw ``randint(key, (1,), 0, 2**31 - 1)``."""
    keys = ["a/dropout", "b/ffn/dropout"]
    seeds = ["a/flash_attention", "a/fused_dropout_residual"]
    rngs = prs.StepRNG.for_steps([7, 8, 2 ** 32 - 1], keys, seeds)
    for counter, rng in zip([7, 8, 2 ** 32 - 1], rngs):
        root = jax.random.fold_in(jax.random.key(0), np.uint32(counter))
        for name in keys + seeds:
            k = jax.random.fold_in(root, prs.fold_in_value(name))
            if name in keys:
                assert rng.key_for(name) == tuple(int(w) for w in _raw(k))
            else:
                want = jax.random.randint(k, (1,), 0,
                                          jnp.iinfo(jnp.int32).max,
                                          dtype=jnp.int32)
                assert rng.seed_for(name) == int(want[0])


# ---------------------------------------------------------------------------
# K0
# ---------------------------------------------------------------------------

def test_mix32_matches_jax():
    rng = np.random.RandomState(40)
    h = np.concatenate([np.array(U32_EDGES, np.uint32),
                        rng.randint(0, 2 ** 32, 5000, dtype=np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(jcommon.mix32(jnp.asarray(h, jnp.uint32)))
    got = K.common.mix32_plain(_t(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed,salt", [(0, 0), (123456789, 0), (7, 5),
                                       (2 ** 31 - 2, 255), (-3, 2 ** 31)])
@pytest.mark.parametrize("keep_prob", [0.9, 0.5, 1.0 - 1e-9])
def test_counter_keep_mask_matches_jax(seed, salt, keep_prob):
    rows = np.arange(37, dtype=np.uint32)[:, None] * np.uint32(977)
    cols = np.array(U32_EDGES + list(range(40)), np.uint32)[None, :]
    want = np.asarray(jcommon.counter_keep_mask(
        jnp.int32(seed) if seed < 2 ** 31 else jnp.uint32(seed),
        jnp.uint32(salt), jnp.asarray(rows), jnp.asarray(cols), keep_prob))
    got = K.common.counter_keep_mask_plain(
        seed, salt, _t(rows.astype(np.int64)), _t(cols.astype(np.int64)),
        keep_prob)
    np.testing.assert_array_equal(got.numpy(), want)
    assert K.common.keep_threshold(keep_prob) == int(
        jcommon.keep_threshold(keep_prob))


# ---------------------------------------------------------------------------
# K4: fused dropout + bias + residual
# ---------------------------------------------------------------------------

def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(13, 40), (3, 100, 48)])
@pytest.mark.parametrize("biased", [False, True])
def test_dropout_residual_matches_jax(dtype, shape, biased):
    # 13 and 300 rows: no multiple of the 8-row tile or the 256-row block
    rng = np.random.RandomState(41 + len(shape))
    n = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32)
    bias = rng.randn(n).astype(np.float32) if biased else None
    g = rng.randn(*shape).astype(np.float32)
    seed, rate = 918273, 0.1
    jd = _jdt(dtype)
    jargs = [jnp.asarray(a, jd) for a in (x, res)]
    jb = None if bias is None else jnp.asarray(bias, jd)
    jseed = jnp.asarray([seed], jnp.int32)

    def jfn(x_, r_, b_=None):
        return jdr.dropout_bias_residual(x_, r_, b_, rate=rate, seed=jseed)

    primals = jargs + ([jb] if biased else [])
    jout, vjp = jax.vjp(jfn, *primals)
    jgrads = vjp(jnp.asarray(g, jd))
    ref = jdr.dropout_bias_residual_reference(*jargs, jb, rate=rate,
                                              seed=jseed)

    tx, tr = (_t(a).to(dtype).requires_grad_() for a in (x, res))
    tb = None if bias is None else _t(bias).to(dtype).requires_grad_()
    out = pdr.dropout_bias_residual(tx, tr, tb, rate=rate, seed=seed)
    grads = torch.autograd.grad(out, [tx, tr] + ([tb] if biased else []),
                                _t(g).to(dtype))
    assert out.dtype == dtype and out.shape == shape
    got = _bits(out.detach().float())
    np.testing.assert_array_equal(got, _bits(_np(jout)))
    np.testing.assert_array_equal(got, _bits(_np(ref)))
    for got, want in zip(grads[:2], jgrads[:2]):
        np.testing.assert_array_equal(_bits(got.float()), _bits(_np(want)))
    if biased:
        # dbias sums the same f32 dx, in PyTorch's order and XLA's: the
        # sums differ in the last bits, and a bf16 cast may round them to
        # neighbouring values
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        np.testing.assert_allclose(grads[2].float().numpy(),
                                   _np(jgrads[2]), rtol=tol, atol=tol)


def test_dropout_residual_mask_drops_what_the_seed_says():
    x, r = torch.ones(300, 64), torch.zeros(300, 64)
    out = pdr.dropout_residual_fwd(x, r, rate=0.1, seed=5)
    keep = pdr.keep_mask_plain(300, 64, 5, 0.9, "cpu")
    assert torch.equal(out != 0, keep)
    assert abs(keep.float().mean().item() - 0.9) < 0.01
    scale = torch.tensor(1 / 0.9, dtype=torch.float32)
    assert torch.equal(out[keep], scale.expand(int(keep.sum())))
    assert not torch.equal(keep, pdr.keep_mask_plain(300, 64, 6, 0.9, "cpu"))


def test_fused_bias_dropout_residual_needs_a_seed():
    from simple_tensorflow_tpu_torch.ops import fused_ops
    x, r = torch.ones(2, 3), torch.full((2, 3), 2.0)
    with pytest.raises(ValueError, match="seed"):
        fused_ops.fused_bias_dropout_residual(x, r, rate=0.1)
    got = fused_ops.fused_bias_dropout_residual(x, r, rate=0.1, seed=3)
    assert torch.equal(got, pdr.dropout_residual_fwd_plain(x, r, rate=0.1,
                                                           seed=3))


# ---------------------------------------------------------------------------
# flash attention with probability dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 24])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_dropout_matches_jax(s, causal):
    rng = np.random.RandomState(42 + s)
    b, h, d = 2, 2, 8
    q, k, v, go = (rng.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    seed, rate = 31337, 0.1
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=jseed)
    jo, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, **kw), jq, jk, jv)
    jgrads = vjp(jnp.asarray(go))
    xo, xvjp = jax.vjp(lambda *a: jfa.attention_xla(*a, **kw), jq, jk, jv)
    xgrads = xvjp(jnp.asarray(go))

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = K.flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate,
                          dropout_seed=seed)
    grads = torch.autograd.grad(o, (tq, tk, tv), _t(go))
    for want_o, want_g in ((jo, jgrads), (xo, xgrads)):
        np.testing.assert_allclose(o.detach().numpy(), _np(want_o),
                                   rtol=1e-5, atol=1e-5)
        for got, want in zip(grads, want_g):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                       atol=1e-4)
    # the mask matters: another seed moves the output
    o2 = K.flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate,
                           dropout_seed=seed + 1)
    assert not np.allclose(o2.detach().numpy(), _np(jo), atol=1e-3)


def test_flash_attention_dropout_kernel_functions_match_the_pallas_pieces():
    """The three kernel-level plain versions with dropout against the
    Pallas forward and the two backward kernels, fed the same (lse,
    delta); the lse does not see dropout."""
    rng = np.random.RandomState(43)
    bh, s, d, heads = 4, 24, 8, 2
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    scale, rate, seed = d ** -0.5, 0.1, 2024
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo, jlse = jfa._fwd(jq, jk, jv, None, jseed, scale, True, 8, 8, s, rate,
                        heads)
    args = dict(heads=heads, sm_scale=scale, causal=True, dropout_rate=rate,
                dropout_seed=seed)
    o, lse = K.flash_attention_fwd(_t(q), _t(k), _t(v), **args)
    np.testing.assert_allclose(o.numpy(), _np(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _np(jlse)[..., 0], rtol=1e-5,
                               atol=1e-5)
    nodrop, _ = K.flash_attention_fwd(_t(q), _t(k), _t(v), heads=heads,
                                      sm_scale=scale, causal=True)
    assert not np.allclose(o.numpy(), nodrop.numpy(), atol=1e-3)
    delta = (_t(do) * o).sum(-1)
    jdq, jdk, jdv = jfa._bwd_with_delta(
        scale, True, 8, 8, s, rate, heads,
        (jq, jk, jv, None, jseed, jlse), jnp.asarray(do),
        jnp.asarray(delta.numpy())[..., None])[:3]
    dk, dv = K.flash_attention_dkdv(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                    **args)
    dq = K.flash_attention_dq(_t(q), _t(k), _t(v), _t(do), lse, delta,
                              **args)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_mask_readoff_gives_the_k0_mask(causal):
    """``keep_mask_readoff`` (how the card's tests and chip_smoke.py read
    the bf16 backward's mask) through the port's plain dK/dV/dQ and the
    Pallas backward kernels: each of dV, dK and dQ gives the K0 mask of
    the live pairs bit for bit, and not the mask of the next seed."""
    bh, s, d, heads, rate, seed = 4, 24, 8, 2, 0.1, 2024
    scale = d ** -0.5
    args = dict(heads=heads, sm_scale=scale, causal=causal,
                dropout_rate=rate, dropout_seed=seed)

    def port(q, k, v, do, lse, delta):
        dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta, **args)
        return dk, dv, K.flash_attention_dq(q, k, v, do, lse, delta, **args)

    def pallas(q, k, v, do, lse, delta):
        jq, jk, jv, jdo, jlse, jdelta = (jnp.asarray(t.numpy())
                                         for t in (q, k, v, do, lse, delta))
        jdq, jdk, jdv = jfa._bwd_with_delta(
            scale, causal, 8, 8, s, rate, heads,
            (jq, jk, jv, None, jnp.asarray([seed], jnp.int32),
             jlse[..., None]), jdo, jdelta[..., None])[:3]
        return tuple(torch.tensor(_np(x)) for x in (jdk, jdv, jdq))

    live = torch.ones(s, s, dtype=torch.bool)
    if causal:
        live = live.tril()
    want = pfa.keep_mask_plain(bh, s, s, rate, seed, "cpu") & live
    bad = pfa.keep_mask_plain(bh, s, s, rate, seed + 1, "cpu") & live
    for bwd in (port, pallas):
        for got in pfa.keep_mask_readoff(bwd, bh, s, d, torch.float32,
                                         "cpu"):
            assert int((got != want).sum()) == 0
            assert int((got != bad).sum()) > 0


# ---------------------------------------------------------------------------
# Dropout (threefry)
# ---------------------------------------------------------------------------

def _jax_dropout(x, keep_prob, key):
    """The JAX package's Dropout lowering, called as a session calls it."""
    ctx = types.SimpleNamespace(rng_for=lambda op: key)
    op = types.SimpleNamespace(attrs={"keep_prob": keep_prob,
                                      "noise_shape": None})
    return jnn._dropout_lower(ctx, op, [x])[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (5, 7, 3), (70001,)])
@pytest.mark.parametrize("counter", [1, 2 ** 32 - 1])
def test_dropout_matches_the_jax_lowering(dtype, shape, counter):
    rng = np.random.RandomState(44)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), counter),
                             prs.fold_in_value("causal_lm/dropout"))
    jd = _jdt(dtype)
    jout, vjp = jax.vjp(lambda x_: _jax_dropout(x_, 0.9, key),
                        jnp.asarray(x, jd))
    (jdx,) = vjp(jnp.asarray(g, jd))
    tx = _t(x).to(dtype).requires_grad_()
    out = nn_ops._dropout_impl(tx, 0.9, tuple(int(w) for w in _raw(key)))
    (dx,) = torch.autograd.grad(out, tx, _t(g).to(dtype))
    got = _bits(out.detach().float())
    np.testing.assert_array_equal(got, _bits(_np(jout)))
    np.testing.assert_array_equal(_bits(dx.float()), _bits(_np(jdx)))


def test_dropout_divides_by_keep_prob_in_the_input_dtype():
    key = (0, 12345)
    x = torch.ones(4096, dtype=torch.bfloat16)
    out = pdo.dropout_plain(x, 0.9, key)
    kept = out[out != 0].float()
    # 1 / 0.8984375 (bf16 0.9) rounds to bf16 1.109375, not 1 / 0.9
    assert torch.equal(kept, torch.full_like(kept, 1.109375))
    assert nn_ops._dropout_impl(x, 1.0, key) is x
    with pytest.raises(ValueError, match="keep_prob"):
        nn_ops._dropout_impl(x, 0.0, key)


def test_trainer_derives_each_step_of_a_block_as_one_step_alone():
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.models import transformer as ptr

    cfg = ptr.TransformerConfig.tiny()
    cfg.dropout = 0.1
    tr = clm.causal_lm_trainer(batch_size=2, seq_len=8, cfg=cfg,
                               device="cpu")
    sites = (tr._key_sites, tr._seed_sites)

    def alone(counter):
        return prs.StepRNG.for_steps([counter], *sites)[0]

    # across a block boundary, then after a counter set from a checkpoint
    want = list(range(1, clm.RNG_BLOCK + 3)) + [6, 7]
    got = []
    for counter in want:
        if counter == 6 and got:
            tr.rng_counter = 5
        rng = tr._step_rng()
        assert tr.rng_counter == counter
        got.append(rng)
    for counter, rng in zip(want, got):
        ref = alone(counter)
        assert rng._keys == ref._keys and rng._seeds == ref._seeds


# ---------------------------------------------------------------------------
# Dropout: the kernels' integer keep test, the saved bits and the backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep_prob", [0.9, 0.5, 0.1, 1.0 - 2.0 ** -24,
                                       2.0 ** -20])
def test_keep_bits_limit_is_the_float_rule_over_every_mantissa(keep_prob):
    """The kernels keep ``r <= keep_bits_limit`` where JAX keeps
    ``bitcast(r >> 9 | 0x3F800000) - 1 < f32(keep_prob)``: the same for
    all 2**23 values of ``r >> 9``, with the 9 low bits all 0 or all 1."""
    m = np.arange(2 ** 23, dtype=np.uint32)
    u = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    want = u < np.float32(keep_prob)
    limit = np.uint32(pdo.keep_bits_limit(keep_prob))
    for low in (0, 511):
        r = (m << np.uint32(9)) | np.uint32(low)
        np.testing.assert_array_equal(r <= limit, want)
    # and the draws of a key agree with the plain version's mask
    key = (123456789, 987654321)
    bits = prng.random_bits(np.asarray(key, np.uint32), (70001,))
    np.testing.assert_array_equal(
        bits <= limit,
        pdo.keep_mask_plain((70001,), keep_prob, key, "cpu").numpy())


@pytest.mark.parametrize("keep_prob", [1e-46, 5e-324])
def test_keep_prob_that_is_zero_in_f32_is_refused(keep_prob):
    """No integer limit keeps nothing, and the JAX rule keeps nothing
    where ``f32(keep_prob)`` is 0: both the limit and the op refuse it
    (on the card the kernel would otherwise keep everything)."""
    assert np.float32(keep_prob) == 0
    with pytest.raises(ValueError, match="keep"):
        pdo.keep_bits_limit(keep_prob)
    with pytest.raises(ValueError, match="keep_prob"):
        nn_ops._dropout_impl(torch.ones(8), keep_prob, (1, 2))
    # the least positive f32 still has a limit: the uniform's 0 alone
    assert pdo.keep_bits_limit(float(np.float32(2.0 ** -149))) == 511


@pytest.mark.parametrize("n", [1, 7, 8, 9, 70001])
def test_keep_bits_layout_on_ragged_counts(n):
    """Bit ``e`` of byte ``j`` is element ``8j + e``; the tail of the last
    byte is zero (numpy's little-endian ``packbits``); unpacking gives the
    mask back."""
    keep = torch.from_numpy(np.random.RandomState(n).rand(n) < 0.9)
    bits = pdo.pack_keep_bits_plain(keep)
    assert bits.dtype == torch.uint8 and bits.shape == (-(-n // 8),)
    np.testing.assert_array_equal(
        bits.numpy(), np.packbits(keep.numpy(), bitorder="little"))
    if n % 8:
        assert int(bits[-1]) >> (n % 8) == 0
    assert torch.equal(pdo.unpack_keep_bits_plain(bits, (n,)), keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (9,), (70001,),
                                   (3, 5, 7)])
def test_dropout_bwd_from_bits_is_the_forward_of_g(dtype, shape):
    """The backward from the forward's bits equals the plain forward of
    the cotangent under the same key (what the backward computed before
    the mask was saved)."""
    rng = np.random.RandomState(45)
    key = (0, 2 ** 32 - 1)
    x, g = (_t(rng.randn(*shape).astype(np.float32)).to(dtype)
            for _ in range(2))
    out, bits = pdo.dropout_fwd(x, 0.9, key, return_bits=True)
    assert torch.equal(out, pdo.dropout_plain(x, 0.9, key))
    keep = pdo.keep_mask_plain(shape, 0.9, key, "cpu")
    assert torch.equal(bits, pdo.pack_keep_bits_plain(keep))
    want = pdo.dropout_plain(g, 0.9, key)
    for dx in (pdo.dropout_bwd_bits_plain(g, bits, 0.9),
               pdo.dropout_bwd(g, 0.9, bits)):
        np.testing.assert_array_equal(_bits(dx.float()), _bits(want.float()))


@pytest.mark.parametrize("plain", [False, True])
def test_dropout_backward_draws_nothing(monkeypatch, plain):
    """After the forward no threefry draw is made: the backward runs from
    the saved bits with the generator made to raise."""
    rng = np.random.RandomState(46)
    key = (7, 8)
    x = _t(rng.randn(4, 33).astype(np.float32)).requires_grad_()
    g = _t(rng.randn(4, 33).astype(np.float32))
    out = pdo.DropoutFunction.apply(x, 0.9, key, plain)
    want = pdo.dropout_plain(g, 0.9, key)

    def drawn(*args, **kwargs):
        raise AssertionError("the backward drew random bits")

    monkeypatch.setattr(prng, "uniform_torch", drawn)
    with pytest.raises(AssertionError, match="drew"):
        pdo.dropout_plain(g, 0.9, key)
    out.backward(g)
    assert torch.equal(x.grad, want)
