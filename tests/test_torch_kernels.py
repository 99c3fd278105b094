"""The PyTorch port's kernel modules against the JAX package's.

Each kernel module of ``simple_tensorflow_tpu_torch.ops.kernels`` holds a
hand-written CUDA kernel and its plain PyTorch version; on CPU tensors
the wrapper runs the plain version. Here the same numpy-seeded inputs go
through the port (CPU) and through the JAX function as the JAX package's
own tests run it on the CPU (the Pallas kernel in interpret mode, and
its composed-XLA reference). f32 tolerances are rtol 1e-5, atol 1e-5
(the two sides sum in different orders); the int8 paths are compared
bit for bit. ``test_torch_cuda.py`` holds each CUDA kernel against its
plain version on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as stf
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.ops.pallas import common as jcommon
from simple_tensorflow_tpu_torch.models import transformer as ptr
from simple_tensorflow_tpu_torch.ops import kernels as K
from simple_tensorflow_tpu_torch.ops.kernels import _build
from simple_tensorflow_tpu_torch.ops.kernels import common as kcommon

# the package's __init__ re-exports functions under the modules' names
jda = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "decode_attention")
jln = importlib.import_module("simple_tensorflow_tpu.ops.pallas.layer_norm")
kda = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "decode_attention")
jqmm = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                               "quant_matmul")
kqmm = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                               "quant_matmul")
kln = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "layer_norm")
kdr = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "dropout_residual")
kdo = importlib.import_module("simple_tensorflow_tpu_torch.ops.kernels."
                              "dropout")

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# DecodeAttention
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b, kq, L, h, d, causal, biased):
    rng = np.random.RandomState(seed)
    qshape = (b, h, d) if kq == 1 else (b, kq, h, d)
    q = rng.randn(*qshape).astype(np.float32)
    k = rng.randn(b, L, h, d).astype(np.float32)
    v = rng.randn(b, L, h, d).astype(np.float32)
    hi = L - (kq if causal else 0)
    lengths = rng.randint(1, hi + 1, size=b).astype(np.int32)
    lengths[0], lengths[-1] = hi, 1      # full walk; a scratch-page row
    bias = rng.randn(b, L).astype(np.float32) if biased else None
    return q, k, v, lengths, bias


@pytest.mark.parametrize("kq,causal", [(1, False), (4, True)])
@pytest.mark.parametrize("biased", [False, True])
def test_decode_attention_matches_jax(kq, causal, biased):
    # L = 13 is no multiple of any block: the tails are masked
    q, k, v, lengths, bias = _attn_inputs(3, 3, kq, 13, 2, 8, causal,
                                          biased)
    got = K.decode_attention(
        _t(q), _t(k), _t(v), _t(lengths),
        bias=None if bias is None else _t(bias),
        causal_offset=causal).numpy()
    jbias = None if bias is None else jnp.asarray(bias)
    for fn in (jda.decode_attention, jda.decode_attention_xla):
        want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(lengths),
                             bias=jbias, block_l=8, causal_offset=causal))
        np.testing.assert_allclose(got, want, **F32)


def test_decode_attention_block_is_chained_single_queries():
    q, k, v, lengths, _ = _attn_inputs(5, 2, 4, 12, 2, 8, True, False)
    blk = K.decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                             causal_offset=True).numpy()
    for j in range(4):
        one = K.decode_attention(_t(q[:, j]), _t(k), _t(v),
                                 _t(lengths + j + 1)).numpy()
        np.testing.assert_allclose(blk[:, j], one, **F32)


def test_decode_attention_empty_row_is_zero_like_the_tpu_kernel():
    # a row with no live position: the Pallas kernel skips every block
    # and returns acc / 1 = 0 (the composed reference would average V)
    q, k, v, lengths, _ = _attn_inputs(7, 2, 1, 8, 2, 4, False, False)
    lengths[1] = 0
    got = K.decode_attention(_t(q), _t(k), _t(v), _t(lengths)).numpy()
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, **F32)
    assert not got[1].any()


def test_decode_attention_sm_scale_matches_jax():
    q, k, v, lengths, _ = _attn_inputs(9, 2, 1, 10, 2, 8, False, False)
    got = K.decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                             sm_scale=0.3).numpy()
    want = np.asarray(jda.decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), sm_scale=0.3))
    np.testing.assert_allclose(got, want, **F32)


def _split_merge(q, k, v, lengths, bias, causal, sm_scale):
    """The query-block kernel's split-K algorithm, written in torch (f32):
    chunk c of ``SPLIT_L`` positions gives each query j a partial (m_c,
    l_c, acc_c) with p = 0 at its masked positions; chunks at or past the
    row's horizon (length + Kq with causal_offset) are not computed; the
    merge is m = max m_c, w_c = exp(m_c - m), l = sum w_c l_c, acc = sum
    w_c acc_c, out = acc / (l == 0 ? 1 : l). Returns (out, the number of
    (query, chunk) partials wholly masked)."""
    b, kq, h, d = q.shape
    L = k.shape[1]
    sl = kda.SPLIT_L
    out = torch.zeros_like(q)
    dead = 0
    for bi in range(b):
        n = int(lengths[bi])
        allowed = torch.full((kq,), n) + (torch.arange(kq) + 1 if causal
                                          else 0)
        horizon = min(n + (kq if causal else 0), L)
        parts = []
        for c0 in range(0, horizon, sl):
            pos = torch.arange(c0, min(c0 + sl, L))
            s = torch.einsum("qhd,lhd->qhl", q[bi], k[bi, pos]) * sm_scale
            if bias is not None:
                s = s + bias[bi, pos]
            live = (pos[None, :] < allowed[:, None])[:, None, :]
            s = torch.where(live, s, torch.full_like(s, kcommon.NEG_INF))
            m_c = s.amax(dim=-1, keepdim=True)
            p = torch.where(live, torch.exp(s - m_c), torch.zeros_like(s))
            dead += int((~live.any(dim=-1)).sum())
            parts.append((m_c, p.sum(dim=-1, keepdim=True),
                          torch.einsum("qhl,lhd->qhd", p, v[bi, pos])))
        if not parts:
            continue
        m = torch.stack([pt[0] for pt in parts]).amax(dim=0)
        w = [torch.exp(pt[0] - m) for pt in parts]
        l = sum(wc * pt[1] for wc, pt in zip(w, parts))
        acc = sum(wc * pt[2] for wc, pt in zip(w, parts))
        out[bi] = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out, dead


@pytest.mark.parametrize("L", [256, 200])
@pytest.mark.parametrize("kq,causal,biased", [(16, True, False),
                                              (16, True, True),
                                              (4, False, True),
                                              (4, False, False)])
def test_decode_attention_split_merge_matches_jax(kq, causal, biased, L):
    # lengths: a full walk; SPLIT_L - 2, whose second chunk is wholly
    # masked for the block's first queries (causal) and SPLIT_L + 1
    # (non-causal: 0, a row with no live position, which returns zeros)
    sl = kda.SPLIT_L
    q, k, v, lengths, bias = _attn_inputs(41, 3, kq, L, 2, 8, causal, biased)
    lengths[1:] = (sl - 2, sl + 1) if causal else (0, sl + 1)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tb = None if bias is None else _t(bias)
    got, dead = _split_merge(tq, tk, tv, _t(lengths), tb, causal, 8 ** -0.5)
    assert dead > 0 if causal else not got[1].any()
    plain = K.decode_attention_plain(tq, tk, tv, _t(lengths), bias=tb,
                                     causal_offset=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        bias=None if bias is None else jnp.asarray(bias),
        causal_offset=causal))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,L,split_l", [
    (1, 256, 64), (4, 256, 128), (16, 256, 256), (1, 200, 64),
    (4, 200, 128), (16, 200, 200), (1, 17, 17), (8, 256, 128),
    (2, 256, 64)])
def test_decode_one_split_len_by_shape(b, L, split_l):
    # the Kq = 1 kernel splits the cache axis over blocks only while the
    # B * H = 16 B blocks leave the 132 SMs idle: B = 1 and 4 split, the
    # B = 16 bucket does not (one block per (b, h), no second pass)
    assert kda.one_split_len(b, 16, L, sms=132) == split_l
    assert split_l % kda.ONE_MIN_SPLIT == 0 or split_l == L


@pytest.mark.parametrize("b,floats", [(1, 16 * 4 * 66), (4, 4 * 16 * 2 * 66),
                                      (16, 0)])
def test_decode_one_workspace_floats(b, floats):
    # per (b, h, split) the f32 accumulator (D = 64) and (m, l); none when
    # one block covers L (the kernel writes its output directly)
    split_l = kda.one_split_len(b, 16, 256, sms=132)
    assert kda.split_workspace_floats(b, 1, 256, 16, 64, split_l) == floats
    # never above what the query-block chunks of SPLIT_L would take
    assert floats <= kda.split_workspace_floats(b, 1, 256, 16, 64)


def _one_split_merge(q, k, v, lengths, bias, causal, sm_scale, split_l):
    """The Kq = 1 kernel's algorithm, written in torch (f32). Block (b,
    split) walks positions [split * split_l, +split_l) below the row's end
    (length, + 1 with causal_offset); its NG lane groups (8 warps of 32 /
    G groups, G lanes covering a row's 16-byte chunks) take positions
    t0 + u NG + g, U = 4 at a time: m_t = max(m, s), alpha = exp(m - m_t),
    p = exp(s - m_t) at live positions and 0 elsewhere. The groups merge
    (m = max m_g, w_g = exp(m_g - m)), then the splits below the end (a
    second pass when there are several). A row with no live position
    returns zeros."""
    b, h, d = q.shape
    L = k.shape[1]
    chunks = -(-d // 4)                    # f32: 4 values a 16-byte chunk
    G = next(g for g in (4, 8, 16, 32, 64) if g >= chunks)
    ng = 8 * 32 // min(G, 32)
    n_split = -(-L // split_l)

    def merge(parts):
        m = torch.stack([pt[0] for pt in parts]).amax(dim=0)
        w = [torch.exp(pt[0] - m) for pt in parts]
        return (m, sum(wg * pt[1] for wg, pt in zip(w, parts)),
                sum(wg[:, None] * pt[2] for wg, pt in zip(w, parts)))

    out = torch.zeros_like(q)
    for bi in range(b):
        end = max(0, min(int(lengths[bi]) + int(causal), L))
        splits = []
        for l0 in range(0, L, split_l):
            if n_split > 1 and l0 >= end:
                continue                   # the block exits, never read
            l1 = min(l0 + split_l, end)
            groups = []
            for g in range(ng):
                m = torch.full((h,), kcommon.NEG_INF)
                lsum, acc = torch.zeros(h), torch.zeros(h, d)
                for t0 in range(l0, l1, ng * 4):
                    pos = [p for p in (t0 + u * ng + g for u in range(4))
                           if p < l1]
                    if not pos:
                        continue           # alpha 1, every p 0
                    idx = torch.tensor(pos)
                    s = torch.einsum("hd,lhd->lh", q[bi], k[bi, idx]) * \
                        sm_scale
                    if bias is not None:
                        s = s + bias[bi, idx][:, None]
                    mt = torch.maximum(m, s.amax(dim=0))
                    p = torch.exp(s - mt)
                    alpha = torch.exp(m - mt)
                    lsum = lsum * alpha + p.sum(dim=0)
                    acc = acc * alpha[:, None] + torch.einsum(
                        "lh,lhd->hd", p, v[bi, idx])
                    m = mt
                groups.append((m, lsum, acc))
            splits.append(merge(groups))
        if splits:
            _, lsum, acc = merge(splits)
            out[bi] = acc / torch.where(lsum == 0.0, torch.ones_like(lsum),
                                        lsum)[:, None]
    return out


@pytest.mark.parametrize("L", [200, 17])
@pytest.mark.parametrize("causal,biased", [(False, False), (False, True),
                                           (True, True)])
def test_decode_one_split_merge_matches_jax(L, causal, biased):
    # the Kq = 1 kernel's split-K algorithm against the plain version and
    # the JAX kernel (interpret mode): B = 3 (L = 200 takes 64-position
    # splits) with a full row, a row of length 0 (zeros without
    # causal_offset) and one of length 1
    q, k, v, lengths, bias = _attn_inputs(43, 3, 1, L, 2, 8, False, biased)
    lengths[1:] = (0, 1)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tb = None if bias is None else _t(bias)
    split_l = kda.one_split_len(3, 2, L, sms=132)
    assert (split_l < L) == (L == 200)
    got = _one_split_merge(tq, tk, tv, _t(lengths), tb, causal, 8 ** -0.5,
                           split_l)
    assert causal or not got[1].any()
    plain = K.decode_attention_plain(tq, tk, tv, _t(lengths), bias=tb,
                                     causal_offset=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)
    # JAX's one-query entry has no causal_offset: with it, the Kq = 1 case
    # is the query block of one query
    jq = jnp.asarray(q[:, None] if causal else q)
    want = np.asarray(jda.decode_attention(
        jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        bias=None if bias is None else jnp.asarray(bias),
        causal_offset=causal))
    np.testing.assert_allclose(got.numpy(), want.reshape(q.shape),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L", [200, 17])
@pytest.mark.parametrize("biased", [False, True])
def test_decode_attention_one_query_b1_matches_jax(L, biased):
    # the decode bucket B = 1 at a ragged cache length, through the
    # wrapper (its plain version on CPU tensors), against the Pallas kernel
    # in interpret mode and the composed reference
    q, k, v, lengths, bias = _attn_inputs(45, 1, 1, L, 2, 8, False, biased)
    lengths[0] = L - 3
    got = K.decode_attention(
        _t(q), _t(k), _t(v), _t(lengths),
        bias=None if bias is None else _t(bias)).numpy()
    jbias = None if bias is None else jnp.asarray(bias)
    for fn in (jda.decode_attention, jda.decode_attention_xla):
        want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(lengths),
                             bias=jbias, block_l=8))
        np.testing.assert_allclose(got, want, **F32)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 32), (2, 8, 48)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    got = K.layer_norm(_t(x), _t(g), _t(b)).numpy()
    want = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), block_rows=8))
    np.testing.assert_allclose(got, want, **F32)
    ref = np.asarray(jln.layer_norm_reference(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, **F32)


def test_layer_norm_bf16_keeps_f32_statistics():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    got = K.layer_norm(_t(x).bfloat16(), _t(g), _t(b))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jln.layer_norm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b),
        block_rows=8).astype(jnp.float32))
    # one bf16 rounding of the output apart at most
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_layer_norm_eps_and_constant_row():
    x = np.full((2, 16), 3.0, np.float32)
    g = np.ones(16, np.float32)
    b = np.arange(16, dtype=np.float32)
    got = K.layer_norm(_t(x), _t(g), _t(b), eps=1e-3).numpy()
    want = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), eps=1e-3,
                                     block_rows=8))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, np.broadcast_to(b, (2, 16)), **F32)


@pytest.mark.parametrize("dtype,n,nv", [
    (torch.bfloat16, 1024, 4), (torch.bfloat16, 512, 2),
    (torch.bfloat16, 256, 1), (torch.float32, 1024, 8),
    (torch.float32, 128, 1), (torch.bfloat16, 768, 3),
    (torch.float32, 768, 6), (torch.float32, 384, 3),
    (torch.bfloat16, 2048, 0), (torch.bfloat16, 4096, 0),
    (torch.float32, 4096, 0), (torch.bfloat16, 96, 0),
    (torch.float32, 1000, 0), (torch.bfloat16, 1000, 0)])
def test_layer_norm_bwd_path_by_shape(dtype, n, nv):
    # the vector path (a warp per row, nv 16-byte vectors a lane) where n
    # is 32 lanes x 16 bytes x nv, nv up to the register cap of 32 values
    # a lane (BERT's 768: bf16 nv 3, f32 nv 6); else the general path (0).
    # The choice is the wrapper's, made before the launch.
    x = torch.zeros(3, n, dtype=dtype)
    assert kln.vectors_per_lane(n, dtype, x, x) == nv


@pytest.mark.parametrize("dtype,n,nv", [
    (torch.bfloat16, 1024, 4), (torch.bfloat16, 512, 2),
    (torch.bfloat16, 256, 1), (torch.float32, 1024, 8),
    (torch.float32, 512, 4), (torch.float32, 256, 2),
    (torch.float32, 128, 1), (torch.bfloat16, 1000, 0),
    (torch.float32, 1000, 0), (torch.bfloat16, 2048, 0),
    (torch.float32, 2048, 0), (torch.bfloat16, 128, 0),
    (torch.bfloat16, 768, 3), (torch.float32, 768, 6),
    (torch.float32, 896, 7), (torch.bfloat16, 1280, 0),
    (torch.float32, 1152, 0)])
def test_layer_norm_fwd_path_by_shape(dtype, n, nv):
    # the forward's vector path (a warp per row) for rows of 32 lanes x 16
    # bytes x nv; any other n takes the general path (0); x, gamma and beta
    # aligned here
    x = torch.zeros(3, n, dtype=dtype)
    g = torch.zeros(n)
    assert kln.vectors_per_lane(n, dtype, x, g, g) == nv


def test_layer_norm_fwd_takes_the_general_path_off_alignment():
    x = torch.zeros(3 * 1024 + 4)
    g = torch.zeros(1024 + 4)
    aligned, shifted = x[:3 * 1024].view(3, 1024), x[1:3 * 1024 + 1].view(
        3, 1024)                                   # 4 bytes in
    assert kln.vectors_per_lane(1024, torch.float32, aligned, g[:1024],
                                g[:1024]) == 8
    assert kln.vectors_per_lane(1024, torch.float32, shifted, g[:1024],
                                g[:1024]) == 0
    assert kln.vectors_per_lane(1024, torch.float32, aligned, g[:1024],
                                g[2:]) == 0        # beta 8 bytes in


def test_layer_norm_bwd_takes_the_general_path_off_alignment():
    x = torch.zeros(3 * 1024 + 8, dtype=torch.bfloat16)
    aligned = x[:3 * 1024].view(3, 1024)
    shifted = x[1:3 * 1024 + 1].view(3, 1024)     # 2 bytes in
    assert aligned.data_ptr() % 16 == 0
    assert kln.vectors_per_lane(1024, torch.bfloat16, aligned) == 4
    assert kln.vectors_per_lane(1024, torch.bfloat16, aligned,
                                    shifted) == 0


# ---------------------------------------------------------------------------
# The dropout kernels' paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n,nv", [
    (torch.bfloat16, 8, 2), (torch.bfloat16, 96, 2),
    (torch.bfloat16, 512, 2), (torch.bfloat16, 520, 4),
    (torch.bfloat16, 1000, 4), (torch.bfloat16, 1024, 4),
    (torch.bfloat16, 1032, 0), (torch.bfloat16, 2048, 0),
    (torch.bfloat16, 4096, 0), (torch.bfloat16, 7, 0),
    (torch.bfloat16, 100, 0), (torch.bfloat16, 1001, 0),
    (torch.float32, 4, 4), (torch.float32, 96, 4), (torch.float32, 512, 4),
    (torch.float32, 1000, 8), (torch.float32, 1024, 8),
    (torch.float32, 1028, 0), (torch.float32, 98, 0),
    (torch.float32, 1, 0)])
def test_dropout_residual_path_by_shape(dtype, n, nv):
    # K4's vector path (a warp per row) for rows of whole 16-byte vectors,
    # at most 1024 values, nv the least count in VEC_NV[dtype] (the shipped
    # widths' 512 and 1024) that holds the row; any other n takes the
    # general path (0)
    x = torch.zeros(kdr.VEC_MIN_ROWS, n, dtype=dtype)
    b = torch.zeros(n, dtype=dtype)
    assert kdr.vectors_per_lane(*x.shape, dtype, x, x, b) == nv


@pytest.mark.parametrize("rows,nv", [(1, 0), (37, 0), (127, 0), (128, 4),
                                     (300, 4), (4096, 4)])
def test_dropout_residual_path_by_rows(rows, nv):
    # below VEC_MIN_ROWS rows the general path's wider grid takes them
    x = torch.zeros(rows, 1024, dtype=torch.bfloat16)
    assert kdr.vectors_per_lane(rows, 1024, torch.bfloat16, x, x) == nv


def test_dropout_residual_takes_the_general_path_off_alignment():
    rows = kdr.VEC_MIN_ROWS
    x = torch.zeros(rows * 1024 + 8, dtype=torch.bfloat16)
    aligned = x[:rows * 1024].view(rows, 1024)
    shifted = x[1:rows * 1024 + 1].view(rows, 1024)     # 2 bytes in
    assert aligned.data_ptr() % 16 == 0
    bf16 = torch.bfloat16
    assert kdr.vectors_per_lane(rows, 1024, bf16, aligned, aligned) == 4
    assert kdr.vectors_per_lane(rows, 1024, bf16, aligned, shifted) == 0
    b = torch.zeros(1024 + 8, dtype=torch.bfloat16)
    assert kdr.vectors_per_lane(rows, 1024, bf16, aligned, aligned,
                                b[4:]) == 0        # bias 8 bytes in


@pytest.mark.parametrize("n,vec", [(8, True), (16 * 256 * 4096, True),
                                   (2 ** 32, True), (7, False),
                                   (70001, False), (12, False),
                                   (2 ** 32 + 8, False)])
def test_dropout_vector_path_by_count(n, vec):
    # 8 elements a thread while the flat index fits 32 bits
    assert kdo.vector_path(n) is vec


def test_dropout_takes_the_general_path_off_alignment():
    x = torch.zeros(1024 + 8, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert kdo.vector_path(1024, x[:1024])
    assert not kdo.vector_path(1024, x[1:1025])    # 2 bytes in
    assert not kdo.vector_path(1024, x[4:1028])    # 8 bytes in
    assert kdo.vector_path(1024, x[8:1032])        # 16 bytes in


# ---------------------------------------------------------------------------
# QuantMatMul
# ---------------------------------------------------------------------------

def test_quantize_rowwise_bit_exact_with_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 40).astype(np.float32)
    x[1] = 0.0                                   # amax == 0 -> scale 1
    x[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]   # halves round to even
    x[2, 6:] = 0.0
    q, s = K.quantize_rowwise_plain(_t(x))
    jq, js = jqmm.quantize_rowwise(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1] == 1.0
    assert q[2, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("layout", ["row_major", "k_major"])
@pytest.mark.parametrize("m", [1, 3, 16])
def test_quant_matmul_bit_exact_with_jax_kernel(m, layout):
    rng = np.random.RandomState(10 + m)
    k, n = 64, 40
    x = rng.randn(m, k).astype(np.float32)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.rand(n) * 0.05 + 1e-3).astype(np.float32)
    tw = _t(wq)
    if layout == "k_major":        # the layout the CUDA kernel takes
        tw = _t(wq.T).t()
        assert tw.stride() == (1, k) and torch.equal(tw, _t(wq))
    got = K.quant_matmul(_t(x), tw, _t(ws)).numpy()
    np.testing.assert_array_equal(
        got, K.quant_matmul(_t(x), _t(wq), _t(ws)).numpy())
    want = np.asarray(jqmm.quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                        jnp.asarray(ws)))
    # identical inputs: the same int32 sums and the same epilogue
    # acc * (xs * ws), so the same bits
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jqmm.quant_matmul_reference(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))
    # the reference multiplies (acc * xs) * ws: one rounding apart
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_int8_logits_weights_bit_exact_with_jax():
    rng = np.random.RandomState(4)
    vocab, d = 12, 8
    emb = (rng.randn(vocab, d) * 0.3).astype(np.float32)
    emb[3] = 0.0                  # amax == 0 -> scale 1e-8 / 127, wq 0
    emb[5, :2] = [1.27, 0.005]    # 0.005 / 0.01 = 0.5 rounds to even
    wq, scale = ptr.build_int8_logits_weights(_t(emb))
    cfg = jtr.TransformerConfig(vocab_size=vocab, d_model=d)
    g = stf.Graph()
    with g.as_default():
        jwq, jscale, init = jtr.build_int8_logits_weights(
            stf.constant(emb), cfg, scope="t")
        with stf.Session(graph=g) as sess:
            sess.run(stf.global_variables_initializer())
            sess.run(init)
            want_q, want_s = sess.run([jwq, jscale])
    assert wq.dtype == torch.int8 and wq.shape == (d, vocab)
    assert wq.stride() == (1, d)   # K-major, as the kernel reads it
    np.testing.assert_array_equal(wq.numpy(), want_q)
    np.testing.assert_array_equal(scale.numpy(), want_s)


def test_int8_logits_weights_k_major_equal_the_row_major_construction():
    # the K-major build quantizes emb's rows against each vocab entry's
    # scale; the (d, vocab) row-major construction it replaced divided the
    # transposed columns: the same true divisions, so the same bits
    rng = np.random.RandomState(5)
    vocab, d = 40, 24
    emb = (rng.randn(vocab, d) * 0.2).astype(np.float32)
    emb[7] = 0.0
    emb[9, :3] = [2.54, 0.01, -0.03]   # 0.01 / 0.02 = 0.5 rounds to even
    wq, scale = ptr.build_int8_logits_weights(_t(emb))
    w = _t(emb).t()
    want_s = kqmm.div127(
        torch.clamp_min(w.abs().amax(dim=0), 1e-8))
    want_q = torch.round(w / want_s[None, :]).to(torch.int8).contiguous()
    assert wq.stride() == (1, d) and wq.t().is_contiguous()
    assert torch.equal(wq, want_q) and torch.equal(scale, want_s)
    assert scale.is_contiguous()


def test_the_kernel_wants_a_k_major_weight():
    km = torch.zeros(12, 64, dtype=torch.int8).t()     # (64, 12) K-major
    kcommon.check_cuda_arg("wq", km, (torch.int8,), 2, k_major=True)
    with pytest.raises(ValueError, match=r"K-major.*strides \(1, 64\).*"
                                         r"got strides \(12, 1\)"):
        kcommon.check_cuda_arg("wq", km.contiguous(), (torch.int8,), 2,
                               k_major=True)
    with pytest.raises(ValueError, match="contiguous"):
        kcommon.check_cuda_arg("x", km, (torch.int8,), 2)


# ---------------------------------------------------------------------------
# Wrappers, counters and the build
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = K.launch_counts()
    q, k, v, lengths, _ = _attn_inputs(0, 2, 1, 8, 2, 4, False, False)
    K.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    K.layer_norm(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    K.quant_matmul(torch.ones(2, 8), torch.ones(8, 4, dtype=torch.int8),
                   torch.ones(4))
    K.dropout_fwd(torch.ones(2, 8), 0.9, (1, 2))
    K.dropout_fwd(torch.ones(2, 8), 0.9,
                  torch.tensor([1, 2], dtype=torch.int32))
    K.dropout_residual_fwd(torch.ones(2, 8), torch.ones(2, 8), rate=0.1,
                           seed=3)
    K.momentum_update(torch.ones(4), torch.ones(4), torch.ones(4),
                      torch.tensor(0.1), torch.tensor(0.9))
    K.numeric_summary([torch.ones(2, 8), torch.zeros(3)])
    assert K.launch_counts() == before
    assert set(before) == {"decode_attention", "decode_attention_block",
                           "layer_norm", "quant_matmul", "layer_norm_bwd",
                           "flash_attention_fwd", "flash_attention_dkdv",
                           "flash_attention_dq", "softmax_xent_fwd",
                           "softmax_xent_bwd", "adam_update",
                           "momentum_update", "momentum_update_bfloat16",
                           "momentum_update_float32", "dropout_residual",
                           "dropout_residual_bwd", "dropout",
                           "dropout_device_key", "dropout_bwd",
                           "flash_attention_fwd_device_seed",
                           "flash_attention_dkdv_device_seed",
                           "flash_attention_dq_device_seed",
                           "dropout_residual_device_seed",
                           "dropout_residual_bwd_device_seed", "cond_set",
                           "numeric_summary"}


def test_tensors_off_cpu_and_cuda_raise():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="devices"):
        K.layer_norm(x, torch.ones(8), torch.zeros(8))


def test_no_kernel_is_built_at_import(monkeypatch, tmp_path):
    # every module of the port is imported by now; none built the kernels
    assert _build._lib is None
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_key_covers_every_source_and_the_flags():
    srcs = sorted(p.name for p in _build.SRC_DIR.iterdir())
    assert {"decode_attention.cu", "layer_norm.cu", "quant_matmul.cu",
            "flash_attention.cu", "softmax_xent.cu", "fused_update.cu",
            "dropout_residual.cu", "dropout.cu", "flash_fwd_mma.cu",
            "flash_bwd_mma.cu", "common.cuh", "mma.cuh",
            "control_flow.cu", "numeric_summary.cu"} <= set(srcs)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert len(_build._key()) == 16
    assert set(_build.SIGNATURES) == {
        "stf_layer_norm_fwd", "stf_layer_norm_bwd", "stf_decode_attention",
        "stf_quant_matmul", "stf_flash_attention_fwd",
        "stf_flash_attention_dkdv", "stf_flash_attention_dq",
        "stf_softmax_xent_fwd", "stf_softmax_xent_bwd", "stf_adam_update",
        "stf_momentum_update", "stf_dropout_residual", "stf_dropout",
        "stf_dropout_key", "stf_dropout_bwd",
        "stf_flash_attention_fwd_seed_ptr",
        "stf_flash_attention_dkdv_seed_ptr",
        "stf_flash_attention_dq_seed_ptr", "stf_dropout_residual_seed_ptr",
        "stf_cond_set", "stf_cond_node_begin", "stf_capture_to_graph_begin",
        "stf_capture_to_graph_end", "stf_graph_node_count",
        "stf_numeric_summary"}


def test_helpers_match_the_pallas_common_module():
    assert kcommon.NEG_INF == jcommon.NEG_INF
    for a, b in ((1, 8), (8, 8), (9, 8), (257, 128)):
        assert kcommon.round_up(a, b) == jcommon.round_up(a, b)
        assert kcommon.cdiv(a, b) == jcommon.cdiv(a, b)
