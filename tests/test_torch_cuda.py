"""Each CUDA kernel of the PyTorch port against its plain PyTorch version,
on the card. These tests skip without an NVIDIA GPU (all but one CPU test
of a comparison limit itself); they import neither JAX nor the JAX
package, so they run on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

(``--noconftest``: the suite's conftest sets JAX up.) f32 tolerances are
rtol 1e-5, atol 1e-5 (the kernel sums in another order than PyTorch);
bf16 2e-2 (one bf16 rounding of the output); QuantMatMul, Adam and
Momentum are bit-exact. A small bf16 ResNet trainer's first loss
matches the plain trainer's within rtol 1e-5, and its optimizer steps are
the plain Momentum update of its own gradients, bit for bit (its later
losses are not compared: the BatchNorm backward amplifies the xent
kernels' roundoff into gradient differences of per cent). The training kernels' outputs are held to a bound scaled by
the largest reference value: f32 1e-5 for forward values and 1e-4 for
gradients (sums of hundreds to thousands of products), bf16 2e-2; the
xent backward element by element (``_close_elementwise``): f32 1e-5,
bf16 1e-2 (one bf16 rounding of the same f32 value).
"""

import contextlib

import numpy as np
import pytest
import torch

from simple_tensorflow_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kq,causal,biased", [(1, False, False),
                                              (1, False, True),
                                              (16, True, False),
                                              (5, True, True)])
def test_decode_attention_kernel_on_card(cuda, dtype, kq, causal, biased):
    q, k, v, lengths, bias = _attn_inputs(11, 4, kq, 200, 16, 64, causal,
                                          biased)
    args = [_t(a).to(cuda, dtype) for a in (q, k, v)]
    lens = _t(lengths).to(cuda)
    bias_t = None if bias is None else _t(bias).to(cuda)
    before = K.launch_counts()
    out = K.decode_attention(*args, lens, bias=bias_t,
                             causal_offset=causal)
    ref = K.decode_attention_plain(*args, lens, bias=bias_t,
                                   causal_offset=causal)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    name = "decode_attention" if kq == 1 else "decode_attention_block"
    assert K.launch_counts()[name] == before[name] + 1


def _trace_names(fn, reps=3, tries=3):
    """Names of the device kernels ``fn`` launches, from a profiler trace
    (``reps`` calls: a trace can drop a kernel's record), taken again, up
    to ``tries`` times, while it holds no device record at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("L", [256, 200, 17])
@pytest.mark.parametrize("d", [16, 64, 100, 128, 256])
def test_decode_attention_one_query_on_card(cuda, dtype, b, L, d):
    # the Kq = 1 kernel at every decode bucket, ragged cache lengths and
    # head dims whose rows are 1-4 16-byte chunks a lane group, 100 (f32:
    # 25 chunks of 16 bytes; bf16: element by element) and 256 (f32: two
    # chunks a lane); biased at D = 64. One count a call, whatever the
    # split of the cache axis.
    q, k, v, lengths, bias = _attn_inputs(51, b, 1, L, 16, d, False,
                                          d == 64)
    args = [_t(a).to(cuda, dtype) for a in (q, k, v)]
    lens = _t(lengths).to(cuda)
    bias_t = None if bias is None else _t(bias).to(cuda)
    before = K.launch_counts()["decode_attention"]
    out = K.decode_attention(*args, lens, bias=bias_t)
    ref = K.decode_attention_plain(*args, lens, bias=bias_t)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert K.launch_counts()["decode_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("causal", [False, True])
def test_decode_attention_one_query_edge_rows_on_card(cuda, dtype, b,
                                                      causal):
    # a row of length 0 (zeros, or one live position with causal_offset),
    # a row of length 1 (its one value row, or two with causal_offset), a
    # full row; with a bias, which comes before the mask
    q, k, v, lengths, bias = _attn_inputs(53, b, 1, 256, 16, 64, False,
                                          True)
    lengths[:3] = (0, 1, 256)
    args = [_t(a).to(cuda, dtype) for a in (q, k, v)]
    lens = _t(lengths).to(cuda)
    bias_t = _t(bias).to(cuda)
    out = K.decode_attention(*args, lens, bias=bias_t, causal_offset=causal)
    ref = K.decode_attention_plain(*args, lens, bias=bias_t,
                                   causal_offset=causal)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if causal:
        torch.testing.assert_close(out[0], args[2][0, 0], rtol=0, atol=0)
    else:
        assert not out[0].any()
        torch.testing.assert_close(out[1], args[2][1, 0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_one_query_misaligned_on_card(cuda, dtype):
    # q, k and v 2 or 4 bytes past a 16-byte boundary: element-by-element
    # loads
    q, k, v, lengths, _ = _attn_inputs(55, 4, 1, 200, 16, 64, False, False)

    def shifted(a):
        t = _t(a).to(cuda, dtype).flatten()
        return torch.cat([t.new_zeros(1), t])[1:].view(a.shape)

    args = [shifted(a) for a in (q, k, v)]
    assert all(a.data_ptr() % 16 for a in args)
    lens = _t(lengths).to(cuda)
    out = K.decode_attention(*args, lens)
    ref = K.decode_attention_plain(*args, lens)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decode_attention_one_query_split_by_batch_on_card(cuda):
    # B * H blocks below the SM count split the cache axis and merge the
    # splits in a second kernel; at B = 16 (256 blocks) one kernel; the
    # kernels read from a trace
    kda = _kernel_module("decode_attention")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b in (1, 4, 16):
        q, k, v, lengths, _ = _attn_inputs(57, b, 1, 256, 16, 64, False,
                                           False)
        args = [_t(a).to(cuda) for a in (q, k, v)]
        lens = _t(lengths).to(cuda)
        names = _trace_names(lambda: K.decode_attention(*args, lens))
        split = kda.one_split_len(b, 16, 256, sms) < 256
        assert any("decode_one_kernel" in nm for nm in names), names
        assert any("decode_block_combine_kernel" in nm
                   for nm in names) == split, (b, names)
        assert split == (b * 16 < sms)


def _split_l():
    return _kernel_module("decode_attention").SPLIT_L


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["split_edges", "length0_noncausal",
                                  "ragged_L", "prefill_B1", "odd_head_dim"])
def test_decode_attention_block_split_on_card(cuda, dtype, case):
    # the split-K query-block kernel at the chunk edges (lengths SPLIT_L - 1,
    # SPLIT_L, SPLIT_L + 1), a non-causal Kq=4 row of length 0 (zeros), an
    # L that is no multiple of the chunk, the B=1 prefill bucket, and a
    # head_dim that is no multiple of 4 (staged element by element)
    sl = _split_l()
    b, kq, L, d, causal, biased = {
        "split_edges": (3, 16, 256, 64, True, False),
        "length0_noncausal": (3, 4, 256, 64, False, True),
        "ragged_L": (2, 16, 200, 64, True, True),
        "prefill_B1": (1, 16, 256, 64, True, False),
        "odd_head_dim": (2, 5, 77, 50, True, True)}[case]
    q, k, v, lengths, bias = _attn_inputs(31, b, kq, L, 16, d, causal,
                                          biased)
    if case == "split_edges":
        lengths[:] = (sl - 1, sl, sl + 1)
    if case == "length0_noncausal":
        lengths[1] = 0
    args = [_t(a).to(cuda, dtype) for a in (q, k, v)]
    lens = _t(lengths).to(cuda)
    bias_t = None if bias is None else _t(bias).to(cuda)
    before = K.launch_counts()["decode_attention_block"]
    out = K.decode_attention(*args, lens, bias=bias_t, causal_offset=causal)
    ref = K.decode_attention_plain(*args, lens, bias=bias_t,
                                   causal_offset=causal)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert K.launch_counts()["decode_attention_block"] == before + 1
    if case == "length0_noncausal":
        assert not out[1].any()
        assert out[0].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_on_card(cuda, dtype):
    rng = np.random.RandomState(12)
    x = _t(rng.randn(37, 1000).astype(np.float32)).to(cuda, dtype)
    g = _t(rng.randn(1000).astype(np.float32)).to(cuda)
    b = _t(rng.randn(1000).astype(np.float32)).to(cuda)
    out = K.layer_norm(x, g, b)
    ref = K.layer_norm_plain(x, g, b)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [256, 512, 1024, 1000])
@pytest.mark.parametrize("rows", [1, 16, 300, 4096])
def test_layer_norm_fwd_kernel_on_card(cuda, dtype, n, rows):
    # both forward paths (n = 1000 is the general one) with the row
    # statistics the backward reads
    x, g, b, _ = _ln_bwd_inputs(cuda, dtype, rows, n, seed=31)
    y, mean, rstd = K.layer_norm_fwd(x, g, b, return_stats=True)
    ry, rmean, rrstd = K.layer_norm_plain(x, g, b, return_stats=True)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_layer_norm_fwd_picks_its_path_on_card(cuda):
    # the vector path (a warp per row) where vectors_per_lane says so; the
    # general path at other n and on a misaligned view; read from the
    # kernels' names in a trace
    kln = _kernel_module("layer_norm")
    cases = [(torch.bfloat16, 1024, 4, False), (torch.float32, 1024, 8, False),
             (torch.bfloat16, 256, 1, False), (torch.float32, 512, 4, False),
             (torch.bfloat16, 1000, 0, False), (torch.float32, 96, 0, False),
             (torch.bfloat16, 2048, 0, False), (torch.bfloat16, 1024, 0, True),
             (torch.float32, 1024, 0, True), (torch.bfloat16, 768, 3, False),
             (torch.float32, 768, 6, False), (torch.bfloat16, 768, 0, True)]
    for dtype, n, nv, shifted in cases:
        x, g, b, _ = _ln_bwd_inputs(cuda, dtype, 33, n)
        if shifted:  # rows start one element past a 16-byte boundary
            x = torch.cat([x.flatten(), x.new_zeros(1)])[1:].view(33, n)
        assert kln.vectors_per_lane(n, dtype, x, g, b) == nv
        names = _trace_names(lambda: K.layer_norm_fwd(x, g, b))
        vec = any("layer_norm_fwd_vec_kernel" in nm for nm in names)
        gen = any("layer_norm_fwd_kernel<" in nm for nm in names)
        assert (vec, gen) == (nv > 0, nv == 0), (dtype, n, names)
        y, mean, rstd = K.layer_norm_fwd(x, g, b, return_stats=True)
        ry, rmean, rrstd = K.layer_norm_plain(x, g, b, return_stats=True)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


def _qmm_inputs(cuda, dtype, m, k, n, seed=13):
    """x (m, k), a K-major wq (k, n) (the ``.t()`` of a contiguous (n, k)
    int8 tensor) and w_scale (n,) on the card."""
    rng = np.random.RandomState(seed)
    x = _t(rng.randn(m, k).astype(np.float32)).to(cuda, dtype)
    wq = _t(rng.randint(-127, 128, (n, k)).astype(np.int8)).to(cuda).t()
    ws = _t((rng.rand(n) * 0.01).astype(np.float32)).to(cuda)
    return x, wq, ws


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 33, 64])
@pytest.mark.parametrize("k,n", [(1024, 32768), (1020, 4100), (64, 8)])
def test_quant_matmul_kernel_on_card_is_bit_exact(cuda, dtype, m, k, n):
    # k = 1020 takes 4-byte loads, n = 4100 half an 8-column tile
    x, wq, ws = _qmm_inputs(cuda, dtype, m, k, n)
    out = K.quant_matmul(x, wq, ws)
    ref = K.quant_matmul_plain(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16])
def test_quant_matmul_unaligned_weight_on_card(cuda, m):
    # a K-major view 4 bytes into its storage: four 4-byte loads a lane
    x, wq, ws = _qmm_inputs(cuda, torch.float32, m, 1024, 4096, seed=15)
    ref = K.quant_matmul_plain(x, wq, ws)
    buf = torch.empty(4 + wq.numel(), dtype=torch.int8, device=cuda)
    w4 = buf[4:].view(wq.shape[1], wq.shape[0]).t()
    w4.copy_(wq)
    assert w4.data_ptr() % 16 == 4 and w4.stride() == (1, 1024)
    assert torch.equal(K.quant_matmul(x, w4, ws), ref)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_quant_matmul_refuses_a_row_major_weight_on_card(cuda):
    x, wq, ws = _qmm_inputs(cuda, torch.float32, 4, 64, 8)
    with pytest.raises(ValueError, match=r"K-major .*strides \(1, 64\)"):
        K.quant_matmul(x, wq.contiguous(), ws)
    # the plain version takes either layout
    assert torch.equal(K.quant_matmul_plain(x, wq.contiguous(), ws),
                       K.quant_matmul(x, wq, ws))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.ones(4, 10, device=cuda)
    with pytest.raises(ValueError, match="divisible by 4"):
        K.quant_matmul(x, torch.ones(8, 10, dtype=torch.int8,
                                     device=cuda).t(),
                       torch.ones(8, device=cuda))
    x1 = torch.ones(4 * 64 + 1, device=cuda)[1:].view(4, 64)
    with pytest.raises(ValueError, match="4-element"):
        K.quant_matmul(x1, torch.ones(8, 64, dtype=torch.int8,
                                      device=cuda).t(),
                       torch.ones(8, device=cuda))
    with pytest.raises(TypeError):
        K.layer_norm(x.double(), torch.ones(10, device=cuda),
                     torch.zeros(10, device=cuda))


@pytest.mark.cuda
def test_plain_quantizer_divides_exactly_on_card(cuda):
    # the bit-exact contract needs amax / 127 as a true f32 division on
    # the card too (a Python-scalar divisor would take the reciprocal)
    rng = np.random.RandomState(14)
    x = rng.randn(4096, 64).astype(np.float32)
    _, scale = K.quantize_rowwise_plain(_t(x).to(cuda))
    want = np.abs(x).max(axis=1) / np.float32(127.0)
    np.testing.assert_array_equal(scale.cpu().numpy(), want)


def _close(out, ref, tol):
    """max |out - ref| <= tol * max(1, max |ref|)."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    assert err <= tol * scale, (err, tol * scale)


def _close_elementwise(out, ref, tol):
    """|out - ref| <= tol * (|ref| + mean |ref|) at every element: for
    outputs whose values span many orders of magnitude (the xent
    backward), where a bound scaled by the largest value would pass a
    wrong small one."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    bound = tol * (ref.abs() + ref.abs().mean())
    assert bool((diff <= bound).all()), (diff.max().item(),
                                        (diff / bound).max().item())


def _xent_inputs(device, dtype, vocab, rows=64, seed=24):
    rng = np.random.RandomState(seed)
    x = _t((rng.randn(rows, vocab) * 3).astype(np.float32)).to(device, dtype)
    lab = rng.randint(0, vocab, rows).astype(np.int32)
    lab[3] = vocab + 5                  # matches no column, as on the TPU
    labels = _t(lab).to(device)
    g = _t(rng.rand(rows).astype(np.float32)).to(device)
    return x, labels, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_dx_limit_fails_planted_faults(dtype):
    # runs on the CPU: the limit the card test below holds the kernel's dx
    # to must fail a backward that leaves out the smoothing mass low * g
    # of the non-label columns, and (f32) one that scales p by 1.001
    vocab, smoothing = 32768, 0.1
    x, labels, g = _xent_inputs("cpu", dtype, vocab)
    _, lse = K.softmax_xent_fwd_plain(x, labels, smoothing=smoothing)
    rdx = K.softmax_xent_bwd_plain(x, labels, lse, g, smoothing=smoothing)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _close_elementwise(rdx, rdx, tol)
    low = smoothing / (vocab - 1)
    no_low = rdx.float() + low * g[:, None]
    rows = torch.arange(len(labels))
    ok = labels.long() < vocab
    no_low[rows[ok], labels.long()[ok]] -= low * g[ok]
    faults = [no_low]
    if dtype == torch.float32:
        p = torch.exp(x.float() - lse[:, None])
        faults.append(rdx.float() + 1e-3 * p * g[:, None])
    for bad in faults:
        with pytest.raises(AssertionError):
            _close_elementwise(bad.to(dtype), rdx, tol)


def _flash_inputs(cuda, dtype, seed, b, h, sq, sk, d, biased):
    rng = np.random.RandomState(seed)
    q, k, v = (_t(rng.randn(b * h, n, d).astype(np.float32)).to(cuda, dtype)
               for n in (sq, sk, sk))
    do = _t(rng.randn(b * h, sq, d).astype(np.float32)).to(cuda, dtype)
    bias = _t(rng.randn(b, sk).astype(np.float32)).to(cuda) \
        if biased else None
    return q, k, v, do, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d,causal,biased", [
    (256, 256, 64, True, False), (200, 200, 64, True, False),
    (100, 200, 64, False, True), (130, 130, 32, True, True),
    (64, 96, 128, False, False), (40, 40, 16, True, False)])
def test_flash_attention_kernels_on_card(cuda, dtype, sq, sk, d, causal,
                                         biased):
    h = 4
    q, k, v, do, bias = _flash_inputs(cuda, dtype, 21, 2, h, sq, sk, d,
                                      biased)
    args = dict(heads=h, sm_scale=d ** -0.5, causal=causal, bias=bias)
    before = K.launch_counts()
    o, lse = K.flash_attention_fwd(q, k, v, **args)
    ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
    delta = (do.float() * ro.float()).sum(-1)
    dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **args)
    dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
    rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    _close(o, ro, 1e-5 if f32 else 2e-2)
    _close(lse, rlse, 1e-5)
    for out, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(out, ref, 1e-4 if f32 else 2e-2)
    after = K.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_dkdv",
                 "flash_attention_dq"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,biased", [
    (77, 77, True, False), (100, 171, False, True), (130, 130, True, True)])
def test_flash_fwd_bf16_tensor_core_kernel_on_card(cuda, d, sq, sk, causal,
                                                   biased):
    # the bf16 forward on tensor cores at every head_dim the wrapper takes,
    # ragged S (no multiple of the 64-row tile), q_len != kv_len, key bias
    h = 4
    q, k, v, _, bias = _flash_inputs(cuda, torch.bfloat16, 32, 2, h, sq, sk,
                                     d, biased)
    args = dict(heads=h, sm_scale=d ** -0.5, causal=causal, bias=bias)
    before = K.launch_counts()["flash_attention_fwd"]
    o, lse = K.flash_attention_fwd(q, k, v, **args)
    ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
    torch.cuda.synchronize()
    _close(o, ro, 2e-2)
    _close(lse, rlse, 1e-5)
    assert K.launch_counts()["flash_attention_fwd"] == before + 1


def _flash_fwd_keep_mask(cuda, bh, s, causal, seed):
    """The keep mask the bf16 forward applied, read off its output: with
    q = 0 every live score is 0, so p = 1; v is one-hot over a 64-key
    block, so o[:, r, d] is nonzero exactly where key 64 * blk + d of row r
    was live and kept."""
    d = 64
    q = torch.zeros((bh, s, d), device=cuda, dtype=torch.bfloat16)
    k = torch.randn((bh, s, d), device=cuda).to(torch.bfloat16)
    parts = []
    for blk in range(-(-s // d)):
        keys = torch.arange(s, device=cuda)[:, None] - blk * d
        v = (keys == torch.arange(d, device=cuda)[None, :]).to(torch.bfloat16)
        o, _ = K.flash_attention_fwd(
            q, k, v.expand(bh, s, d).contiguous(), heads=1, sm_scale=0.125,
            causal=causal, dropout_rate=0.1, dropout_seed=seed)
        parts.append(o != 0)
    return torch.cat(parts, dim=-1)[..., :s]


@pytest.mark.cuda
@pytest.mark.parametrize("s,causal", [(128, True), (100, True),
                                      (192, False)])
def test_flash_fwd_bf16_dropout_mask_on_card(cuda, s, causal):
    # the tensor-core forward's dropout mask is K0's, bit for bit: 0
    # mismatches; the mask of the next seed differs (a planted fault)
    bh, seed = 6, 424242
    got = _flash_fwd_keep_mask(cuda, bh, s, causal, seed)
    live = torch.ones(s, s, dtype=torch.bool, device=cuda)
    if causal:
        live = live.tril()
    fa = _kernel_module("flash_attention")
    want = fa.keep_mask_plain(bh, s, s, 0.1, seed, cuda) & live
    bad = fa.keep_mask_plain(bh, s, s, 0.1, seed + 1, cuda) & live
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0
    assert int((got != bad).sum()) > 0


@pytest.mark.cuda
def test_flash_fwd_dtype_picks_its_kernel_on_card(cuda):
    # bf16 runs the tensor-core kernel, f32 keeps the CUDA-core kernel (its
    # 1e-5 limit rules out TF32); read from the kernels' names in a trace
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, _ = _flash_inputs(cuda, dtype, 33, 2, 4, 96, 96, 64,
                                      False)
        K.flash_attention_fwd(q, k, v, heads=4, sm_scale=0.125, causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            o, lse = K.flash_attention_fwd(q, k, v, heads=4, sm_scale=0.125,
                                           causal=True)
            torch.cuda.synchronize()
        names[dtype] = [e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA]
        ro, rlse = K.flash_attention_fwd_plain(q, k, v, heads=4,
                                               sm_scale=0.125, causal=True)
        _close(o, ro, 1e-5 if dtype == torch.float32 else 2e-2)
    assert any("flash_fwd_kernel<" in n for n in names[torch.float32])
    assert not any("mma" in n for n in names[torch.float32])
    assert any("flash_fwd_mma_kernel" in n for n in names[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,biased", [
    (77, 77, True, False), (130, 130, True, True), (100, 171, False, True)])
def test_flash_bwd_bf16_tensor_core_kernels_on_card(cuda, rate, d, sq, sk,
                                                    causal, biased):
    # the bf16 dK/dV and dQ on tensor cores at every head_dim the wrapper
    # takes, ragged S (no multiple of the 64-row tile), q_len != kv_len, a
    # key bias, without and with dropout
    h = 4
    q, k, v, do, bias = _flash_inputs(cuda, torch.bfloat16, 34, 2, h, sq, sk,
                                      d, biased)
    args = dict(heads=h, sm_scale=d ** -0.5, causal=causal, bias=bias)
    if rate:
        args.update(dropout_rate=rate, dropout_seed=424242)
    ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
    delta = (do.float() * ro.float()).sum(-1)
    before = K.launch_counts()
    dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
    dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **args)
    rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
    torch.cuda.synchronize()
    for out, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(out, ref, 2e-2)
    after = K.launch_counts()
    for name in ("flash_attention_dkdv", "flash_attention_dq"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
def test_flash_bwd_dtype_picks_its_kernel_on_card(cuda):
    # bf16 runs the tensor-core dK/dV and dQ kernels, f32 keeps the
    # CUDA-core kernels (its 1e-4 limit rules out TF32); read from the
    # kernels' names in a trace
    args = dict(heads=4, sm_scale=0.125, causal=True)
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, _ = _flash_inputs(cuda, dtype, 35, 2, 4, 96, 96, 64,
                                       False)
        ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
        delta = (do.float() * ro.float()).sum(-1)

        def run():
            dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
            return dk, dv, K.flash_attention_dq(q, k, v, do, rlse, delta,
                                                **args)

        # a trace can drop a kernel's record: three calls a trace, and
        # the trace taken again while it holds no device record
        names[dtype] = _trace_names(run)
        outs = run()
        rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta,
                                                **args)
        rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
        for out, ref in zip(outs, (rdk, rdv, rdq)):
            _close(out, ref, 1e-4 if dtype == torch.float32 else 2e-2)
    f32, bf16 = names[torch.float32], names[torch.bfloat16]
    assert any("flash_dkdv_kernel<" in n for n in f32)
    assert any("flash_dq_kernel<" in n for n in f32)
    assert not any("mma" in n for n in f32)
    assert any("flash_bwd_dkdv_mma_kernel" in n for n in bf16)
    assert any("flash_bwd_dq_mma_kernel" in n for n in bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("s,causal", [(128, True), (100, True),
                                      (192, False)])
def test_flash_bwd_bf16_dropout_mask_on_card(cuda, s, causal):
    # the tensor-core backward's dropout mask is K0's, bit for bit, read
    # off each of dV, dK and dQ (keep_mask_readoff): 0 mismatches; the mask
    # of the next seed differs (a planted fault)
    bh, seed, d = 6, 424242, 64
    args = dict(heads=1, sm_scale=0.125, causal=causal, dropout_rate=0.1,
                dropout_seed=seed)

    def bwd(q, k, v, do, lse, delta):
        dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta, **args)
        return dk, dv, K.flash_attention_dq(q, k, v, do, lse, delta, **args)

    fa = _kernel_module("flash_attention")
    live = torch.ones(s, s, dtype=torch.bool, device=cuda)
    if causal:
        live = live.tril()
    want = fa.keep_mask_plain(bh, s, s, 0.1, seed, cuda) & live
    bad = fa.keep_mask_plain(bh, s, s, 0.1, seed + 1, cuda) & live
    for got in fa.keep_mask_readoff(bwd, bh, s, d, torch.bfloat16, cuda):
        torch.cuda.synchronize()
        assert int((got != want).sum()) == 0
        assert int((got != bad).sum()) > 0


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain_on_card(cuda):
    rng = np.random.RandomState(22)
    q, k, v = (_t(rng.randn(2, 4, 77, 64).astype(np.float32)).to(cuda)
               .requires_grad_() for _ in range(3))
    go = _t(rng.randn(2, 4, 77, 64).astype(np.float32)).to(cuda)
    glse = _t(rng.randn(2, 4, 77).astype(np.float32)).to(cuda)
    grads = []
    for plain in (False, True):
        o, lse = K.flash_attention(q, k, v, causal=True, return_lse=True,
                                   plain=plain)
        grads.append(torch.autograd.grad((o * go).sum() + (lse * glse).sum(),
                                         (q, k, v)))
    for a, b in zip(*grads):
        _close(a, b, 1e-4)


def _ln_bwd_inputs(cuda, dtype, rows, n, seed=23):
    rng = np.random.RandomState(seed)
    x = _t((rng.randn(rows, n) * 2 + 0.5).astype(np.float32)).to(cuda, dtype)
    g = _t(rng.randn(n).astype(np.float32)).to(cuda)
    b = _t(rng.randn(n).astype(np.float32)).to(cuda)
    dy = _t(rng.randn(rows, n).astype(np.float32)).to(cuda, dtype)
    return x, g, b, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 300, 4096])
@pytest.mark.parametrize("n", [96, 1000, 1024, 4096])
def test_layer_norm_bwd_kernel_on_card(cuda, dtype, rows, n):
    x, g, b, dy = _ln_bwd_inputs(cuda, dtype, rows, n)
    y, mean, rstd = K.layer_norm_fwd(x, g, b, return_stats=True)
    ry, rmean, rrstd = K.layer_norm_plain(x, g, b, return_stats=True)
    dx, dg, db = K.layer_norm_bwd(x, g, rmean, rrstd, dy)
    rdx, rdg, rdb = K.layer_norm_bwd_plain(x, g, rmean, rrstd, dy)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    _close(mean, rmean, 1e-5)
    _close(rstd, rrstd, 1e-5)
    _close(y, ry, 1e-5 if f32 else 2e-2)
    _close(dx, rdx, 1e-4 if f32 else 2e-2)
    _close(dg, rdg, 1e-4)
    _close(db, rdb, 1e-4)


@pytest.mark.cuda
def test_layer_norm_bwd_picks_its_path_on_card(cuda):
    # the vector path (a warp per row) where n is 32 lanes x 16 bytes x
    # nv; the general path elsewhere and on a misaligned view; read from
    # the kernels' names in a trace
    kln = _kernel_module("layer_norm")
    cases = [(torch.bfloat16, 1024, 4, False), (torch.float32, 1024, 8, False),
             (torch.bfloat16, 512, 2, False), (torch.float32, 128, 1, False),
             (torch.bfloat16, 96, 0, False), (torch.float32, 1000, 0, False),
             (torch.bfloat16, 4096, 0, False), (torch.bfloat16, 1024, 0, True),
             (torch.bfloat16, 768, 3, False), (torch.float32, 768, 6, False),
             (torch.float32, 896, 7, False)]
    for dtype, n, nv, shifted in cases:
        x, g, b, dy = _ln_bwd_inputs(cuda, dtype, 33, n)
        if shifted:  # rows start 2 bytes past a 16-byte boundary
            x = torch.cat([x.flatten(), x.new_zeros(1)])[1:].view(33, n)
        _, mean, rstd = K.layer_norm_plain(x, g, b, return_stats=True)
        assert kln.vectors_per_lane(n, dtype, x, dy, g) == nv
        names = _trace_names(lambda: K.layer_norm_bwd(x, g, mean, rstd, dy))
        dx, dg, db = K.layer_norm_bwd(x, g, mean, rstd, dy)
        vec = any("layer_norm_bwd_vec_kernel" in nm for nm in names)
        gen = any("layer_norm_bwd_kernel<" in nm for nm in names)
        assert (vec, gen) == (nv > 0, nv == 0), (dtype, n, names)
        rdx, rdg, rdb = K.layer_norm_bwd_plain(x, g, mean, rstd, dy)
        _close(dx, rdx, 1e-4 if dtype == torch.float32 else 2e-2)
        _close(dg, rdg, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 1000])
def test_layer_norm_bwd_is_bitwise_reproducible_on_card(cuda, dtype, n):
    # no float atomics: two runs give the same dgamma and dbeta bits, on
    # both paths
    x, g, b, dy = _ln_bwd_inputs(cuda, dtype, 4096, n, seed=29)
    _, mean, rstd = K.layer_norm_plain(x, g, b, return_stats=True)
    first = K.layer_norm_bwd(x, g, mean, rstd, dy)
    second = K.layer_norm_bwd(x, g, mean, rstd, dy)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [16384, 2432])
def test_layer_norm_at_bert_width_on_card(cuda, dtype, rows):
    # BERT-base's LayerNorms: (32 x 512) and (32 x 76) rows of 768, eps
    # 1e-12. n = 768 takes the vector path (bf16 nv 3, f32 nv 6: not a
    # power of two, the means divide by n) forward and backward, held
    # against the plain versions at the tolerances above and against the
    # general path (forced) at the same ones
    kln = _kernel_module("layer_norm")
    x, g, b, dy = _ln_bwd_inputs(cuda, dtype, rows, 768, seed=31)
    f32 = dtype == torch.float32
    assert kln.vectors_per_lane(768, dtype, x, dy, g, b) == (6 if f32 else 3)
    y, mean, rstd = K.layer_norm_fwd(x, g, b, eps=1e-12, return_stats=True)
    ry, rmean, rrstd = K.layer_norm_plain(x, g, b, eps=1e-12,
                                          return_stats=True)
    dx, dg, db = K.layer_norm_bwd(x, g, rmean, rrstd, dy)
    gdx, gdg, gdb = kln.launch_bwd(x, g, rmean, rrstd, dy, 0)
    rdx, rdg, rdb = K.layer_norm_bwd_plain(x, g, rmean, rrstd, dy)
    torch.cuda.synchronize()
    _close(mean, rmean, 1e-5)
    _close(rstd, rrstd, 1e-5)
    _close(y, ry, 1e-5 if f32 else 2e-2)
    for got in (dx, gdx):
        _close(got, rdx, 1e-4 if f32 else 2e-2)
    for got, ref in ((dg, rdg), (db, rdb), (gdg, rdg), (gdb, rdb)):
        _close(got, ref, 1e-4)
    again = K.layer_norm_bwd(x, g, rmean, rrstd, dy)
    torch.cuda.synchronize()
    for a, c in zip((dx, dg, db), again):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab", [32768, 1000])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_xent_kernels_on_card(cuda, dtype, vocab, smoothing):
    x, labels, g = _xent_inputs(cuda, dtype, vocab)
    loss, lse = K.softmax_xent_fwd(x, labels, smoothing=smoothing)
    rloss, rlse = K.softmax_xent_fwd_plain(x, labels, smoothing=smoothing)
    dx = K.softmax_xent_bwd(x, labels, rlse, g, smoothing=smoothing)
    rdx = K.softmax_xent_bwd_plain(x, labels, rlse, g, smoothing=smoothing)
    torch.cuda.synchronize()
    _close(loss, rloss, 1e-5)
    _close(lse, rlse, 1e-5)
    _close_elementwise(dx, rdx, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_kernel_on_card_is_bit_exact(cuda, dtype):
    rng = np.random.RandomState(25)
    n = 1000003
    p = _t(rng.randn(n).astype(np.float32)).to(cuda, dtype)
    m = _t((rng.randn(n) * 0.1).astype(np.float32)).to(cuda)
    v = _t(rng.rand(n).astype(np.float32) * 0.01).to(cuda)
    g = _t((rng.randn(n) * 0.1).astype(np.float32)).to(cuda, dtype)
    alpha = torch.tensor(1e-3, device=cuda)
    kw = dict(beta1=0.9, beta2=0.997, eps=1e-9)
    pk, mk, vk = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha,
                               **kw)
    pp, mp, vp = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g,
                                     alpha, **kw)
    torch.cuda.synchronize()
    assert torch.equal(mk, mp) and torch.equal(vk, vp)
    assert torch.equal(pk, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_momentum_kernel_on_card_is_bit_exact(cuda, dtype, nesterov):
    rng = np.random.RandomState(26)
    n = 1000003
    p = _t(rng.randn(n).astype(np.float32)).to(cuda, dtype)
    acc = _t((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)  # mu is read
    g = _t((rng.randn(n) * 0.1).astype(np.float32)).to(cuda, dtype)
    lr, mu = torch.tensor(0.1, device=cuda), torch.tensor(0.9, device=cuda)
    before = K.launch_counts()["momentum_update"]
    pk, ak = K.momentum_update(p.clone(), acc.clone(), g, lr, mu,
                               use_nesterov=nesterov)
    pp, ap = K.momentum_update_plain(p.clone(), acc.clone(), g, lr, mu,
                                     use_nesterov=nesterov)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap) and torch.equal(pk, pp)
    assert K.launch_counts()["momentum_update"] == before + 1
    # the other Nesterov setting is another function
    po, _ = K.momentum_update_plain(p.clone(), acc.clone(), g, lr, mu,
                                    use_nesterov=not nesterov)
    assert not torch.equal(pk, po)


@pytest.mark.cuda
def test_resnet_trainer_steps_match_plain_on_card(cuda):
    # the first loss through the xent kernel matches the plain trainer's;
    # each optimizer step is the plain Momentum update of the trainer's
    # own gradient, bit for bit (the second step reads mu)
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import resnet

    images, labels = resnet.synthetic_imagenet(8, 64)
    labels = labels % 10
    params = convert.init_resnet_params(0, num_classes=10)
    kw = dict(batch_size=8, image_size=64, num_classes=10,
              dtype=torch.bfloat16, params=params, device=cuda)
    plain = resnet.resnet50_trainer(plain=True, **kw)
    trainer = resnet.resnet50_trainer(**kw)
    lp = plain.step(images, labels).item()
    before = K.launch_counts()
    opt = trainer.optimizer
    lr, mu = opt._learning_rate(), opt.mu
    for step in range(2):
        loss = trainer.loss_and_grads(images, labels).item()
        if step == 0:
            np.testing.assert_allclose(loss, lp, rtol=1e-5)
        want = [K.momentum_update_plain(grp.p.clone(), grp.momentum.clone(),
                                        grp.g, lr, mu)
                for grp in opt.flat_groups]
        opt.step()
        for grp, (p, acc) in zip(opt.flat_groups, want):
            assert torch.equal(grp.p, p) and torch.equal(grp.momentum, acc)
    counts = K.launch_counts()
    assert counts["momentum_update"] - before["momentum_update"] == 4
    assert counts["softmax_xent_bwd"] - before["softmax_xent_bwd"] == 2


# ---------------------------------------------------------------------------
# dropout: the fused dropout-residual kernel (K4), the threefry Dropout
# kernel and flash attention's dropout branch. The masks are integer
# functions of the seed or key, so K4 and Dropout are bit-exact with their
# plain versions; a planted fault (another salt, key or seed) must fail.
# ---------------------------------------------------------------------------

def _kernel_module(name):
    import importlib
    return importlib.import_module(
        f"simple_tensorflow_tpu_torch.ops.kernels.{name}")


def _k4_inputs(cuda, dtype, rows, n, biased, seed=26):
    rng = np.random.RandomState(seed)
    x, res = (_t(rng.randn(rows, n).astype(np.float32)).to(cuda, dtype)
              for _ in range(2))
    bias = _t(rng.randn(n).astype(np.float32)).to(cuda, dtype) \
        if biased else None
    return x, res, bias


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["picked", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("rows,n", [(300, 8), (300, 96), (37, 1000),
                                    (300, 1000), (4096, 1024)])
def test_dropout_residual_kernel_on_card_is_bit_exact(cuda, path, dtype,
                                                      biased, rows, n):
    # the forward and dx on the path vectors_per_lane picks (the vector
    # path at 300 and 4096 rows, the general one at 37) and forced onto the
    # general path
    dr = _kernel_module("dropout_residual")
    x, res, bias = _k4_inputs(cuda, dtype, rows, n, biased)
    kw = dict(rate=0.1, seed=918273)
    want = dr.dropout_residual_fwd_plain(x, res, bias, **kw)
    want_dx = dr.dropout_residual_bwd_plain(x, **kw)
    before = K.launch_counts()
    if path == "picked":
        assert (dr.vectors_per_lane(rows, n, dtype, x, res, *(
            [bias] if biased else [])) > 0) == (rows >= dr.VEC_MIN_ROWS)
        out = dr.dropout_residual_fwd(x, res, bias, **kw)
        dx = dr.dropout_residual_bwd(x, **kw)
    else:
        out = dr.launch("dropout_residual", x, res, bias, 0.1, 918273, 0)
        dx = dr.launch("dropout_residual_bwd", x, None, None, 0.1, 918273,
                       0)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(dx, want_dx)
    after = K.launch_counts()
    for name in ("dropout_residual", "dropout_residual_bwd"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [4, 0])
def test_dropout_residual_mask_fault_is_caught_on_card(cuda, nv):
    # x = ones: the output is the mask; 0 mismatches with K0's mask on
    # both paths, and the mask of salt 1 differs
    dr = _kernel_module("dropout_residual")
    ones = torch.ones(4096, 1024, device=cuda, dtype=torch.bfloat16)
    zeros = torch.zeros_like(ones)
    out = dr.launch("dropout_residual", ones, zeros, None, 0.1, 5, nv)
    dx = dr.launch("dropout_residual_bwd", ones, None, None, 0.1, 5, nv)
    rr = torch.arange(4096, device=cuda)[:, None]
    cc = torch.arange(1024, device=cuda)[None, :]
    salt1 = K.common.counter_keep_mask_plain(5, 1, rr, cc, 0.9)
    keep = dr.keep_mask_plain(4096, 1024, 5, 0.9, cuda)
    for got in (out, dx):
        assert int(((got != 0) != keep).sum()) == 0
        assert int(((got != 0) != salt1).sum()) > 0


@pytest.mark.cuda
def test_dropout_residual_picks_its_path_on_card(cuda):
    # the vector path (a warp per row) where vectors_per_lane says so; the
    # general path at odd n, past 1024 values, below VEC_MIN_ROWS rows
    # and on a misaligned view; read from the kernels' names in a trace
    dr = _kernel_module("dropout_residual")
    bf16, f32, rows = torch.bfloat16, torch.float32, dr.VEC_MIN_ROWS
    cases = [(bf16, rows, 1024, 4, False), (f32, rows, 1024, 8, False),
             (bf16, rows, 96, 2, False), (f32, 4096, 1000, 8, False),
             (bf16, rows, 1001, 0, False), (bf16, rows, 4096, 0, False),
             (bf16, 37, 1024, 0, False), (bf16, rows, 1024, 0, True),
             (f32, rows, 96, 0, True)]
    for dtype, m, n, nv, shifted in cases:
        x, res, _ = _k4_inputs(cuda, dtype, m, n, False)
        if shifted:  # rows start one element past a 16-byte boundary
            x = torch.cat([x.flatten(), x.new_zeros(1)])[1:].view(m, n)
        assert dr.vectors_per_lane(m, n, dtype, x, res) == nv
        names = _trace_names(lambda: dr.dropout_residual_fwd(
            x, res, rate=0.1, seed=3))
        vec = any("dropout_residual_vec_kernel" in nm for nm in names)
        gen = any("dropout_residual_kernel<" in nm for nm in names)
        assert (vec, gen) == (nv > 0, nv == 0), (dtype, m, n, names)
        assert torch.equal(dr.dropout_residual_fwd(x, res, rate=0.1, seed=3),
                           dr.dropout_residual_fwd_plain(x, res, rate=0.1,
                                                         seed=3))


@pytest.mark.cuda
def test_dropout_residual_refuses_a_forced_vector_path_off_alignment(cuda):
    dr = _kernel_module("dropout_residual")
    x, res, _ = _k4_inputs(cuda, torch.bfloat16, 4, 1024, False)
    shifted = torch.cat([x.flatten(), x.new_zeros(1)])[1:].view(4, 1024)
    with pytest.raises(RuntimeError, match="cudaError"):
        dr.launch("dropout_residual", shifted, res, None, 0.1, 3, 4)
    with pytest.raises(RuntimeError, match="cudaError"):
        dr.launch("dropout_residual", x, res, None, 0.1, 3, 2)  # too few
    # a count no shipped width of the dtype takes is not built
    for dtype, nv in ((torch.bfloat16, 8), (torch.float32, 2),
                      (torch.float32, 1)):
        xd, rd, _ = _k4_inputs(cuda, dtype, 4, 64, False)
        with pytest.raises(RuntimeError, match="cudaError"):
            dr.launch("dropout_residual", xd, rd, None, 0.1, 3, nv)


DROPOUT_KEY = (123456789, 987654321)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (4096,), (70001,),
                                   (16, 256, 1024), (16, 256, 4096),
                                   (3, 77, 33)])
def test_dropout_kernel_on_card_is_bit_exact(cuda, dtype, shape):
    # the forward's values and bits, and the backward from those bits, bit
    # for bit with the plain versions; one count a call each
    do = _kernel_module("dropout")
    rng = np.random.RandomState(29)
    x, g = (_t(rng.randn(*shape).astype(np.float32)).to(cuda, dtype)
            for _ in range(2))
    keep = do.keep_mask_plain(shape, 0.9, DROPOUT_KEY, cuda)
    before = K.launch_counts()
    out, bits = do.dropout_fwd(x, 0.9, DROPOUT_KEY, return_bits=True)
    dx = do.dropout_bwd(g, 0.9, bits)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["dropout"] == before["dropout"] + 1
    assert after["dropout_bwd"] == before["dropout_bwd"] + 1
    assert torch.equal(out, do.dropout_plain(x, 0.9, DROPOUT_KEY))
    assert torch.equal(bits, do.pack_keep_bits_plain(keep))
    assert torch.equal(dx, do.dropout_plain(g, 0.9, DROPOUT_KEY))
    assert torch.equal(dx, do.dropout_bwd_bits_plain(g, bits, 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4096, 70001])
def test_dropout_general_path_on_card_is_bit_exact(cuda, dtype, n):
    # a view 2 (bf16) or 4 (f32) bytes past a 16-byte boundary takes the
    # general path, read from the kernels' names; and the general path
    # forced at an aligned n gives the vector path's values and bits
    do = _kernel_module("dropout")
    rng = np.random.RandomState(30)
    buf = _t(rng.randn(n + 1).astype(np.float32)).to(cuda, dtype)
    x = buf[1:]
    assert not do.vector_path(n, x)
    names = _trace_names(lambda: do.dropout_fwd(x, 0.9, DROPOUT_KEY))
    assert any("dropout_kernel<" in nm for nm in names), names
    assert not any("dropout_vec_kernel" in nm for nm in names), names
    out, bits = do.dropout_fwd(x, 0.9, DROPOUT_KEY, return_bits=True)
    assert torch.equal(out, do.dropout_plain(x, 0.9, DROPOUT_KEY))
    assert torch.equal(bits, do.pack_keep_bits_plain(
        do.keep_mask_plain((n,), 0.9, DROPOUT_KEY, cuda)))
    names = _trace_names(lambda: do.dropout_bwd(x, 0.9, bits))
    assert any("dropout_bwd_kernel<" in nm for nm in names), names
    assert torch.equal(do.dropout_bwd(x, 0.9, bits),
                       do.dropout_bwd_bits_plain(x, bits, 0.9))
    if n % 8 == 0:
        y = buf[:n]
        vec_out, vec_bits = do.launch_fwd(y, 0.9, DROPOUT_KEY, True)
        gen_out, gen_bits = do.launch_fwd(y, 0.9, DROPOUT_KEY, False)
        assert torch.equal(vec_out, gen_out)
        assert torch.equal(vec_bits, gen_bits)
        assert torch.equal(do.launch_bwd(y, vec_bits, 0.9, True),
                           do.launch_bwd(y, vec_bits, 0.9, False))


@pytest.mark.cuda
def test_dropout_next_key_fault_is_caught_on_card(cuda):
    # x = ones: the output is the mask scaled; 0 mismatches with the plain
    # mask, and the plain output and bits of the key's second word plus
    # one differ
    do = _kernel_module("dropout")
    ones = torch.ones((16, 256, 1024), device=cuda, dtype=torch.bfloat16)
    other = (DROPOUT_KEY[0], DROPOUT_KEY[1] + 1)
    out, bits = do.dropout_fwd(ones, 0.9, DROPOUT_KEY, return_bits=True)
    assert int((out != do.dropout_plain(ones, 0.9, DROPOUT_KEY)).sum()) == 0
    assert int((out != do.dropout_plain(ones, 0.9, other)).sum()) > 0
    bad = do.pack_keep_bits_plain(do.keep_mask_plain(ones.shape, 0.9, other,
                                                     cuda))
    assert int((bits != bad).sum()) > 0
    dx = do.dropout_bwd(ones, 0.9, bits)
    assert int((dx != do.dropout_plain(ones, 0.9, other)).sum()) > 0
    assert int((dx != out).sum()) == 0


@pytest.mark.cuda
def test_dropout_refuses_a_forced_vector_path_off_alignment(cuda):
    do = _kernel_module("dropout")
    buf = torch.zeros(4097, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError"):
        do.launch_fwd(buf[1:], 0.9, DROPOUT_KEY, True)
    with pytest.raises(RuntimeError, match="cudaError"):
        do.launch_fwd(buf[:4095], 0.9, DROPOUT_KEY, True)   # n % 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal,biased", [
    (256, 256, True, False), (200, 200, True, False),
    (100, 200, False, True)])
def test_flash_attention_dropout_kernels_on_card(cuda, dtype, sq, sk, causal,
                                                 biased):
    h, d = 4, 64
    q, k, v, do, bias = _flash_inputs(cuda, dtype, 27, 2, h, sq, sk, d,
                                      biased)
    args = dict(heads=h, sm_scale=d ** -0.5, causal=causal, bias=bias,
                dropout_rate=0.1, dropout_seed=424242)
    o, lse = K.flash_attention_fwd(q, k, v, **args)
    ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
    delta = (do.float() * ro.float()).sum(-1)
    dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **args)
    dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
    rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    _close(o, ro, 1e-5 if f32 else 2e-2)
    _close(lse, rlse, 1e-5)
    for out, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(out, ref, 1e-4 if f32 else 2e-2)
    # a planted fault: the plain version under seed + 1 fails each limit
    bad = dict(args, dropout_seed=424243)
    bo, _ = K.flash_attention_fwd_plain(q, k, v, **bad)
    bdk, bdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **bad)
    bdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **bad)
    for out, ref, tol in ((o, bo, 1e-5 if f32 else 2e-2),
                          (dk, bdk, 1e-4 if f32 else 2e-2),
                          (dv, bdv, 1e-4 if f32 else 2e-2),
                          (dq, bdq, 1e-4 if f32 else 2e-2)):
        with pytest.raises(AssertionError):
            _close(out, ref, tol)


@pytest.mark.cuda
def test_dropout_trainer_step_matches_plain_on_card(cuda):
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig.tiny()
    cfg.dropout = 0.1
    tok = np.random.RandomState(28).randint(2, cfg.vocab_size, (2, 32))
    runs = []
    for plain in (False, True):
        t = clm.causal_lm_trainer(batch_size=2, seq_len=32, cfg=cfg,
                                  compute_dtype=torch.float32,
                                  warmup_steps=4, device="cuda",
                                  plain=plain)
        K.reset_launch_counts()
        loss = t.loss_and_grads(tok, tok).item()
        runs.append((t, loss, K.launch_counts()))
    (tk, lk, ck), (tp, lp, cp) = runs
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    assert not any(cp.values())
    want = {"dropout": 3, "dropout_bwd": 3, "dropout_residual": 2,
            "dropout_residual_bwd": 2, "flash_attention_fwd": 2}
    assert {k: ck[k] for k in want} == want
    grads_p = dict(tp.stack.named_parameters())
    for name, pk in tk.stack.named_parameters():
        if name.endswith("self_attn.k.bias"):
            continue
        gk, gp = pk.grad.float(), grads_p[name].grad.float()
        assert ((gk - gp).norm() / gp.norm()).item() <= 1e-4, name


SESSION_PER_STEP = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                    "adam_update": 1, "dropout": 1, "dropout_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_session_trains_the_convnet_through_the_kernels(cuda, dtype):
    """``models/mnist.py``'s convnet through ``stf.Session()`` (the card by
    default): every step launches the xent forward and backward, one Adam
    and the Dropout forward and backward once; under
    ``fused_ops.plain_versions()`` none, with the first loss within rtol
    1e-5 (f32) or 2e-2 (bf16) of the kernels' run."""
    import contextlib

    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import mnist
    from simple_tensorflow_tpu_torch.ops import fused_ops

    x, labels, _ = mnist.synthetic_mnist(16, seed=0)
    runs = []
    for plain in (False, True):
        g = stf.Graph()
        with g.as_default():
            m = mnist.convnet_model(dtype=getattr(stf, dtype))
            init = stf.global_variables_initializer()
        with stf.Session(graph=g) as s:
            assert s.device.type == "cuda"
            s.run(init)
            feeds = {m["x"]: x.reshape(-1, 28, 28, 1), m["y_"]: labels,
                     m["keep_prob"]: 0.5}
            with (fused_ops.plain_versions() if plain
                  else contextlib.nullcontext()):
                K.reset_launch_counts()
                losses = [float(s.run([m["train_op"], m["loss"]],
                                      feeds)[1]) for _ in range(2)]
                counts = K.launch_counts()
            assert int(s.run(m["global_step"])) == 2
        runs.append((losses, counts))
    (lk, ck), (lp, cp) = runs
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert abs(lk[0] - lp[0]) <= tol * abs(lp[0])
    assert all(np.isfinite(lk + lp))
    assert not any(cp.values())
    # step 1 runs eagerly (the launch-argument Dropout entry), step 2 is
    # captured and replayed (the device-key entry)
    want = {k: 2 * SESSION_PER_STEP.get(k, 0) for k in ck}
    want.update(dropout=1, dropout_device_key=1)
    assert ck == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7,), (512, 1024), (16, 256, 4096)])
def test_dropout_device_key_entry_on_card_is_bit_exact(cuda, dtype, shape):
    # the forward with its key read through a device pointer: the values
    # and bits of the launch-argument entry and of the plain version on
    # the same key tensor; one dropout_device_key count a call; another
    # key in the same buffer gives another mask
    do = _kernel_module("dropout")
    x = _t(np.random.RandomState(31).randn(*shape).astype(
        np.float32)).to(cuda, dtype)
    key_t = torch.tensor(np.array(DROPOUT_KEY, np.uint32).view(np.int32),
                         device=cuda)
    want, want_bits = do.dropout_fwd(x, 0.9, DROPOUT_KEY, return_bits=True)
    before = K.launch_counts()
    out, bits = do.dropout_fwd(x, 0.9, key_t, return_bits=True)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["dropout_device_key"] == before["dropout_device_key"] + 1
    assert after["dropout"] == before["dropout"]
    assert torch.equal(out, want) and torch.equal(bits, want_bits)
    assert torch.equal(out, do.dropout_plain(x, 0.9, key_t))
    key_t[1] += 1
    if x.numel() > 64:
        assert not torch.equal(do.dropout_fwd(x, 0.9, key_t), want)


@pytest.mark.cuda
def test_session_graph_replays_match_eager_steps_on_card(cuda):
    # a Session that captures its step: 4 steps (warm-up, capture, two
    # replays) bit-identical to the same steps dispatched eagerly; one
    # capture; a store load makes the next run a warm-up and the one
    # after a second capture
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import mnist

    x, labels, _ = mnist.synthetic_mnist(32, seed=0)
    g = stf.Graph()
    with g.as_default():
        m = mnist.convnet_model()
        init = stf.global_variables_initializer()
    feeds = {m["x"]: x.reshape(-1, 28, 28, 1), m["y_"]: labels,
             m["keep_prob"]: 0.5}
    fetch = [m["train_op"], m["loss"], "convnet/dropout:0"]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for capture in (True, False):
            with stf.Session(graph=g) as s:
                s._capture = capture
                s.run(init)
                out = [s.run(fetch, feeds) for _ in range(4)]
                w = s.run("convnet/fc2/bias:0")
                convert.load_session_variables(
                    s, {"convnet/fc2/bias": w + 0.5})
                out += [s.run(fetch, feeds) for _ in range(3)]
                runs.append((out, {k: v.cpu().numpy().copy() for k, v in
                                   s._variable_store.values.items()},
                             s.captures))
    finally:
        torch.backends.cudnn.deterministic = prev
    (og, sg, cg), (oe, se, ce) = runs
    assert cg == 2 and ce == 0
    for a, b in zip(og, oe):
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
    for k in se:
        np.testing.assert_array_equal(sg[k], se[k], err_msg=k)


@pytest.mark.cuda
def test_execution_plan_compile_then_execute_on_card(cuda):
    # ExecutionPlan.compile captures ahead of traffic (a dry warm-up:
    # nothing committed, no run counter consumed); every execute after it
    # replays, bit-identical to eager steps from the same initializer run
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import mnist

    x, labels, _ = mnist.synthetic_mnist(32, seed=0)
    g = stf.Graph()
    with g.as_default():
        m = mnist.convnet_model()
        init = stf.global_variables_initializer()
    feeds = {m["x"]: x.reshape(-1, 28, 28, 1), m["y_"]: labels,
             m["keep_prob"]: 0.5}
    fetch = [m["train_op"], m["loss"], "convnet/dropout:0"]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with stf.Session(graph=g) as s:
            s.run(init)
            counter = s._run_counter
            plan = s.plan(fetch, feeds=list(feeds))
            exe = plan.compile(
                feed_shapes={m["x"]: (32, 28, 28, 1), m["y_"]: (32,)},
                feed_dict={m["keep_prob"]: 0.5})
            assert s._run_counter == counter and s.captures == 1
            assert exe.launches["dropout_device_key"] == 1
            got = [plan.execute(feeds) for _ in range(3)]
            assert s.captures == 1 and len(plan.compiled_buckets()) == 1
        with stf.Session(graph=g) as s:
            s._capture = False
            s.run(init)
            want = [s.run(fetch, feeds) for _ in range(3)]
    finally:
        torch.backends.cudnn.deterministic = prev
    for a, b in zip(got, want):
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.cuda
def test_serving_bucket_graphs_match_eager_on_card(cuda):
    # the paged model with aot_warmup on and off at a small width: the
    # same tokens and bit-identical log-probs through prefill and decode
    # at every bucket, partial buckets included
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig.tiny()
    params = convert.init_params(cfg, seed=0)
    rng = np.random.RandomState(5)
    chunks = rng.randint(2, cfg.vocab_size, (6, 4)).astype(np.int32)
    got = []
    for aot in (True, False):
        model = clm.CausalLMGenerativeModel(
            cfg, page_len=4, pages_per_seq=4, num_pages=16, max_live=4,
            prefill_bucket_sizes=[1, 4], params=params, aot_warmup=aot)
        tables = np.full((4, 4), model.scratch_page, np.int32)
        tables[:, :3] = np.arange(12).reshape(4, 3)
        model.prefill_chunk(chunks[:4], np.zeros(4, np.int32), tables,
                            tables[:, 0])
        pos = np.full(4, 4, np.int32)
        last = chunks[:4, -1].copy()
        out = []
        for rows in (4, 1, 3, 4, 2):
            tok, lp, _ = model.decode(last[:rows], pos[:rows],
                                      tables[:rows])
            out.append((tok, lp))
            last[:rows], pos[:rows] = tok, pos[:rows] + 1
        model.close()
        got.append(out)
    for (ta, la), (tb, lb) in zip(*got):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


SEED = 1234567


def _seed_tensor(cuda, seed=SEED):
    # a row of a seed buffer: the int32 bits of the seed on the card
    return torch.tensor([seed], dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal,biased", [
    (64, 64, True, False), (64, 64, False, True), (64, 96, False, True),
    (200, 130, False, True)])
def test_flash_seed_pointer_entries_match_launch_argument_on_card(
        cuda, dtype, sq, sk, causal, biased):
    # the three flash kernels with the seed read through a device pointer:
    # bit-identical to the launch-argument entry; one *_device_seed count
    # each and no launch-argument count; another seed in the buffer draws
    # another mask
    h, d = 4, 64
    q, k, v, do, bias = _flash_inputs(cuda, dtype, 41, 2, h, sq, sk, d,
                                      biased)
    base = dict(heads=h, sm_scale=d ** -0.5, causal=causal, bias=bias,
                dropout_rate=0.1)
    outs = []
    for seed in (SEED, _seed_tensor(cuda)):
        args = dict(base, dropout_seed=seed)
        before = K.launch_counts()
        o, lse = K.flash_attention_fwd(q, k, v, **args)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta, **args)
        dq = K.flash_attention_dq(q, k, v, do, lse, delta, **args)
        torch.cuda.synchronize()
        after = K.launch_counts()
        suffix = "_device_seed" if isinstance(seed, torch.Tensor) else ""
        for name in ("fwd", "dkdv", "dq"):
            name = f"flash_attention_{name}"
            assert after[name + suffix] == before[name + suffix] + 1
            other = name if suffix else name + "_device_seed"
            assert after[other] == before[other]
        outs.append((o, lse, dk, dv, dq))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    o2, _ = K.flash_attention_fwd(q, k, v, **dict(
        base, dropout_seed=_seed_tensor(cuda, SEED + 1)))
    assert not torch.equal(o2, outs[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n,biased", [(4096, 1024, False),
                                           (37, 1000, True)])
def test_dropout_residual_seed_pointer_entry_matches_on_card(
        cuda, dtype, rows, n, biased):
    # K4 and its dx with the seed read through a device pointer: bit for
    # bit the launch-argument entry, on the vector and the general path;
    # counted as dropout_residual(_bwd)_device_seed
    dr = _kernel_module("dropout_residual")
    x, res, bias = _k4_inputs(cuda, dtype, rows, n, biased)
    want = dr.dropout_residual_fwd(x, res, bias, rate=0.1, seed=SEED)
    want_dx = dr.dropout_residual_bwd(x, rate=0.1, seed=SEED)
    before = K.launch_counts()
    out = dr.dropout_residual_fwd(x, res, bias, rate=0.1,
                                  seed=_seed_tensor(cuda))
    dx = dr.dropout_residual_bwd(x, rate=0.1, seed=_seed_tensor(cuda))
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("dropout_residual", "dropout_residual_bwd"):
        assert after[name + "_device_seed"] == \
            before[name + "_device_seed"] + 1
        assert after[name] == before[name]
    assert torch.equal(out, want) and torch.equal(dx, want_dx)
    assert torch.equal(out, dr.dropout_residual_fwd_plain(
        x, res, bias, rate=0.1, seed=_seed_tensor(cuda)))
    assert not torch.equal(dr.dropout_residual_fwd(
        x, res, bias, rate=0.1, seed=_seed_tensor(cuda, SEED + 1)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(64, 96), (96, 64), (64, 64)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_non_causal_pad_bias_at_sq_ne_sk_on_card(cuda, dtype, sq, sk,
                                                       rate):
    # the transformer's encoder and cross-attention case: non-causal, the
    # (B, kv_len) pad bias (-1e9 on the last keys of one row, as
    # _pad_bias builds it), Sq != Sk; forward and both backward kernels
    # against the plain versions
    h, d = 4, 64
    q, k, v, do, _ = _flash_inputs(cuda, dtype, 43, 2, h, sq, sk, d, False)
    bias = torch.zeros(2, sk, device=cuda)
    bias[1, -7:] = -1e9
    args = dict(heads=h, sm_scale=d ** -0.5, causal=False, bias=bias,
                dropout_rate=rate, dropout_seed=SEED if rate else None)
    o, lse = K.flash_attention_fwd(q, k, v, **args)
    ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
    delta = (do.float() * ro.float()).sum(-1)
    dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **args)
    dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
    rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    _close(o, ro, 1e-5 if f32 else 2e-2)
    _close(lse, rlse, 1e-5)
    for out, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(out, ref, 1e-4 if f32 else 2e-2)
    # the padded keys take no probability, so no dK/dV
    pad = slice(h, 2 * h)
    assert float(dk[pad, -7:].abs().max()) == 0.0
    assert float(dv[pad, -7:].abs().max()) == 0.0


@pytest.mark.cuda
def test_transformer_session_graph_replays_match_eager_on_card(cuda):
    # a tiny transformer_train_model (bf16, dropout 0.1, pads in src and
    # tgt) through stf.Session: 4 steps captured (warm-up, capture, two
    # replays) bit-identical to 4 eager steps, losses and every variable
    # and Adam slot; the replays launch the seed-pointer entries; replays
    # with the seed buffer left unfilled differ
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                               d_ff=128, num_layers=2, dropout=0.1,
                               max_len=32)
    b = tr.synthetic_wmt_batch(4, 16, 16, vocab_size=64, seed=0)
    b["src_ids"][0, -3:] = 0
    b["tgt_in"][1, -2:] = 0
    b["tgt_out"][1, -3:] = 0
    g = stf.Graph()
    with g.as_default():
        m = tr.transformer_train_model(4, 16, 16, cfg=cfg, warmup_steps=4)
        init = stf.global_variables_initializer()
    feeds = {m[k]: b[k] for k in ("src_ids", "tgt_in", "tgt_out")}
    fetch = [m["loss"], m["train_op"]]
    runs = []
    for capture, refresh in ((True, True), (False, True), (True, False)):
        with stf.Session(graph=g) as s:
            s._capture = capture
            s._refresh_seeds = refresh
            s.run(init)
            before = K.launch_counts()
            losses = [s.run(fetch, feeds)[0] for _ in range(4)]
            after = K.launch_counts()
            state = {k: v.float().cpu().numpy()
                     for k, v in s._variable_store.values.items()}
            runs.append((losses, state, s.captures, {
                k: after[k] - before[k] for k in after}))
    (lg, sg, cg, ng), (le, se, ce, ne), (lf, _, _, _) = runs
    assert cg == 1 and ce == 0
    assert lg == le
    for k in se:
        np.testing.assert_array_equal(sg[k], se[k], err_msg=k)
    # 2 layers x (enc self, dec self, cross) flash and K4 ops a step; the
    # warm-up (step 1) passes its seeds as launch arguments, the replays
    # (steps 2-4) read theirs on the device
    assert ng["flash_attention_fwd"] == 6 and ng["dropout_residual"] == 6
    for name in ("flash_attention_fwd", "flash_attention_dkdv",
                 "flash_attention_dq", "dropout_residual",
                 "dropout_residual_bwd"):
        assert ng[name + "_device_seed"] == 3 * 6, name
        assert ne[name + "_device_seed"] == 0 and ne[name] == 4 * 6, name
    assert lf[0] == le[0] and all(a != b for a, b in zip(lf[1:], le[1:]))


@pytest.mark.cuda
def test_mixed_embedding_gradient_is_deterministic_on_card(cuda):
    # the bf16 lookup's f32 gradient table, with many repeated ids, is the
    # same bit for bit on every run (a captured step is held bit for bit
    # against eager dispatch) and equal to the CPU's sum within f32 order
    from simple_tensorflow_tpu_torch.ops.embedding_ops import embedding_lookup

    rng = np.random.RandomState(5)
    table = _t(rng.randn(512, 1024).astype(np.float32))
    ids = _t(rng.randint(0, 40, (64, 64)).astype(np.int64))
    g = _t(rng.randn(64, 64, 1024).astype(np.float32)).to(torch.bfloat16)

    def grad(dev):
        t = table.to(dev).requires_grad_()
        out = embedding_lookup(t, ids.to(dev), compute_dtype=torch.bfloat16)
        return torch.autograd.grad(out, t, g.to(dev))[0]

    runs = [grad(cuda) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    torch.testing.assert_close(runs[0].cpu(), grad("cpu"), rtol=1e-5,
                               atol=1e-4)


def _momentum_graph(stf, nesterov):
    """Two groups (bf16 and f32 variables) under a quadratic loss, one
    graph MomentumOptimizer step a run."""
    rng = np.random.RandomState(9)
    g = stf.Graph()
    with g.as_default():
        a = stf.Variable(stf.cast(stf.constant(rng.randn(300, 257).astype(
            np.float32)), stf.bfloat16), name="a")
        b = stf.Variable(stf.constant(rng.randn(1001).astype(np.float32)),
                         name="b")
        loss = (stf.reduce_sum(stf.cast(a._ref, stf.float32) ** 2.0)
                + stf.reduce_sum(b._ref ** 3.0))
        opt = stf.train.MomentumOptimizer(0.01, 0.9, use_nesterov=nesterov)
        train = opt.minimize(loss)
        init = stf.global_variables_initializer()
    return g, init, [train, loss]


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
def test_graph_momentum_launches_k5_and_equals_plain_on_card(cuda,
                                                             nesterov):
    # the graph FusedMomentumUpdate through stf.Session (warm-up, capture,
    # replays): one K5 launch per group a step, and every variable and
    # flat slot bit for bit those of the same Session under
    # plain_versions() (the plain Momentum update on the card)
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.ops import fused_ops

    g, init, fetch = _momentum_graph(stf, nesterov)
    runs = []
    for plain in (False, True):
        with stf.Session(graph=g) as s:
            s.run(init)
            before = K.launch_counts()
            with (fused_ops.plain_versions() if plain
                  else contextlib.nullcontext()):
                losses = [s.run(fetch)[1] for _ in range(4)]
            after = K.launch_counts()
            n = {k: after[k] - before[k] for k in (
                "momentum_update", "momentum_update_bfloat16",
                "momentum_update_float32")}
            runs.append((losses, {k: v.float().cpu().numpy() for k, v in
                                  s._variable_store.values.items()}, n,
                         s.captures))
    (lk, sk, nk, ck), (lp, sp, np_, _) = runs
    assert nk == {"momentum_update": 2 * 4, "momentum_update_bfloat16": 4,
                  "momentum_update_float32": 4}
    assert not any(np_.values()) and ck == 1
    assert lk == lp
    assert any("fused_momentum_g1" in k for k in sk)
    for k in sp:
        np.testing.assert_array_equal(sk[k], sp[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_flash_seed_pointer_entries_under_a_capture_on_card(cuda,
                                                                   dtype):
    # the causal flash kernels captured in a CUDA graph through their
    # seed-pointer entries: each replay reads the seed the buffer holds
    # then, bit-identical to the launch-argument entries with that seed
    h, s, d = 4, 256, 64
    q, k, v, do, _ = _flash_inputs(cuda, dtype, 47, 2, h, s, s, d, False)
    base = dict(heads=h, sm_scale=d ** -0.5, causal=True, bias=None,
                dropout_rate=0.1)

    def step(seed):
        o, lse = K.flash_attention_fwd(q, k, v, dropout_seed=seed, **base)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta,
                                        dropout_seed=seed, **base)
        dq = K.flash_attention_dq(q, k, v, do, lse, delta,
                                  dropout_seed=seed, **base)
        return o, lse, dk, dv, dq

    buf = _seed_tensor(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(buf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step(buf)
    for seed in (SEED, SEED + 1, 77):
        buf.fill_(seed)
        graph.replay()
        want = step(seed)
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
    assert not torch.equal(outs[0], step(SEED)[0])


@pytest.mark.cuda
def test_causal_lm_session_graph_replays_match_eager_on_card(cuda):
    # a tiny causal_lm_train_model (bf16, dropout 0.1, pads in tok_out)
    # through stf.Session: 4 steps captured bit-identical to 4 eager steps,
    # losses and every variable and Adam slot; the replays launch the
    # causal flash and K4 seed-pointer entries
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    cfg = clm.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                                d_ff=128, num_layers=2, dropout=0.1,
                                max_len=32)
    rng = np.random.RandomState(0)
    tok = rng.randint(2, 64, (4, 17)).astype(np.int32)
    tok_out = tok[:, 1:].copy()
    tok_out[1, -3:] = 0
    g = stf.Graph()
    with g.as_default():
        m = clm.causal_lm_train_model(4, 16, cfg=cfg, warmup_steps=4)
        init = stf.global_variables_initializer()
    feeds = {m["tok_in"]: tok[:, :-1], m["tok_out"]: tok_out}
    runs = []
    for capture in (True, False):
        with stf.Session(graph=g) as s:
            s._capture = capture
            s.run(init)
            before = K.launch_counts()
            losses = [s.run([m["loss"], m["train_op"]], feeds)[0]
                      for _ in range(4)]
            after = K.launch_counts()
            runs.append((losses, {k: v.float().cpu().numpy() for k, v in
                                  s._variable_store.values.items()},
                         s.captures, {k: after[k] - before[k]
                                      for k in after}))
    (lg, sg, cg, ng), (le, se, ce, ne) = runs
    assert cg == 1 and ce == 0 and lg == le
    for k in se:
        np.testing.assert_array_equal(sg[k], se[k], err_msg=k)
    for name in ("flash_attention_fwd", "flash_attention_dkdv",
                 "flash_attention_dq", "dropout_residual",
                 "dropout_residual_bwd"):
        assert ng[name] == 2 and ng[name + "_device_seed"] == 3 * 2, name
        assert ne[name] == 4 * 2, name
    assert ng["dropout_device_key"] == 3 * 3
    assert ng["adam_update"] == ne["adam_update"] == 4 * 2


@pytest.mark.cuda
def test_resnet_session_graph_replays_match_eager_on_card(cuda):
    # a small resnet50_train_model (bf16, 4 x 64^2, 10 classes) through
    # stf.Session with cuDNN's deterministic algorithms (its weight
    # gradients may otherwise sum with atomics): 4 steps captured
    # bit-identical to 4 eager steps; two K5 launches a step (the bf16
    # convolution kernels, the f32 BatchNorm and fc variables); the moving
    # statistics untouched
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import resnet

    images, labels = resnet.synthetic_imagenet(4, 64)
    g = stf.Graph()
    with g.as_default():
        m = resnet.resnet50_train_model(batch_size=4, image_size=64,
                                        num_classes=10)
        init = stf.global_variables_initializer()
    feeds = {m["images"]: images, m["labels"]: labels % 10}
    runs = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for capture in (True, False):
            with stf.Session(graph=g) as s:
                s._capture = capture
                s.run(init)
                before = K.launch_counts()
                losses = [s.run([m["loss"], m["train_op"]], feeds)[0]
                          for _ in range(4)]
                after = K.launch_counts()
                runs.append((losses, {k: v.float().cpu().numpy() for k, v
                                      in s._variable_store.values.items()},
                             s.captures,
                             {k: after[k] - before[k] for k in (
                                 "momentum_update",
                                 "momentum_update_bfloat16",
                                 "momentum_update_float32")}))
    finally:
        torch.backends.cudnn.deterministic = prev
    (lg, sg, cg, ng), (le, se, ce, ne) = runs
    assert cg == 1 and ce == 0 and lg == le
    assert ng == ne == {"momentum_update": 2 * 4,
                        "momentum_update_bfloat16": 4,
                        "momentum_update_float32": 4}
    for k in se:
        np.testing.assert_array_equal(sg[k], se[k], err_msg=k)
        if k.endswith("moving_mean"):
            assert not se[k].any(), k


@pytest.mark.cuda
@pytest.mark.parametrize("refresh", [True, False])
def test_run_steps_window_equals_sequential_runs_on_card(cuda, refresh):
    # Session.run_steps on the MNIST convnet (keep_prob 0.5 fed alike at
    # every step, a batch a step through stacked_feeds): two windows of 4
    # replays of the captured step, "stacked" then "last", bit-identical
    # to 8 sequential runs (losses, fc1's Dropout output, every variable
    # and slot); the window is compiled ahead, so its 8 steps are 8
    # replays (the device-key Dropout entry 8 times; the launch-argument
    # one once, the dry warm-up); no fallback. With the key buffer not
    # refilled between replays (_refresh_keys off) the windows' later
    # steps draw stale masks and differ.
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import mnist

    n, windows = 4, 2
    x, labels, _ = mnist.synthetic_mnist(32 * n * windows, seed=0)
    x = x.reshape(n * windows, 32, 28, 28, 1)
    labels = labels.reshape(n * windows, 32)
    g = stf.Graph()
    with g.as_default():
        m = mnist.convnet_model()
        init = stf.global_variables_initializer()
    fetch = [m["train_op"], m["loss"], "convnet/dropout:0"]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with stf.Session(graph=g) as s:
            s.run(init)
            seq = [s.run(fetch, {m["x"]: x[i], m["y_"]: labels[i],
                                 m["keep_prob"]: 0.5})
                   for i in range(n * windows)]
            want = {k: v.float().cpu().numpy() for k, v in
                    s._variable_store.values.items()}
        with stf.Session(graph=g) as s:
            s.run(init)
            s._refresh_keys = refresh
            K.reset_launch_counts()
            got = []
            for w, mode in enumerate(("stacked", "last")):
                rows = slice(w * n, (w + 1) * n)
                got.append(s.run_steps(
                    fetch, n, feed_dict={m["keep_prob"]: 0.5},
                    stacked_feeds={m["x"]: x[rows], m["y_"]: labels[rows]},
                    output_mode=mode))
            counts = K.launch_counts()
            state = {k: v.float().cpu().numpy() for k, v in
                     s._variable_store.values.items()}
            fallbacks, fused = s.loop_fusion_fallbacks, s.fused_steps
    finally:
        torch.backends.cudnn.deterministic = prev
    assert fallbacks == {} and fused == n * windows
    stacked, last = got
    same = [float(stacked[1][i]) == float(seq[i][1]) and
            np.array_equal(stacked[2][i], seq[i][2]) for i in range(n)]
    same.append(float(last[1]) == float(seq[-1][1]) and
                np.array_equal(last[2], seq[-1][2]))
    same_state = all(np.array_equal(state[k], want[k]) for k in want)
    if refresh:
        assert all(same) and same_state
        assert counts["dropout_device_key"] == n * windows
        # two plans ("stacked" and "last" share the fetches: one plan), one
        # dry warm-up through the launch-argument entry
        assert counts["dropout"] == 1
        assert counts["adam_update"] == n * windows + 1
    else:
        assert same[0] and not any(same[1:n]) and not same_state


@pytest.mark.cuda
def test_saver_round_trip_on_card(cuda, tmp_path):
    # train.Saver on a captured Session: a save reads the store only (its
    # version stays, the next run replays), a restore into the live
    # session copies into the store's tensors (addresses stay; no
    # re-capture) and brings back every variable, the flat Adam slots and
    # the RNG run counter bit for bit; a fresh session restores the same
    # values; a flipped payload byte raises DataLossError
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.framework import errors
    from simple_tensorflow_tpu_torch.models import mnist

    x, labels, _ = mnist.synthetic_mnist(32, seed=0)
    g = stf.Graph()
    with g.as_default():
        m = mnist.convnet_model(dtype=stf.bfloat16)
        init = stf.global_variables_initializer()
        saver = stf.train.Saver(max_to_keep=2)
    feeds = {m["x"]: x.reshape(-1, 28, 28, 1), m["y_"]: labels,
             m["keep_prob"]: 0.5}
    fetch = [m["train_op"], m["loss"]]

    def state(s):
        return {k: v.float().cpu().numpy()
                for k, v in s._variable_store.values.items()}

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with stf.Session(graph=g) as s:
            s.run(init)
            for _ in range(3):
                s.run(fetch, feeds)
            version, captures = s._variable_store.version, s.captures
            ptrs = {k: v.data_ptr() for k, v in s._variable_store.values.items()}
            prefix = saver.save(s, str(tmp_path / "model.ckpt"),
                                global_step=m["global_step"])
            assert prefix.endswith("model.ckpt-3")
            assert s._variable_store.version == version
            saved, counter = state(s), s._run_counter
            after_save = s.run(fetch, feeds)[1]
            assert s.captures == captures
            saver.restore(s, prefix)
            assert s._variable_store.version == version
            assert {k: v.data_ptr() for k, v in
                    s._variable_store.values.items()} == ptrs
            restored = state(s)
            assert s._run_counter == counter
            assert float(s.run(fetch, feeds)[1]) == float(after_save)
            assert s.captures == captures
    finally:
        torch.backends.cudnn.deterministic = prev
    assert set(restored) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    with stf.Session(graph=g) as s2:
        saver.restore(s2, prefix)
        fresh = state(s2)
        assert s2._run_counter == counter
    for k in saved:
        np.testing.assert_array_equal(fresh[k], saved[k], err_msg=k)
    bad = str(tmp_path / "bad")
    for suffix in (".stfz", ".index.json"):
        (tmp_path / ("bad" + suffix)).write_bytes(
            (tmp_path / ("model.ckpt-3" + suffix)).read_bytes())
    raw = bytearray((tmp_path / "bad.stfz").read_bytes())
    raw[len(raw) // 2] ^= 0x01
    (tmp_path / "bad.stfz").write_bytes(bytes(raw))
    with stf.Session(graph=g) as s3:
        with pytest.raises(errors.DataLossError, match="checksum"):
            saver.restore(s3, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab", [(700, 10000), (768, 120)])
def test_softmax_xent_at_the_rnn_shapes_on_card(cuda, rows, vocab):
    # PTB medium's logits (20 x 35 rows of its 10000 words) and seq2seq's
    # (64 x 12 of 120) in f32; seq2seq hands the wrapper [B, T, V] logits
    # with [B, T] labels, which it runs as rows
    from simple_tensorflow_tpu_torch.ops.kernels.softmax_xent import (
        softmax_cross_entropy)

    x, labels, g = _xent_inputs(cuda, torch.float32, vocab, rows=rows)
    loss, lse = K.softmax_xent_fwd(x, labels)
    rloss, rlse = K.softmax_xent_fwd_plain(x, labels)
    dx = K.softmax_xent_bwd(x, labels, rlse, g)
    rdx = K.softmax_xent_bwd_plain(x, labels, rlse, g)
    torch.cuda.synchronize()
    _close(loss, rloss, 1e-5)
    _close(lse, rlse, 1e-5)
    _close_elementwise(dx, rdx, 1e-5)
    b = 64 if rows == 768 else 20
    x3 = x.reshape(b, rows // b, vocab).detach().requires_grad_()
    lab3 = labels.reshape(b, rows // b)
    before = K.launch_counts()
    out = softmax_cross_entropy(x3, lab3)
    (gk,) = torch.autograd.grad(out, x3, g.reshape(out.shape))
    counts = K.launch_counts()
    assert counts["softmax_xent_fwd"] - before["softmax_xent_fwd"] == 1
    assert counts["softmax_xent_bwd"] - before["softmax_xent_bwd"] == 1
    ref = softmax_cross_entropy(x3, lab3, plain=True)
    (gp,) = torch.autograd.grad(ref, x3, g.reshape(out.shape))
    assert out.shape == (b, rows // b)
    _close(out, ref, 1e-5)
    _close_elementwise(gk, gp, 1e-5)


def _scan_session(stf, capture, steps=4, dropout=True):
    """A graph whose ``Scan`` body (``steps`` steps over (20, 650) rows)
    runs a seeded Dropout at keep_prob 0.5 on its carry and a product
    with a captured variable, and the gradient of a loss through it, in
    a Session on the card: ``(fetches, session)``."""
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(3)
        w = stf.get_variable("w", [650, 650], initializer=(
            stf.random_uniform_initializer(-0.05, 0.05, seed=1)))
        xs = stf.constant(np.random.RandomState(0).randn(
            steps, 20, 650).astype(np.float32))

        def body(c, x):
            h = stf.tanh(stf.matmul(c, w) + x)
            return stf.nn.dropout(h, keep_prob=0.5, seed=11) \
                if dropout else h

        first = stf.nn.dropout(stf.ones([20, 650]), keep_prob=0.5, seed=11)
        hs = stf.scan(body, xs, initializer=first * 0.0)
        masks = stf.scan(lambda c, x: stf.nn.dropout(
            stf.ones_like(x), keep_prob=0.5, seed=11), xs,
            initializer=first)
        loss = stf.reduce_sum(hs * hs)
        grad = stf.gradients(loss, [w])[0]
        init = stf.global_variables_initializer()
    s = stf.Session(graph=g)
    s._capture = capture
    s.run(init)
    return [hs, masks, grad, loss], s


@pytest.mark.cuda
def test_a_scan_body_dropout_under_a_capture_on_card(cuda):
    # a seeded Dropout in a Scan body at (20, 650): a captured step draws
    # it through the device-key entry from its row of the key buffer,
    # the same mask at every step of a run and the eager step's mask
    import simple_tensorflow_tpu_torch as stf

    outs = {}
    for capture in (False, True):
        fetch, s = _scan_session(stf, capture)
        K.reset_launch_counts()
        outs[capture] = [s.run(fetch) for _ in range(4)]
        counts = K.launch_counts()
        assert s.captures == (1 if capture else 0)
        s.close()
        # each run: 4 + 4 body Dropouts and the outer one; 4 backwards
        assert counts["dropout_bwd"] == 4 * 4
        if capture:
            assert counts["dropout"] == 9
            assert counts["dropout_device_key"] == 9 * 3
        else:
            assert counts["dropout"] == 9 * 4
    for (h0, m0, g0, l0), (h1, m1, g1, l1) in zip(outs[False], outs[True]):
        assert l0 == l1
        np.testing.assert_array_equal(h0, h1)
        np.testing.assert_array_equal(m0, m1)
        np.testing.assert_array_equal(g0, g1)
        kept = m1 != 0
        assert 0.45 < kept.mean() < 0.55
        for t in range(1, 4):
            np.testing.assert_array_equal(kept[t], kept[0])
    # the next run draws another mask
    assert not np.array_equal(outs[True][1][1], outs[True][2][1])


@pytest.mark.cuda
def test_a_captured_scan_gradient_equals_eager_on_card(cuda):
    # a 2-step Scan without randomness: the captured step's gradient of a
    # captured variable equals the eager step's bit for bit
    import simple_tensorflow_tpu_torch as stf

    outs = {}
    for capture in (False, True):
        fetch, s = _scan_session(stf, capture, steps=2, dropout=False)
        outs[capture] = [s.run([fetch[0], fetch[2]]) for _ in range(3)]
        assert s.captures == (1 if capture else 0)
        s.close()
    for (h0, g0), (h1, g1) in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(h0, h1)
        np.testing.assert_array_equal(g0, g1)
        assert np.abs(g1).max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,biased", [(1, False), (32, False),
                                           (64, False), (64, True)])
def test_decode_attention_at_the_beam_shapes_on_card(cuda, dtype, length,
                                                     biased):
    # beam search at batch 4 x beam 4: B = 16, L = 64, 16 heads of 64;
    # self-attention at lengths i + 1, cross-attention over the padded
    # source with the pad bias
    rng = np.random.RandomState(length)
    q = _t(rng.randn(16, 16, 64).astype(np.float32)).to(cuda, dtype)
    k = _t(rng.randn(16, 64, 16, 64).astype(np.float32)).to(cuda, dtype)
    v = _t(rng.randn(16, 64, 16, 64).astype(np.float32)).to(cuda, dtype)
    lens = torch.full((16,), length, dtype=torch.int32, device=cuda)
    bias = None
    if biased:
        b = np.zeros((16, 64), np.float32)
        b[:, -9:] = -1e9
        bias = _t(b).to(cuda)
    before = K.launch_counts()["decode_attention"]
    out = K.decode_attention(q, k, v, lens, bias=bias)
    ref = K.decode_attention_plain(q, k, v, lens, bias=bias)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert K.launch_counts()["decode_attention"] == before + 1


def _control_flow_graph(stf):
    """A data-dependent loop (doubling through a tanh layer until the
    squared sum passes 400), a cond whose untaken branch is NaN, and the
    gradients of a bounded loop whose body is NaN past its exit."""
    x = stf.placeholder(stf.float32, [8], name="x")
    w = stf.get_variable("w", [8, 8], initializer=stf.constant_initializer(
        np.eye(8, dtype=np.float32) * 1.5))
    i, v = stf.while_loop(
        lambda i, v: stf.less(stf.reduce_sum(v * v), 400.0),
        lambda i, v: (i + 1, stf.reshape(stf.tanh(stf.matmul(
            stf.reshape(v, [1, 8]), w)), [8]) * 2.0 + v),
        [stf.constant(0), x])
    s = stf.reduce_sum(x)
    # each branch is NaN where it is not taken
    c = stf.cond(stf.greater(s, 0.0), lambda: stf.sqrt(s),
                 lambda: stf.sqrt(-s) * 2.0)
    _, a = stf.while_loop(lambda j, a: stf.greater(a, 1.0),
                          lambda j, a: (j + 1, stf.sqrt(a - 1.0)),
                          [stf.constant(0), s * s + 1.5],
                          maximum_iterations=6)
    g = stf.gradients(a + c, [x])[0]
    return [i, v, c, a, g]


@pytest.mark.cuda
def test_a_captured_while_and_cond_equal_eager_on_card(cuda):
    # values and the gradient of a bounded loop: captured replays (WHILE
    # and IF conditional nodes, guarded steps) equal the eager runs bit
    # for bit; a replay reads no predicate on the host; the setter's
    # launches settle to one a node and one a WHILE body run
    import simple_tensorflow_tpu_torch as stf

    rng = np.random.RandomState(0)
    feeds = [rng.randn(8).astype(np.float32) * s for s in (0.1, 1.0, -3.0,
                                                           0.02)]
    outs = {}
    for capture in (False, True):
        g = stf.Graph()
        with g.as_default():
            fetch = _control_flow_graph(stf)
            s = stf.Session()
            s._capture = capture
            s.run(stf.global_variables_initializer())
            x = g.get_tensor_by_name("x:0")
            s.run(fetch, {x: feeds[0]})       # warm-up
            s.host_predicate_reads = 0
            K.reset_launch_counts()
            outs[capture] = [s.run(fetch, {x: f}) for f in feeds]
            counts = K.launch_counts()
            if capture:
                assert s.captures == 1 and s.host_predicate_reads == 0
                assert counts["cond_set"] > 0
            else:
                assert s.host_predicate_reads > 0
            s.close()
    for eager, cap in zip(outs[False], outs[True]):
        for a, b in zip(eager, cap):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len({int(o[0]) for o in outs[True]}) > 1   # trip counts differ
    assert all(np.isfinite(np.asarray(v)).all() for o in outs[True]
               for v in o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_search_captured_equals_eager_on_card(cuda, dtype):
    # tiny width, batch 2 x beam 3, decode_len 8, padded source: the
    # captured naive and cached searches equal their eager runs bit for
    # bit, and every DecodeAttention of the cached loop is counted
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig.tiny()
    src_ids = tr.synthetic_wmt_batch(2, 8, 8, vocab_size=cfg.vocab_size)[
        "src_ids"].copy()
    src_ids[:, -2:] = cfg.pad_id
    outs = {}
    for capture in (False, True):
        g = stf.Graph()
        with g.as_default():
            stf.set_random_seed(3)
            src = stf.placeholder(stf.int32, [2, 8], "src")
            dt = getattr(stf, dtype)
            fetch = [tr.beam_search_decode(src, cfg, beam_size=3,
                                           decode_len=8, compute_dtype=dt,
                                           use_cache=c)
                     for c in (False, True)]
            s = stf.Session()
            s._capture = capture
            s.run(stf.global_variables_initializer())
            s.run(fetch[1], {src: src_ids})
            K.reset_launch_counts()
            outs[capture] = [s.run(fetch, {src: src_ids}) for _ in range(3)]
            counts = K.launch_counts()
            # 2 layers x (self + cross) a step, 7 steps a search
            assert counts["decode_attention"] == 3 * 2 * 2 * 7
            assert s.captures == (1 if capture else 0)
            s.close()
    for eager, cap in zip(outs[False], outs[True]):
        for (ei, es), (ci, cs) in zip(eager, cap):
            np.testing.assert_array_equal(ei, ci)
            np.testing.assert_array_equal(es, cs)
    naive, cached = outs[True][0]
    assert (cached[0][:, :, 0] == cfg.eos_id).all()
    assert np.isfinite(cached[1]).all()
    if dtype == "float32":
        np.testing.assert_array_equal(naive[0], cached[0])
        np.testing.assert_allclose(naive[1], cached[1], atol=1e-4)


# -- the input pipeline's device staging --------------------------------------

def _delayed_copies(monkeypatch, cycles):
    """Queue ``cycles`` of GPU sleep on the pipeline's side stream before
    each element's copies, so a copy runs well after the host issued it."""
    from simple_tensorflow_tpu_torch.data import staging

    orig = staging.to_device

    def slow(x, device, stream):
        if stream is not None:
            with staging._cuda_lock(device), torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
        return orig(x, device, stream)

    monkeypatch.setattr(staging, "to_device", slow)


def _batches(n=12, rows=64):
    rng = np.random.RandomState(7)
    return [{"a": rng.randint(-2**30, 2**30, (rows, 33)).astype(np.int32),
             "b": rng.randn(rows, 7).astype(np.float32)} for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("arena", [None, False])
def test_prefetch_to_device_orders_the_consumer_after_its_copy(cuda,
                                                               monkeypatch,
                                                               arena):
    import simple_tensorflow_tpu_torch as stf

    _delayed_copies(monkeypatch, 2_000_000)
    batches = _batches()
    # arena_staging: pinned slots (the default) or pageable copies
    ds = stf.data.Dataset.from_generator(lambda: iter(batches)) \
        .prefetch_to_device(2, arena_staging=arena)
    # the consumer reads each batch at once on its own stream: only the
    # wait on the copy's event orders it after the delayed copy
    sums = [(x["a"].double().sum(), x["b"].double().sum(), x["a"].is_cuda)
            for x in ds]
    assert len(sums) == len(batches)
    for (sa, sb, on_card), w in zip(sums, batches):
        assert on_card
        assert sa.item() == w["a"].astype(np.float64).sum()
        np.testing.assert_allclose(sb.item(), w["b"].astype(np.float64)
                                   .sum(), rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("wait", [True, False])
def test_pinned_slots_wait_for_their_copies(cuda, monkeypatch, wait):
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.data import staging

    # ~10 ms of GPU sleep before each copy: the host assembles the next
    # slots' batches long before the queued copies read theirs
    _delayed_copies(monkeypatch, 20_000_000)
    orig_init = staging.PinnedPool.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        self.wait_copies = wait   # False: the planted fault

    monkeypatch.setattr(staging.PinnedPool, "__init__", init)
    rows = [{k: v[i] for k, v in b.items()}
            for b in _batches(16, 4) for i in range(4)]
    ds = stf.data.Dataset.from_generator(lambda: iter(rows)).batch(4) \
        .prefetch_to_device(2)
    got = list(ds)   # no sync: the host runs ahead of the delayed copies
    torch.cuda.synchronize()
    want = list(stf.data.Dataset.from_generator(lambda: iter(rows)).batch(4))
    same = [all(np.array_equal(g[k].cpu().numpy(), w[k]) for k in w)
            for g, w in zip(got, want)]
    if wait:
        assert all(same)
    else:
        assert not all(same)


@pytest.mark.cuda
def test_staged_input_copies_a_card_value_on_the_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from simple_tensorflow_tpu_torch.compiler import aot

    buf = aot.StagedInput((256, 64), torch.int32, cuda)
    host_before = buf._host.clone()
    value = torch.arange(256 * 64, dtype=torch.int64,
                         device=cuda).reshape(256, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(50_000_000)     # tens of ms of queued work
        buf.stage(value)
        # stage returned with the sleep still queued: no host sync
        assert not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not any("HtoD" in n for n in names)
    assert torch.equal(buf.static, value.int())
    assert torch.equal(buf._host, host_before)   # staging untouched


def _summary_taps(dev, sizes, dtypes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n, dt in zip(sizes, dtypes):
        x = torch.randn(n, device=dev, generator=g) * 3
        if n >= 16:
            idx = torch.randperm(n, device=dev, generator=g)
            x[idx[:3]] = float("nan")
            x[idx[3:5]] = float("inf")
            x[idx[5:6]] = -float("inf")
            x[idx[6:16]] = 0
        out.append(x.to(dt))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 7, 130])
def test_numeric_summary_kernel_matches_plain_on_card(cuda, count):
    """Counts and max_abs exact, l2 and zero fraction within rtol 1e-6 (a
    sum in another order), the same bits at every launch, one launch a
    128 taps."""
    from simple_tensorflow_tpu_torch.ops.kernels import common
    import importlib

    ns = importlib.import_module(
        "simple_tensorflow_tpu_torch.ops.kernels.numeric_summary")
    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    sizes = [1 + (i * 7919) % 300000 for i in range(count)]
    taps = _summary_taps(cuda, sizes, [dtypes[i % 3] for i in range(count)],
                         count)
    taps.append(torch.empty(0, device=cuda))
    before = common.launch_counts()["numeric_summary"]
    out = K.numeric_summary(taps)
    again = K.numeric_summary(taps)
    ref = ns.numeric_summary_plain(taps)
    torch.cuda.synchronize()
    assert common.launch_counts()["numeric_summary"] - before == \
        2 * -(-len(taps) // ns.MAX_TAPS_PER_LAUNCH)
    assert torch.equal(out, again)
    assert torch.equal(out[:, :2], ref[:, :2])
    torch.testing.assert_close(out[:, 2:], ref[:, 2:], rtol=1e-6, atol=0)
    assert torch.equal(out[-1], torch.zeros(4, device=cuda))


@pytest.mark.cuda
def test_numeric_summary_kernel_in_a_cuda_graph(cuda):
    taps = _summary_taps(cuda, [5000, 123457],
                         [torch.bfloat16, torch.float32], 3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = K.numeric_summary(taps)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.numeric_summary(taps)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    taps[1].mul_(2)          # a replay reads the tensors as they are
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[1, :2], (eager[1, :2] * torch.tensor(
        [1.0, 2.0], device=cuda)))


@pytest.mark.cuda
def test_async_snapshot_reaches_the_host_through_the_bounce_buffers(
        cuda, monkeypatch):
    """A barrier snapshot's copy to the host, chunk by chunk through the
    two pinned buffers (a chunk of 1000 bytes here: several chunks a
    buffer, a buffer's last chunk partly filled), equals a plain copy of
    every entry, views of a flat group included."""
    from simple_tensorflow_tpu_torch.checkpoint import snapshot

    monkeypatch.setattr(snapshot, "D2H_CHUNK", 1000)
    g = torch.Generator(device=cuda).manual_seed(0)
    flat = torch.randn(5003, device=cuda, generator=g)
    values = {"a": flat[:3000].view(30, 100), "b": flat[3000:],
              "c": torch.randn(7, 9, device=cuda,
                               generator=g).to(torch.bfloat16).t(),
              "d": torch.arange(333, device=cuda),
              "e": torch.rand(50, device=cuda, generator=g) > 0.5,
              "f": torch.empty(0, device=cuda)}
    copies = snapshot.device_copies(values, [flat])
    assert len(copies.bases) == 5
    snap = snapshot.TrainingStateSnapshot(
        copies, {k: k for k in values}, {}, {})
    arrays = snap.materialize()
    for k, v in values.items():
        want = snapshot.host_array(v)
        assert arrays[k].shape == want.shape and arrays[k].dtype == want.dtype
        assert arrays[k].tobytes() == want.tobytes(), k
    snap.release_device_state()
