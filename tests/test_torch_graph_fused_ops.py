"""Each op type the transformer graph adds to the port, built by the same
user code in both packages and run through each package's ``Session`` on
the CPU: forward values and gradients against the JAX package's (in the
style of ``tests/test_op_conformance.py``, with the JAX Session as the
oracle).

One graph per package holds every case, so the JAX Session compiles once;
each case has placeholders of its own (fed the same values), and the
gradients are one ``stf.gradients`` of the sum of every case's weighted
output over every case's float inputs, so each input's gradient is its
own case's. Float inputs are fed as f32 numpy
and cast in the graph where a case runs in bf16. Tolerances: f32 values
rtol/atol 1e-5, gradients 1e-4 by norm (sums in another order); the bf16
cases 1e-2 (one bf16 rounding of the output). Integer and boolean
outputs are exact; ``RandomStandardNormal`` within 3 ulp of JAX's (the
two ``log1p`` round differently; most values are bit-equal), and the
dropout ops draw the same masks from the same seeds (the graph seed is
set). The cases cover ``Minimum``, ``NotEqual``, ``Pow``, ``TrueDiv``,
``Transpose``, ``Gather``, ``EmbeddingLookupMixed``,
``RandomStandardNormal``, ``FlashAttention`` and ``FlashAttentionDropout``
(causal or not, with or without the key bias, Sq != Sk),
``FusedLayerNorm``, ``FusedSoftmaxXent`` and ``FusedDropoutBiasResidual``.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu_torch.framework import dtypes as pdtypes

PKGS = {"jax": jstf, "port": pstf}
SEED = 7


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    pad = np.zeros((2, 12), np.float32)
    pad[1, -4:] = -1e9
    return {
        "a": f(3, 5), "b": f(3, 5), "pa": np.abs(f(3, 5)) + 0.5,
        "pb": f(3, 5), "ids": rng.randint(0, 6, (3, 4)).astype(np.int32),
        "ids2": rng.randint(0, 6, (3, 4)).astype(np.int32),
        "t4": f(2, 3, 4, 5), "table": f(6, 8), "gids": rng.randint(
            0, 6, (2, 5)).astype(np.int32),
        "q": f(2, 2, 8, 16), "k": f(2, 2, 12, 16), "v": f(2, 2, 12, 16),
        "qs": f(2, 2, 12, 16), "pad": pad,
        "lx": f(4, 6, 32), "lg": 1.0 + 0.1 * f(32), "lb": 0.1 * f(32),
        "logits": f(3, 4, 40), "labels": rng.randint(0, 40, (3, 4)).astype(
            np.int32),
        "rx": f(4, 6, 32), "rr": f(4, 6, 32), "rbias": f(32),
    }


# name -> (builder(stf, ph) -> output tensor, float inputs differentiated,
#          tolerance or None for an exact comparison)
def _flash(causal, bias, rate, q="q", dt="float32"):
    def build(stf, ph):
        cast = lambda t: stf.cast(t, getattr(stf, dt))  # noqa: E731
        kb = ph["pad"] if bias else None
        return stf.nn.fused_attention(
            cast(ph[q]), cast(ph["k" if q == "q" else "qs"]),
            cast(ph["v" if q == "q" else "qs"]), bias=kb, causal=causal,
            dropout_rate=rate)
    ins = [q, "k", "v"] if q == "q" else ["qs"]
    return build, ins, 1e-5 if dt == "float32" else 1e-2


CASES = {
    "Minimum": (lambda stf, ph: stf.minimum(ph["a"], ph["b"]),
                ["a", "b"], 1e-5),
    "NotEqual": (lambda stf, ph: stf.not_equal(ph["ids"], ph["ids2"]),
                 [], None),
    "NotEqual_scalar": (lambda stf, ph: stf.not_equal(ph["ids"], 0), [],
                        None),
    "Pow": (lambda stf, ph: stf.pow(ph["pa"], ph["pb"]), ["pa", "pb"],
            1e-5),
    "Pow_scalar": (lambda stf, ph: stf.pow(ph["pa"], -0.5), ["pa"], 1e-5),
    "TrueDiv": (lambda stf, ph: ph["a"] / ph["pa"], ["a", "pa"], 1e-5),
    "Transpose": (lambda stf, ph: stf.transpose(ph["t4"], [0, 2, 1, 3]),
                  ["t4"], 1e-5),
    "Gather": (lambda stf, ph: stf.gather(ph["table"], ph["gids"]),
               ["table"], 1e-5),
    "Gather_axis1": (lambda stf, ph: stf.gather(ph["table"], ph["gids"],
                                                axis=1), ["table"], 1e-5),
    "EmbeddingLookupMixed": (
        lambda stf, ph: stf.nn.embedding_lookup(
            ph["table"], ph["gids"], compute_dtype=stf.bfloat16),
        ["table"], 1e-2),
    "FlashAttention_causal": _flash(True, False, 0.0, "qs"),
    "FlashAttention_bias_sq_ne_sk": _flash(False, True, 0.0),
    "FlashAttention_plain_sq_ne_sk": _flash(False, False, 0.0),
    "FlashAttention_bias_bf16": _flash(False, True, 0.0, dt="bfloat16"),
    "FlashAttentionDropout_causal": _flash(True, False, 0.1, "qs"),
    "FlashAttentionDropout_bias_sq_ne_sk": _flash(False, True, 0.1),
    "FlashAttentionDropout_bias_bf16": _flash(False, True, 0.1,
                                              dt="bfloat16"),
    "FusedLayerNorm": (lambda stf, ph: stf.nn.fused_layer_norm(
        ph["lx"], ph["lg"], ph["lb"], eps=1e-6), ["lx", "lg", "lb"], 1e-5),
    "FusedLayerNorm_bf16": (lambda stf, ph: stf.nn.fused_layer_norm(
        stf.cast(ph["lx"], stf.bfloat16), ph["lg"], ph["lb"]),
        ["lx", "lg", "lb"], 1e-2),
    "FusedSoftmaxXent": (lambda stf, ph: stf.nn.fused_softmax_cross_entropy(
        ph["logits"], ph["labels"], label_smoothing=0.1), ["logits"], 1e-5),
    "FusedDropoutBiasResidual": (
        lambda stf, ph: stf.nn.fused_bias_dropout_residual(
            ph["rx"], ph["rr"], ph["rbias"], rate=0.1),
        ["rx", "rr", "rbias"], 1e-5),
    "FusedDropoutBiasResidual_nobias_bf16": (
        lambda stf, ph: stf.nn.fused_bias_dropout_residual(
            stf.cast(ph["rx"], stf.bfloat16),
            stf.cast(ph["rr"], stf.bfloat16), rate=0.1),
        ["rx", "rr"], 1e-2),
}


class _Placeholders(dict):
    """One case's placeholders, made at first use and fed ``values``."""

    def __init__(self, stf, values, case, feeds):
        super().__init__()
        self._args = (stf, values, case, feeds)

    def __missing__(self, k):
        stf, values, case, feeds = self._args
        v = values[k]
        t = stf.placeholder(getattr(stf, v.dtype.name), v.shape,
                            f"{case}_{k}")
        feeds[t] = v
        self[k] = t
        return t


def _run(stf, values):
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(SEED)
        feeds, outs, phs = {}, {}, {}
        for name, (build, _, _) in CASES.items():
            phs[name] = _Placeholders(stf, values, name, feeds)
            outs[name] = build(stf, phs[name])
        normal = [stf.random_normal((64, 96), stddev=0.25),
                  stf.random_normal((64, 96), mean=0.5, stddev=0.25)]
        rng = np.random.RandomState(3)
        loss = None
        for name, (_, ins, _) in CASES.items():
            if not ins:
                continue
            o = stf.cast(outs[name], stf.float32)
            w = stf.constant(rng.randn(*o.shape.as_list()).astype(
                np.float32))
            term = stf.reduce_sum(o * w)
            loss = term if loss is None else loss + term
        xs = [(name, k) for name, (_, ins, _) in CASES.items()
              for k in ins]
        grads = stf.gradients(loss, [phs[n][k] for n, k in xs])
        with stf.Session(config=stf.ConfigProto(device_count={"GPU": 0})) \
                as s:
            fetched = s.run({"outs": outs, "normal": normal,
                             "grads": {f"{n}:{k}": t for (n, k), t in
                                       zip(xs, grads)}}, feeds)
    return fetched, {n: o.op.type for n, o in outs.items()}


@pytest.fixture(scope="module")
def results():
    values = _inputs()
    return {name: _run(stf, values) for name, stf in PKGS.items()}


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" else x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_forward_and_gradient(results, case):
    (jf, jtypes), (pf, ptypes) = results["jax"], results["port"]
    assert ptypes[case] == jtypes[case] == case.split("_")[0]
    _, ins, tol = CASES[case]
    j, p = _f32(jf["outs"][case]), _f32(pf["outs"][case])
    assert p.shape == j.shape and p.dtype == j.dtype
    if tol is None:
        np.testing.assert_array_equal(p, j)
        return
    np.testing.assert_allclose(p, j, rtol=tol, atol=tol)
    for x in ins:
        gj = _f32(jf["grads"][f"{case}:{x}"])
        gp = _f32(pf["grads"][f"{case}:{x}"])
        assert gp.shape == gj.shape
        assert _rel(gp, gj) <= max(tol, 1e-4), x


def test_dropout_cases_drop_the_same_elements(results):
    # the masks themselves: the dropped positions of the fused
    # dropout-residual op (out == residual) are the same in both
    jf, pf = results["jax"][0], results["port"][0]
    values = _inputs()
    for fetched in (jf, pf):
        out = _f32(fetched["outs"]["FusedDropoutBiasResidual"])
        dropped = np.isclose(out, values["rr"], rtol=0, atol=1e-6)
        assert 0.05 < dropped.mean() < 0.15
    jd = np.isclose(_f32(jf["outs"]["FusedDropoutBiasResidual"]),
                    values["rr"], rtol=0, atol=1e-6)
    pd = np.isclose(_f32(pf["outs"]["FusedDropoutBiasResidual"]),
                    values["rr"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pd, jd)


def test_random_standard_normal_within_three_ulp(results):
    # mean 0: within 3 ulp, most values bit-equal; mean 0.5: the same
    # error before the shift, so within 3 ulp of 1.0 absolute (values
    # near 0 have far finer ulps than the draw's error)
    (j0, j1), (p0, p1) = (np.asarray(results[k][0]["normal"], np.float32)
                          for k in ("jax", "port"))
    ulps = np.abs(p0.view(np.int32).astype(np.int64) - j0.view(np.int32))
    assert ulps.max() <= 3
    assert (ulps != 0).mean() < 0.03
    assert np.abs(p1 - j1).max() <= 3 * np.spacing(np.float32(1.0))
    assert (p1 != j1).mean() < 0.03
    assert abs(float(p1.mean()) - 0.5) < 0.02 and \
        abs(float(p1.std()) - 0.25) < 0.02


def test_divide_builds_true_div_and_realdiv_real_div():
    for stf in PKGS.values():
        with stf.Graph().as_default():
            a = stf.constant(1.0)
            assert (a / 2.0).op.type == "TrueDiv"
            assert stf.divide(a, a).op.type == "TrueDiv"
            assert stf.realdiv(a, a).op.type == "RealDiv"
            assert (a ** 2.0).op.type == "Pow"


def test_embedding_lookup_at_the_table_dtype_builds_gather():
    for stf in PKGS.values():
        with stf.Graph().as_default():
            t = stf.constant(np.ones((4, 3), np.float32))
            ids = stf.constant(np.zeros(2, np.int32))
            assert stf.nn.embedding_lookup(t, ids).op.type == "Gather"
            assert stf.nn.embedding_lookup(
                t, ids, compute_dtype=stf.float32).op.type == "Gather"
            assert stf.nn.embedding_lookup(
                t, ids, compute_dtype=stf.bfloat16).op.type == \
                "EmbeddingLookupMixed"


def test_fused_ops_keep_their_eager_form():
    # the eager callers pass torch tensors and get torch tensors back
    import torch

    from simple_tensorflow_tpu_torch.ops import fused_ops

    x = torch.randn(2, 3, 8)
    g, b = torch.ones(8), torch.zeros(8)
    y = fused_ops.fused_layer_norm(x, g, b)
    assert isinstance(y, torch.Tensor) and y.shape == x.shape
    out = fused_ops.fused_bias_dropout_residual(x, x, rate=0.1, seed=5)
    assert isinstance(out, torch.Tensor)
    assert pdtypes.as_dtype("bfloat16").torch_dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(7,), (33, 65)])
def test_prng_normal_matches_jax_random_normal(shape):
    # the host draw of framework/prng.py against jax.random.normal in f32
    import jax
    import jax.numpy as jnp

    from simple_tensorflow_tpu_torch.framework import prng

    key = prng.key(2024)
    j = np.asarray(jax.random.normal(
        jax.random.wrap_key_data(jnp.asarray(key), impl="threefry2x32"),
        shape, dtype=jnp.float32))
    p = prng.normal(key, shape)
    assert p.dtype == np.float32 and p.shape == shape
    ulps = np.abs(p.view(np.int32).astype(np.int64) - j.view(np.int32))
    assert ulps.max() <= 3
