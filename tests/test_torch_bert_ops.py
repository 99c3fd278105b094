"""Each op type the BERT graph adds to the port, built by the same user
code in both packages and run through each package's ``Session`` on the
CPU, against the JAX package's (the style of
``tests/test_torch_graph_fused_ops.py``): ``Gelu`` (``approximate`` True,
the tanh form and the default, and False, the erf form), ``Tanh``,
``Squeeze`` (one axis, several, none) and ``range`` (a ``Const``).

One graph per package holds every case; the gradients are one
``stf.gradients`` of the sum of every float case's weighted output over
its input. Tolerances: f32 values and gradients rtol/atol 1e-5 (``Gelu``
and ``Tanh`` are transcendental: PyTorch's and XLA's ``tanh``/``erf``
differ in the last bits); bf16 ``Gelu`` within 2 bf16 ulp of its input
``x``: XLA rounds to bf16 after each step of the tanh form, so ``1 +
tanh(.)`` keeps 8 bits and the output ``x/2 (1 + tanh(.))`` carries an
error of up to one ulp of ``x`` (on the negative tail JAX's bf16 gives
-0.0 where the function is -0.003), while PyTorch's
``gelu(approximate="tanh")`` computes in f32 and rounds once; 44% of the
values differ, the largest difference is one ulp of ``x``. bf16 ``Tanh``
bit-exact. ``Squeeze`` and ``range`` exact, with JAX's dtypes and shapes.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf

PKGS = {"jax": jstf, "port": pstf}
TOL = 1e-5
BF16_X_ULPS = 2


def _inputs():
    rng = np.random.RandomState(0)
    return {"g": (3.0 * rng.randn(64, 48)).astype(np.float32),
            "t": (2.0 * rng.randn(33, 7)).astype(np.float32),
            "s": rng.randn(4, 1, 6, 1).astype(np.float32),
            "w_g": rng.randn(64, 48).astype(np.float32),
            "w_t": rng.randn(33, 7).astype(np.float32)}


def _build(stf):
    v = _inputs()
    g = stf.Graph()
    with g.as_default():
        ph = {k: stf.placeholder(stf.float32, a.shape, name=k)
              for k, a in v.items()}
        outs = {
            "gelu_tanh": stf.nn.gelu(ph["g"]),
            "gelu_erf": stf.nn.gelu(ph["g"], approximate=False),
            "gelu_bf16": stf.nn.gelu(stf.cast(ph["g"], stf.bfloat16)),
            "tanh": stf.tanh(ph["t"]),
            "tanh_bf16": stf.tanh(stf.cast(ph["t"], stf.bfloat16)),
            "squeeze_1": stf.squeeze(ph["s"], axis=[1]),
            "squeeze_13": stf.squeeze(ph["s"], axis=[1, 3]),
            "squeeze_all": stf.squeeze(ph["s"]),
            "squeeze_int": stf.squeeze(stf.cast(ph["s"], stf.int32),
                                       axis=3),
            "range": stf.range(0, 12) * 5,
            "range_limit": stf.range(7),
            "range_f": stf.range(0.5, 3.0, 0.25),
            "range_dtype": stf.range(2, 20, 3, dtype=stf.float32),
        }
        loss = (stf.reduce_sum(outs["gelu_tanh"] * ph["w_g"])
                + stf.reduce_sum(outs["gelu_erf"] * ph["w_g"])
                + stf.reduce_sum(outs["tanh"] * ph["w_t"])
                + stf.reduce_sum(outs["squeeze_13"]))
        grads = dict(zip(("g", "t", "s"), stf.gradients(
            loss, [ph["g"], ph["t"], ph["s"]])))
        types = {k: o.op.type for k, o in outs.items()}
        with stf.Session(config=stf.ConfigProto(
                device_count={"GPU": 0})) as s:
            got = s.run({"outs": outs, "grads": grads},
                        {ph[k]: a for k, a in v.items()})
    return got, types, {k: (str(o.shape), o.dtype.name)
                        for k, o in outs.items()}


@pytest.fixture(scope="module")
def runs():
    return {name: _build(stf) for name, stf in PKGS.items()}


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" else x


CASES = ["gelu_tanh", "gelu_erf", "gelu_bf16", "tanh", "tanh_bf16",
         "squeeze_1", "squeeze_13", "squeeze_all", "squeeze_int", "range",
         "range_limit", "range_f", "range_dtype"]


@pytest.mark.parametrize("case", CASES)
def test_bert_op_case_matches_jax(runs, case):
    (jv, jt, js), (pv, pt, ps) = runs["jax"], runs["port"]
    assert pt[case] == jt[case]
    assert ps[case] == js[case]
    j, p = jv["outs"][case], pv["outs"][case]
    assert p.dtype == j.dtype and p.shape == j.shape
    if case == "gelu_bf16":
        x = _f32(np.asarray(_inputs()["g"]).astype(
            jstf.bfloat16.np_dtype))
        ulp_x = np.spacing(np.abs(x)) * 2 ** 16   # bf16 keeps 8 bits
        assert (np.abs(_f32(p) - _f32(j)) <= BF16_X_ULPS * ulp_x).all()
    elif case == "tanh_bf16":
        np.testing.assert_array_equal(_f32(p), _f32(j))
    elif case.startswith(("squeeze", "range")):
        np.testing.assert_array_equal(p, j)
    else:
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_op_types(runs):
    _, pt, _ = runs["port"]
    assert {pt[k] for k in CASES} == {"Gelu", "Tanh", "Squeeze", "Const",
                                      "Mul"}
    assert pt["gelu_tanh"] == pt["gelu_erf"] == "Gelu"
    assert pt["range_limit"] == "Const"


@pytest.mark.parametrize("x", ["g", "t", "s"])
def test_bert_op_gradients_match_jax(runs, x):
    j, p = runs["jax"][0]["grads"][x], runs["port"][0]["grads"][x]
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)
