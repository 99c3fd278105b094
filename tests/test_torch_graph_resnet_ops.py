"""Each op type the ResNet graph adds to the port, built by the same user
code in both packages and run through each package's ``Session`` on the
CPU, against the JAX package's (the style of
``tests/test_torch_graph_fused_ops.py``): ``TruncatedNormal``,
``FusedBatchNorm`` (training and inference, its VJP with the cotangents of
the mean and variance outputs), ``L2Loss``, ``FusedMomentumUpdate`` (plain
and Nesterov, two groups) with the graph ``MomentumOptimizer``'s
per-variable path under ``stf.kernels`` mode ``"off"``, and the graph
``BatchNormalization`` layer.

Tolerances: f32 values rtol/atol 1e-5, gradients 1e-4 by norm (sums in
another order); bf16 1e-2 (one bf16 rounding). ``TruncatedNormal`` within
3 ulp of JAX's draw (the two ``log1p`` differ by an ulp at some inputs, as
for ``RandomStandardNormal``), most values bit-equal, inside the clip
``(nextafter(-2, inf), nextafter(2, -inf))`` times the stddev; its two
``erf`` endpoints bit-equal to XLA's. Momentum: the gradients of a linear
loss are exact in both packages, so the updates differ only where XLA
contracts ``mu * acc + g`` into one fused multiply-add: f32 parameters and
slots within 4 ulp of the larger of their magnitudes and the update's,
bf16 parameters within one bf16 ulp.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf

PKGS = {"jax": jstf, "port": pstf}
SEED = 11


def _session(stf):
    return stf.Session(config=stf.ConfigProto(device_count={"GPU": 0}))


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" else x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


# -- TruncatedNormal ----------------------------------------------------------

TN_CASES = {"unit": (1.0, 0.0, "float32"), "scaled": (0.05, 0.0, "float32"),
            "shifted": (0.25, 0.5, "float32"),
            "bf16": (0.3, 0.0, "bfloat16")}


def _truncated(stf):
    with stf.Graph().as_default():
        stf.set_random_seed(SEED)
        outs = {k: stf.truncated_normal((96, 128), mean=mean, stddev=sd,
                                        dtype=getattr(stf, dt))
                for k, (sd, mean, dt) in TN_CASES.items()}
        init = stf.init_ops.VarianceScaling(2.0, "fan_out",
                                            "truncated_normal")
        outs["variance_scaling"] = init([3, 3, 16, 32])
        outs["variance_scaling_normal"] = stf.variance_scaling_initializer(
            1.0, "fan_in", "normal")([64, 48])
        types = {k: v.op.type for k, v in outs.items()}
        with _session(stf) as s:
            return s.run(outs), types


@pytest.fixture(scope="module")
def truncated():
    return {name: _truncated(stf) for name, stf in PKGS.items()}


@pytest.mark.parametrize("case", sorted(TN_CASES) + [
    "variance_scaling", "variance_scaling_normal"])
def test_truncated_normal_matches_jax(truncated, case):
    (jv, jt), (pv, pt) = truncated["jax"], truncated["port"]
    assert pt[case] == jt[case] == "TruncatedNormal"
    j, p = jv[case], pv[case]
    assert p.dtype == j.dtype and p.shape == j.shape
    if case == "bf16":
        np.testing.assert_allclose(_f32(p), _f32(j), rtol=2 ** -8, atol=0)
        assert (_f32(p) != _f32(j)).mean() < 0.03
        return
    sd, mean, _ = TN_CASES.get(case, (None, 0.0, None))
    if mean:
        # the shift keeps the draw's absolute error: 3 ulp of the mean
        assert np.abs(p - j).max() <= 3 * np.spacing(np.float32(mean))
    else:
        assert _ulps(p, j).max() <= (3 if sd == 1.0 else 4)
    assert (p != j).mean() < 0.03
    if sd is not None:
        lo = np.float32(mean) + np.float32(sd) * np.nextafter(
            np.float32(-2), np.float32(0))
        assert p.min() >= lo - np.spacing(np.float32(lo))
        assert np.abs(p - mean).max() < 2 * sd
        # a unit normal truncated to (-2, 2) has stddev 0.8796
        assert abs(float((p - mean).std()) / sd - 0.8796) < 0.02


def test_truncated_normal_endpoints_are_xla_erf():
    import jax
    from jax import lax

    from simple_tensorflow_tpu_torch.framework import prng

    sqrt2 = np.float32(np.sqrt(2.0))
    erf = jax.jit(lambda x: lax.erf(x / sqrt2))
    for bound, want in ((-2.0, prng.TRUNC_ERF_LO), (2.0, prng.TRUNC_ERF_HI)):
        got = np.asarray(erf(np.float32(bound)))
        assert got.view(np.uint32) == np.float32(want).view(np.uint32)
    assert prng.TRUNC_LO == float(np.nextafter(np.float32(-2), 0))
    assert prng.TRUNC_HI == float(np.nextafter(np.float32(2), 0))


@pytest.mark.parametrize("shape", [(5,), (257, 33)])
def test_prng_truncated_normal_matches_jax_random(shape):
    import jax
    import jax.numpy as jnp

    from simple_tensorflow_tpu_torch.framework import prng

    key = prng.key(77)
    j = np.asarray(jax.random.truncated_normal(
        jax.random.wrap_key_data(jnp.asarray(key), impl="threefry2x32"),
        -2.0, 2.0, shape, dtype=jnp.float32))
    p = prng.truncated_normal(key, shape)
    assert p.dtype == np.float32 and p.shape == shape
    assert _ulps(p, j).max() <= 3
    assert p.min() >= prng.TRUNC_LO and p.max() <= prng.TRUNC_HI


# -- FusedBatchNorm, L2Loss, the BatchNormalization layer ---------------------

def _bn_values():
    rng = np.random.RandomState(0)
    return {"x": (1.5 + 2.0 * rng.randn(4, 5, 6, 8)).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.randn(8)).astype(np.float32),
            "offset": (0.1 * rng.randn(8)).astype(np.float32),
            "mm": (0.1 * rng.randn(8)).astype(np.float32),
            "mv": (1.0 + rng.rand(8)).astype(np.float32),
            "wy": rng.randn(4, 5, 6, 8).astype(np.float32),
            "wm": rng.randn(8).astype(np.float32),
            "wv": rng.randn(8).astype(np.float32),
            "l2": rng.randn(7, 9).astype(np.float32)}


def _bn_graph(stf, v):
    """Every FusedBatchNorm / L2Loss / layer case in one graph."""
    g = stf.Graph()
    with g.as_default():
        ph = {k: stf.placeholder(stf.float32, a.shape, name=k)
              for k, a in v.items()}
        feeds = {ph[k]: a for k, a in v.items()}
        outs, grads = {}, {}
        for dt in ("float32", "bfloat16"):
            x = stf.cast(ph["x"], getattr(stf, dt))
            y, m, var = stf.nn.fused_batch_norm(
                x, ph["scale"], ph["offset"], epsilon=1e-5,
                is_training=True)
            yi, mi, vi = stf.nn.fused_batch_norm(
                x, ph["scale"], ph["offset"], mean=ph["mm"],
                variance=ph["mv"], epsilon=1e-5, is_training=False)
            outs[f"train_{dt}"] = (y, m, var)
            outs[f"infer_{dt}"] = (yi, mi, vi)
            loss = (stf.reduce_sum(stf.cast(y, stf.float32) * ph["wy"])
                    + stf.reduce_sum(m * ph["wm"])
                    + stf.reduce_sum(var * ph["wv"]))
            gx, gs, go = stf.gradients(loss, [ph["x"], ph["scale"],
                                              ph["offset"]])
            grads[f"train_{dt}"] = (gx, gs, go)
            outs[f"l2_{dt}"] = stf.nn.l2_loss(stf.cast(ph["l2"],
                                                       getattr(stf, dt)))
        grads["l2_float32"] = stf.gradients(outs["l2_float32"], [ph["l2"]])
        with stf.variable_scope("bn_layer"):
            layer_y = stf.layers.batch_normalization(
                ph["x"], momentum=0.9, epsilon=1e-5, training=True,
                name="bn")
            infer_y = stf.layers.batch_normalization(
                ph["x"], momentum=0.9, epsilon=1e-5, training=False,
                name="bn")
        updates = stf.get_collection(stf.GraphKeys.UPDATE_OPS)
        moving = [v for v in stf.global_variables()
                  if "moving" in v.var_name]
        with _session(stf) as s:
            s.run(stf.global_variables_initializer())
            fetched = s.run({"outs": outs, "grads": grads,
                             "layer": layer_y}, feeds)
            fetched["moving_before"] = s.run(moving)
            s.run(updates, feeds)
            fetched["moving_after"] = s.run(moving)
            fetched["layer_infer"] = s.run(infer_y, feeds)
        fetched["updates"] = [op.name for op in updates]
        fetched["types"] = {k: (o[0] if isinstance(o, tuple) else o).op.type
                            for k, o in outs.items()}
    return fetched


@pytest.fixture(scope="module")
def bn():
    v = _bn_values()
    return {name: _bn_graph(stf, v) for name, stf in PKGS.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "infer"])
def test_fused_batch_norm_matches_jax(bn, mode, dtype):
    j, p = bn["jax"], bn["port"]
    case = f"{mode}_{dtype}"
    assert p["types"][case] == j["types"][case] == "FusedBatchNorm"
    tol = 1e-5 if dtype == "float32" else 1e-2
    for a, b in zip(p["outs"][case], j["outs"][case]):
        assert _f32(a).shape == _f32(b).shape
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)
    if mode == "train":
        assert p["outs"][case][1].dtype == np.float32
        for a, b in zip(p["grads"][case], j["grads"][case]):
            assert _rel(_f32(a), _f32(b)) <= max(tol, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_loss_matches_jax(bn, dtype):
    j, p = bn["jax"], bn["port"]
    case = f"l2_{dtype}"
    assert p["types"][case] == j["types"][case] == "L2Loss"
    assert np.asarray(p["outs"][case]).dtype == \
        np.asarray(j["outs"][case]).dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_f32(p["outs"][case]),
                               _f32(j["outs"][case]), rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(p["grads"][case][0], j["grads"][case][0],
                                   rtol=1e-6)


def test_batch_normalization_layer_matches_jax(bn):
    j, p = bn["jax"], bn["port"]
    np.testing.assert_allclose(p["layer"], j["layer"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p["layer_infer"], j["layer_infer"],
                               rtol=1e-5, atol=1e-5)
    assert p["updates"] == j["updates"] and len(p["updates"]) == 2
    for st in (p, j):
        mean0, var0 = st["moving_before"]
        assert not mean0.any() and (var0 == 1).all()
    for a, b in zip(p["moving_after"], j["moving_after"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert np.abs(p["moving_after"][0]).max() > 0.1


# -- FusedMomentumUpdate and the graph MomentumOptimizer ---------------------

STEPS = 3


def _momentum(stf, nesterov, mode):
    """Two groups (bf16 and f32 variables), a linear loss (exact
    gradients), ``STEPS`` Momentum steps; the graph's op types, slot
    names, every variable after each step."""
    rng = np.random.RandomState(1)
    init = {"a": rng.randn(4, 3), "b": rng.randn(5), "c": rng.randn(2, 2)}
    coef = {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in init.items()}
    stf.kernels.set_mode(mode)
    try:
        g = stf.Graph()
        with g.as_default():
            vs = {"a": stf.Variable(stf.constant(init["a"].astype(
                      np.float32)), name="a"),
                  "b": stf.Variable(stf.constant(init["b"].astype(
                      np.float32)), name="b"),
                  "c": stf.Variable(stf.cast(stf.constant(init["c"].astype(
                      np.float32)), stf.bfloat16), name="c")}
            loss = stf.add_n([stf.reduce_sum(
                stf.cast(v._ref, stf.float32) * coef[k])
                for k, v in vs.items()])
            opt = stf.train.MomentumOptimizer(0.05, 0.9,
                                              use_nesterov=nesterov)
            train = opt.minimize(loss)
            slots = {k: opt.get_slot(v, "momentum") for k, v in vs.items()}
            sig = [(op.type, op.name, [t.name for t in op.inputs])
                   for op in g.get_operations()]
            with _session(stf) as s:
                s.run(stf.global_variables_initializer())
                states = []
                for _ in range(STEPS):
                    s.run(train)
                    states.append(s.run(
                        {"vars": vs, "slots": {
                            k: (sl if isinstance(sl, stf.Tensor)
                                else sl._ref) for k, sl in slots.items()}}))
        return sig, states
    finally:
        stf.kernels.set_mode(None)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_momentum_optimizer_matches_jax(nesterov, mode):
    (jsig, jstates), (psig, pstates) = (
        _momentum(stf, nesterov, mode) for stf in PKGS.values())
    assert psig == jsig
    types = {t for t, _, _ in psig}
    if mode == "off":
        assert "FusedMomentumUpdate" not in types
        assert {"Assign", "AssignSub"} <= types
    else:
        (op,) = [s for s in psig if s[0] == "FusedMomentumUpdate"]
        assert len(op[2]) == 2 + 2 + 3   # lr, mu per group; 3 gradients
    for pst, jst in zip(pstates, jstates):
        for part in ("vars", "slots"):
            for k in ("a", "b", "c"):
                p, j = pst[part][k], jst[part][k]
                assert p.dtype == j.dtype, (part, k)
                p, j = _f32(p), _f32(j)
                if part == "vars" and k == "c":
                    np.testing.assert_allclose(p, j, rtol=2 ** -7, atol=0)
                    continue
                scale = np.maximum(np.abs(j), np.abs(p)) + 1.0
                assert np.all(np.abs(p - j)
                              <= 4 * np.spacing(scale.astype(np.float32)))
    # the momentum moved the variables
    assert np.abs(_f32(pstates[-1]["slots"]["a"])).max() > 0.1
