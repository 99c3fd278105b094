"""``ops/functional_ops.py`` of the port (``scan``, ``map_fn``, ``foldl``,
``foldr``) against the JAX package's, on the CPU: one graph of small
loops built in each package under graph seed 5, run once in a JAX
Session and once in a port Session from JAX's initial values
(``convert.load_session_variables``).

- values and gradients (``stf.gradients``) with respect to the elems, the
  initial carries and a captured variable within 1e-5, for a plain carry,
  a namedtuple ``LSTMStateTuple`` carry nested in a tuple, two elems, an
  integer carry beside a float one, ``initializer=None`` (the first
  element starts the carry: ``StridedSlice``, ``ExpandDims``,
  ``Concat``), ``map_fn``, ``foldl`` and ``foldr``;
- the ops have JAX's types, names, attrs and output specs, their bodies
  JAX's ops;
- a seeded ``Dropout`` in a ``Scan`` body keeps JAX's mask and the same
  mask at every step, is in the plan's RNG rows
  (``analysis.rng_ops``), and a captured step (its CPU replay) draws it
  as the eager step does;
- a body that assigns a variable raises ``InvalidArgumentError`` in both
  packages; ``py_func`` raises ``NotImplementedError`` naming its ROADMAP
  item (``cond``, ``while_loop`` and ``case`` build their ops).
"""

import collections

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu_torch import analysis, convert
from simple_tensorflow_tpu_torch.framework import errors as perrors
from simple_tensorflow_tpu.framework import errors as jerrors

PKGS = {"jax": jstf, "port": pstf}
TOL = 1e-5
T, B, D = 5, 2, 3


def _feeds(rng):
    return {"xs": rng.randn(T, B, D).astype(np.float32),
            "ys": rng.randn(T, B).astype(np.float32),
            "c0": rng.randn(B, D).astype(np.float32)}


def _build(stf):
    """The loops, their gradients and the placeholders, in a new graph."""
    g = stf.Graph()
    out, grads = {}, {}
    with g.as_default():
        stf.set_random_seed(5)
        xs = stf.placeholder(stf.float32, [T, B, D], name="xs")
        ys = stf.placeholder(stf.float32, [T, B], name="ys")
        c0 = stf.placeholder(stf.float32, [B, D], name="c0")
        w = stf.get_variable("w", [D, D], initializer=(
            stf.random_uniform_initializer(-0.5, 0.5, seed=1)))
        LST = stf.nn.rnn_cell.LSTMStateTuple

        out["plain"] = stf.scan(
            lambda c, x: stf.tanh(stf.matmul(c, w) + x), xs, initializer=c0)

        def lstm_like(carry, elem):
            (st, n) = carry
            x, y = elem
            c = st.c * 0.5 + stf.tanh(stf.matmul(st.h, w) + x)
            h = stf.tanh(c) * stf.sigmoid(stf.expand_dims(y, -1))
            return (LST(c, h), n + stf.reduce_sum(h, axis=1))

        nested = stf.scan(lstm_like, (xs, ys),
                          initializer=(LST(c0, c0 * 2.0), ys[0] * 0.0))
        out["nested_c"], out["nested_h"] = nested[0].c, nested[0].h
        out["nested_n"] = nested[1]

        def counted(carry, x):
            i, acc = carry
            i = i + 1
            return (i, acc + x * stf.cast(i, stf.float32))

        out["count_i"], out["count_acc"] = stf.scan(
            counted, xs, initializer=(stf.constant(np.int32(0)), c0))
        out["first"] = stf.scan(lambda a, x: a * 0.5 + x, xs)
        out["map"] = stf.map_fn(lambda x: stf.matmul(x, w) * 2.0, xs)
        out["foldl"] = stf.foldl(lambda a, x: stf.tanh(a + x), xs,
                                 initializer=c0)
        out["foldr"] = stf.foldr(lambda a, x: a * 0.9 + x, xs,
                                 initializer=c0)
        # a seeded Dropout in a body: the same mask at every step, and
        # the mask of an outer Dropout of the same seed and shape (keyed
        # first outside the loop, as dynamic_rnn's probe cell is: JAX
        # leaks a traced key when the loop keys a fold first and the plan
        # differentiates)
        outer = stf.nn.dropout(stf.ones([B, D]), keep_prob=0.5, seed=3)
        out["drop_outer"] = outer
        out["drop"] = stf.scan(
            lambda a, x: stf.nn.dropout(stf.ones_like(x), keep_prob=0.5,
                                        seed=3) + a * 0.0,
            xs, initializer=outer * 0.0)
        floats = [v for k, v in sorted(out.items()) if k != "count_i"]
        loss = stf.add_n([stf.reduce_sum(v * v) for v in floats])
        for name, x in (("xs", xs), ("ys", ys), ("c0", c0), ("w", w)):
            grads[name] = stf.gradients(loss, [x])[0]
        init = stf.global_variables_initializer()
    return g, dict(out=out, grads=grads, init=init, xs=xs, ys=ys, c0=c0)


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _run(name, init=None):
    stf = PKGS[name]
    g, m = _build(stf)
    feeds = {m[k]: v for k, v in _feeds(np.random.RandomState(0)).items()}
    with g.as_default(), stf.Session(
            config=stf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(m["init"])
        state0 = _state(s)
        if init is not None:
            convert.load_session_variables(s, init)
        got = s.run({"out": m["out"], "grads": m["grads"]}, feeds)
        plan = list(s._cache.values())[-1] if name == "port" else None
    return dict(got, state0=state0, graph=g, plan=plan)


@pytest.fixture(scope="module")
def runs():
    j = _run("jax")
    return j, _run("port", init=j["state0"])


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op.type, op.name, [t.name for t in op.inputs],
                    [(str(t.shape), t.dtype.name) for t in op.outputs],
                    {k: v for k, v in op.attrs.items()
                     if k in ("n_carry", "n_elems", "spec", "axis", "seed",
                              "_graph_seed", "keep_prob")}))
        body = op.attrs.get("body")
        if body is not None:
            out.append(_signature(body))
            out.append([(a.name, b.name) for a, b in body.captures])
    return out


def test_loop_graphs_match_jax_op_for_op(runs):
    j, p = runs
    assert _signature(p["graph"]) == _signature(j["graph"])
    types = [op.type for op in p["graph"].get_operations()]
    assert types.count("Scan") == 5 and types.count("MapFn") == 1
    assert types.count("Foldl") == 2
    assert {"StridedSlice", "ExpandDims", "Concat", "Reverse",
            "SymbolicGradient"} <= set(types)


def test_init_matches_jax_bit_for_bit(runs):
    j, p = runs
    assert sorted(p["state0"]) == sorted(j["state0"])
    for k, v in j["state0"].items():
        np.testing.assert_array_equal(p["state0"][k], v, err_msg=k)


@pytest.mark.parametrize("name", ["plain", "nested_c", "nested_h",
                                  "nested_n", "count_acc", "first", "map",
                                  "foldl", "foldr"])
def test_loop_values_match_jax(runs, name):
    j, p = runs
    jv, pv = j["out"][name], p["out"][name]
    assert pv.shape == jv.shape and pv.dtype == jv.dtype
    np.testing.assert_allclose(pv, jv, rtol=TOL, atol=TOL)


def test_an_integer_carry_counts_exactly(runs):
    j, p = runs
    assert p["out"]["count_i"].dtype == np.int32
    np.testing.assert_array_equal(p["out"]["count_i"], j["out"]["count_i"])
    np.testing.assert_array_equal(p["out"]["count_i"], np.arange(1, T + 1))


@pytest.mark.parametrize("name", ["xs", "ys", "c0", "w"])
def test_loop_gradients_match_jax(runs, name):
    j, p = runs
    jg, pg = j["grads"][name], p["grads"][name]
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL * np.abs(jg).max())


def test_a_body_dropout_draws_jax_mask_at_every_step(runs):
    j, p = runs
    jd, pd = j["out"]["drop"], p["out"]["drop"]
    np.testing.assert_array_equal(pd, jd)
    kept = pd != 0
    assert 0 < kept.mean() < 1
    for t in range(1, T):
        np.testing.assert_array_equal(kept[t], kept[0])
    np.testing.assert_array_equal(p["out"]["drop_outer"], pd[0])
    names = [op.name for op in analysis.rng_ops(p["plan"].ops)]
    # the outer op, then the body's, named within the body
    assert names == ["dropout", "dropout"]
    drop = [op for op in p["plan"].ops if op.type == "Scan" and any(
        o.type == "Dropout" for o in op.attrs["body"].get_operations())]
    assert len(drop) == 1


def test_a_captured_step_draws_the_body_masks_as_eager():
    g, m = _build(pstf)
    feeds = {m[k]: v for k, v in _feeds(np.random.RandomState(1)).items()}
    outs = {}
    for capture in (False, True):
        with g.as_default(), pstf.Session(
                config=pstf.ConfigProto(device_count={"GPU": 0})) as s:
            s._capture = capture
            s.run(m["init"])
            outs[capture] = [s.run([m["out"]["drop"], m["grads"]["w"]],
                                   feeds) for _ in range(3)]
            assert s.captures == (1 if capture else 0)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    # each run draws a new mask (the run counter moves), the same at
    # every step of the run
    assert not np.array_equal(outs[True][1][0], outs[True][2][0])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_a_variable_assigned_in_a_body_raises(name):
    stf = PKGS[name]
    err = {"jax": jerrors, "port": perrors}[name].InvalidArgumentError
    g = stf.Graph()
    with g.as_default():
        v = stf.get_variable("v", [B], initializer=stf.zeros_initializer())
        out = stf.scan(lambda a, x: a + stf.assign(v, x), stf.ones([T, B]),
                       initializer=stf.zeros([B]))
        init = stf.global_variables_initializer()
    with g.as_default(), stf.Session(
            config=stf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(init)
        with pytest.raises(err, match="assigned inside"):
            s.run(out)


def test_unported_control_flow_raises_naming_its_roadmap_item():
    # py_func is still unported; cond, while_loop and case now build their
    # ops (tests/test_torch_control_flow.py holds them to JAX)
    with pstf.Graph().as_default():
        x = pstf.constant(np.ones(3, np.float32))
        built = [
            pstf.cond(x[0] > 0, lambda: x, lambda: -x),
            pstf.while_loop(lambda i: i < 3, lambda i: i + 1, [0]),
            pstf.case([(x[0] > 0, lambda: x)], default=lambda: x)]
        assert [t.op.type for t in built] == ["Cond", "While", "Cond"]
        with pytest.raises(NotImplementedError, match="front-end item 2"):
            pstf.py_func(lambda a: a, [x], pstf.float32)


def test_a_loop_keeps_jax_structure_helpers():
    from simple_tensorflow_tpu.ops import control_flow_ops as jcf
    from simple_tensorflow_tpu_torch.ops import control_flow_ops as pcf

    Pair = collections.namedtuple("Pair", ("a", "b"))
    struct = ({"k": Pair(1, [2, 3])}, (4,))
    for cf in (jcf, pcf):
        flat = cf._flatten(struct)
        assert flat == [1, 2, 3, 4]
        back = cf._pack_like(struct, flat)
        assert back == struct and isinstance(back[0]["k"], Pair)
