"""``ops/control_flow_ops.py`` (``cond``, ``case``, ``while_loop``),
``ops/tensor_array_ops.py`` and ``ops/rnn.py``'s ``raw_rnn`` of the port
against the JAX package's, on the CPU. Every case of
``tests/test_control_flow.py``'s ``TestCond``, ``TestWhileLoop`` and
``TestRawRNN`` is built in one graph in each package (no graph seed), run
in a JAX Session and in two port Sessions from JAX's initial values: one
eager (``_capture`` off: predicates read on the host) and one that
captures (its CPU replay: the conditional-node lowering, a host loop over
the same buffers, and the guarded steps of a differentiated bounded
loop). For each feed of a case:

- values equal JAX's (exactly for integers and where the JAX test asks
  for exact numbers), gradients within rtol 1e-5;
- the graphs have JAX's op types, names and attrs, their branches and
  bodies JAX's ops;
- the raising cases raise JAX's exception types: a loop var whose shape
  or dtype changes, ``raw_rnn`` without ``maximum_iterations``, and a
  gradient through an unbounded ``while_loop`` (a path cut by
  ``stop_gradient`` or carrying only integers does not raise);
- a bounded loop whose body is NaN past its exit keeps a finite gradient
  (the body never runs there), eager and captured;
- ``TensorArray`` write/read/stack/scatter/gather/unstack, inside a loop
  and out;
- an unseeded ``Dropout`` in a ``cond`` branch and in a ``while_loop``
  body draws JAX's mask, the same one at every iteration;
- an eager run counts its host predicate reads, a captured one reads
  none.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.framework import errors as jerrors
from simple_tensorflow_tpu.ops import rnn as jrnn
from simple_tensorflow_tpu.ops import rnn_cell as jcell
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.framework import errors as perrors
from simple_tensorflow_tpu_torch.ops import rnn as prnn
from simple_tensorflow_tpu_torch.ops import rnn_cell as pcell

PKGS = {"jax": (jstf, jrnn, jcell, jerrors),
        "port": (pstf, prnn, pcell, perrors)}
RTOL = 1e-5
CPU = {"device_count": {"GPU": 0}}


def _build(name):
    """Every case's fetches, in a new graph: ``{case: fetch structure}``,
    the placeholders and the initializer."""
    stf, rnn, cell_mod, _ = PKGS[name]
    g = stf.Graph()
    f = {}
    with g.as_default():
        x = stf.placeholder(stf.float32, [], name="x")
        xi = stf.placeholder(stf.int32, [], name="xi")
        xv = stf.placeholder(stf.float32, [3], name="xv")

        # TestCond
        f["basic"] = stf.cond(stf.less(x, stf.constant(0.0)),
                              lambda: stf.square(x), lambda: x + 1.0)
        f["nested"] = stf.cond(
            stf.less(x, 0.0),
            lambda: stf.cond(stf.less(x, -10.0), lambda: stf.constant(-2.0),
                             lambda: stf.constant(-1.0)),
            lambda: stf.constant(1.0))
        c2 = stf.constant(2.0)
        a, b = stf.cond(stf.greater(c2, 0.0), lambda: (c2 + 1.0, c2 + 2.0),
                        lambda: (c2 - 1.0, c2 - 2.0))
        f["multi"] = {"a": a, "b": b}
        yc = stf.cond(stf.less(x, 0.0), lambda: stf.square(x),
                      lambda: x * 3.0)
        f["cond_grad"] = stf.gradients(yc, [x])[0]
        f["case"] = stf.case(
            [(stf.equal(xi, 1), lambda: stf.constant(10.0)),
             (stf.equal(xi, 2), lambda: stf.constant(20.0))],
            default=lambda: stf.constant(-1.0))

        # TestWhileLoop
        f["counter"] = stf.while_loop(lambda i: stf.less(i, 10),
                                      lambda i: i + 1, [stf.constant(0)])
        _, f["multi_vars"] = stf.while_loop(
            lambda i, a: stf.less(i, 5),
            lambda i, a: (i + 1, a + stf.cast(i, stf.float32)),
            [stf.constant(0), stf.constant(0.0)])
        f["vector"] = stf.while_loop(
            lambda v: stf.less(stf.reduce_sum(v), 100.0),
            lambda v: v * 2.0, [stf.constant([1.0, 1.0])])
        # a data-dependent trip count: doubling until past 50
        f["data_trips"] = stf.while_loop(
            lambda i, v: stf.less(v, 50.0),
            lambda i, v: (i + 1, v * 2.0), [stf.constant(0), x])

        # TestRawRNN
        T, B, D, H = 5, 3, 4, 6
        rng = np.random.RandomState(0)
        xrv = rng.rand(T, B, D).astype(np.float32)
        xc = stf.constant(xrv)
        seq_t = stf.constant(np.array([5, 3, 1], np.int32))
        cell = cell_mod.BasicRNNCell(H)

        def loop_fn(time, output, state, loop_state):
            finished = time >= seq_t
            nxt = cell.zero_state(B, stf.float32) if output is None \
                else state
            return (finished, stf.gather(xc, stf.minimum(time, T - 1)), nxt,
                    output, None)

        emit_ta, final_state, _ = rnn.raw_rnn(cell, loop_fn,
                                              maximum_iterations=T)
        out_ref, state_ref = rnn.dynamic_rnn(
            cell, stf.constant(xrv.transpose(1, 0, 2)),
            sequence_length=seq_t, dtype=stf.float32)
        f["raw_rnn"] = {"emit": emit_ta.stack(), "state": final_state,
                        "ref_out": out_ref, "ref_state": state_ref}

        _, y = stf.while_loop(lambda i, a: stf.less(i, 5),
                              lambda i, a: (i + 1, a * x),
                              [stf.constant(0), x], maximum_iterations=8)
        f["bounded_exact"] = {"y": y, "g": stf.gradients(y, [x])[0]}
        _, y = stf.while_loop(
            lambda i, a: stf.greater(a, 1.0),
            lambda i, a: (i + 1, stf.sqrt(a - 1.0)),
            [stf.constant(0), x], maximum_iterations=6)
        f["past_exit"] = {"y": y, "g": stf.gradients(y, [x])[0]}
        _, out = stf.while_loop(lambda i, v: stf.less(i, 4),
                                lambda i, v: (i + 1, stf.tanh(v) * 1.5),
                                [stf.constant(0), xv], maximum_iterations=6)
        yv = stf.reduce_sum(stf.square(out))
        f["bounded_numeric"] = {"y": yv, "g": stf.gradients(yv, [xv])[0]}

        cell2 = cell_mod.BasicRNNCell(3)
        xc2 = stf.constant(np.random.RandomState(0).randn(4, 2, 2)
                           .astype(np.float32))
        seq2 = stf.constant(np.array([4, 2], np.int32))

        def loop_fn2(time, output, state, loop_state):
            finished = time >= seq2
            st = cell2.zero_state(2, stf.float32) if output is None \
                else state
            return (finished, stf.gather(xc2, stf.minimum(time, 3)), st,
                    output, None)

        with stf.variable_scope("rnn2"):
            emit2, _, _ = rnn.raw_rnn(cell2, loop_fn2, maximum_iterations=4)
        loss2 = stf.reduce_mean(stf.square(emit2.stack()))
        tv2 = [v for v in stf.trainable_variables()
               if v.name.startswith("rnn2/")]
        f["raw_rnn_grad"] = stf.gradients(loss2, tv2)

        w = stf.Variable(np.float32(2.0), name="w")
        count = stf.while_loop(lambda i: stf.less(i, 3), lambda i: i + 1,
                               [stf.constant(0)])
        loss = w * w * stf.stop_gradient(stf.cast(count, stf.float32))
        f["cut_by_stop"] = stf.gradients(loss, [w])[0]
        wv = stf.Variable(np.arange(4, dtype=np.float32), name="wv")
        idx = stf.while_loop(lambda i: stf.less(i, 2), lambda i: i + 1,
                             [stf.constant(0)])
        f["integer_path"] = stf.gradients(stf.square(stf.gather(wv, idx)),
                                          [wv])[0]

        # TensorArray, outside a loop and carried by one
        ta = stf.TensorArray(stf.float32, size=4, element_shape=[2])
        ta = ta.write(1, stf.fill([2], x)).write(3, stf.constant([5.0, 6.0]))
        sc = ta.scatter(stf.constant([0, 2]), stf.constant([[1.0, 2.0],
                                                             [3.0, 4.0]]))
        un = stf.TensorArray(stf.float32, size=2,
                             element_shape=[1]).unstack(
            stf.constant([[7.0], [8.0]]))
        _, ta_loop = stf.while_loop(
            lambda i, buf: stf.less(i, 4),
            lambda i, buf: (i + 1, stf.TensorArray(
                stf.float32, size=4, _buffer=buf).write(
                    i, stf.fill([2], stf.cast(i, stf.float32) * x))._buffer),
            [stf.constant(0), stf.zeros([4, 2])])
        f["tensor_array"] = {
            "stack": ta.stack(), "read": ta.read(xi), "size": ta.size(),
            "scatter": sc.stack(), "gather": sc.gather(stf.constant([2, 0])),
            "unstack": un.read(1), "concat": sc.concat(),
            "loop": stf.TensorArray(stf.float32, size=4,
                                    _buffer=ta_loop).stack()}

        # unseeded Dropout in a branch and in a loop body
        ones = stf.ones([64])
        f["drop_cond"] = stf.cond(stf.greater(x, 0.0),
                                  lambda: stf.nn.dropout(ones, 0.5),
                                  lambda: ones * 0.0)
        _, f["drop_while"] = stf.while_loop(
            lambda i, acc: stf.less(i, 3),
            lambda i, acc: (i + 1, stf.concat(
                [acc[64:], stf.reshape(stf.nn.dropout(ones, 0.5), [64])],
                0)),
            [stf.constant(0), stf.zeros([192])])
        init = stf.global_variables_initializer()
    return g, {"x": x, "xi": xi, "xv": xv}, f, init


# case -> feeds ({placeholder key: value}) it runs with
FEEDS = {
    "basic": [{"x": -3.0}, {"x": 3.0}],
    "nested": [{"x": -20.0}, {"x": -5.0}, {"x": 5.0}],
    "multi": [{}],
    "cond_grad": [{"x": -4.0}, {"x": 4.0}],
    "case": [{"xi": 1}, {"xi": 2}, {"xi": 9}],
    "counter": [{}],
    "multi_vars": [{}],
    "vector": [{}],
    "data_trips": [{"x": 1.0}, {"x": 7.0}, {"x": 60.0}],
    "raw_rnn": [{}],
    "bounded_exact": [{"x": 2.0}],
    "past_exit": [{"x": 5.0}, {"x": 17.0}],
    "bounded_numeric": [{"xv": np.array([0.3, -0.7, 1.2], np.float32)}],
    "raw_rnn_grad": [{}],
    "cut_by_stop": [{}],
    "integer_path": [{}],
    "tensor_array": [{"x": 1.5, "xi": 3}, {"x": -2.0, "xi": 1}],
    "drop_cond": [{"x": 1.0}, {"x": -1.0}],
    "drop_while": [{}],
}


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _run_all(sess, phs, f):
    out = {}
    for case, feeds in FEEDS.items():
        out[case] = [sess.run(f[case], {phs[k]: v for k, v in fd.items()})
                     for fd in feeds]
    return out


@pytest.fixture(scope="module")
def runs():
    g, phs, f, init = _build("jax")
    with g.as_default(), jstf.Session(
            config=jstf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(init)
        state = _state(s)
        jax = _run_all(s, phs, f)
    out = {"jax": jax, "jax_graph": g}
    pg, pphs, pf, pinit = _build("port")
    out["port_graph"] = pg
    for mode in ("eager", "captured"):
        with pg.as_default(), pstf.Session(
                config=pstf.ConfigProto(**CPU)) as s:
            s._capture = mode == "captured"
            s.run(pinit)
            convert.load_session_variables(s, state)
            if s._capture:
                # a first pass warms every plan up; the second, from the
                # same RNG run counter, is all captured runs
                counter = s._run_counter
                _run_all(s, pphs, pf)
                s._run_counter = counter
            s.host_predicate_reads = 0
            out[mode] = _run_all(s, pphs, pf)
            out[mode + "_reads"] = s.host_predicate_reads
            out[mode + "_captures"] = s.captures
    return out


def _flat(v):
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in _flat(v[k])]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _flat(e)]
    return [np.asarray(v)]


def _close(got, want, exact=False):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact or a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=RTOL * max(np.abs(b).max(), 1))


EXACT = {"basic", "nested", "multi", "cond_grad", "case", "counter",
         "multi_vars", "vector", "data_trips", "bounded_exact",
         "cut_by_stop", "integer_path", "tensor_array", "drop_cond",
         "drop_while"}


@pytest.mark.parametrize("mode", ["eager", "captured"])
@pytest.mark.parametrize("case", sorted(FEEDS))
def test_values_and_gradients_match_jax(runs, case, mode):
    for got, want in zip(runs[mode][case], runs["jax"][case]):
        _close(got, want, exact=case in EXACT)


def test_the_reference_test_numbers(runs):
    p = runs["captured"]
    assert [float(v) for v in p["basic"]] == [9.0, 4.0]
    assert [float(v) for v in p["nested"]] == [-2.0, -1.0, 1.0]
    assert float(p["multi"][0]["a"]) == 3.0
    assert [float(v) for v in p["cond_grad"]] == [-8.0, 3.0]
    assert [float(v) for v in p["case"]] == [10.0, 20.0, -1.0]
    assert int(p["counter"][0]) == 10 and float(p["multi_vars"][0]) == 10.0
    assert p["vector"][0].tolist() == [64.0, 64.0]
    assert [int(v[0]) for v in p["data_trips"]] == [6, 3, 0]
    assert float(p["bounded_exact"][0]["y"]) == 64.0
    assert float(p["bounded_exact"][0]["g"]) == 6.0 * 2.0 ** 5
    assert float(p["past_exit"][0]["y"]) == 1.0
    np.testing.assert_allclose(float(p["past_exit"][0]["g"]), 0.125,
                               rtol=1e-5)
    assert float(p["cut_by_stop"][0]) == 4.0 * 3.0
    np.testing.assert_allclose(p["integer_path"][0], [0.0, 0.0, 4.0, 0.0])
    r = p["raw_rnn"][0]
    np.testing.assert_allclose(r["emit"], r["ref_out"].transpose(1, 0, 2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["state"], r["ref_state"], rtol=1e-5,
                               atol=1e-6)
    for gv in p["raw_rnn_grad"][0]:
        assert np.isfinite(gv).all() and np.abs(gv).sum() > 0
    assert np.isfinite(p["past_exit"][1]["g"])


def test_tensor_array_values(runs):
    t = runs["captured"]["tensor_array"][0]
    np.testing.assert_array_equal(
        t["stack"], [[0, 0], [1.5, 1.5], [0, 0], [5, 6]])
    np.testing.assert_array_equal(t["read"], [5, 6])
    assert int(t["size"]) == 4
    np.testing.assert_array_equal(t["scatter"],
                                  [[1, 2], [1.5, 1.5], [3, 4], [5, 6]])
    np.testing.assert_array_equal(t["gather"], [[3, 4], [1, 2]])
    np.testing.assert_array_equal(t["unstack"], [8])
    assert t["concat"].shape == (8,)
    np.testing.assert_array_equal(t["loop"],
                                  np.arange(4)[:, None] * [1.5, 1.5])


def test_a_body_dropout_keeps_one_mask(runs):
    for mode in ("eager", "captured"):
        d = runs[mode]["drop_while"][0].reshape(3, 64)
        assert 0 < (d[0] != 0).mean() < 1
        np.testing.assert_array_equal(d[1], d[0])
        np.testing.assert_array_equal(d[2], d[0])
        taken, untaken = runs[mode]["drop_cond"]
        assert 0 < (taken != 0).mean() < 1 and not untaken.any()


def test_eager_runs_read_predicates_and_captured_runs_do_not(runs):
    assert runs["eager_reads"] > 0
    assert runs["captured_reads"] == 0
    assert runs["eager_captures"] == 0
    assert runs["captured_captures"] >= len(FEEDS) - 1


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op.type, op.name, [t.name for t in op.inputs],
                    [(str(t.shape), t.dtype.name) for t in op.outputs],
                    {k: getattr(v, "name", v) for k, v in op.attrs.items()
                     if k in ("n_vars", "n_cond_caps", "max_iterations",
                              "n_true_caps", "depth", "axis", "dtype",
                              "multiples", "k")}))
        for attr in ("true_graph", "false_graph", "cond_graph",
                     "body_graph"):
            body = op.attrs.get(attr)
            if body is not None:
                out.append((attr, _signature(body),
                            [(a.name, b.name) for a, b in body.captures]))
    return out


def test_graphs_match_jax_op_for_op(runs):
    assert _signature(runs["port_graph"]) == _signature(runs["jax_graph"])
    types = [op.type for op in runs["port_graph"].get_operations()]
    assert types.count("While") >= 10 and types.count("Cond") >= 5


def _raises(name, build):
    stf = PKGS[name][0]
    with stf.Graph().as_default():
        with pytest.raises(Exception) as info:
            build(*PKGS[name])
    return type(info.value).__name__, str(info.value)


RAISING = {
    "shape_changes": lambda stf, rnn, cell, err: stf.while_loop(
        lambda v: stf.less(stf.reduce_sum(v), 5.0),
        lambda v: stf.concat([v, v], 0), [stf.constant([1.0])]),
    "dtype_changes": lambda stf, rnn, cell, err: stf.while_loop(
        lambda i: stf.less(i, 3), lambda i: stf.cast(i, stf.float32) + 1.0,
        [stf.constant(0)]),
    "raw_rnn_unbounded": lambda stf, rnn, cell, err: rnn.raw_rnn(
        cell.BasicRNNCell(2), lambda *a: None),
    "unbounded_gradient": lambda stf, rnn, cell, err: _unbounded(stf),
    "branch_dtypes": lambda stf, rnn, cell, err: stf.cond(
        stf.constant(True), lambda: stf.constant(1.0),
        lambda: stf.constant(1)),
}


def _unbounded(stf):
    x = stf.placeholder(stf.float32, [], name="x")
    _, y = stf.while_loop(lambda i, a: stf.less(i, 5),
                          lambda i, a: (i + 1, a * x),
                          [stf.constant(0), x])
    return stf.gradients(y, [x])


@pytest.mark.parametrize("case", sorted(RAISING))
def test_raising_cases_raise_jax_exception_types(case):
    jtype, jmsg = _raises("jax", RAISING[case])
    ptype, pmsg = _raises("port", RAISING[case])
    assert ptype == jtype
    if case in ("raw_rnn_unbounded", "unbounded_gradient"):
        assert "maximum_iterations" in pmsg and "maximum_iterations" in jmsg


def test_maximum_iterations_must_be_static():
    for stf in (jstf, pstf):
        with stf.Graph().as_default():
            m = stf.placeholder(stf.int32, [])
            with pytest.raises(ValueError, match="static"):
                stf.while_loop(lambda i: stf.less(i, 3), lambda i: i + 1,
                               [stf.constant(0)], maximum_iterations=m)


def test_smart_cond_folds_a_static_predicate():
    from simple_tensorflow_tpu_torch.ops import control_flow_ops as pcf

    with pstf.Graph().as_default() as g:
        assert float(pcf.smart_cond(True, lambda: 1.0, lambda: 2.0)) == 1.0
        out = pcf.smart_cond(pstf.placeholder(pstf.bool, []),
                             lambda: pstf.constant(1.0),
                             lambda: pstf.constant(2.0))
        assert out.op.type == "Cond"
        assert [op.type for op in g.get_operations()].count("Cond") == 1


@pytest.mark.parametrize("name", ["jax", "port"])
@pytest.mark.parametrize("where", ["cond", "while"])
def test_a_variable_assigned_in_a_branch_or_body_raises(name, where):
    stf, _, _, errors = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        v = stf.get_variable("v", [2], initializer=stf.zeros_initializer())
        x = stf.placeholder(stf.float32, [])
        if where == "cond":
            out = stf.cond(x > 0, lambda: stf.assign(v, stf.ones([2])),
                           lambda: v + 0.0)
        else:
            out = stf.while_loop(
                lambda i: i < 3,
                lambda i: i + stf.cast(stf.reduce_sum(stf.assign(
                    v, stf.ones([2]))), stf.int32), [stf.constant(0)])
        init = stf.global_variables_initializer()
    with g.as_default(), stf.Session(
            config=stf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(init)
        with pytest.raises(errors.InvalidArgumentError,
                           match="assigned inside"):
            s.run(out, {x: 1.0})
