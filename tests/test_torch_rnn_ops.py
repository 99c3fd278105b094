"""The op types, clip functions, RNN cells and RNN loops of the port's RNN
slice against the JAX package's, on the CPU: one graph built in each
package under graph seed 9, run once in a JAX Session and once in a port
Session from JAX's initial values (``convert.load_session_variables``).

- each new op type's values, and its gradient where it has one
  (``stf.gradients`` of one weighted sum over every output), within 1e-5:
  ``Select`` broadcasting a ``[B, 1]`` condition against ``[B, H]``,
  ``StridedSlice`` with shrinking, negative, stepped and reversed indices,
  ``newaxis`` and ``...``, ``BatchMatMul`` of rank 3 (with ``adj_y``),
  ``SequenceMask``, ``Concat``, ``ExpandDims``, ``ZerosLike``,
  ``OnesLike``, ``Maximum``, ``Sigmoid``, ``Sqrt``, ``Square``, ``Neg``,
  ``Less``, ``LessEqual``, ``Greater``, ``GreaterEqual``, ``LogicalNot``
  (the operators ``< <= > >= ~ -``), ``Softmax``, ``Reverse`` and
  ``ClipByValue``;
- ``clip_by_norm``, ``global_norm`` and ``clip_by_global_norm``;
- one step of every cell (``BasicRNNCell``, ``GRUCell``,
  ``BasicLSTMCell`` with tuple and concatenated state, ``MultiRNNCell``,
  ``DropoutWrapper`` (seeded) and ``ResidualWrapper``);
- ``dynamic_rnn`` with and without ``sequence_length`` (past a row's
  length its output is zero and its state frozen), ``static_rnn`` and
  ``bidirectional_dynamic_rnn``;
- the variables and their names are JAX's, the initial values bit-exact.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu_torch import convert

PKGS = {"jax": jstf, "port": pstf}
TOL = 1e-5
B, T, D, H = 3, 4, 5, 6
LENGTHS = np.array([4, 2, 1], np.int32)


def _feeds():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(B, H).astype(np.float32),
            "y": rng.randn(B, H).astype(np.float32),
            "seq": rng.randn(B, T, D).astype(np.float32),
            "a": rng.randn(B, T, D).astype(np.float32),
            "b": rng.randn(B, D, H).astype(np.float32),
            "lengths": LENGTHS}


def _ops(stf, x, y, seq, a, b, lengths):
    """Every new op type on the placeholders: ``{name: tensor}``."""
    cond = stf.less(stf.reduce_sum(x, axis=1, keepdims=True),
                    stf.constant(np.float32(0.0)))
    return {
        "select": stf.where(cond, x, y * 2.0),
        "idx": seq[1],
        "neg_idx": seq[:, -1],
        "reversed": seq[::-1],
        "stepped": seq[:, 1:4:2, ::-2],
        "ellipsis": seq[..., 0],
        "newaxis": seq[None, 0, ..., 1:],
        "strided": stf.strided_slice(seq, [0, 1, 0], [B, T, D], [1, 2, 1]),
        "bmm": stf.matmul(a, b),
        "bmm_adj": stf.matmul(a, a, transpose_b=True),
        "mask": stf.sequence_mask(lengths, T, dtype=stf.float32),
        "mask_bool": stf.cast(stf.sequence_mask(lengths, T), stf.int32),
        "concat": stf.concat([x, y, x], 1),
        "expand": stf.expand_dims(x, -1) * stf.expand_dims(y, 1),
        "zeros_like": stf.zeros_like(x) + y,
        "ones_like": stf.ones_like(x) * x,
        "maximum": stf.maximum(x, y),
        "sigmoid": stf.sigmoid(x),
        "sqrt": stf.sqrt(stf.square(x) + 1.0),
        "neg": -x,
        "less": stf.cast(x < y, stf.float32) * x,
        "compare": stf.cast(x <= y, stf.float32) + stf.cast(
            x > 0.5, stf.float32) * 2.0 + stf.cast(y >= 0.0, stf.float32)
        * 4.0 + stf.cast(~(x < y), stf.float32) * 8.0,
        "softmax": stf.nn.softmax(x * 3.0),
        "reverse": stf.reverse(seq, [1]),
        "clip_value": stf.clip_by_value(x, -0.5, 0.7),
        "clip_norm": stf.clip_by_norm(x, 1.5),
        "clip_norm_axis": stf.clip_by_norm(seq, 1.0, axes=[2]),
    }


def _build(stf):
    g = stf.Graph()
    out = {}
    rc = stf.nn.rnn_cell
    with g.as_default():
        stf.set_random_seed(9)
        x = stf.placeholder(stf.float32, [B, H], name="x")
        y = stf.placeholder(stf.float32, [B, H], name="y")
        seq = stf.placeholder(stf.float32, [B, T, D], name="seq")
        a = stf.placeholder(stf.float32, [B, T, D], name="a")
        b = stf.placeholder(stf.float32, [B, D, H], name="b")
        lengths = stf.placeholder(stf.int32, [B], name="lengths")
        out.update(_ops(stf, x, y, seq, a, b, lengths))
        gclip, gnorm = stf.clip_by_global_norm([x, y * 3.0], 2.0)
        out["gclip0"], out["gclip1"] = gclip
        out["gnorm"] = stf.global_norm([x, seq])
        inp = seq[:, 0]
        with stf.variable_scope("cells"):
            for name, cell, state in (
                    ("rnn", rc.BasicRNNCell(H), x),
                    ("gru", rc.GRUCell(H), x),
                    ("lstm", rc.BasicLSTMCell(H),
                     rc.LSTMStateTuple(x, y)),
                    ("lstm_concat", rc.BasicLSTMCell(H, state_is_tuple=False),
                     stf.concat([x, y], 1)),
                    ("residual", rc.ResidualWrapper(rc.BasicRNNCell(D)),
                     x[:, :D])):
                with stf.variable_scope(name):
                    o, s = cell(inp, state)
                out[f"cell_{name}"] = o
                for i, t in enumerate(_flat(s)):
                    out[f"cell_{name}_s{i}"] = t
            multi = rc.MultiRNNCell([
                rc.DropoutWrapper(rc.BasicLSTMCell(H), input_keep_prob=0.7,
                                  output_keep_prob=0.5, seed=21),
                rc.GRUCell(H)])
            with stf.variable_scope("multi"):
                o, (s0, s1) = multi(inp, (rc.LSTMStateTuple(x, y), x))
            out["cell_multi"], out["cell_multi_c"], out["cell_multi_h"], \
                out["cell_multi_s1"] = o, s0.c, s0.h, s1
        lstm = rc.BasicLSTMCell(H)
        o, s = stf.nn.dynamic_rnn(lstm, seq, dtype=stf.float32,
                                  scope="dyn")
        out["dyn"], out["dyn_c"], out["dyn_h"] = o, s.c, s.h
        o, s = stf.nn.dynamic_rnn(rc.GRUCell(H), seq, sequence_length=lengths,
                                  dtype=stf.float32, scope="dyn_len")
        out["dyn_len"], out["dyn_len_s"] = o, s
        outs, s = stf.nn.static_rnn(rc.BasicRNNCell(H),
                                    [seq[:, t] for t in range(T)],
                                    dtype=stf.float32, scope="static")
        out["static"] = stf.concat(outs, 1)
        out["static_s"] = s
        (fw, bw), (sf, sb) = stf.nn.bidirectional_dynamic_rnn(
            rc.BasicLSTMCell(H), rc.GRUCell(H), seq, dtype=stf.float32,
            scope="bi")
        out["bi_fw"], out["bi_bw"] = fw, bw
        out["bi_sf_h"], out["bi_sb"] = sf.h, sb
        w = np.random.RandomState(1)
        terms = [stf.reduce_sum(v * stf.constant(
            np.asarray(w.rand(*v.shape.as_list()), np.float32)))
            for k, v in sorted(out.items())
            if v.dtype.is_floating and k != "mask"]
        loss = stf.add_n(terms)
        tvars = stf.trainable_variables()
        wrt = [x, y, seq, a, b] + tvars
        grads = dict(zip(["x", "y", "seq", "a", "b"]
                         + [v.var_name for v in tvars],
                         stf.gradients(loss, wrt)))
        init = stf.global_variables_initializer()
    return g, dict(out=out, grads=grads, init=init, x=x, y=y, seq=seq, a=a,
                   b=b, lengths=lengths, names=[v.var_name for v in tvars])


def _flat(s):
    from simple_tensorflow_tpu_torch.ops.control_flow_ops import _flatten

    return _flatten(s)


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _run(name, init=None):
    stf = PKGS[name]
    g, m = _build(stf)
    feeds = {m[k]: v for k, v in _feeds().items()}
    with g.as_default(), stf.Session(
            config=stf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(m["init"])
        state0 = _state(s)
        if init is not None:
            convert.load_session_variables(s, init)
        got = s.run({"out": m["out"], "grads": m["grads"]}, feeds)
    return dict(got, state0=state0, names=m["names"],
                types={op.type for op in g.get_operations()})


@pytest.fixture(scope="module")
def runs():
    j = _run("jax")
    return j, _run("port", init=j["state0"])


def test_variables_and_init_match_jax(runs):
    j, p = runs
    assert p["names"] == j["names"]
    assert "dyn/basic_lstm_cell/linear/kernel" in p["names"]
    assert "cells/gru/gru_cell/gates/kernel" in p["names"]
    assert sorted(p["state0"]) == sorted(j["state0"])
    for k, v in j["state0"].items():
        np.testing.assert_array_equal(p["state0"][k], v, err_msg=k)
    assert {"Select", "StridedSlice", "BatchMatMul", "SequenceMask",
            "Concat", "ExpandDims", "ZerosLike", "OnesLike", "Maximum",
            "Sigmoid", "Sqrt", "Square", "Neg", "Less", "LessEqual",
            "Greater", "GreaterEqual", "LogicalNot", "Softmax",
            "Reverse", "ClipByValue", "Scan", "Dropout"} <= p["types"]
    assert p["types"] == j["types"]


def _op_names():
    with pstf.Graph().as_default():
        return sorted(_ops(pstf, *[pstf.placeholder(pstf.float32, [B, H])] * 2,
                           *[pstf.placeholder(pstf.float32, [B, T, D])] * 2,
                           pstf.placeholder(pstf.float32, [B, D, H]),
                           pstf.placeholder(pstf.int32, [B])))


OPS = _op_names() + ["gclip0", "gclip1", "gnorm"]
CELLS = ["cell_rnn", "cell_gru", "cell_lstm", "cell_lstm_s0",
         "cell_lstm_s1", "cell_lstm_concat", "cell_lstm_concat_s0",
         "cell_residual", "cell_multi", "cell_multi_c", "cell_multi_h",
         "cell_multi_s1"]
LOOPS = ["dyn", "dyn_c", "dyn_h", "dyn_len", "dyn_len_s", "static",
         "static_s", "bi_fw", "bi_bw", "bi_sf_h", "bi_sb"]


@pytest.mark.parametrize("name", OPS + CELLS + LOOPS)
def test_values_match_jax(runs, name):
    j, p = runs
    jv, pv = j["out"][name], p["out"][name]
    assert pv.shape == jv.shape and pv.dtype == jv.dtype, name
    if not np.issubdtype(jv.dtype, np.floating):
        np.testing.assert_array_equal(pv, jv)
    else:
        np.testing.assert_allclose(pv, jv, rtol=TOL, atol=TOL)


def test_sequence_length_masks_and_freezes(runs):
    _, p = runs
    out, st = p["out"]["dyn_len"], p["out"]["dyn_len_s"]
    for i, n in enumerate(LENGTHS):
        assert not out[i, n:].any()
        np.testing.assert_array_equal(st[i], out[i, n - 1])
    np.testing.assert_array_equal(p["out"]["mask"],
                                  np.arange(T)[None] < LENGTHS[:, None])


def test_gradients_match_jax(runs):
    j, p = runs
    assert sorted(p["grads"]) == sorted(j["grads"])
    for k, jg in j["grads"].items():
        pg = p["grads"][k]
        assert pg.shape == jg.shape, k
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL * scale,
                                   err_msg=k)
    # every variable of every cell and loop takes a gradient
    assert all(np.abs(j["grads"][k]).max() > 0 for k in j["names"])
