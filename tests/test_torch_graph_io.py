"""Meta-graph I/O of the port against the JAX package's, on the CPU
(``framework/graph_io.py``, ``Variable.to_proto``/``from_proto``,
``Saver.save``'s ``.meta``, ``train.import_meta_graph``).

- a meta graph the JAX package exported (a small dense net: two
  ``layers.dense``, ``nn.dropout`` through a fed keep_prob, sparse
  softmax cross entropy, Adam and ``global_step``, f32) imports into the
  port, restores the JAX checkpoint and trains 3 steps to JAX's losses
  (rtol 1e-5);
- a meta graph the port's ``Saver`` wrote imports into the JAX package,
  restores and trains 3 steps to the port's losses (rtol 1e-5);
- a ``.meta`` written by the port's ``Saver`` round-trips through
  ``import_meta_graph`` and ``restore`` into a fresh graph that trains on
  bit for bit like the original;
- ``import_graph_def`` under a prefix keeps an imported variable apart
  from the graph's own, ``write_graph`` writes JSON either package reads,
  and a graph function's body survives the trip.
"""

import json
import os

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.framework import graph_io as jgraph_io
from simple_tensorflow_tpu_torch import checkpoint as pckpt
from simple_tensorflow_tpu_torch.framework import graph_io as pgraph_io

PKGS = {"jax": (jstf,), "port": (pstf,)}
LOSS_RTOL = 1e-5
STEPS = 3
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _stop_the_port_writer():
    yield
    pckpt.wait_until_finished(timeout=10.0)
    assert pckpt.shutdown_writer(timeout=5.0)


def _session(name, graph):
    stf = PKGS[name][0]
    kw = {"device_count": {"GPU": 0}} if name == "port" else {}
    return stf.Session(graph=graph, config=stf.ConfigProto(**kw))


def _batch():
    rng = np.random.RandomState(1)
    return (rng.standard_normal((16, 24)).astype(np.float32),
            rng.randint(0, 5, 16).astype(np.int32))


def _model(stf):
    x = stf.placeholder(stf.float32, [None, 24], name="x")
    y_ = stf.placeholder(stf.int32, [None], name="y_")
    keep_prob = stf.placeholder_with_default(stf.constant(1.0), [],
                                             name="keep_prob")
    with stf.variable_scope("net"):
        h = stf.layers.dense(x, 32, activation=stf.nn.relu, name="fc1")
        h = stf.nn.dropout(h, keep_prob=keep_prob)
        logits = stf.layers.dense(h, 5, name="fc2")
    loss = stf.reduce_mean(stf.nn.sparse_softmax_cross_entropy_with_logits(
        labels=y_, logits=logits))
    gs = stf.train.get_or_create_global_step()
    train_op = stf.train.AdamOptimizer(1e-2).minimize(loss, global_step=gs)
    return {"x": x, "y_": y_, "keep_prob": keep_prob, "loss": loss,
            "train_op": train_op}


def _feeds(g, names):
    x, y = _batch()
    return {g.get_tensor_by_name(names["x"]): x,
            g.get_tensor_by_name(names["y_"]): y,
            g.get_tensor_by_name(names["keep_prob"]): 0.5}


def _train(sess, g, names, steps=STEPS):
    loss = g.get_tensor_by_name(names["loss"])
    train = g.get_operation_by_name(names["train_op"])
    feeds = _feeds(g, names)
    return [float(sess.run([loss, train], feeds)[0]) for _ in range(steps)]


def _exported(name, directory):
    """:func:`_model` built, initialized and saved with its meta graph by
    one package: ``(checkpoint prefix, tensor names, losses of STEPS steps
    from the checkpoint)``."""
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(SEED)
        m = _model(stf)
        init = stf.global_variables_initializer()
        saver = stf.train.Saver()
    names = {k: m[k].name for k in ("x", "y_", "keep_prob", "loss",
                                    "train_op")}
    with g.as_default(), _session(name, g) as sess:
        sess.run(init)
        prefix = saver.save(sess, os.path.join(directory, "model.ckpt"),
                            global_step=0)
        losses = _train(sess, g, names)
    assert os.path.exists(prefix + ".meta")
    return prefix, names, losses


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return {name: _exported(name, str(tmp_path_factory.mktemp(name)))
            for name in PKGS}


def _imported_losses(name, prefix, names):
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(SEED)
        saver = stf.train.import_meta_graph(prefix + ".meta")
    with g.as_default(), _session(name, g) as sess:
        saver.restore(sess, prefix)
        return _train(sess, g, names)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_meta_graph_crosses_to_the_other_package(exported, writer):
    reader = "port" if writer == "jax" else "jax"
    prefix, names, losses = exported[writer]
    got = _imported_losses(reader, prefix, names)
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_a_saver_meta_round_trips_bit_for_bit(exported):
    prefix, names, losses = exported["port"]
    assert _imported_losses("port", prefix, names) == losses
    meta = json.load(open(prefix + ".meta"))
    assert {"graph_def", "collections", "meta_info"} <= set(meta)
    protos = [it["proto"] for it in meta["collections"]["variables"]]
    assert all(set(p) == {"variable_name", "initial_value_name",
                          "initializer_name", "snapshot_name",
                          "trainable"} for p in protos)


def test_imported_variables_rebind_to_the_imported_ops(exported):
    prefix, _, _ = exported["jax"]
    g = pstf.Graph()
    with g.as_default():
        pstf.train.import_meta_graph(prefix + ".meta")
        gvars = pstf.global_variables()
        tvars = pstf.trainable_variables()
    assert gvars and set(tvars) <= set(gvars)
    for v in gvars:
        assert v.graph is g and v.op.graph is g
        assert v.initializer.type == "Assign"
        assert v.value().op.type == "ReadVariable"
    assert len({v.var_name for v in gvars}) == len(gvars)


def test_scoped_import_keeps_variables_apart(tmp_path):
    g = pstf.Graph()
    with g.as_default():
        w = pstf.Variable(np.arange(3, dtype=np.float32), name="w")
        y = pstf.multiply(w, 2.0, name="y")
    gd = pgraph_io.graph_to_graphdef(g)
    path = pgraph_io.write_graph(g, str(tmp_path), "g.json")
    assert json.load(open(path)) == json.loads(json.dumps(gd))
    with g.as_default():
        y2, = pgraph_io.import_graph_def(gd, name="copy",
                                         return_elements=["y:0"])
        init = pstf.global_variables_initializer()
        init2 = g.get_operation_by_name("copy/w/Assign/Assign")
    assert y2.name == "copy/y:0"
    with g.as_default(), _session("port", g) as sess:
        sess.run([init, init2])
        sess.run(pstf.assign(w, [5.0, 5.0, 5.0]))
        np.testing.assert_array_equal(sess.run(y), [10, 10, 10])
        np.testing.assert_array_equal(sess.run(y2), [0, 2, 4])
    jg = jstf.Graph()
    with jg.as_default():
        jgraph_io.import_graph_def(json.load(open(path)), name="")
    assert [op.name for op in jg.get_operations()] == \
        [op.name for op in g.get_operations()[:len(gd["node"])]]


def test_a_graph_function_body_survives_the_trip():
    g = pstf.Graph()
    with g.as_default():
        x = pstf.placeholder(pstf.float32, [3], name="x")

        @pstf.Defun(pstf.float32)
        def cube_plus_one(t):
            return t * t * t + 1.0

        y = pstf.identity(cube_plus_one(x), name="y")
    meta = pgraph_io.export_meta_graph(graph=g)
    kinds = {v.get("__kind__") for n in meta["graph_def"]["node"]
             for v in n["attr"].values() if isinstance(v, dict)}
    assert "funcgraph" in kinds
    g2 = pstf.Graph()
    with g2.as_default():
        pgraph_io.import_meta_graph(json.loads(json.dumps(meta)))
    xs = np.array([1.0, -2.0, 0.5], np.float32)
    with g2.as_default(), _session("port", g2) as sess:
        np.testing.assert_allclose(
            sess.run("y:0", {"x:0": xs}), xs ** 3 + 1, rtol=1e-6)


def test_an_unchanged_graph_writes_its_meta_graph_once(tmp_path):
    """A Saver links the ``.meta`` of an unchanged graph to the one it
    wrote last; a graph that grew gets a new export."""
    g = pstf.Graph()
    with g.as_default():
        w = pstf.Variable(np.arange(4, dtype=np.float32), name="w")
        init = pstf.global_variables_initializer()
        saver = pstf.train.Saver(max_to_keep=3)
    with g.as_default(), _session("port", g) as sess:
        sess.run(init)
        p1 = saver.save(sess, str(tmp_path / "m"), global_step=1)
        p2 = saver.save(sess, str(tmp_path / "m"), global_step=2)
        assert os.path.samefile(p1 + ".meta", p2 + ".meta")
        with g.as_default():
            pstf.multiply(w, 2.0, name="twice")
        p3 = saver.save(sess, str(tmp_path / "m"), global_step=3)
    assert not os.path.samefile(p2 + ".meta", p3 + ".meta")
    ops = [n["name"] for n in json.load(open(p3 + ".meta"))["graph_def"][
        "node"]]
    assert "twice" in ops and "twice" not in [
        n["name"] for n in json.load(open(p1 + ".meta"))["graph_def"]["node"]]
    assert pgraph_io.export_meta_graph(str(tmp_path / "x.meta"),
                                       graph=g) is None
    assert json.load(open(tmp_path / "x.meta")) == \
        json.loads(json.dumps(pgraph_io.export_meta_graph(graph=g)))
