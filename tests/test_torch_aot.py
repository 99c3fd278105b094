"""Compiled Session steps of the port (``Session.plan``,
``ExecutionPlan.execute``/``compile``/``compiled_buckets``,
``make_callable``) on the CPU, against the port's eager path and the JAX
package's Session on the same user code.

On the CPU a compiled step is the same ``StepExecutable`` as on the card
(static feed, key and fetch buffers, the end-of-run commit into the
store's tensors, the invalidation by store version) whose replay runs the
op list eagerly into those buffers, so everything but the
``torch.cuda.CUDAGraph`` itself is checked here. Compiled against eager
is bit for bit (the same ops in the same order on the same values). The
port against JAX: the initializer run bit-exact, losses within rtol
1e-5, every variable and Adam slot within relative norm 1e-4, the
Dropout masks equal where both ReLUs are live (``test_torch_mnist.py``
states why those tolerances).
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import mnist as jmnist
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.framework import errors as perrors
from simple_tensorflow_tpu_torch.models import mnist as pmnist
from simple_tensorflow_tpu_torch.ops.kernels import common as kcommon
from torch_threads import one_torch_thread  # noqa: F401

BATCH = 4
STEPS = 4
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4


def cpu_session(stf, graph=None, **kw):
    return stf.Session(graph=graph, config=stf.ConfigProto(
        device_count={"GPU": 0}, **kw))


def _state(sess):
    return {k: np.array(v) for k, v in sess._variable_store.values.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _data():
    x, labels, onehot = jmnist.synthetic_mnist(BATCH, seed=0)
    return x, labels.astype(np.int32), onehot


def _model(stf, mn, which):
    """``(graph, model dict, fetches, feed tensors, feed values)``."""
    g = stf.Graph()
    x, labels, onehot = _data()
    with g.as_default():
        stf.set_random_seed(5)
        if which == "convnet":
            m = mn.convnet_model()
            fetch = {"train": m["train_op"], "loss": m["loss"],
                     "drop": "convnet/dropout:0",
                     "relu": "convnet/fc1/Relu:0"}
            feed_ts = [m["x"], m["y_"], m["keep_prob"]]
            values = [x.reshape(-1, 28, 28, 1), labels, np.float32(0.5)]
        else:
            m = mn.softmax_model(learning_rate=0.05)
            fetch = {"train": m["train_op"], "loss": m["loss"],
                     "correct": "Equal:0"}
            feed_ts = [m["x"], m["y_"]]
            values = [x, onehot]
        m["init"] = stf.global_variables_initializer()
    return g, m, fetch, feed_ts, values


def _port_runs(which):
    """The port's steps three ways, each in its own session from its own
    initializer run: eager (``_capture`` off), ``Session.plan`` +
    ``compile`` + ``execute``, and ``make_callable``."""
    g, m, fetch, feed_ts, values = _model(pstf, pmnist, which)
    feeds = dict(zip(feed_ts, values))
    out = {}
    with g.as_default():
        s = cpu_session(pstf, g)
        s._capture = False
        s.run(m["init"])
        init = _state(s)
        out["eager"] = ([s.run(fetch, feeds) for _ in range(STEPS)],
                        _state(s), s.captures)
        s.close()

        s = cpu_session(pstf, g)
        s.run(m["init"])
        plan = s.plan(fetch, feeds=feed_ts)
        assert plan.compiled_buckets() == []
        kp = {feed_ts[2]: values[2]} if which == "convnet" else None
        exe = plan.compile(feed_dict=kp, feed_shapes={
            t: np.shape(v) for t, v in zip(feed_ts[:2], values)})
        assert exe.graph is not None and exe.launches == {}
        assert len(plan.compiled_buckets()) == 1
        out["compiled"] = ([plan.execute(feeds) for _ in range(STEPS)],
                           _state(s), s.captures)
        assert plan.device_op_count > 10
        s.close()

        s = cpu_session(pstf, g)
        s.run(m["init"])
        call = s.make_callable(fetch, feed_ts)
        out["callable"] = ([call(*values) for _ in range(STEPS)],
                           _state(s), s.captures)
        s.close()
    return init, out


def _jax_runs(which):
    g, m, fetch, feed_ts, values = _model(jstf, jmnist, which)
    with g.as_default(), cpu_session(jstf, g) as s:
        s.run(m["init"])
        init = _state(s)
        plan = s.plan(fetch, feeds=feed_ts)
        steps = [plan.execute(dict(zip(feed_ts, values)))
                 for _ in range(STEPS)]
        return init, steps, _state(s)


@pytest.mark.parametrize("which", ["softmax", "convnet"])
def test_compiled_steps_match_eager_and_jax(which):
    init, port = _port_runs(which)
    jinit, jsteps, jstate = _jax_runs(which)
    assert sorted(init) == sorted(jinit)
    for k in jinit:
        np.testing.assert_array_equal(init[k], jinit[k], err_msg=k)
    esteps, estate, ecaptures = port["eager"]
    assert ecaptures == 0
    # compile() captured once; make_callable warms up, then captures
    assert port["compiled"][2] == port["callable"][2] == 1
    for how in ("compiled", "callable"):
        steps, state, _ = port[how]
        for a, b in zip(steps, esteps):
            assert a.keys() == b.keys() and a["train"] is None
            for k in a:
                if k != "train":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert sorted(state) == sorted(estate)
        for k in estate:
            np.testing.assert_array_equal(state[k], estate[k], err_msg=k)
    for a, b in zip(esteps, jsteps):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        if which == "convnet":
            live = (a["relu"] != 0) & (b["relu"] != 0)
            assert live.sum() > 0.2 * live.size
            np.testing.assert_array_equal((a["drop"] != 0)[live],
                                          (b["drop"] != 0)[live])
        else:
            np.testing.assert_array_equal(a["correct"], b["correct"])
    for k in jstate:
        assert _rel(estate[k], jstate[k]) <= STATE_RTOL, k


def _dropout_graph(stf):
    x = stf.placeholder(stf.float32, [None, 64], name="x")
    kp = stf.placeholder(stf.float32, [], name="kp")
    return x, kp, stf.nn.dropout(x, kp)


def test_keys_are_refreshed_on_every_replay():
    """Every replay draws with its own run counter's key, as the eager
    path and the JAX session do; a replay whose key buffer is not
    refilled repeats the previous step's mask (the planted fault the
    smoke checks on the card)."""
    x = np.random.RandomState(1).rand(16, 64).astype(np.float32) + 0.5
    got = {}
    for name, stf in (("jax", jstf), ("port", pstf)):
        with stf.Graph().as_default():
            xt, kp, y = _dropout_graph(stf)
            with cpu_session(stf) as s:
                got[name] = [s.run(y, {xt: x, kp: 0.5}) for _ in range(5)]
                if name == "port":
                    assert s.captures == 1
                    s._refresh_keys = False
                    stale = [s.run(y, {xt: x, kp: 0.5}) for _ in range(2)]
    masks = [m != 0 for m in got["port"]]
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)
    assert all(not np.array_equal(a, b) for a, b in zip(masks, masks[1:]))
    # without the refill the key buffer still holds step 5's key
    np.testing.assert_array_equal(stale[0], got["port"][-1])
    np.testing.assert_array_equal(stale[1], got["port"][-1])


def test_keep_prob_and_feed_shape_key_the_executables():
    """A fed keep_prob is read on the host, so each value gets its own
    executable; a new feed shape is a new bucket."""
    rng = np.random.RandomState(2)
    with pstf.Graph().as_default():
        xt, kp, y = _dropout_graph(pstf)
        with cpu_session(pstf) as s:
            plan = s.plan(y, feeds=[xt, kp])
            for kpv in (0.5, 0.5, 1.0, 1.0, 0.5):
                plan.execute({xt: rng.rand(8, 64), kp: kpv})
            assert s.captures == 2
            assert len(plan.compiled_buckets()) == 1
            assert sorted(k[1] for k in plan._plan.executables) == [
                (0.5,), (1.0,)]
            for _ in range(2):
                s.run(y, {xt: rng.rand(3, 64), kp: 0.5})
            assert s.captures == 3
            assert [sig[1][1] for sig in plan.compiled_buckets()] == [
                (3, 64), (8, 64)]
            assert s.plan_cache_misses == 1
            with pytest.raises(perrors.InvalidArgumentError,
                               match="feeds must match"):
                plan.execute({xt: rng.rand(8, 64)})


def test_store_load_forces_a_recapture():
    """A load replaces a store tensor (a new address): the executable
    captured before it is never replayed; the next run warms up again and
    the one after re-captures, with the eager session's values."""
    rng = np.random.RandomState(3)
    xs = [rng.rand(2, 3).astype(np.float32) for _ in range(7)]
    new_w = rng.rand(3, 1).astype(np.float32)
    got = {}
    for capture in (True, False):
        with pstf.Graph().as_default():
            x = pstf.placeholder(pstf.float32, [None, 3], name="x")
            w = pstf.Variable(pstf.constant([[1.0], [0.5], [-1.0]]), name="w")
            y = pstf.matmul(x, w)
            loss = pstf.reduce_sum(y * y)
            train = pstf.train.GradientDescentOptimizer(0.1).minimize(loss)
            with cpu_session(pstf) as s:
                s._capture = capture
                s.run(pstf.global_variables_initializer())
                out = [s.run([train, loss], {x: v})[1] for v in xs[:3]]
                version = s._variable_store.version
                convert.load_session_variables(s, {"w": new_w})
                assert s._variable_store.version > version
                out += [s.run([train, loss], {x: v})[1] for v in xs[3:]]
                got[capture] = (out, s.run(w), s.captures)
    assert got[True][2] == 2 and got[False][2] == 0
    np.testing.assert_array_equal(got[True][0], got[False][0])
    np.testing.assert_array_equal(got[True][1], got[False][1])


def test_a_load_after_the_warm_up_warms_up_again():
    """A load between a key's warm-up and its capture (here after run 1)
    moves the store's tensors, and the fused update would have to rebuild
    its flat buffer inside the capture: the run after the load warms up
    again instead, the one after captures, with the eager session's
    values."""
    rng = np.random.RandomState(4)
    xs = [rng.rand(2, 3).astype(np.float32) for _ in range(5)]
    new_w = rng.rand(3, 1).astype(np.float32)
    got = {}
    for capture in (True, False):
        with pstf.Graph().as_default():
            x = pstf.placeholder(pstf.float32, [2, 3], name="x")
            w = pstf.Variable(pstf.constant([[1.0], [0.5], [-1.0]]), name="w")
            loss = pstf.reduce_sum(pstf.matmul(x, w) ** 2.0)
            train = pstf.train.MomentumOptimizer(0.1, 0.9).minimize(loss)
            with cpu_session(pstf) as s:
                s._capture = capture
                s.run(pstf.global_variables_initializer())
                out = [s.run([train, loss], {x: xs[0]})[1]]
                convert.load_session_variables(s, {"w": new_w})
                out += [s.run([train, loss], {x: v})[1] for v in xs[1:]]
                got[capture] = (out, s.run(w), s.captures)
    assert got[True][2] == 1 and got[False][2] == 0
    np.testing.assert_array_equal(got[True][0], got[False][0])
    np.testing.assert_array_equal(got[True][1], got[False][1])


def test_launch_accounting_moves_capture_counts_to_replays():
    """A capture's launches come off the global counters onto the graph;
    each replay adds them back."""
    before = kcommon.launch_counts()
    kcommon.count_launch("adam_update")
    kcommon.count_launch("adam_update")
    kcommon.count_launch("dropout_device_key")
    taken = kcommon.take_launches(before)
    assert taken == {"adam_update": 2, "dropout_device_key": 1}
    assert kcommon.launch_counts() == before
    for _ in range(3):
        kcommon.add_launches(taken)
    after = kcommon.launch_counts()
    assert after["adam_update"] == before["adam_update"] + 6
    assert after["dropout_device_key"] == before["dropout_device_key"] + 3
    kcommon.reset_launch_counts()


def _ordered_read_graph(stf):
    w = stf.Variable(stf.constant([1.0, 2.0]), name="w")
    r = w.read_value()
    with stf.control_dependencies([r]):
        up = stf.assign_add(w, stf.constant([10.0, 20.0]))
    return w, r, up


def test_fetched_read_before_an_ordered_assign_keeps_its_value():
    """``run([r, up])`` with the read ordered before the assign: the
    fetched read is the value before the write, in every run (the
    end-of-run commit copies into the store tensor the read returned, so
    the fetch is preserved), as in the JAX package."""
    got = {}
    for name, stf in (("jax", jstf), ("port", pstf)):
        with stf.Graph().as_default():
            w, r, up = _ordered_read_graph(stf)
            with cpu_session(stf) as s:
                s.run(stf.global_variables_initializer())
                got[name] = [s.run([r, up]) for _ in range(4)]
                got[name].append(s.run(w))
                if name == "port":
                    assert s.captures == 1
    for a, b in zip(got["port"][:-1], got["jax"][:-1]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(got["port"][-1], got["jax"][-1])
    np.testing.assert_array_equal(got["port"][-1], [41.0, 82.0])
