"""The input pipeline through the port's ``stf.Session``, on the CPU,
against the JAX package's:

- ``examples/train_mnist_end_to_end.py``'s graph (``get_next()`` of a
  TFRecord pipeline feeding a convnet, Adam): the JAX Session's losses and
  the port's, from the same state at each of 3 steps (JAX's state loaded
  before each port step: Adam's first steps turn roundoff into lr-sized
  moves, so free runs part after a step), within rtol 1e-5; the first
  free step too; a captured step (the host stage outside the replay)
  equal to an eager one bit for bit;
- a device op reading a post-host output raises JAX's
  ``InvalidArgumentError``;
- a ``run_steps`` window over ``IteratorGetNext`` falls back with JAX's
  ``host_stage_op`` reason and equals sequential runs;
- tiny BERT fed superbatches by ``prefetch_to_device(superbatch=4,
  device="cpu")`` through ``run_steps(stacked_feeds=)`` (one window each)
  equals per-step numpy feeds bit for bit;
- iterator positions cross the packages in ``train.Saver`` checkpoints
  both ways, aligned by creation order;
- ``MonitoredTrainingSession`` over the journey's graph, stopped and
  resumed from its checkpoint, resumes at the saved step and position
  and continues with the uninterrupted run's losses bit for bit;
- an initializable iterator: ``FailedPreconditionError`` before its
  initializer runs, the stream from its start after each run of it,
  ``OutOfRangeError`` at its end, in both packages.
"""

import importlib.util
import os

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.platform import monitoring as jmonitoring
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import bert as pbert
from simple_tensorflow_tpu_torch.models import mnist as pmnist
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _stop_the_port_writer():
    """The port's ``stf_ckpt_writer`` thread (its async saves) drained and
    stopped when the module ends."""
    yield
    from simple_tensorflow_tpu_torch import checkpoint as port_ckpt

    port_ckpt.wait_until_finished(timeout=10.0)
    assert port_ckpt.shutdown_writer(timeout=5.0)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16
STEPS = 3


def _example_module():
    spec = importlib.util.spec_from_file_location(
        "train_mnist_end_to_end",
        os.path.join(ROOT, "examples", "train_mnist_end_to_end.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example_module()


def cpu_config(stf, **kw):
    return stf.ConfigProto(device_count={"GPU": 0}, **kw)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist")
    _, _, files = pmnist.write_records(str(d / "train.tfrecord"), n=128)
    return files


def _jax_graph(files):
    g = jstf.Graph()
    with g.as_default():
        jstf.set_random_seed(42)
        it = EX.input_pipeline(files, BATCH)
        feats = it.get_next()
        _, loss = EX.model(feats["image"],
                           jstf.cast(feats["label"], jstf.int32))
        gs = jstf.train.get_or_create_global_step()
        train = jstf.train.AdamOptimizer(1e-3).minimize(loss, global_step=gs)
        init = jstf.global_variables_initializer()
    return g, it, loss, train, init


def _port_graph(files):
    g = pstf.Graph()
    with g.as_default():
        pstf.set_random_seed(42)
        m = pmnist.records_model(files, BATCH, device="cpu")
        init = pstf.global_variables_initializer()
    return g, m, init


def _store(sess):
    return {k: np.array(v) for k, v in sess._variable_store.values.items()}


def test_mnist_journey_graph_matches_jax(shards):
    g, it, loss, train, init = _jax_graph(shards)
    jlosses, jstates = [], []
    with jstf.Session(graph=g) as s:
        s.run(init)
        for _ in range(STEPS):
            jstates.append({k: np.asarray(v) for k, v in
                            s._variable_store.values.items()})
            jlosses.append(float(s.run([train, loss])[1]))
    it.close()
    pg, m, pinit = _port_graph(shards)
    with pstf.Session(graph=pg, config=cpu_config(pstf)) as s:
        s.run(pinit)
        first = _store(s)
        for k, v in jstates[0].items():
            np.testing.assert_array_equal(first[k], v, err_msg=k)
        for i in range(STEPS):
            convert.load_session_variables(s, jstates[i])
            got = float(s.run([m["train_op"], m["loss"]])[1])
            np.testing.assert_allclose(got, jlosses[i], rtol=1e-5)
        assert s.snapshot_host_state()["iterators"] == {
            m["iterator"].name: {"position": STEPS}}
    m["iterator"].close()


def _port_losses(files, capture, steps=4):
    pg, m, init = _port_graph(files)
    with pstf.Session(graph=pg, config=cpu_config(pstf)) as s:
        s._capture = capture
        s.run(init)
        losses = [s.run([m["train_op"], m["loss"]])[1]
                  for _ in range(steps)]
        out = (losses, _store(s), s.captures)
    m["iterator"].close()
    return out


def test_captured_get_next_steps_equal_eager_ones(shards):
    graph, eager = _port_losses(shards, True), _port_losses(shards, False)
    assert graph[2] >= 1 and eager[2] == 0
    assert [float(v) for v in graph[0]] == [float(v) for v in eager[0]]
    assert graph[0][-1] < graph[0][0]
    for k, v in eager[1].items():
        np.testing.assert_array_equal(graph[1][k], v, err_msg=k)


def _post_host_read(stf):
    g = stf.Graph()
    with g.as_default():
        x = stf.placeholder(stf.float32, [3], name="x")
        po = stf.parsing_ops
        back = po.parse_tensor(po.serialize_tensor(x * 2.0), stf.float32)
        y = stf.identity(back) + 1.0
    return g, x, y


@pytest.mark.parametrize("name", ["jax", "port"])
def test_a_device_op_reading_a_post_host_output_raises(name):
    stf, errors = {"jax": (jstf, jstf.errors),
                   "port": (pstf, pstf.errors)}[name]
    g, x, y = _post_host_read(stf)
    kw = {"config": cpu_config(stf)} if name == "port" else {}
    with stf.Session(graph=g, **kw) as s:
        with pytest.raises(errors.InvalidArgumentError,
                           match="consumes output of host sink op"):
            s.run(y, {x: np.ones(3, np.float32)})


def _fallback_count():
    m = jmonitoring.get_metric("/stf/session/loop_fusion_fallbacks")
    return m.snapshot()["cells"].get("host_stage_op", 0) if m else 0


def test_a_run_steps_window_over_get_next_falls_back_as_jax(shards):
    g, it, loss, train, init = _jax_graph(shards)
    before = _fallback_count()
    with jstf.Session(graph=g) as s:
        s.run(init)
        s.run_steps([train, loss], 3)
    it.close()
    assert _fallback_count() - before == 1
    pg, m, pinit = _port_graph(shards)
    with pstf.Session(graph=pg, config=cpu_config(pstf)) as s:
        s.run(pinit)
        out = s.run_steps([m["train_op"], m["loss"]], 3,
                          output_mode="stacked")
        assert s.loop_fusion_fallbacks == {"host_stage_op": 1}
        assert s.fused_steps == 0
        state = _store(s)
    m["iterator"].close()
    losses, ref_state, _ = _port_losses(shards, True, steps=3)
    assert [float(v) for v in out[1]] == [float(v) for v in losses]
    for k, v in ref_state.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)


B, S, P = 2, 16, 4


def _tiny_bert():
    g = pstf.Graph()
    with g.as_default():
        pstf.set_random_seed(3)
        m = pbert.bert_pretrain_model(
            B, S, P, cfg=pbert.BertConfig.tiny(), compute_dtype=pstf.float32,
            use_input_mask=True)
        init = pstf.global_variables_initializer()
    s = pstf.Session(graph=g, config=cpu_config(pstf))
    s.run(init)
    return m, s


def test_superbatches_on_the_device_feed_tiny_bert_as_per_step_feeds(
        tmp_path):
    vocab = pbert.BertConfig.tiny().vocab_size
    files, batches = pbert.write_pretrain_records(
        str(tmp_path / "bert"), 8, B, S, P, vocab_size=vocab, shards=2)
    ds = pbert.pretrain_dataset(files, B, S, P).prefetch_to_device(
        2, superbatch=4, device="cpu")
    m, s = _tiny_bert()
    it = iter(ds)
    losses = []
    for _ in range(2):
        sb = next(it)
        assert all(v.shape[:2] == (4, B) for v in sb.values())
        out = s.run_steps([m["loss"], m["train_op"]], 4,
                          stacked_feeds={m[k]: v for k, v in sb.items()},
                          output_mode="stacked")
        losses += [float(v) for v in out[0]]
    it.close()
    assert s.fused_steps == 8 and not s.loop_fusion_fallbacks
    got = _store(s)
    s.close()
    m, s = _tiny_bert()
    ref = [float(s.run([m["loss"], m["train_op"]],
                       {m[k]: v for k, v in batch.items()})[0])
           for batch in batches]
    want = _store(s)
    s.close()
    assert losses == ref
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _ckpt_graph(stf, D, files):
    """A variable and a one-shot iterator over the journey's records, in
    a new graph."""
    g = stf.Graph()
    with g.as_default():
        w = stf.Variable(np.arange(3, dtype=np.float32), name="w")
        ds = (D.TFRecordDataset(files, num_parallel_reads=D.AUTOTUNE)
              .shuffle(32, seed=9).repeat().batch(4))
        it = ds.make_one_shot_iterator()
        init = stf.global_variables_initializer()
        saver = stf.train.Saver()
    return g, w, it, init, saver


def test_iterator_positions_cross_the_packages(shards, tmp_path):
    pkgs = {"jax": (jstf, jstf.data, {}),
            "port": (pstf, pstf.data, {"config": cpu_config(pstf)})}
    for src, dst in (("jax", "port"), ("port", "jax")):
        stf, D, kw = pkgs[src]
        g, _, it, init, saver = _ckpt_graph(stf, D, shards)
        with stf.Session(graph=g, **kw) as s:
            s.run(init)
            for _ in range(5):
                it._next_value()
            with g.as_default():
                path = saver.save(s, str(tmp_path / f"{src}.ckpt"))
            nxt = list(it._next_value())
        it.close()
        stf, D, kw = pkgs[dst]
        g, _, it, init, saver = _ckpt_graph(stf, D, shards)
        with stf.Session(graph=g, **kw) as s:
            with g.as_default():
                saver.restore(s, path)
            assert it.save_state() == {"position": 5}
            assert list(it._next_value()) == nxt
        it.close()


def _monitored(files, directory, last_step):
    g = pstf.Graph()
    with g.as_default():
        pstf.set_random_seed(42)
        m = pmnist.records_model(files, BATCH, device="cpu")
        losses = []
        with pstf.train.MonitoredTrainingSession(
                checkpoint_dir=directory, save_checkpoint_steps=3,
                save_summaries_steps=2, config=cpu_config(pstf),
                hooks=[pstf.train.StopAtStepHook(last_step=last_step)]) \
                as ms:
            raw = ms.raw_session
            start = int(raw.variable_value(m["global_step"]).item())
            position = m["iterator"].save_state()["position"]
            while not ms.should_stop():
                losses.append(float(ms.run([m["train_op"], m["loss"]])[1]))
    m["iterator"].close()
    return start, position, losses


def test_the_journey_resumes_from_its_checkpoint(shards, tmp_path):
    full = _monitored(shards, str(tmp_path / "full"), 7)
    first = _monitored(shards, str(tmp_path / "split"), 4)
    resumed = _monitored(shards, str(tmp_path / "split"), 7)
    assert full[:2] == first[:2] == (0, 0)
    n = len(first[2])
    assert resumed[:2] == (n, n)
    assert first[2] + resumed[2] == full[2]
    assert full[2][-1] < full[2][0]


def _init_graph(stf, D):
    g = stf.Graph()
    with g.as_default():
        it = D.Dataset.range(5).map(lambda i: i * 3).batch(2) \
            .make_initializable_iterator()
        nxt = it.get_next()
        total = stf.reduce_sum(nxt)
        init = it.initializer
    return g, it, init, nxt, total


@pytest.mark.parametrize("name", ["jax", "port"])
def test_an_initializable_iterator_restarts_at_its_initializer(name):
    stf, D, errors, kw = {
        "jax": (jstf, jstf.data, jstf.errors, {}),
        "port": (pstf, pstf.data, pstf.errors,
                 {"config": cpu_config(pstf)})}[name]
    g, it, init, nxt, total = _init_graph(stf, D)
    with stf.Session(graph=g, **kw) as s:
        with pytest.raises(errors.FailedPreconditionError):
            s.run(nxt)
        s.run(init)
        got = [list(s.run(nxt)), int(s.run(total))]
        s.run(init)
        got.append(list(s.run(nxt)))
        s.run(nxt)
        with pytest.raises(errors.OutOfRangeError):
            s.run(nxt)
    it.close()
    assert got == [[0, 3], 6 + 9, [0, 3]]
