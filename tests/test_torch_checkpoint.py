"""The async checkpoint plane of the port against the JAX package's, on
the CPU (``checkpoint/{writer,manager,snapshot,preemption}.py``,
``Saver(backend="async")``, the async ``CheckpointSaverHook``). The
classes mirror JAX's ``tests/test_checkpoint.py`` ``TestAsyncSave``,
``TestManager`` and ``TestPreemption``.

- an async save's data file is byte-identical to a blocking save of the
  same step and to the JAX package's save of the same state (restored
  from the port's file), with the same host state; later steps never
  reach a snapshot taken before them;
- a write error surfaces on ``wait_until_finished`` and, once the write
  failed, on the next ``save``; it never becomes the latest checkpoint;
- manager retention across async saves; ``restore_or_initialize``
  fresh, resumed, and past a corrupted latest checkpoint; a port manager
  adopts a directory the JAX manager wrote and the reverse;
- ``PreemptionHandler(manager=)``, from the default SIGTERM disposition,
  drains the queued async saves, saves through the manager and stops;
- the hook is async by default, and a monitored run with async saves
  equals JAX's: the same steps, files and losses (rtol 1e-5).
"""

import json
import os
import signal

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu import checkpoint as jckpt
from simple_tensorflow_tpu_torch import checkpoint as pckpt
from simple_tensorflow_tpu_torch.checkpoint import atomic as patomic
from simple_tensorflow_tpu_torch.platform import monitoring as pmonitoring
from simple_tensorflow_tpu_torch.train import saver as psaver

PKGS = {"jax": (jstf, jckpt), "port": (pstf, pckpt)}
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _stop_the_port_writer():
    """The port's ``stf_ckpt_writer`` drained and stopped when the module
    ends (its thread must not outlive the module)."""
    yield
    pckpt.wait_until_finished(timeout=10.0)
    assert pckpt.shutdown_writer(timeout=5.0)


@pytest.fixture(autouse=True)
def fresh_state():
    yield
    patomic.set_fault_hook(None)
    for _, ck in PKGS.values():
        ck.reset_preemption_state()
        ck.uninstall_preemption_handler()
        ck.get_writer().wait_until_finished(timeout=10.0)


def _session(name, graph):
    stf = PKGS[name][0]
    kw = {"device_count": {"GPU": 0}} if name == "port" else {}
    return stf.Session(graph=graph, config=stf.ConfigProto(**kw))


def _model(name, lr=0.25):
    """A tiny Adam model (JAX's ``_model``): a variable, the Adam slots
    and beta powers, ``global_step``."""
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        gs = stf.train.get_or_create_global_step()
        v = stf.Variable(stf.constant([1.0, 2.0]), name="cv")
        loss = stf.reduce_sum(stf.square(v._ref), name="loss")
        train = stf.train.AdamOptimizer(lr).minimize(loss, global_step=gs)
        init = stf.global_variables_initializer()
    return g, gs, v, loss, train, init


def _value(sess, v):
    return np.asarray(sess.run(v.value()))


def _data(prefix):
    with open(prefix + ".stfz", "rb") as f:
        return f.read()


def _cells(name):
    m = pmonitoring.get_metric(name)
    return {k[0] if k else "": c.value() for k, c in m.cells().items()}


class TestAsyncSave:
    def test_async_save_is_byte_identical_to_blocking_and_jax(
            self, tmp_path):
        g, gs, v, loss, train, init = _model("port")
        with g.as_default(), _session("port", g) as sess:
            sess.run(init)
            for _ in range(3):
                sess.run(train)
            p_blk = pstf.train.Saver().save(
                sess, str(tmp_path / "blk" / "ckpt"), global_step=gs)
            mgr = pckpt.CheckpointManager(str(tmp_path / "async"))
            p_async = mgr.save(sess, global_step=gs, blocking=True)
            p_shim = pstf.train.Saver(backend="async").save(
                sess, str(tmp_path / "shim" / "ckpt"), global_step=gs,
                write_meta_graph=False)
            pckpt.wait_until_finished()
        jg, jgs, _, _, _, jinit = _model("jax")
        with jg.as_default(), _session("jax", jg) as js:
            js.run(jinit)
            jstf.train.Saver().restore(js, p_blk)
            p_jax = jstf.train.Saver().save(
                js, str(tmp_path / "jax" / "ckpt"), global_step=jgs,
                write_meta_graph=False)
        assert p_async.endswith("-3") and p_jax.endswith("-3")
        assert any("Adam" in k for k in psaver.load_checkpoint_values(
            p_async))
        assert _data(p_async) == _data(p_blk) == _data(p_shim) == \
            _data(p_jax)
        docs = [json.load(open(p + ".index.json"))
                for p in (p_blk, p_async, p_jax)]
        for d in docs[1:]:
            assert d["host_state"] == docs[0]["host_state"]
            assert d["tensors"] == docs[0]["tensors"]
            assert d["checksum"] == docs[0]["checksum"]

    def test_snapshot_is_taken_at_the_barrier(self, tmp_path):
        g = pstf.Graph()
        with g.as_default():
            v = pstf.Variable(pstf.constant(np.zeros((64, 64), np.float32)),
                              name="dw")
            train = pstf.assign_add(v._ref, pstf.ones([64, 64]))
            init = pstf.global_variables_initializer()
        with g.as_default(), _session("port", g) as sess:
            sess.run(init)
            sess.run_steps(train, n=4)
            mgr = pckpt.CheckpointManager(str(tmp_path))
            prefix = mgr.save(sess)
            sess.run_steps(train, n=8)
            mgr.wait_until_finished()
            assert float(_value(sess, v)[0, 0]) == 12.0
        saved = psaver.load_checkpoint_values(prefix)["dw"]
        np.testing.assert_array_equal(saved, np.full((64, 64), 4.0))
        assert mgr.verify(prefix) == []

    def test_a_flat_group_is_copied_once(self):
        """The snapshot of the Adam model's store: one copy of the flat
        parameter group, each variable a view of it."""
        g, gs, v, loss, train, init = _model("port")
        with g.as_default(), _session("port", g) as sess:
            sess.run(init)
            sess.run(train)
            assert sess._flat_groups
            copies, host = sess.snapshot_device_state()
            flat = next(iter(sess._flat_groups.values()))
            n_views = sum(
                1 for t in sess._variable_store.values.values()
                if t.untyped_storage().data_ptr() ==
                flat.untyped_storage().data_ptr())
            assert n_views >= 1
            assert len(copies.bases) == len(copies) - n_views + 1
            for name, t in sess._variable_store.values.items():
                np.testing.assert_array_equal(copies[name].numpy(),
                                              t.numpy())
                assert copies[name].untyped_storage().data_ptr() != \
                    t.untyped_storage().data_ptr()
            assert host == sess.snapshot_host_state()

    @pytest.mark.parametrize("surfaces_on", ["wait", "next_save"])
    def test_write_error_surfaces(self, tmp_path, surfaces_on):
        g, gs, v, loss, train, init = _model("port")
        with g.as_default(), _session("port", g) as sess:
            sess.run(init)
            mgr = pckpt.CheckpointManager(str(tmp_path))
            ok = mgr.save(sess, global_step=0, blocking=True)
            errors0 = _cells("/stf/checkpoint/write_errors").get("", 0)

            def boom(point):
                if point == "data:wrote_tmp":
                    raise RuntimeError("disk on fire")

            patomic.set_fault_hook(boom)
            mgr.save(sess, global_step=1)
            if surfaces_on == "wait":
                with pytest.raises(RuntimeError, match="disk on fire"):
                    mgr.wait_until_finished()
            else:
                assert pckpt.wait_until_finished(timeout=10.0)
                with pytest.raises(RuntimeError, match="disk on fire"):
                    mgr.save(sess, global_step=2)
            patomic.set_fault_hook(None)
            assert psaver.latest_checkpoint(str(tmp_path)) == ok
            p = mgr.save(sess, global_step=3, blocking=True)
            assert psaver.latest_checkpoint(str(tmp_path)) == p
        assert _cells("/stf/checkpoint/write_errors")[""] == errors0 + 1

    def test_saver_async_backend(self, tmp_path):
        g, gs, v, loss, train, init = _model("port")
        with g.as_default():
            saver = pstf.train.Saver(backend="async")
        with g.as_default(), _session("port", g) as sess:
            sess.run(init)
            sess.run(train)
            path = saver.save(sess, str(tmp_path / "m"), global_step=gs)
            stall = dict(saver.last_save_stats)
            saver.wait_until_finished()
            assert psaver.latest_checkpoint(str(tmp_path)) == path
            assert os.path.exists(path + ".meta")
            at_save = _value(sess, v)
            sess.run(train)
            saver.restore(sess, path)
            np.testing.assert_array_equal(_value(sess, v), at_save)
        assert {"snapshot", "put", "stall"} <= set(stall)
        assert {"d2h", "serialize", "commit", "write", "bytes"} <= \
            set(saver.last_save_stats)

    def test_the_hook_is_async_by_default_and_runs_as_jax(self, tmp_path):
        out = {}
        for name, (stf, ck) in PKGS.items():
            d = str(tmp_path / name)
            g, gs, v, loss, train, init = _model(name)
            events = []

            class Listener(stf.train.CheckpointSaverListener):
                def before_save(self, session, step):
                    events.append(("before", step))

                def after_save(self, session, step):
                    events.append(("after", step))

            with g.as_default():
                hook = stf.train.CheckpointSaverHook(
                    d, save_steps=2, listeners=[Listener()])
                kw = {"device_count": {"GPU": 0}} if name == "port" else {}
                losses = []
                with stf.train.MonitoredSession(
                        session_creator=stf.train.ChiefSessionCreator(
                            config=stf.ConfigProto(**kw)),
                        hooks=[stf.train.StopAtStepHook(last_step=5),
                               hook]) as ms:
                    while not ms.should_stop():
                        losses.append(float(ms.run([loss, train])[0]))
            assert hook._async_engine is not None
            path = stf.train.latest_checkpoint(d)
            out[name] = dict(
                losses=losses, events=events, latest=os.path.basename(path),
                files=sorted(f for f in os.listdir(d)
                             if not f.endswith(".meta")),
                verify=ck.verify_checkpoint(path))
        assert out["port"]["verify"] == [] == out["jax"]["verify"]
        assert out["port"]["latest"] == out["jax"]["latest"] == \
            "model.ckpt-5"
        for key in ("events", "files"):
            assert out["port"][key] == out["jax"][key], key
        np.testing.assert_allclose(out["port"]["losses"],
                                   out["jax"]["losses"], rtol=LOSS_RTOL)
        assert _cells("/stf/checkpoint/saves").get("async", 0) >= 1


class TestManager:
    def test_retention_across_async_saves(self, tmp_path):
        g, gs, v, loss, train, init = _model("port")
        with g.as_default(), _session("port", g) as sess:
            sess.run(init)
            mgr = pckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
            prefixes = []
            for _ in range(4):
                sess.run(train)
                prefixes.append(mgr.save(sess, global_step=gs))
            mgr.wait_until_finished()
        assert mgr.checkpoints == prefixes[-2:]
        for old in prefixes[:2]:
            assert not os.path.exists(old + ".stfz")
            assert not os.path.exists(old + ".index.json")
        for kept in prefixes[-2:]:
            assert pckpt.verify_checkpoint(kept) == []

    def test_restore_or_initialize_fresh_resumed_and_past_corruption(
            self, tmp_path):
        g, gs, v, loss, train, init = _model("port")
        with g.as_default():
            mgr = pckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
            with _session("port", g) as sess:
                assert mgr.restore_or_initialize(sess, init_op=init) is None
                for _ in range(3):
                    sess.run(train)
                v3 = _value(sess, v)
                good = mgr.save(sess, global_step=gs, blocking=True)
                sess.run(train)
                bad = mgr.save(sess, global_step=gs, blocking=True)
            with _session("port", g) as sess2:
                resumed = pckpt.CheckpointManager(str(tmp_path))
                assert resumed.restore_or_initialize(
                    sess2, init_op=init) == bad
                assert int(sess2.variable_value(gs).item()) == 4
            raw = bytearray(_data(bad))
            raw[40] ^= 0xFF
            with open(bad + ".stfz", "wb") as f:
                f.write(bytes(raw))
            mismatches = _cells("/stf/checkpoint/integrity_failures").get(
                "checksum_mismatch", 0)
            assert mgr.verify(bad) != []
            assert _cells("/stf/checkpoint/integrity_failures")[
                "checksum_mismatch"] == mismatches + 1
            with _session("port", g) as sess3:
                assert mgr.restore_or_initialize(sess3, init_op=init) \
                    == good
                np.testing.assert_array_equal(_value(sess3, v), v3)
                assert int(sess3.variable_value(gs).item()) == 3
                with pytest.raises(pstf.errors.DataLossError):
                    mgr.restore(sess3, bad)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_a_manager_adopts_the_other_packages_directory(self, tmp_path,
                                                           writer):
        reader = "port" if writer == "jax" else "jax"
        d = str(tmp_path)
        for name, steps in ((writer, (0, 1)), (reader, (2,))):
            stf, ck = PKGS[name]
            g, gs, v, loss, train, init = _model(name)
            with g.as_default(), _session(name, g) as sess:
                mgr = ck.CheckpointManager(d, max_to_keep=2)
                restored = mgr.restore_or_initialize(sess, init_op=init)
                if name == reader:
                    assert restored == os.path.join(d, "model.ckpt-1")
                    assert len(mgr.checkpoints) == 2
                for step in steps:
                    sess.run(train)
                    mgr.save(sess, global_step=step, blocking=True)
                assert len(mgr.checkpoints) == 2
        assert not os.path.exists(os.path.join(d, "model.ckpt-0.stfz"))
        assert [os.path.basename(p) for p in pckpt.CheckpointManager(
            d).checkpoints] == ["model.ckpt-1", "model.ckpt-2"]


class _SigtermAt(pstf.train.SessionRunHook):
    """Sends this process SIGTERM after the run that ends at ``step``."""

    def __init__(self, gs, step):
        self._gs = gs
        self._step = step

    def before_run(self, run_context):
        return pstf.train.SessionRunArgs(self._gs._ref)

    def after_run(self, run_context, run_values):
        if int(run_values.results) + 1 == self._step:
            os.kill(os.getpid(), signal.SIGTERM)


class TestPreemption:
    def test_handler_with_a_manager_drains_saves_and_stops(self, tmp_path):
        g, gs, v, loss, train, init = _model("port")
        d = str(tmp_path)
        preempted0 = _cells("/stf/checkpoint/preemptions").get("", 0)
        # from the default disposition: the handler chains to SIG_DFL by
        # not calling it, and the process lives on
        outer = signal.signal(signal.SIGTERM, signal.SIG_DFL)
        try:
            with g.as_default():
                mgr = pckpt.CheckpointManager(d, max_to_keep=3)
                handler = pckpt.PreemptionHandler(manager=mgr)
                saves = pstf.train.CheckpointSaverHook(d, save_steps=2)
                with pstf.train.MonitoredSession(
                        session_creator=pstf.train.ChiefSessionCreator(
                            config=pstf.ConfigProto(
                                device_count={"GPU": 0},
                                loop_fusion_steps=4)),
                        hooks=[pstf.train.StopAtStepHook(last_step=100),
                               saves, handler, _SigtermAt(gs, 5)]) as ms:
                    while not ms.should_stop():
                        ms.run(train)
                    stopped = int(ms.raw_session.variable_value(gs).item())
            assert pckpt.preemption_requested()
        finally:
            pckpt.reset_preemption_state()
            after = signal.signal(signal.SIGTERM, outer)
        assert after is signal.SIG_DFL
        assert stopped < 100
        assert handler.last_saved_prefix == os.path.join(
            d, f"model.ckpt-{stopped}")
        assert psaver.latest_checkpoint(d) == handler.last_saved_prefix
        assert not pckpt.get_writer()._q.unfinished_tasks
        assert pckpt.verify_checkpoint(handler.last_saved_prefix) == []
        doc = json.load(open(handler.last_saved_prefix + ".index.json"))
        assert "rng_run_counter" in doc["host_state"]
        assert _cells("/stf/checkpoint/preemptions")[""] == preempted0 + 1

    def test_preemption_vote_drops_window_to_one(self):
        handler = pckpt.PreemptionHandler(checkpoint_dir="/tmp/x",
                                          install=False)
        assert handler.until_next_trigger(10) == 1 << 30
        pckpt.request_preemption()
        assert handler.until_next_trigger(10) == 1
        with pytest.raises(ValueError, match="CheckpointManager"):
            pckpt.PreemptionHandler()
