"""The numerics-health plane of the port against the JAX package's, on the
CPU (``debug/numerics.py``, ``ops/numerics.py``, the ``numeric_summary``
kernel's plain version, ``train/health.py``).

- ``numeric_summary`` on seeded f32 and bf16 tensors holding NaN, +-Inf
  and zeros against JAX's ``_numeric_summary_pure``: the counts and
  max_abs exact, l2_norm and zero_fraction within rtol 1e-6 (the sums run
  in another order);
- the tap table (names, kinds, ops, op types, order) of a planned
  training step equals JAX's on ``convnet_model`` and a 2-layer
  ``transformer_train_model`` (both cut at ``MAX_TAPS``);
- ``metrics`` observes every step of a ``run_steps`` window, which stays
  one window, with JAX's steps, window indices and norms (rtol 1e-5);
- ``raise`` names the same taps and ops as JAX after a planted ``Log`` of
  a negative value, in a run and in a window (index 2);
- ``dump`` bisects to the same op as JAX (``poison_log``) and writes a
  dump that the port's and JAX's ``DebugDumpDir`` read;
- a resume from the checkpoint saved before the raise is bit-exact.
"""

import json
import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.debug import analyzer as janalyzer
from simple_tensorflow_tpu.debug import numerics as jnum
from simple_tensorflow_tpu.models import mnist as jmnist
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.ops import numerics as jnum_ops
from simple_tensorflow_tpu_torch import debug as pdebug
from simple_tensorflow_tpu_torch.debug import numerics as pnum
from simple_tensorflow_tpu_torch.models import mnist as pmnist
from simple_tensorflow_tpu_torch.models import transformer as ptr
from simple_tensorflow_tpu_torch.ops import kernels as K
from simple_tensorflow_tpu_torch.ops import numerics as pnum_ops

PKGS = {"jax": (jstf, jnum), "port": (pstf, pnum)}
RTOL = 1e-6
CLEAN = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
POISON = np.array([1.0, 2.0, -1.0, 3.0], np.float32)   # log(-1) = NaN


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("STF_NUMERICS", raising=False)
    monkeypatch.delenv("STF_NUMERICS_DUMP_ROOT", raising=False)
    for _, num in PKGS.values():
        num.get_plane().reset()
    yield
    for _, num in PKGS.values():
        num.set_numerics_mode(None)
        num.get_plane().reset()


def _config(name, **kw):
    stf = PKGS[name][0]
    if name == "port":
        kw["device_count"] = {"GPU": 0}
    return stf.ConfigProto(**kw)


def _seeded(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    flat[idx[:5]] = np.nan
    flat[idx[5:8]] = np.inf
    flat[idx[8:10]] = -np.inf
    flat[idx[10:40]] = 0.0
    return x.astype(dtype)


def _stats_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7,), (33, 65), (4, 5, 129)])
def test_numeric_summary_matches_jax(dtype, shape):
    npd = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = _seeded(npd, shape, seed=sum(shape))
    want = np.asarray(jnum_ops._numeric_summary_pure(x))
    if dtype == "bfloat16":
        t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    got = K.numeric_summary([t])
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 4)
    _stats_close(got[0].numpy(), want)
    assert np.all(np.isfinite(got.numpy()))


def test_numeric_summary_of_many_tensors_is_its_rows():
    """One call over several taps (an empty one too) gives each tap's row,
    as the JAX plane's per-tap ops and Pack do."""
    xs = [_seeded(np.float32, (n,), n) for n in (50, 1, 300)]
    xs.append(np.zeros((0,), np.float32))
    got = K.numeric_summary([torch.from_numpy(x) for x in xs]).numpy()
    want = np.stack([np.asarray(jnum_ops._numeric_summary_pure(x))
                     for x in xs])
    _stats_close(got, want)
    assert K.launch_counts()["numeric_summary"] == 0   # plain on the CPU


@pytest.mark.parametrize("name", ["jax", "port"])
def test_numeric_summary_op_in_a_session(name):
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        x = stf.placeholder(stf.float32, [6], name="x")
        num_ops = jnum_ops if name == "jax" else pnum_ops
        s = num_ops.numeric_summary(x, name="s")
    with g.as_default(), stf.Session(graph=g, config=_config(name)) as sess:
        v = sess.run(s, {x: np.array([0.0, -2.0, np.nan, np.inf, 1.0, 0.0],
                                     np.float32)})
    stats = dict(zip(num_ops.STAT_NAMES, v))
    assert stats["nonfinite_count"] == 2.0
    assert stats["max_abs"] == 2.0
    assert stats["zero_fraction"] == pytest.approx(2.0 / 6.0, rel=RTOL)
    assert stats["l2_norm"] == pytest.approx(np.sqrt(5.0), rel=RTOL)


def _tap_key(table):
    return [(t["name"], t["kind"], t["op"], t["op_type"]) for t in table]


def _mnist_plan(name):
    stf, mnist = PKGS[name][0], {"jax": jmnist, "port": pmnist}[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(3)
        m = mnist.convnet_model()
    return g, [m["train_op"], m["loss"]], [m["x"], m["y_"], m["keep_prob"]]


def _transformer_plan(name):
    stf, tr = PKGS[name][0], {"jax": jtr, "port": ptr}[name]
    cfg = tr.TransformerConfig(vocab_size=64, d_model=32, num_heads=2,
                               d_ff=64, num_layers=2, dropout=0.1,
                               max_len=32)
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        m = tr.transformer_train_model(2, 8, 8, cfg=cfg,
                                       compute_dtype=stf.float32,
                                       warmup_steps=64)
    return g, [m["train_op"], m["loss"]], [m["src_ids"], m["tgt_in"],
                                           m["tgt_out"]]


@pytest.mark.parametrize("build", [_mnist_plan, _transformer_plan],
                         ids=["mnist", "transformer"])
def test_tap_table_equals_jax(build):
    tables = {}
    for name in PKGS:
        g, fetches, feeds = build(name)
        with g.as_default(), PKGS[name][0].Session(
                graph=g, config=_config(name, numerics="metrics")) as sess:
            plan = sess.plan(fetches, feeds=feeds)
            step = plan._step if name == "jax" else plan._plan
            tables[name] = _tap_key(step.numerics["taps"])
    assert tables["port"] == tables["jax"]
    kinds = {k for _, k, _, _ in tables["port"]}
    assert "gradient" in kinds
    assert len(tables["port"]) <= pnum.MAX_TAPS


def _train_graph(stf):
    """A step whose loss goes through ``Log``: a negative x makes the Log
    op, and nothing before it, give the first nonfinite value."""
    g = stf.Graph()
    with g.as_default():
        x = stf.placeholder(stf.float32, [4], name="x")
        w = stf.Variable(np.ones(4, np.float32), name="w")
        logx = stf.log(x, name="poison_log")
        loss = stf.reduce_sum(logx * w, name="loss")
        train = stf.train.GradientDescentOptimizer(0.1).minimize(loss)
        init = stf.global_variables_initializer()
        saver = stf.train.Saver()
    return g, x, w, loss, train, init, saver


def _history(info):
    return [(e["step"], e.get("window_index"), e["nonfinite_taps"],
             e["grad_norm"], e["update_norm"], e["max_abs"])
            for e in info["history"]]


def test_metrics_observes_every_window_step_as_jax():
    out = {}
    for name, (stf, num) in PKGS.items():
        g, x, w, loss, train, init, _ = _train_graph(stf)
        with g.as_default(), stf.Session(
                graph=g, config=_config(name, numerics="metrics")) as sess:
            sess.run(init)
            sess.run([loss, train], {x: CLEAN})
            sess.run_steps([loss, train], 4, feed_dict={x: CLEAN})
            if name == "port":
                assert sess.fused_steps == 4
                assert not sess.loop_fusion_fallbacks
            out[name] = num.get_plane().info()
    j, p = _history(out["jax"]), _history(out["port"])
    assert out["port"]["steps_observed"] == out["jax"]["steps_observed"] \
        == 5
    assert [e[:3] for e in p] == [e[:3] for e in j]
    assert [e[1] for e in p][-4:] == [0, 1, 2, 3]
    for a, b in zip(p, j):
        for u, v in zip(a[3:], b[3:]):
            assert (u is None) == (v is None)
            if u is not None:
                assert u == pytest.approx(v, rel=1e-5)
    assert out["port"]["anomalies"] == 0


def _poisoned(name, mode, fused, tmp_path, monkeypatch):
    stf, num = PKGS[name]
    num.get_plane().reset()
    monkeypatch.setenv("STF_NUMERICS_DUMP_ROOT", str(tmp_path / name))
    g, x, w, loss, train, init, _ = _train_graph(stf)
    with g.as_default(), stf.Session(
            graph=g, config=_config(name, numerics=mode)) as sess:
        sess.run(init)
        with pytest.raises(stf.errors.InvalidArgumentError) as ei:
            if fused:
                sess.run_steps([loss, train], 4, stacked_feeds={
                    x: np.stack([CLEAN, CLEAN, POISON, CLEAN])})
            else:
                sess.run([loss, train], {x: CLEAN})
                sess.run([loss, train], {x: POISON})
    info = num.get_plane().info()
    if fused:
        # the first bad step raises; the poisoned weights make the next
        # one bad too, which the history records
        bad = [e["window_index"] for e in info["history"]
               if e["nonfinite_taps"]]
        assert bad == [2, 3]
    return str(ei.value), info["last_anomaly"]


@pytest.mark.parametrize("fused", [False, True], ids=["run", "window"])
def test_raise_names_the_same_tap_and_op_as_jax(fused, tmp_path,
                                                monkeypatch):
    got = {name: _poisoned(name, "raise", fused, tmp_path, monkeypatch)
           for name in PKGS}
    for name, (msg, anomaly) in got.items():
        assert "nonfinite values detected" in msg
        assert "from op loss (Sum)" in msg
        if fused:
            assert "fused window index 2" in msg
    taps = {name: [(t["name"], t["kind"], t["op"], t["op_type"],
                    t["nonfinite_count"]) for t in a["taps"]]
            for name, (_, a) in got.items()}
    assert taps["port"] == taps["jax"]


def _dump_root(msg):
    m = re.search(r"dump written to (\S+)", msg)
    assert m, msg
    return m.group(1).rstrip(":")


@pytest.mark.parametrize("fused", [False, True], ids=["run", "window"])
def test_dump_bisects_to_the_same_op_as_jax(fused, tmp_path, monkeypatch):
    reports = {}
    for name in PKGS:
        msg, anomaly = _poisoned(name, "dump", fused, tmp_path, monkeypatch)
        root = _dump_root(msg)
        assert "first bad op: poison_log (Log)" in msg
        with open(os.path.join(root, "bisect_report.json")) as f:
            reports[name] = json.load(f)
        assert anomaly["first_bad_op"] == "poison_log"
        assert anomaly["dump_root"] == root
    for key in ("first_bad_op", "op_type", "inputs", "outputs"):
        assert reports["port"][key] == reports["jax"][key], key
    if fused:
        assert reports["port"]["window_index"] == 2 == \
            reports["jax"]["window_index"]
    port_root = _dump_root(_poisoned("port", "dump", fused, tmp_path,
                                     monkeypatch)[0])
    for reader in (pdebug.DebugDumpDir, janalyzer.DebugDumpDir):
        dd = reader(port_root)
        assert dd.runs == [0]
        assert "poison_log:0" in dd.dumped_tensor_names()
        bad = [d.tensor_name for d in dd.find_inf_or_nan()]
        assert bad == ["poison_log:0"]
        x = dd.get_tensor("x:0", 0)
        np.testing.assert_array_equal(x, POISON)


def test_resume_from_checkpoint_after_raise_is_bit_exact(tmp_path):
    stf = pstf
    g, x, w, loss, train, init, saver = _train_graph(stf)
    ckpt = str(tmp_path / "model.ckpt")
    with g.as_default(), stf.Session(graph=g, config=_config("port")) as ref:
        ref.run(init)
        ref.run([loss, train], {x: CLEAN})
        for _ in range(2):
            ref.run([loss, train], {x: CLEAN})
        ref_final = ref.run(w)
    with g.as_default(), stf.Session(
            graph=g, config=_config("port", numerics="raise")) as sess:
        sess.run(init)
        sess.run([loss, train], {x: CLEAN})
        saver.save(sess, ckpt)
        with pytest.raises(stf.errors.InvalidArgumentError):
            sess.run([loss, train], {x: POISON})
        assert not np.all(np.isfinite(sess.run(w)))   # committed
        saver.restore(sess, ckpt)
        for _ in range(2):
            sess.run([loss, train], {x: CLEAN})
        np.testing.assert_array_equal(sess.run(w), ref_final)


def test_check_numerics_and_verify_tensor_all_finite():
    g = pstf.Graph()
    with g.as_default():
        x = pstf.placeholder(pstf.float32, [3], name="x")
        y = pstf.verify_tensor_all_finite(x * 2.0, "doubled x")
        checks = pstf.add_check_numerics_ops()
    with g.as_default(), pstf.Session(graph=g,
                                      config=_config("port")) as sess:
        np.testing.assert_array_equal(
            sess.run(y, {x: np.ones(3, np.float32)}), 2 * np.ones(3))
        sess.run(checks, {x: np.ones(3, np.float32)})
        with pytest.raises(pstf.errors.InvalidArgumentError,
                           match="doubled x"):
            sess.run(y, {x: np.array([1, np.inf, 0], np.float32)})


def test_modes_resolve_as_in_jax(monkeypatch):
    from simple_tensorflow_tpu.train import health as jhealth
    from simple_tensorflow_tpu_torch.train import health as phealth

    for health, num, stf in ((jhealth, jnum, jstf), (phealth, pnum, pstf)):
        assert health.resolved_mode(None) == "off"
        monkeypatch.setenv("STF_NUMERICS", "raise")
        assert health.resolved_mode(None) == "raise"
        num.set_numerics_mode("metrics")
        assert health.resolved_mode(None) == "metrics"
        assert health.resolved_mode(stf.ConfigProto(numerics="dump")) \
            == "dump"
        num.set_numerics_mode(None)
        monkeypatch.delenv("STF_NUMERICS")
        with pytest.raises(ValueError):
            stf.ConfigProto(numerics="loud")
        with pytest.raises(ValueError):
            num.set_numerics_mode("loud")


def test_monitored_session_adds_the_health_hook():
    logs = []
    g, x, w, loss, train, init, _ = _train_graph(pstf)
    with g.as_default():
        gs = pstf.train.get_or_create_global_step()
        step = pstf.assign_add(gs, 1)
        hook = pstf.train.NumericsHealthHook(every_n_steps=2,
                                             log_fn=logs.append)
        with pstf.train.MonitoredTrainingSession(
                config=_config("port", numerics="metrics"),
                hooks=[hook, pstf.train.StopAtStepHook(last_step=4)]) as ms:
            assert sum(isinstance(h, pstf.train.NumericsHealthHook)
                       for h in ms._hooks) == 1
            while not ms.should_stop():
                ms.run([loss, train, step], {x: CLEAN})
        with pstf.train.MonitoredTrainingSession(
                config=_config("port", numerics="metrics")) as ms:
            assert sum(isinstance(h, pstf.train.NumericsHealthHook)
                       for h in ms._hooks) == 1
    assert any(m.startswith("numerics health @ step") for m in logs)
    assert logs[-1].startswith("numerics health: observed")
    assert hook.until_next_trigger(0) == 1 << 30
