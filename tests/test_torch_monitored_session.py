"""The port's training loop against the JAX package's, on the CPU:
``MonitoredTrainingSession``, the hooks' window votes, checkpoints,
summaries, resume and preemption.

- the window sizes ``_fusion_window`` picks for StopAtStep (last step
  20), CheckpointSaver every 5, StepCounter every 3 and SummarySaver every
  4, under ``loop_fusion_steps`` 8, driven by ``run`` and by
  ``run_steps``, equal JAX's step for step, and so do the checkpoints'
  steps and values (``TestHookFusionAlignment`` of
  ``tests/test_checkpoint_resume.py``);
- ``transformer_train_model`` (2 + 2 layers, d_model 64, batch 4 x 8 / 8,
  dropout 0.1, f32) under ``MonitoredTrainingSession(save_checkpoint_steps
  =8, save_summaries_steps=4, log_step_count_steps=4,
  loop_fusion_steps=4)`` with ``StopAtStepHook(last_step=16)``, driven by
  ``run_steps(..., 4)`` from the same checkpoint in both packages: the
  same windows, checkpoint steps and summary steps; losses within rtol
  1e-5;
- a run stopped at step 8 and resumed in a new graph and session ends in
  a checkpoint bit-identical to the uninterrupted run's, with the same
  losses;
- the port's event files parse with JAX's ``summary_iterator`` (tags,
  steps; values within 1e-6), and a record and an event are
  byte-identical to the JAX writers' for the same payload;
- a SIGTERM the process sends itself from a hook mid-run: the
  ``PreemptionHandler`` saves at the window's end and stops, the resumed
  run reaches the uninterrupted run's final state bit for bit, and the
  SIGTERM handler in place before is back afterwards.

Two behaviours of the JAX hooks that these runs show, and the port keeps
(ROADMAP Queue 3): the hooks read ``global_step`` as fetched beside
``train_op``, before the increment in the transformer's plan, so
StopAtStepHook(last_step=16) ends at step 17 and a checkpoint named
``-8`` holds step 9; SummarySaverHook writes its first summary only and
then votes windows of 1.
"""

import glob
import os
import shutil
import signal
import struct

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.lib.io import tf_record as jrec
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.summary import summary_iterator as jax_events
from simple_tensorflow_tpu.summary.writer import writer as jwriter
from simple_tensorflow_tpu_torch import checkpoint as pckpt
from simple_tensorflow_tpu_torch.lib.io import tf_record as prec
from simple_tensorflow_tpu_torch.models import transformer as ptr
from simple_tensorflow_tpu_torch.summary import summary_iterator as events
from simple_tensorflow_tpu_torch.summary.writer import writer as pwriter
from simple_tensorflow_tpu_torch.train import saver as psaver
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _stop_the_port_writer():
    """The port's ``stf_ckpt_writer`` thread (its async saves) drained and
    stopped when the module ends."""
    yield
    from simple_tensorflow_tpu_torch import checkpoint as port_ckpt

    port_ckpt.wait_until_finished(timeout=10.0)
    assert port_ckpt.shutdown_writer(timeout=5.0)


PKGS = {"jax": (jstf, jtr), "port": (pstf, ptr)}
LOSS_RTOL = 1e-5


def _config(stf, steps):
    return stf.ConfigProto(device_count={"GPU": 0},
                           loop_fusion_steps=steps)


def _record_windows(ms):
    """Wrap ``ms._run_once`` to record each window's size."""
    sizes = []
    orig = ms._run_once

    def run_once(*a, window=1, **k):
        sizes.append(window)
        return orig(*a, window=window, **k)

    ms._run_once = run_once
    return sizes


def _steps(directory):
    return sorted(int(p.rsplit("-", 1)[1][:-len(".stfz")])
                  for p in glob.glob(os.path.join(directory, "*.stfz")))


# -- hook votes on a cheap graph -----------------------------------------------

def _hook_run(name, directory, drive):
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        gs = stf.train.get_or_create_global_step()
        v = stf.Variable(stf.constant([0.0]), name="fv")
        added = stf.assign_add(v._ref, stf.constant([1.0]))
        train = stf.group(added,
                          stf.assign_add(gs, stf.constant(1, stf.int64)))
        stf.summary.scalar("fv", stf.reduce_sum(added))
        scaffold = stf.train.Scaffold()
        hooks = [stf.train.StopAtStepHook(last_step=20),
                 stf.train.CheckpointSaverHook(directory, save_steps=5,
                                               scaffold=scaffold),
                 stf.train.StepCounterHook(every_n_steps=3,
                                           output_dir=directory),
                 stf.train.SummarySaverHook(save_steps=4,
                                            output_dir=directory,
                                            scaffold=scaffold)]
        with stf.train.MonitoredSession(
                session_creator=stf.train.ChiefSessionCreator(
                    scaffold=scaffold, config=_config(stf, 8)),
                hooks=hooks) as ms:
            sizes = _record_windows(ms)
            while not ms.should_stop():
                if drive == "run":
                    ms.run(train)
                else:
                    ms.run_steps(train, 4)
    values = {s: float(psaver.load_checkpoint_values(
        os.path.join(directory, f"model.ckpt-{s}"))["fv"][0])
        for s in _steps(directory)}
    return sizes, values


@pytest.mark.parametrize("drive", ["run", "run_steps"])
def test_window_sizes_and_checkpoint_steps_match_jax(tmp_path, drive):
    out = {}
    for name in PKGS:
        d = tmp_path / name
        d.mkdir()
        out[name] = _hook_run(name, str(d), drive)
    assert out["port"] == out["jax"]
    sizes, values = out["port"]
    assert sum(sizes) == 20 and max(sizes) > 1
    assert all(values[s] == s for s in values)


# -- the transformer under MonitoredTrainingSession ---------------------------

def _transformer(stf, T):
    cfg = T.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                              d_ff=128, num_layers=2, dropout=0.1,
                              max_len=32)
    m = T.transformer_train_model(4, 8, 8, cfg=cfg,
                                  compute_dtype=stf.float32,
                                  warmup_steps=64)
    stf.summary.scalar("loss", m["loss"])
    b = jtr.synthetic_wmt_batch(4, 8, 8, vocab_size=64, seed=0)
    return m, {m[k]: b[k] for k in ("src_ids", "tgt_in", "tgt_out")}


class _SigtermAt(pstf.train.SessionRunHook):
    """Sends this process SIGTERM after the run that ends at ``step``."""

    def __init__(self, step):
        self._step = step

    def before_run(self, run_context):
        return pstf.train.SessionRunArgs(
            pstf.train.get_global_step()._ref)

    def after_run(self, run_context, run_values):
        if int(run_values.results) + 1 == self._step:
            os.kill(os.getpid(), signal.SIGTERM)


def _monitored(name, directory, last_step, extra_hooks=()):
    """Train under MonitoredTrainingSession until it stops: ``(window
    sizes, the fetched (loss, global step) of each window)``."""
    stf, T = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(7)
        m, feeds = _transformer(stf, T)
        ms = stf.train.MonitoredTrainingSession(
            checkpoint_dir=directory, save_checkpoint_steps=8,
            save_summaries_steps=4, log_step_count_steps=4,
            config=_config(stf, 4),
            hooks=[stf.train.StopAtStepHook(last_step=last_step),
                   *extra_hooks])
        sizes = _record_windows(ms)
        fetched = []
        with ms:
            while not ms.should_stop():
                out = ms.run_steps([m["train_op"], m["loss"],
                                    m["global_step"]], 4, feed_dict=feeds)
                fetched.append((float(out[1]), int(out[2])))
    return sizes, fetched


def _start(name, directory, seed_ckpt):
    os.makedirs(directory)
    for f in glob.glob(seed_ckpt + ".*"):
        shutil.copy(f, directory)
    psaver.update_checkpoint_state(
        directory, os.path.join(directory, os.path.basename(seed_ckpt)))


@pytest.fixture(scope="module")
def start_ckpt(tmp_path_factory):
    """The JAX session's initialized transformer as a checkpoint
    (``model.ckpt-0``): both packages start from it."""
    d = str(tmp_path_factory.mktemp("start"))
    g = jstf.Graph()
    with g.as_default():
        jstf.set_random_seed(7)
        _transformer(jstf, jtr)
        saver = jstf.train.Saver()
        with jstf.Session(graph=g) as s:
            s.run(jstf.global_variables_initializer())
            return saver.save(s, os.path.join(d, "model.ckpt"),
                              global_step=0)


def _values(directory, step):
    return psaver.load_checkpoint_values(
        os.path.join(directory, f"model.ckpt-{step}"))


def _events(directory, iterator):
    out = []
    for f in sorted(glob.glob(os.path.join(directory, "events.*"))):
        for e in iterator(f):
            if e.summary is not None:
                out += [(e.step, v.tag, v.simple_value)
                        for v in e.summary.value]
    return sorted(out)


def _jax_writers_flush_at_end_only(mp):
    """The JAX hooks leave their FileWriters open, and the step counter's
    writer shares its file name with the summary writer's: its periodic
    flush, ``flush_secs`` (120 s) after it opened, writes its buffered
    records over the start of that file. A run slower than that (a loaded
    machine) would lose JAX's loss summary by the clock alone, so the JAX
    writers made here flush only when asked (the summary hook's ``end``)."""
    init = jwriter.FileWriter.__init__

    def no_timed_flush(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._flush_secs = float("inf")

    mp.setattr(jwriter.FileWriter, "__init__", no_timed_flush)


@pytest.fixture(scope="module")
def monitored(tmp_path_factory, start_ckpt):
    root = tmp_path_factory.mktemp("monitored")
    out = {}
    for name in PKGS:
        d = str(root / name)
        _start(name, d, start_ckpt)
        with pytest.MonkeyPatch.context() as mp:
            if name == "jax":
                _jax_writers_flush_at_end_only(mp)
            out[name] = (d,) + _monitored(name, d, 16)
    return out


def test_monitored_transformer_matches_jax(monitored):
    (pd, psz, pf), (jd, jsz, jf) = monitored["port"], monitored["jax"]
    assert psz == jsz
    assert [s for _, s in pf] == [s for _, s in jf]
    np.testing.assert_allclose([x for x, _ in pf], [x for x, _ in jf],
                               rtol=LOSS_RTOL)
    assert _steps(pd) == _steps(jd) == [0, 8, 16, 17]
    assert int(_values(pd, 8)["global_step"]) == 9
    assert int(_values(pd, 17)["global_step"]) == 17
    pe, je = _events(pd, events), \
        _events(jd, jax_events)
    # the JAX step counter's writer shares its file name with the summary
    # writer's and its records never reach the file: compare the loss
    assert [e for e in pe if e[1] == "loss"] == \
        [e[:2] + (pytest.approx(e[2], rel=LOSS_RTOL),)
         for e in je if e[1] == "loss"]
    assert [e[0] for e in pe if e[1] == "global_step/sec"] == [4, 8, 12, 16]


def test_port_event_files_parse_with_jax_summary_iterator(monitored):
    d = monitored["port"][0]
    mine = _events(d, events)
    theirs = _events(d, jax_events)
    assert [e[:2] for e in theirs] == [e[:2] for e in mine]
    np.testing.assert_allclose([e[2] for e in theirs],
                               [e[2] for e in mine], rtol=1e-6)
    # the summary hook's one summary: the loss of the first run, a window
    # of one step (its fetched global step is 0)
    loss = [e for e in mine if e[1] == "loss"]
    assert [e[0] for e in loss] == [0] and np.isfinite(loss[0][2])


@pytest.mark.parametrize("payload", [b"", b"x" * 7, bytes(range(256)) * 3])
def test_records_and_events_are_byte_identical_to_jax(tmp_path, payload):
    assert prec.encode_record(payload) == jrec._encode_record(payload)
    ev = dict(wall_time=1234.5, step=17, summary_bytes=payload or None)
    assert pwriter.encode_event(**ev) == jwriter._encode_event(**ev)
    paths = {}
    for name, mod in (("port", prec), ("jax", jrec)):
        paths[name] = str(tmp_path / name)
        with mod.TFRecordWriter(paths[name]) as w:
            w.write(payload)
            w.write(b"tail")
    assert open(paths["port"], "rb").read() == \
        open(paths["jax"], "rb").read()
    assert list(prec.tf_record_iterator(paths["jax"])) == [payload, b"tail"]


def test_resumed_run_equals_the_uninterrupted_one(monitored, start_ckpt,
                                                  tmp_path):
    full, _, full_fetched = monitored["port"]
    d = str(tmp_path / "resume")
    _start("port", d, start_ckpt)
    _, first = _monitored("port", d, 8)
    assert psaver.latest_checkpoint(d).endswith("model.ckpt-9")
    _, second = _monitored("port", d, 16)
    assert first[-1][1] == 8 and second[-1][1] == 16
    by_step = dict((s, x) for x, s in full_fetched)
    for x, s in first + second:
        if s in by_step:
            assert x == by_step[s], s
    a, b = _values(full, 17), _values(d, 17)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sigterm_from_a_hook_saves_stops_and_resumes(monitored, start_ckpt,
                                                     tmp_path):
    full = monitored["port"][0]
    d = str(tmp_path / "preempted")
    _start("port", d, start_ckpt)
    # the run starts from the default disposition: the port's handler
    # chains to the one before it, and a handler that ends the process
    # (the JAX package's telemetry dump re-raises with the default) would
    # end this one
    outer = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        sizes, fetched = _monitored("port", d, 16, [_SigtermAt(6)])
        assert pckpt.preemption_requested()
    finally:
        pckpt.reset_preemption_state()
        after = signal.signal(signal.SIGTERM, outer)
    assert after is signal.SIG_DFL
    # the SIGTERM came after the run ending at step 6 (a window of 1: the
    # summary hook's vote); the handler saved at that run's end
    assert fetched[-1][1] + 1 == 6
    assert psaver.latest_checkpoint(d).endswith("model.ckpt-6")
    assert 16 not in _steps(d)
    _monitored("port", d, 16)
    a, b = _values(full, 17), _values(d, 17)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_numerics_modes_other_than_off_are_refused():
    """Since the numerics plane is ported, a mode other than off, metrics,
    raise and dump is what ``ConfigProto`` refuses; "raise" adds the
    health hook (``tests/test_torch_numerics.py`` tests the plane)."""
    with pytest.raises(ValueError, match="numerics"):
        pstf.ConfigProto(numerics="loud")
    with pstf.Graph().as_default():
        pstf.train.get_or_create_global_step()
        with pstf.train.MonitoredTrainingSession(config=pstf.ConfigProto(
                device_count={"GPU": 0}, numerics="raise")) as ms:
            assert any(isinstance(h, pstf.train.NumericsHealthHook)
                       for h in ms._hooks)


def test_profiler_hook_waits_for_tracing():
    with pytest.raises(NotImplementedError, match="RunOptions"):
        pstf.train.ProfilerHook(save_steps=2)


def test_event_record_crc_is_checked(tmp_path):
    p = str(tmp_path / "r")
    with prec.TFRecordWriter(p) as w:
        w.write(b"payload")
    raw = bytearray(open(p, "rb").read())
    raw[14] ^= 1
    open(p, "wb").write(bytes(raw))
    with pytest.raises(pstf.errors.DataLossError, match="crc"):
        list(prec.tf_record_iterator(p))
    assert struct.unpack("<Q", bytes(raw[:8]))[0] == 7
