"""``Session.run_steps`` of the port against the JAX package's, on the CPU.

- the window's trajectory against the JAX Session's sequential ``run``
  trajectory (``softmax_model`` at lr 0.05, ``convnet_model`` at
  ``keep_prob`` 0.7 and
  ``transformer_train_model`` at 2 + 2 layers, d_model 64, batch 4 x 8 /
  8, dropout 0.1, from the JAX session's initial state): every loss
  within rtol 1e-5, ``global_step`` exact, and the same steps run
  sequentially in the port bit-identical;
- ``output_mode`` ``"last"``/``"stacked"``, ``stacked_feeds`` and
  ``feed_iterator`` give the JAX package's values; the JAX validation
  errors (``tests/test_run_steps.py``: a wrong leading dim, an exhausted
  iterator, a feed both per window and per step, ``loop_fusion_steps``
  and ``output_mode`` out of range);
- the fallback diagnostics (``Print``, a summary under ``"stacked"``, a
  write to an uninitialized variable) have JAX's codes, messages and
  ``fallback_reasons``, are counted on ``loop_fusion_fallbacks`` and
  still give the sequential values; a summary under ``"last"`` runs once
  a window (no fallback) with JAX's bytes.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.analysis import loop_safety as jls
from simple_tensorflow_tpu.models import mnist as jmnist
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.ops import logging_ops as jlog
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.analysis import loop_safety as pls
from simple_tensorflow_tpu_torch.models import mnist as pmnist
from simple_tensorflow_tpu_torch.models import transformer as ptr
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jmnist, jtr), "port": (pstf, pmnist, ptr)}
LOSS_RTOL = 1e-5
N = 4


def _session(stf, graph=None, **kw):
    return stf.Session(graph=graph, config=stf.ConfigProto(
        device_count={"GPU": 0}, **kw))


def _convnet(stf, mnist, T):
    m = mnist.convnet_model(batch_size=4)
    rng = np.random.RandomState(0)
    return m, {m["x"]: rng.rand(4, 28, 28, 1).astype(np.float32),
               m["y_"]: rng.randint(0, 10, 4).astype(np.int32),
               m["keep_prob"]: 0.7}


def _softmax(stf, mnist, T):
    m = mnist.softmax_model(batch_size=4, learning_rate=0.05)
    x, _, onehot = jmnist.synthetic_mnist(4, seed=0)
    return m, {m["x"]: x, m["y_"]: onehot}


def _transformer(stf, mnist, T):
    cfg = T.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                              d_ff=128, num_layers=2, dropout=0.1,
                              max_len=32)
    m = T.transformer_train_model(4, 8, 8, cfg=cfg,
                                  compute_dtype=stf.float32,
                                  warmup_steps=64)
    b = jtr.synthetic_wmt_batch(4, 8, 8, vocab_size=64, seed=0)
    return m, {m[k]: b[k] for k in ("src_ids", "tgt_in", "tgt_out")}


MODELS = {"softmax": _softmax, "convnet": _convnet,
          "transformer": _transformer}


def _build(name, model):
    stf, mnist, T = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(11)
        m, feeds = MODELS[model](stf, mnist, T)
        gs = stf.train.get_global_step(g)
        # softmax_model has no global step: its loss twice instead
        third = m["loss"] if gs is None else gs._ref
        init = stf.global_variables_initializer()
    return g, m, feeds, [m["train_op"], m["loss"], third], init


@pytest.fixture(scope="module")
def jax_runs():
    """Per model: the JAX session's initial state and its sequential
    losses and global steps over N steps."""
    out = {}
    for model in MODELS:
        g, m, feeds, fetch, init = _build("jax", model)
        with g.as_default(), _session(jstf, g) as s:
            s.run(init)
            state = {k: np.asarray(v)
                     for k, v in s._variable_store.values.items()}
            seq = [s.run(fetch, feeds)[1:] for _ in range(N)]
        out[model] = (state, np.array([l for l, _ in seq]),
                      np.array([gs for _, gs in seq]))
    return out


@pytest.mark.parametrize("mode", ["stacked", "last"])
@pytest.mark.parametrize("model", list(MODELS))
def test_window_matches_the_jax_sequential_trajectory(jax_runs, model,
                                                      mode):
    state, losses, steps = jax_runs[model]
    g, m, feeds, fetch, init = _build("port", model)
    outs = []
    for window in (True, False):
        with g.as_default(), _session(pstf, g) as s:
            s.run(init)
            convert.load_session_variables(s, state)
            if window:
                out = s.run_steps(fetch, N, feed_dict=feeds,
                                  output_mode=mode)
                assert s.fused_steps == N and not s.loop_fusion_fallbacks
            else:
                seq = [s.run(fetch, feeds) for _ in range(N)]
                out = ([None] + [np.stack([r[i] for r in seq])
                                 for i in (1, 2)] if mode == "stacked"
                       else seq[-1])
            outs.append((out, {k: v.clone() for k, v in
                               s._variable_store.values.items()}))
    (win, win_state), (seq, seq_state) = outs
    assert win[0] is None
    exact = steps.dtype.kind in "iu"  # the global step, else the loss
    check = np.testing.assert_array_equal if exact else \
        (lambda a, b: np.testing.assert_allclose(a, b, rtol=LOSS_RTOL))
    if mode == "stacked":
        np.testing.assert_allclose(win[1], losses, rtol=LOSS_RTOL)
        check(win[2], steps)
    else:
        np.testing.assert_allclose(win[1], losses[-1], rtol=LOSS_RTOL)
        check(win[2], steps[-1])
    np.testing.assert_array_equal(win[1], seq[1])
    np.testing.assert_array_equal(win[2], seq[2])
    for k in seq_state:
        assert win_state[k].equal(seq_state[k]), k


# -- feeds and output modes, as the JAX package ------------------------------

def _accumulator(stf):
    x = stf.placeholder(stf.float32, [2], name="x")
    v = stf.Variable(stf.zeros([2]), name="v")
    return x, stf.assign_add(v, x)


def _both(fn):
    """``fn(stf, sess, x, acc)`` in each package on a fresh accumulator
    graph."""
    out = {}
    for name in PKGS:
        stf = PKGS[name][0]
        g = stf.Graph()
        with g.as_default():
            x, acc = _accumulator(stf)
            init = stf.global_variables_initializer()
            with _session(stf, g) as s:
                s.run(init)
                out[name] = fn(stf, s, x, acc)
    return out


FEEDS = {
    "feed_dict_stacked": lambda stf, s, x, acc: s.run_steps(
        acc, n=3, feed_dict={x: np.ones(2, np.float32)},
        output_mode="stacked"),
    "feed_dict_last": lambda stf, s, x, acc: s.run_steps(
        acc, n=2, feed_dict={x: np.ones(2, np.float32)}),
    "stacked_feeds": lambda stf, s, x, acc: s.run_steps(
        acc, n=4, stacked_feeds={
            x: np.arange(8, dtype=np.float32).reshape(4, 2)}),
    "feed_iterator": lambda stf, s, x, acc: s.run_steps(
        [acc, x], n=3, feed_iterator=iter(
            [{x: np.full(2, i, np.float32)} for i in range(5)]),
        output_mode="stacked"),
    "fed_fetch_last": lambda stf, s, x, acc: s.run_steps(
        [acc, x], n=2, stacked_feeds={
            x: np.arange(4, dtype=np.float32).reshape(2, 2)}),
}


@pytest.mark.parametrize("case", list(FEEDS))
def test_feeds_and_output_modes_match_jax(case):
    out = _both(FEEDS[case])
    np.testing.assert_array_equal(np.asarray(out["port"], np.float32),
                                  np.asarray(out["jax"], np.float32))


ERRORS = {
    "wrong_lead_dim": (ValueError, "leading dim", lambda stf, s, x, acc:
                       s.run_steps(acc, n=4, stacked_feeds={
                           x: np.zeros((3, 2), np.float32)})),
    "wrong_slice_shape": (ValueError, "incompatible", lambda stf, s, x, acc:
                          s.run_steps(acc, n=2, stacked_feeds={
                              x: np.zeros((2, 3), np.float32)})),
    "iterator_exhausted": ("OutOfRangeError", "exhausted after 2 of 3",
                           lambda stf, s, x, acc: s.run_steps(
                               acc, n=3, feed_iterator=iter(
                                   [{x: np.ones(2, np.float32)}] * 2))),
    "fed_twice": (ValueError, "both per-window", lambda stf, s, x, acc:
                  s.run_steps(acc, n=2, feed_dict={x: np.ones(2,
                                                           np.float32)},
                              stacked_feeds={x: np.ones((2, 2),
                                                        np.float32)})),
    "output_mode": (ValueError, "output_mode", lambda stf, s, x, acc:
                    s.run_steps(acc, n=2, output_mode="bogus")),
    "n_zero": (ValueError, "n >= 1", lambda stf, s, x, acc:
               s.run_steps(acc, n=0)),
    "config_steps": (ValueError, "loop_fusion_steps", lambda stf, s, x, acc:
                     stf.ConfigProto(loop_fusion_steps=0)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_validation_errors_match_jax(case):
    exc, match, fn = ERRORS[case]

    def raises(stf, s, x, acc):
        want = getattr(stf.errors, exc) if isinstance(exc, str) else exc
        with pytest.raises(want, match=match) as ei:
            fn(stf, s, x, acc)
        return str(ei.value)

    out = _both(raises)
    assert out["port"] == out["jax"]


def test_loop_fusion_steps_is_the_default_window():
    def run(stf, s, x, acc):
        return s.run_steps(acc, feed_dict={x: np.ones(2, np.float32)})

    for name in PKGS:
        stf = PKGS[name][0]
        g = stf.Graph()
        with g.as_default():
            x, acc = _accumulator(stf)
            init = stf.global_variables_initializer()
            with _session(stf, g, loop_fusion_steps=4) as s:
                s.run(init)
                np.testing.assert_array_equal(run(stf, s, x, acc),
                                              [4.0, 4.0])


# -- fallbacks -----------------------------------------------------------------

def _fallback_case(name, case):
    """Run ``case`` in package ``name``: ``(values, diagnostics as
    (code, message, op name), reasons)``."""
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        x = stf.placeholder(stf.float32, [2], name="x")
        if case == "print":
            pr = (jlog.Print if name == "jax" else pstf.Print)
            fetch = pr(x * 2.0, [x], message="v=", name="my_print")
            mode, n = "stacked", 3
        elif case == "summary_stacked":
            fetch = stf.summary.scalar("mean_x", stf.reduce_mean(x * 3.0))
            mode, n = "stacked", 2
        else:
            v = stf.Variable(stf.zeros([2]), name="v")
            fetch = v.initializer
            mode, n = "last", 2
        with _session(stf, g) as s:
            before = set(s._variable_store.values)
            out = s.run_steps(fetch, n=n,
                              feed_dict={x: np.ones(2, np.float32)},
                              output_mode=mode)
            plan = next(iter(s._cache.values()))
            diags = list(plan.fusion_diags[0])
            written = plan.fusion_diags[1]
            missing = sorted(written - before)
            if case == "uninitialized":
                out = np.asarray(s.run(v.value()))
    mod = jls if name == "jax" else pls
    if missing:
        diags.append(mod.uninitialized_write_diag(missing))
    if case == "summary_stacked":
        ops = [op for op in g.get_operations()
               if op.type == "ScalarSummary"]
        diags.append(mod.stacked_host_sink_diag(ops))
    return (out, [(d.code, d.message, d.op_name) for d in diags],
            mod.fallback_reasons(diags))


@pytest.mark.parametrize("case", ["print", "summary_stacked",
                                  "uninitialized"])
def test_fallback_diagnostics_match_jax(case, capsys):
    got = {name: _fallback_case(name, case) for name in PKGS}
    (pv, pd, pr), (jv, jd, jr) = got["port"], got["jax"]
    assert pd == jd and pr == jr
    assert pr == {"print": ["host_effectful_op"],
                  "summary_stacked": ["host_sink_op"],
                  "uninitialized": ["uninitialized_write"]}[case]
    if case == "summary_stacked":
        assert list(pv) == list(jv) and len(pv) == 2
    else:
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(jv))


def test_fallbacks_are_counted_and_logged_once(caplog):
    g = pstf.Graph()
    with g.as_default():
        x = pstf.placeholder(pstf.float32, [2], name="x")
        y = pstf.Print(x * 2.0, [x], name="my_print")
        with _session(pstf, g) as s:
            for _ in range(2):
                s.run_steps(y, n=2, feed_dict={x: np.ones(2, np.float32)})
            assert s.loop_fusion_fallbacks == {"host_effectful_op": 2}
            assert s.fused_steps == 0
    warned = [r for r in caplog.records if "falling back" in r.message]
    assert len(warned) == 1 and "my_print" in warned[0].message


def test_summary_under_last_runs_once_a_window_with_jax_bytes():
    def run(stf, s, x, acc):
        summ = stf.summary.scalar("mean_x", stf.reduce_mean(x * 3.0))
        h = stf.summary.histogram("x", x)
        out = s.run_steps([summ, h, acc], n=2, stacked_feeds={
            x: np.array([[1, 2], [3, 5]], np.float32)})
        return out, getattr(s, "loop_fusion_fallbacks", {})

    out = _both(run)
    (pv, pf), (jv, _) = out["port"], out["jax"]
    assert pf == {}
    assert pv[0] == jv[0]
    assert pv[1] == jv[1]
    np.testing.assert_array_equal(pv[2], jv[2])


@pytest.mark.parametrize("refresh", ["keys", "seeds"])
def test_window_replays_refill_keys_and_seeds(jax_runs, refresh):
    # a window is n replays of the plan's compiled step (on the CPU each
    # replay runs the op list into the executable's static buffers): one
    # compile for three windows, and each replay's keys (the Dropout ops)
    # and seeds (the flash and dropout-residual kernels) refilled from the
    # window's rows; with that refill off (a planted fault) the replays
    # after a window's first draw stale masks
    state, losses, _ = jax_runs["transformer"]
    g, m, feeds, fetch, init = _build("port", "transformer")
    out = {}
    for fault in (False, True):
        with g.as_default(), _session(pstf, g) as s:
            s.run(init)
            convert.load_session_variables(s, state)
            setattr(s, f"_refresh_{refresh}", not fault)
            got = [s.run_steps(fetch, 2, feed_dict=feeds,
                               output_mode="stacked")[1] for _ in range(2)]
            out[fault] = np.concatenate(got)
            assert s.captures == 1 and s.fused_steps == N
    np.testing.assert_allclose(out[False], losses, rtol=LOSS_RTOL)
    # step 1 draws fresh masks; step 2 replays step 1's, and every step
    # from there trains other weights
    assert out[True][0] == out[False][0]
    assert all(out[True][1:] != out[False][1:])
