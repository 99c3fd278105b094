"""The reference's two RNN graphs through the port's ``stf.Session``
against the JAX package's, on the CPU:

- ``models/ptb_lstm.py`` ``ptb_lm_model`` at ``PTBConfig.tiny()`` with
  ``keep_prob`` 0.5 (the shipped tiny config has 1.0; 0.5 exercises the
  embedding's Dropout and the two Dropouts of the ``Scan`` body), batch 4,
  ``synthetic_ptb_batch``, SGD with clipping by global norm;
- ``models/rnn_seq2seq.py`` ``seq2seq_model`` at ``Seq2SeqConfig.tiny()``,
  batch 8, ``synthetic_copy_batch``, Adam.

Held: the graphs op for op (training and eval; loop bodies and captures
too); the initializer run bit-exact under a graph seed (seq2seq's two
embeddings equal, as ``random_uniform_initializer(seed=7)`` draws them in
TF-1 and JAX); from JAX's initial state 3 truncated-BPTT runs with the
LSTM state fetched and fed back: losses within rtol 1e-5, fetched states
within 1e-5, variables within relative norm 1e-5, the embedding Dropout's
mask equal; eval bit-deterministic and within 1e-5 of JAX; 3 Adam steps
of seq2seq within the same limits with ``decoded`` int-exact; JAX's state
after 2 runs (Adam slots, global step) resumed in a port Session; a
``train.Saver`` checkpoint of either package resumed by the other; a
changed graph seed changes the loss; ``lr_update`` sets the next SGD
step; a captured step (its CPU replay) equal to the eager one; the plan
does not run ``dynamic_rnn``'s probe cell.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import ptb_lstm as jptb
from simple_tensorflow_tpu.models import rnn_seq2seq as js2s
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import ptb_lstm as pptb
from simple_tensorflow_tpu_torch.models import rnn_seq2seq as ps2s
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jptb, js2s), "port": (pstf, pptb, ps2s)}
OTHER = {"jax": "port", "port": "jax"}
PTB_B, S2S_B = 4, 8
STEPS = 3
LOSS_RTOL = 1e-5
VALUE_TOL = 1e-5
STATE_REL = 1e-5
SEED = 7


def _ptb_cfg(M):
    cfg = M.PTBConfig.tiny()
    cfg.keep_prob = 0.5
    return cfg


def _graph(name, model, training=True, seed=SEED):
    stf, ptb, s2s = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(seed)
        if model == "ptb":
            m = ptb.ptb_lm_model(PTB_B, _ptb_cfg(ptb), training=training)
        else:
            m = s2s.seq2seq_model(S2S_B, s2s.Seq2SeqConfig.tiny(),
                                  training=training)
        m["init"] = stf.global_variables_initializer()
        if training:
            m["saver"] = stf.train.Saver()
    return g, m


def _session(name, g):
    stf = PKGS[name][0]
    return stf.Session(graph=g,
                       config=stf.ConfigProto(device_count={"GPU": 0}))


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _ptb_batch():
    cfg = _ptb_cfg(pptb)
    return pptb.synthetic_ptb_batch(PTB_B, cfg.seq_len, cfg.vocab_size,
                                    seed=0)


def _ptb_feeds(M, m, state):
    x, y = _ptb_batch()
    feeds = {m["input_ids"]: x, m["target_ids"]: y}
    feeds.update(M.state_feed(m, state))
    return feeds


def _ptb_steps(name, m, s, n, fetch_drop=False, state=None):
    """``n`` truncated-BPTT runs from ``state`` (default the zero state):
    losses, fetched states (each fed to the next run), the first run's
    embedding Dropout output."""
    M = PKGS[name][1]
    if state is None:
        state = M.zero_state(PTB_B, _ptb_cfg(M))
    losses, states, drop = [], [], None
    for i in range(n):
        fetch = [m["loss"], m["train_op"], m["state_out"]]
        if fetch_drop and i == 0:
            fetch.append("dropout:0")
        out = s.run(fetch, _ptb_feeds(M, m, state))
        if fetch_drop and i == 0:
            drop = out[3]
        losses.append(float(out[0]))
        state = [(c, h) for c, h in out[2]]
        states.append(state)
    return losses, states, drop


def _s2s_feeds(m):
    src, lens, tin, tout = ps2s.synthetic_copy_batch(
        S2S_B, ps2s.Seq2SeqConfig.tiny(), seed=0)
    return {m["src"]: src, m["src_len"]: lens, m["tgt_in"]: tin,
            m["tgt_out"]: tout}


def _run(name, model, init=None):
    g, m = _graph(name, model)
    with g.as_default(), _session(name, g) as s:
        s.run(m["init"])
        state0 = _state(s)
        if init is not None:
            convert.load_session_variables(s, init)
        # the state and run counter before the last step: the JAX
        # training state a port Session resumes from
        if model == "ptb":
            losses, states, drop = _ptb_steps(name, m, s, STEPS - 1, True)
            mid = dict(state=_state(s), counter=s._run_counter,
                       feed=states[-1])
            more, last, _ = _ptb_steps(name, m, s, 1, state=states[-1])
            out = dict(losses=losses + more, states=states + last,
                       drop=drop)
        else:
            feeds = _s2s_feeds(m)
            steps = []
            for i in range(STEPS):
                if i == STEPS - 1:
                    mid = dict(state=_state(s), counter=s._run_counter)
                steps.append(s.run([m["loss"], m["train_op"],
                                    m["decoded"]], feeds))
            out = dict(losses=[float(a[0]) for a in steps],
                       decoded=[a[2] for a in steps])
        out.update(state0=state0, final=_state(s), mid=mid)
    return out


@pytest.fixture(scope="module", params=["ptb", "seq2seq"])
def runs(request):
    j = _run("jax", request.param)
    return request.param, j, _run("port", request.param, init=j["state0"])


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op._id, op.type, op.name, [t.name for t in op.inputs],
                    [c.name for c in op.control_inputs],
                    [(str(t.shape), t.dtype.name) for t in op.outputs],
                    {k: v for k, v in op.attrs.items()
                     if k in ("seed", "_graph_seed", "keep_prob", "n_carry",
                              "n_elems", "spec", "axis", "maxlen")}))
        body = op.attrs.get("body")
        if body is not None:
            out.append(_signature(body))
            out.append([(a.name, b.name) for a, b in body.captures])
    return out


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("model", ["ptb", "seq2seq"])
def test_graphs_match_jax_op_for_op(model, training):
    gj, mj = _graph("jax", model, training)
    gp, mp = _graph("port", model, training)
    assert _signature(gp) == _signature(gj)
    scans = [op for op in gp.get_operations() if op.type == "Scan"]
    assert len(scans) == (1 if model == "ptb" else 3)
    if model == "ptb" and training:
        body = scans[0].attrs["body"]
        drops = [op.name for op in body.get_operations()
                 if op.type == "Dropout"]
        assert drops == ["multi_rnn_cell/cell_0/dropout",
                         "multi_rnn_cell/cell_1/dropout"]
        assert [op.attrs["seed"] for op in body.get_operations()
                if op.type == "Dropout"] == [100, 101]


def test_init_matches_jax(runs):
    model, j, _ = runs
    g, m = _graph("port", model)
    with g.as_default(), _session("port", g) as s:
        s.run(m["init"])
        p_init = _state(s)
    assert sorted(p_init) == sorted(j["state0"])
    for k, v in j["state0"].items():
        assert p_init[k].dtype == v.dtype, k
        np.testing.assert_array_equal(p_init[k], v, err_msg=k)
    if model == "seq2seq":
        np.testing.assert_array_equal(p_init["seq2seq/src_emb"],
                                      p_init["seq2seq/tgt_emb"])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_training_runs_match_jax(runs):
    model, j, p = runs
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=LOSS_RTOL)
    assert p["losses"][-1] < p["losses"][0]
    assert sorted(p["final"]) == sorted(j["final"])
    for k, v in j["final"].items():
        if np.issubdtype(v.dtype, np.floating) and np.abs(v).max() > 0:
            assert _rel(p["final"][k], v) <= STATE_REL, k
        else:
            np.testing.assert_array_equal(p["final"][k], v, err_msg=k)


def test_fetched_states_and_masks_match_jax(runs):
    model, j, p = runs
    if model == "seq2seq":
        for a, b in zip(p["decoded"], j["decoded"]):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        return
    for ps_, js_ in zip(p["states"], j["states"]):
        for (pc, ph), (jc, jh) in zip(ps_, js_):
            np.testing.assert_allclose(pc, jc, rtol=VALUE_TOL,
                                       atol=VALUE_TOL)
            np.testing.assert_allclose(ph, jh, rtol=VALUE_TOL,
                                       atol=VALUE_TOL)
    np.testing.assert_array_equal(p["drop"] == 0, j["drop"] == 0)
    assert 0 < (p["drop"] == 0).mean() < 1


def test_a_mid_training_jax_state_resumes_in_the_port(runs):
    # JAX's variables, Adam slots or global step after STEPS - 1 runs,
    # loaded into a fresh port Session at JAX's run counter (PTB: fed
    # JAX's last fetched LSTM state): the last run's loss and the final
    # state as JAX's
    model, j, _ = runs
    mid = j["mid"]
    g, m = _graph("port", model)
    with g.as_default(), _session("port", g) as s:
        s.run(m["init"])
        convert.load_session_variables(s, mid["state"])
        s._run_counter = mid["counter"]
        if model == "ptb":
            loss = _ptb_steps("port", m, s, 1, state=mid["feed"])[0][0]
        else:
            loss = float(s.run([m["loss"], m["train_op"]],
                               _s2s_feeds(m))[0])
        final = _state(s)
    np.testing.assert_allclose(loss, j["losses"][-1], rtol=LOSS_RTOL)
    for k, v in j["final"].items():
        if np.issubdtype(v.dtype, np.floating) and np.abs(v).max() > 0:
            assert _rel(final[k], v) <= STATE_REL, k
        else:
            np.testing.assert_array_equal(final[k], v, err_msg=k)


def _eval_losses(name, init):
    g, m = _graph(name, "ptb", training=False)
    M = PKGS[name][1]
    with g.as_default(), _session(name, g) as s:
        s.run(m["init"])
        if name == "port":
            convert.load_session_variables(s, init)
        state = M.zero_state(PTB_B, _ptb_cfg(M))
        return [float(s.run(m["loss"], _ptb_feeds(M, m, state)))
                for _ in range(2)]


def test_eval_is_deterministic_and_matches_jax():
    g, m = _graph("jax", "ptb", training=False)
    with g.as_default(), _session("jax", g) as s:
        s.run(m["init"])
        init = _state(s)
    j = _eval_losses("jax", init)
    p = _eval_losses("port", init)
    assert p[0] == p[1]
    np.testing.assert_allclose(p, j, rtol=LOSS_RTOL)


def test_lr_update_sets_the_next_sgd_step():
    g, m = _graph("port", "ptb")
    with g.as_default(), _session("port", g) as s:
        s.run(m["init"])
        s.run(m["lr_update"], {m["new_lr"]: 0.25})
        assert float(s.run(m["lr"])) == 0.25
        before = _state(s)
        state = pptb.zero_state(PTB_B, _ptb_cfg(pptb))
        feeds = _ptb_feeds(pptb, m, state)
        tvars = g.get_collection("trainable_variables")
        with g.as_default():
            grads = pstf.clip_by_global_norm(
                pstf.gradients(m["loss"], tvars), 5.0)[0]
        # the train step's run counter: the same masks
        counter = s._run_counter
        gv = s.run(grads, feeds)
        s._run_counter = counter
        s.run(m["train_op"], feeds)
        after = _state(s)
    for v, gr in zip(tvars, gv):
        want = before[v.var_name] - np.float32(0.25) * gr
        np.testing.assert_allclose(after[v.var_name], want, rtol=1e-6,
                                   atol=1e-7, err_msg=v.var_name)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Per writer: the losses of 2 PTB runs the writer made after saving
    at step 2, and those the other package made after restoring that
    checkpoint into its live session (which had trained its own 2 runs
    first)."""
    d = tmp_path_factory.mktemp("ptb")
    sessions, prefix, own = {}, {}, {}
    for name in ("port", "jax"):
        g, m = _graph(name, "ptb")
        s = _session(name, g)
        with g.as_default():
            s.run(m["init"])
            _ptb_steps(name, m, s, 2)
            prefix[name] = m["saver"].save(s, str(d / f"{name}.ckpt"),
                                           global_step=m["global_step"])
            own[name] = _ptb_steps(name, m, s, 2)[0]
        sessions[name] = (g, m, s)
    other = {}
    for writer in ("port", "jax"):
        name = OTHER[writer]
        g, m, s = sessions[name]
        with g.as_default():
            m["saver"].restore(s, prefix[writer])
            other[writer] = _ptb_steps(name, m, s, 2)[0]
    for _, _, s in sessions.values():
        s.close()
    return own, other


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ptb_checkpoint_resumes_in_the_other_package(resumed, writer):
    own, other = resumed
    np.testing.assert_allclose(other[writer], own[writer], rtol=LOSS_RTOL)


def test_a_changed_graph_seed_changes_the_loss():
    losses = []
    for seed in (SEED, SEED + 1):
        g, m = _graph("port", "ptb", seed=seed)
        with g.as_default(), _session("port", g) as s:
            s.run(m["init"])
            losses.append(_ptb_steps("port", m, s, 1)[0][0])
    assert losses[0] != losses[1]


@pytest.mark.parametrize("model", ["ptb", "seq2seq"])
def test_a_captured_step_equals_the_eager_step(model):
    outs = {}
    for capture in (False, True):
        g, m = _graph("port", model)
        with g.as_default(), _session("port", g) as s:
            s._capture = capture
            s.run(m["init"])
            if model == "ptb":
                losses, states, _ = _ptb_steps("port", m, s, 4)
                outs[capture] = (losses, states, _state(s))
            else:
                feeds = _s2s_feeds(m)
                outs[capture] = ([s.run([m["loss"], m["train_op"],
                                         m["decoded"]], feeds)
                                  for _ in range(4)], _state(s))
            assert s.captures == (1 if capture else 0)
    eager, graph = outs[False], outs[True]
    if model == "ptb":
        assert eager[0] == graph[0]
        for a, b in zip(eager[1], graph[1]):
            for (ac, ah), (bc, bh) in zip(a, b):
                np.testing.assert_array_equal(ac, bc)
                np.testing.assert_array_equal(ah, bh)
    else:
        for a, b in zip(eager[0], graph[0]):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[2], b[2])
    for k, v in eager[-1].items():
        np.testing.assert_array_equal(graph[-1][k], v, err_msg=k)


def test_a_ptb_plan_skips_the_probe_cell():
    from simple_tensorflow_tpu_torch import analysis

    g, m = _graph("port", "ptb")
    with g.as_default(), _session("port", g) as s:
        s.run(m["init"])
        state = pptb.zero_state(PTB_B, _ptb_cfg(pptb))
        s.run([m["loss"], m["train_op"]], _ptb_feeds(pptb, m, state))
        plan = [p for p in s._cache.values()
                if any(op.type == "Scan" for op in p.ops)][0]
    # the probe's ops (the first cell step, outside the loop) stay out;
    # the variables it made are read for the loop
    probe = [op for op in g.get_operations()
             if op.name.startswith("ptb_rnn/multi_rnn_cell/")
             and op.type not in ("VariableV2", "ReadVariable")]
    assert len(probe) > 20
    assert not set(probe) & set(plan.ops)
    assert [op.name for op in analysis.rng_ops(plan.ops)] == [
        "dropout", "multi_rnn_cell/cell_0/dropout",
        "multi_rnn_cell/cell_1/dropout"]
