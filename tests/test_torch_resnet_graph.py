"""``models/resnet.py``'s graph ``resnet50_train_model`` through the port's
``stf.Session`` against the JAX package's, on the CPU:
``resnet50_train_model(batch_size=4, image_size=64, num_classes=10,
dtype=f32, learning_rate=1e-2)``, graph seed set, one
``synthetic_imagenet`` batch.

- the graphs built by both packages have the same ops, names, types,
  inputs, seeds and output specs in creation order (f32 and the shipped
  bf16), the same ``UPDATE_OPS`` (the moving-average assigns of every
  BatchNorm) and, at bf16, the same two-group flat Momentum layout
  (``FusedMomentumUpdate``'s groups and slot names);
- the initializer run: the truncated-normal convolution kernels within 4
  ulp of JAX's (3 ulp of the draw, as ``prng.normal``'s, and one rounding
  of the product with the stddev) and the normal ``fc`` kernel within 3
  ulp, most values bit-equal; the constant ones bit-exact;
- teacher-forced steps: from the JAX session's initial state and again
  from its state after steps 1 and 2 (``convert.load_session_variables``,
  the flat ``momentum`` slot and the global step included), each port
  step gives JAX's loss within rtol 1e-5 (a forward of the same weights)
  and each variable's update within relative norm 0.1 of JAX's (the
  moving statistics untouched on both sides). The reason and the measured
  spread are ``tests/test_torch_resnet.py``'s: a free run amplifies the
  gradients' roundoff, which moves with the host's oneDNN code path
  (JAX's third loss 4.0840 or 3.8835 on one box);
- the exact chain: from JAX's state after step 1, and again after step 2,
  one port step each gives JAX's next loss within rtol 1e-5 and carries
  the loaded Momentum slot (the port's new slot minus ``mu`` times the
  loaded one, the gradient, within relative norm 0.1 of JAX's, as
  ``tests/test_torch_resnet.py`` holds it); the global step counts on;
- ``moving_mean``/``moving_variance`` unchanged by the ``train_op`` in
  both packages (it never runs ``UPDATE_OPS``).
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import resnet as jres
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import resnet as pres
from torch_threads import one_thread

PKGS = {"jax": (jstf, jres), "port": (pstf, pres)}
SEED = 5
B, SIZE, CLASSES, LR, MU = 4, 64, 10, 1e-2, 0.9
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_REL = 0.1
SLOT = "Momentum/Momentum/fused_momentum_g0"


def _graph(stf, R, dtype="float32", seed=SEED):
    g = stf.Graph()
    with g.as_default():
        if seed is not None:
            stf.set_random_seed(seed)
        m = R.resnet50_train_model(batch_size=B, image_size=SIZE,
                                   num_classes=CLASSES,
                                   dtype=getattr(stf, dtype),
                                   learning_rate=LR)
    return g, m


def _signature(g):
    return [(op._id, op.type, op.name, [t.name for t in op.inputs],
             [c.name for c in op.control_inputs], op.attrs.get("seed"),
             op.attrs.get("_graph_seed"),
             [(str(t.shape), t.dtype.name) for t in op.outputs])
            for op in g.get_operations()]


def _momentum_layout(g):
    (op,) = [op for op in g.get_operations()
             if op.type == "FusedMomentumUpdate"]
    return {k: op.attrs[k] for k in ("group_params", "group_momentum",
                                     "group_ud", "use_nesterov")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_match_jax_op_for_op(dtype):
    graphs = {name: _graph(stf, R, dtype)[0]
              for name, (stf, R) in PKGS.items()}
    sigs = {name: _signature(g) for name, g in graphs.items()}
    assert sigs["port"] == sigs["jax"]
    assert {"FusedBatchNorm", "L2Loss", "TruncatedNormal", "AddN",
            "RandomStandardNormal", "FusedMomentumUpdate"} <= \
        {s[1] for s in sigs["port"]}
    updates = {name: [op.name for op in g.get_collection(
        stf.GraphKeys.UPDATE_OPS)]
        for (name, g), stf in zip(graphs.items(), (jstf, pstf))}
    assert updates["port"] == updates["jax"]
    assert len(updates["port"]) == 2 * 53
    layouts = {name: _momentum_layout(g) for name, g in graphs.items()}
    assert layouts["port"] == layouts["jax"]
    groups = layouts["port"]["group_params"]
    if dtype == "bfloat16":
        # the bf16 convolution kernels, then the f32 BatchNorm and fc
        assert len(groups) == 2
        assert all(n.endswith("/kernel") for n in groups[0])
        assert layouts["port"]["group_ud"] == ("float32", "float32")
    else:
        assert len(groups) == 1


def _session(stf):
    return stf.Session(config=stf.ConfigProto(device_count={"GPU": 0}))


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _batch():
    images, labels = jres.synthetic_imagenet(B, SIZE)
    return images, labels % CLASSES


def _fetches(m):
    return {"loss": m["loss"], "gs": m["global_step"], "train": m["train_op"]}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX session: its initial state, and the state and fetches of
    each of 3 steps."""
    g, m = _graph(jstf, jres)
    images, labels = _batch()
    with g.as_default(), _session(jstf) as s:
        s.run(jstf.global_variables_initializer())
        states = [_state(s)]
        outs = []
        for _ in range(STEPS):
            outs.append(s.run(_fetches(m), {m["images"]: images,
                                            m["labels"]: labels}))
            states.append(_state(s))
    return states, outs


@pytest.fixture(scope="module")
def port_run(jax_run):
    """One port session: its own initial state, then one step from JAX's
    initial state, one from JAX's state after step 1 and one after step 2
    (fetches and state after each), and the state after the last."""
    states, _ = jax_run
    g, m = _graph(pstf, pres)
    images, labels = _batch()
    feeds = {m["images"]: images, m["labels"]: labels}
    with g.as_default(), _session(pstf) as s:
        # the initializer in one thread (torch_threads); the steps at the
        # default count
        with one_thread():
            s.run(pstf.global_variables_initializer())
        init = _state(s)
        chain = []
        for k in range(STEPS):
            convert.load_session_variables(s, states[k])
            chain.append((s.run(_fetches(m), feeds), _state(s)))
    return init, chain, chain[-1][1]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def test_init_matches_jax(jax_run, port_run):
    jinit, pinit = jax_run[0][0], port_run[0]
    assert sorted(pinit) == sorted(jinit)
    convs = [k for k in jinit if k.endswith("/kernel") and "/fc/" not in k]
    assert len(convs) == 53
    for k, j in jinit.items():
        p = pinit[k]
        assert p.dtype == j.dtype and p.shape == j.shape, k
        if k in convs:
            ulps = _ulps(p, j)
            assert ulps.max() <= 4 and (ulps != 0).mean() < 0.03, k
        elif k == "resnet/fc/kernel":
            ulps = _ulps(p, j)
            assert ulps.max() <= 3 and (ulps != 0).mean() < 0.03
        else:
            np.testing.assert_array_equal(p, j, err_msg=k)
    k = pinit["resnet/stage2_block0/conv2/kernel"]     # (3, 3, 256, 256)
    std = np.sqrt(2.0 / (3 * 3 * 256)) / 0.87962566103423978
    assert np.abs(k).max() < 2 * std


def test_free_steps_match_jax(jax_run, port_run):
    # teacher-forced (module docstring): each step from JAX's state before
    # it gives JAX's loss and, variable by variable, JAX's update
    states, jout = jax_run
    for k, (out, state) in enumerate(port_run[1]):
        assert out["train"] is None
        assert int(out["gs"]) == int(jout[k]["gs"]) == k
        np.testing.assert_allclose(out["loss"], jout[k]["loss"],
                                   rtol=LOSS_RTOL)
        errs = {}
        for name, before in states[k].items():
            if before.dtype.kind != "f":
                continue
            before = before.astype(np.float64)
            step_port = state[name].astype(np.float64) - before
            step_jax = states[k + 1][name].astype(np.float64) - before
            if np.any(step_jax):
                errs[name] = _rel(step_port, step_jax)
            else:     # the moving statistics
                assert not np.any(step_port), name
        assert max(errs.values()) <= GRAD_REL, errs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_the_chain_from_jax_states_matches_step_by_step(jax_run, port_run):
    states, jout = jax_run
    chain = port_run[1][1:]
    for k, (out, state) in zip((1, 2), chain):
        assert int(out["gs"]) == int(jout[k]["gs"]) == k
        np.testing.assert_allclose(out["loss"], jout[k]["loss"],
                                   rtol=LOSS_RTOL)
        acc0 = states[k][SLOT]
        assert np.abs(acc0).max() > 0        # the carried slot is not zero
        g_port = state[SLOT] - np.float32(MU) * acc0
        g_jax = states[k + 1][SLOT] - np.float32(MU) * acc0
        assert _rel(g_port, g_jax) <= GRAD_REL
        # the slot the step started from is in the new one
        assert _rel(state[SLOT], states[k + 1][SLOT]) < \
            _rel(g_port, states[k + 1][SLOT])
        assert int(state["global_step"]) == k + 1


def test_moving_statistics_stay_at_their_initial_values(jax_run, port_run):
    jstate, pstate = jax_run[0][-1], port_run[2]
    for st in (jstate, pstate):
        means = [k for k in st if k.endswith("/moving_mean")]
        variances = [k for k in st if k.endswith("/moving_variance")]
        assert len(means) == len(variances) == 53
        for k in means:
            assert not st[k].any(), k
        for k in variances:
            assert (st[k] == 1).all(), k


def test_the_train_plan_has_no_variable_hazard():
    # the L2 reads every kernel variable that FusedMomentumUpdate writes;
    # the gradients order the two, so the detector finds nothing to raise
    # or warn about, as the JAX Session's (both runs above plan
    # [loss, train_op] under the default mode, "raise")
    from simple_tensorflow_tpu_torch import analysis
    from simple_tensorflow_tpu_torch.framework import lowering

    g, m = _graph(pstf, pres)
    ops = lowering.prune([m["loss"].op, m["train_op"]], set())
    assert any(op.type == "FusedMomentumUpdate" for op in ops)
    assert sum(op.type == "L2Loss" for op in ops) == 54
    _, diags = analysis.check_plan(ops, mode="raise")
    assert diags == []
