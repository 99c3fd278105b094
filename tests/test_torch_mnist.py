"""``models/mnist.py`` through the port's ``stf.Session`` against the JAX
package's, on the CPU at batch 8 (the models' published widths).

- ``convnet_model`` built by both packages has the same ops, names, types
  and ids in creation order (seeded random ops read the op counter), and
  the same for ``softmax_model``;
- the initializer run is bit-exact, unseeded and under
  ``set_random_seed(11)``;
- from the JAX session's state (``convert.load_session_variables``),
  three Adam steps at ``keep_prob`` 0.5 on the same numpy feeds: the
  Dropout masks, ``global_step``, the accuracy's ``correct`` vector and,
  at the first step, a variable fetched beside ``train_op`` (its value
  before the in-place update) exact, each loss within rtol 1e-5, every
  variable and Adam slot within relative norm 1e-4 (the two forwards sum
  in other orders: XLA's convolutions and reductions against PyTorch's;
  after three steps they read 1e-7 to 1e-6);
- ``softmax_model``: three GradientDescent steps, the same tolerances.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import mnist as jmnist
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import mnist as pmnist
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jmnist), "port": (pstf, pmnist)}
BATCH = 8
STEPS = 3
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4


def cpu_session(stf):
    return stf.Session(config=stf.ConfigProto(device_count={"GPU": 0}))


def _graph(stf, build, seed=None):
    g = stf.Graph()
    with g.as_default():
        if seed is not None:
            stf.set_random_seed(seed)
        m = build()
    return g, m


def _state(sess):
    return {k: np.array(v) for k, v in sess._variable_store.values.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _signature(g):
    return [(op._id, op.type, op.name, [t.name for t in op.inputs],
             [c.name for c in op.control_inputs],
             op.attrs.get("seed"), op.attrs.get("_graph_seed"))
            for op in g.get_operations()]


@pytest.mark.parametrize("seed", [None, 11])
@pytest.mark.parametrize("model", ["convnet_model", "softmax_model"])
def test_graphs_match_jax_op_for_op(model, seed):
    sigs = {name: _signature(_graph(stf, getattr(mn, model), seed)[0])
            for name, (stf, mn) in PKGS.items()}
    assert sigs["port"] == sigs["jax"]
    assert len(sigs["port"]) > 10


def _images(n):
    x, labels, onehot = jmnist.synthetic_mnist(n, seed=0)
    return x.reshape(-1, 28, 28, 1), labels.astype(np.int32), onehot, x


@pytest.fixture(scope="module", params=[None, 11], ids=["unseeded",
                                                        "seed11"])
def convnet_runs(request):
    """Both packages: the initializer run, then STEPS training steps of
    ``convnet_model`` at keep_prob 0.5, the port started from the JAX
    session's state (after its own initializer run, so both sessions'
    run counters stand at 1)."""
    x4, labels, _, _ = _images(BATCH)
    out = {}
    jax_state = None
    for name, (stf, mn) in PKGS.items():
        g, m = _graph(stf, mn.convnet_model, request.param)
        with g.as_default(), cpu_session(stf) as s:
            s.run(stf.global_variables_initializer())
            init = _state(s)
            if name == "jax":
                jax_state = init
            else:
                convert.load_session_variables(s, jax_state)
            steps = [s.run({"train": m["train_op"], "loss": m["loss"],
                            "gs": m["global_step"], "correct": "Equal:0",
                            "drop": "convnet/dropout:0",
                            "relu": "convnet/fc1/Relu:0",
                            "bias": "convnet/fc2/bias:0"},
                           {m["x"]: x4, m["y_"]: labels,
                            m["keep_prob"]: 0.5})
                     for _ in range(STEPS)]
            out[name] = (init, steps, _state(s), s._run_counter)
    return out


def test_convnet_init_is_bit_exact(convnet_runs):
    j, p = convnet_runs["jax"][0], convnet_runs["port"][0]
    assert sorted(j) == sorted(p)
    for k in j:
        assert p[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_convnet_adam_steps_match_jax(convnet_runs):
    _, jsteps, jstate, jc = convnet_runs["jax"]
    _, psteps, pstate, pc = convnet_runs["port"]
    assert pc == jc == 1 + STEPS
    for i, (a, b) in enumerate(zip(psteps, jsteps)):
        assert a["train"] is None
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        assert a["gs"].dtype == b["gs"].dtype == np.int32
        assert int(a["gs"]) == int(b["gs"]) == i + 1
        np.testing.assert_array_equal(a["correct"], b["correct"])
        # the Dropout masks: where both ReLUs are non-zero, the same units
        # are dropped (a unit the ReLU zeroed carries no mask information)
        live = (a["relu"] != 0) & (b["relu"] != 0)
        assert live.sum() > 0.2 * live.size
        np.testing.assert_array_equal((a["drop"] != 0)[live],
                                      (b["drop"] != 0)[live])
        kept = (b["drop"] != 0)[live].mean()
        assert 0.4 < kept < 0.6
        # a variable fetched beside train_op: its value before the
        # in-place update, as in the JAX package
        if i == 0:
            np.testing.assert_array_equal(a["bias"], b["bias"])
        assert _rel(a["bias"], b["bias"]) <= STATE_RTOL
    assert sorted(pstate) == sorted(jstate)
    for k in jstate:
        assert _rel(pstate[k], jstate[k]) <= STATE_RTOL, k


def test_softmax_model_gradient_descent_matches_jax():
    _, _, onehot, x = _images(BATCH)
    out = {}
    jax_state = None
    for name, (stf, mn) in PKGS.items():
        g, m = _graph(stf, lambda: mn.softmax_model(learning_rate=0.05))
        with g.as_default(), cpu_session(stf) as s:
            s.run(stf.global_variables_initializer())
            if name == "jax":
                jax_state = _state(s)
            else:
                convert.load_session_variables(s, jax_state)
            steps = [s.run([m["train_op"], m["loss"], m["accuracy"],
                            "Equal:0"], {m["x"]: x, m["y_"]: onehot})
                     for _ in range(STEPS)]
            out[name] = (steps, _state(s))
    for a, b in zip(out["port"][0], out["jax"][0]):
        np.testing.assert_allclose(a[1], b[1], rtol=LOSS_RTOL)
        np.testing.assert_array_equal(a[3], b[3])
        assert a[2] == b[2]
    for k in out["jax"][1]:
        assert _rel(out["port"][1][k], out["jax"][1][k]) <= STATE_RTOL, k


def test_load_session_variables_refuses_unknown_names():
    g, _ = _graph(pstf, pmnist.softmax_model)
    with g.as_default(), cpu_session(pstf) as s:
        with pytest.raises(KeyError, match="no variable named"):
            convert.load_session_variables(s, {"W": np.zeros((784, 10)),
                                               "nope": np.zeros(3)})
        convert.load_session_variables(s, {"W": np.ones((784, 10))})
        assert s._variable_store.values["W"].dtype.is_floating_point
        np.testing.assert_array_equal(s._variable_store.as_numpy("W"),
                                      np.ones((784, 10), np.float32))
