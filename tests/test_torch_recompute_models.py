"""``recompute=True`` on the port's three graph models that take it
(``transformer_train_model``, ``causal_lm_train_model``,
``resnet50_train_model``) against the JAX package's, on the CPU: every
layer (bottleneck block for ResNet) a ``RecomputeGradCall`` through
``common.maybe_recompute``.

Configs: the transformer and the causal LM at the tiny config of their
parity tests (2 layers, d_model 32, 2 heads, d_ff 64, vocab 64, dropout
0.1, batch 2 x 8, pad tokens, ``warmup_steps`` 64), ResNet-50 at the
config of its graph parity test (batch 4 x 64 x 64, 10 classes; at batch
2 x 32 x 32 the last stage's BatchNorm normalizes two values a channel
and the packages' losses part by 8% without recompute); f32, graph seed
set. From the JAX Session's initial state
(``convert.load_session_variables``), each package runs one step
(``[loss, train_op]``); the step's gradient is read back from the
optimizer's flat slot (Adam's ``m`` after one step is 0.1 times the
gradient, the Momentum accumulator from zero is the gradient), so each
package differentiates the graph once.

- the graphs have the same ops, names, types and inputs, the call bodies
  too (op for op, with their captures);
- losses within rtol 1e-5, and every variable after the step within
  relative norm 1e-4 of JAX's (the bound of the models' parity tests)
  (the attention key biases' gradient is zero in exact arithmetic, a key
  bias adds the same q . b_k to every score of a query, which the softmax
  cancels, so Adam moves them by roundoff alone: they are held to the
  learning rate);
- gradients (the flat slot): for the transformer and the causal LM
  within relative norm 1e-5 of JAX's. ResNet's f32 gradients sit 2-4%
  from a float64 evaluation in both packages (BatchNorm's backward
  cancels most of every gradient, ``tests/test_torch_resnet.py``), so
  they are held to JAX's at relative norm 0.1 (the bound of
  ``tests/test_torch_resnet_graph.py``), and so is ResNet's update (the
  learning rate times the gradient);
- against the same port graph run under
  ``function.without_rematerialization()`` (every body run once and kept
  by autograd, the same op names and masks): losses within rtol 1e-5,
  the gradient (the flat slot) within relative norm 1e-5;
- ResNet's moving statistics stay at their initial values: the bodies'
  moving-average assigns never run, as in JAX.
"""

import contextlib

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu_torch.framework import function
from simple_tensorflow_tpu.models import causal_lm as jclm
from simple_tensorflow_tpu.models import resnet as jres
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import causal_lm as pclm
from simple_tensorflow_tpu_torch.models import resnet as pres
from simple_tensorflow_tpu_torch.models import transformer as ptr
from torch_threads import one_torch_thread  # noqa: F401

SEED = 5
B, S = 2, 8
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
RESNET_GRAD_REL = 0.1
STATE_RTOL = 1e-4
MODULES = {"transformer": (jtr, ptr), "causal_lm": (jclm, pclm),
           "resnet": (jres, pres)}
SLOT = {"transformer": "Adam/Adam/fused_m_g0",
        "causal_lm": "Adam/Adam/fused_m_g0",
        "resnet": "Momentum/Momentum/fused_momentum_g0"}


def _cfg(T):
    return T.TransformerConfig(vocab_size=64, d_model=32, num_heads=2,
                               d_ff=64, num_layers=2, dropout=0.1,
                               max_len=32)


def _model(name, stf, M, recompute):
    if name == "transformer":
        m = M.transformer_train_model(B, S, S, cfg=_cfg(M),
                                      compute_dtype=stf.float32,
                                      warmup_steps=64, recompute=recompute)
        b = jtr.synthetic_wmt_batch(B, S, S, vocab_size=64, seed=0)
        b["src_ids"][0, -3:] = 0
        b["tgt_out"][1, -2:] = 0
        return m, {m[k]: v for k, v in b.items()}
    if name == "causal_lm":
        m = M.causal_lm_train_model(B, S, cfg=_cfg(M),
                                    compute_dtype=stf.float32,
                                    warmup_steps=64, recompute=recompute)
        ids = np.random.RandomState(0).randint(2, 64, (B, S + 1))
        ids[1, -2:] = 0
        return m, {m["tok_in"]: ids[:, :-1].astype(np.int32),
                   m["tok_out"]: ids[:, 1:].astype(np.int32)}
    m = M.resnet50_train_model(batch_size=4, image_size=64, num_classes=10,
                               dtype=stf.float32, learning_rate=1e-2,
                               recompute=recompute)
    images, labels = jres.synthetic_imagenet(4, 64)
    return m, {m["images"]: images, m["labels"]: labels % 10}


def _build(name, pkg, recompute):
    stf = jstf if pkg == "jax" else pstf
    M = MODULES[name][0 if pkg == "jax" else 1]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(SEED)
        m, feeds = _model(name, stf, M, recompute)
    return g, m, feeds


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _run(name, pkg, init=None, inline=False):
    stf = jstf if pkg == "jax" else pstf
    g, m, feeds = _build(name, pkg, True)
    cfg = stf.ConfigProto(device_count={"GPU": 0})
    mode = function.without_rematerialization() if inline \
        else contextlib.nullcontext()
    with g.as_default(), stf.Session(config=cfg) as s, mode:
        s.run(stf.global_variables_initializer())
        if init is not None:
            convert.load_session_variables(s, init)
        state0 = _state(s)
        # with Adam, the learning rate the step used (fetched beside it)
        out = s.run({"loss": m["loss"], "train": m["train_op"],
                     "lr": m.get("learning_rate", [])}, feeds)
        state1 = _state(s)
    slot = SLOT[name]
    grad = np.asarray(state1[slot], np.float64) / (
        0.1 if slot.startswith("Adam/") else 1.0)
    return grad, out["loss"], state0, state1, out["lr"]


@pytest.fixture(scope="module", params=list(MODULES))
def runs(request):
    name = request.param
    jax_run = _run(name, "jax")
    return name, jax_run, _run(name, "port", init=jax_run[2]), \
        _run(name, "port", init=jax_run[2], inline=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op.type, op.name, [t.name for t in op.inputs]))
        fg = op.attrs.get("func_graph")
        if fg is not None:
            out.append([(o.type, o.name, [t.name for t in o.inputs])
                        for o in fg.get_operations()])
            out.append([(a.name, b.name) for a, b in fg.captures])
    return out


@pytest.mark.parametrize("name", list(MODULES))
def test_recompute_graphs_match_jax_op_for_op(name):
    sigs = [_signature(_build(name, pkg, True)[0]) for pkg in ("jax",
                                                                "port")]
    assert sigs[0] == sigs[1]
    calls = [s for s in sigs[1] if isinstance(s, tuple)
             and s[0] == "RecomputeGradCall"]
    assert len(calls) == {"transformer": 4, "causal_lm": 2,
                          "resnet": 16}[name]


def test_recompute_losses_and_gradients_match_jax(runs):
    name, (jg, jloss, j0, j1, _), (pg, ploss, p0, p1, lr), _ = runs
    np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
    assert sorted(p1) == sorted(j1)
    assert _rel(pg, jg) <= (RESNET_GRAD_REL if name == "resnet"
                            else GRAD_REL)
    for k in j1:
        p, j = (np.asarray(x[k], np.float32) for x in (p1, j1))
        if name == "resnet":
            # the step's update is the learning rate times the gradient
            # (the Momentum slot starts at zero)
            assert _rel(p - p0[k], j - j0[k]) <= RESNET_GRAD_REL, k
        elif k.endswith("/k/bias"):
            for x in (p, j):
                assert np.abs(x - p0[k]).max() <= 1.01 * lr, k
        else:
            assert _rel(p, j) <= STATE_RTOL, k
    moving = [k for k in p0 if "moving_" in k]
    assert len(moving) == (2 * 53 if name == "resnet" else 0)
    for k in moving:
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
        np.testing.assert_array_equal(j1[k], j0[k], err_msg=k)


def test_recompute_gradients_match_the_inline_graph(runs):
    name, _, (pg, ploss, _, _, _), (ig, iloss, _, _, _) = runs
    np.testing.assert_allclose(ploss, iloss, rtol=LOSS_RTOL)
    assert _rel(pg, ig) <= GRAD_REL
