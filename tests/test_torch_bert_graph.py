"""``models/bert.py``'s ``bert_pretrain_model`` through the port's
``stf.Session`` against the JAX package's, on the CPU, with and without
``recompute``: ``BertConfig.tiny()`` (2 layers, hidden 32, 2 heads,
intermediate 64, vocab 99) with both dropouts at 0.1, batch 2 x 16, 4
predictions, ``use_input_mask=True`` with padded rows (lengths 15 and 12
from the seed), f32 compute, Adam lr 1e-4; unseeded graphs (each random
op's stream from its name).

- the graphs have the same ops, names, types, inputs and output specs in
  creation order, the recompute bodies too, at both compute dtypes; the
  variables are the same;
- the initializer run: the truncated-normal kernels and embeddings within
  4 ulp of JAX's (3 ulp of the draw and one rounding of the product with
  the stddev), most values bit-equal; the constant ones bit-exact;
- from JAX's initial state (``convert.load_session_variables``): every
  Dropout's mask equal to JAX's (fetched where the op is in the root
  graph), the flash attention outputs within 1e-5 (another keep mask
  moves them by O(1)), and with ``recompute`` each layer's output (its
  call op) within 1e-5; the masks of the two variants differ (a body's ops
  are named within the body, and an unseeded stream comes from the name),
  as in JAX;
- the gradient of every variable (``stf.gradients``) within relative norm
  1e-5 of JAX's, except the attention key biases, whose gradient is zero
  in exact arithmetic (the softmax cancels a key bias): both packages give
  roundoff, held to 1e-6 in absolute value;
- 3 Adam steps: the losses within rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import bert as jbert
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import bert as pbert
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jbert), "port": (pstf, pbert)}
B, S, P = 2, 16, 4
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
ZERO_GRAD_ATOL = 1e-6
VALUE_TOL = 1e-5


def _cfg(M):
    return dataclasses.replace(M.BertConfig.tiny(), hidden_dropout=0.1,
                               attention_dropout=0.1)


def _batch():
    return pbert.synthetic_pretrain_batch(B, S, P, vocab_size=99, seed=0,
                                          input_mask=True)


def _graph(stf, M, recompute, dtype="float32"):
    g = stf.Graph()
    with g.as_default():
        m = M.bert_pretrain_model(B, S, P, cfg=_cfg(M),
                                  compute_dtype=getattr(stf, dtype),
                                  use_input_mask=True, recompute=recompute)
        tvars = stf.trainable_variables()
        m["grads"] = stf.gradients(m["loss"], tvars)
        m["names"] = [v.var_name for v in tvars]
        m["init"] = stf.global_variables_initializer()
    return g, m


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op._id, op.type, op.name, [t.name for t in op.inputs],
                    [c.name for c in op.control_inputs],
                    [(str(t.shape), t.dtype.name) for t in op.outputs]))
        fg = op.attrs.get("func_graph")
        if fg is not None:
            out.append([(o.type, o.name, [t.name for t in o.inputs],
                         [(str(t.shape), t.dtype.name) for t in o.outputs])
                        for o in fg.get_operations()])
            out.append([(a.name, b.name) for a, b in fg.captures])
    return out


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_match_jax_op_for_op(dtype, recompute):
    graphs = {name: _graph(stf, M, recompute, dtype)
              for name, (stf, M) in PKGS.items()}
    assert _signature(graphs["port"][0]) == _signature(graphs["jax"][0])
    assert graphs["port"][1]["names"] == graphs["jax"][1]["names"]
    types = {op.type for op in graphs["port"][0].get_operations()}
    # (with recompute, the layers' ops of the root graph are the
    # throwaway calls' that made the variables: never run)
    assert {"FlashAttentionDropout", "Dropout", "FusedLayerNorm", "Gelu",
            "Tanh", "Squeeze", "FusedSoftmaxXent",
            "SparseSoftmaxCrossEntropyWithLogits",
            "FusedAdamUpdate"} <= types
    calls = [op for op in graphs["port"][0].get_operations()
             if op.type == "RecomputeGradCall"]
    assert len(calls) == (2 if recompute else 0)
    for op in calls:
        body = {o.type for o in op.attrs["func_graph"].get_operations()}
        assert {"FlashAttentionDropout", "Dropout", "FusedLayerNorm",
                "Gelu", "FuncArg", "CapturedInput"} <= body


def _probes(g, recompute):
    """Root-graph tensors that show the masks: every Dropout op's output
    (mask = its zeros), the flash ops' outputs and, with recompute, each
    layer call's output."""
    drops, values = {}, {}
    for op in g.get_operations():
        if op.type == "Dropout" and not op.name.startswith(
                ("bert/encoder/layer_", "cls/")):
            drops[op.name] = op.outputs[0]
        elif op.type == "Dropout" and not recompute:
            drops[op.name] = op.outputs[0]
        elif op.type == "FlashAttentionDropout" and not recompute:
            values[op.name] = op.outputs[0]
        elif op.type == "RecomputeGradCall":
            values[op.name] = op.outputs[0]
    return drops, values


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _run(name, recompute, init=None):
    stf, M = PKGS[name]
    g, m = _graph(stf, M, recompute)
    batch = _batch()
    drops, values = _probes(g, recompute)
    with g.as_default(), stf.Session(
            config=stf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(m["init"])
        state0 = _state(s)
        if init is not None:
            convert.load_session_variables(s, init)
        feeds = {m[k]: v for k, v in batch.items()}
        first = s.run({"drops": drops, "values": values,
                       "grads": m["grads"], "loss": m["loss"]}, feeds)
        losses = [float(s.run([m["loss"], m["train_op"]], feeds)[0])
                  for _ in range(STEPS)]
    return dict(first, names=m["names"], state0=state0, losses=losses)


@pytest.fixture(scope="module", params=[False, True],
                ids=["inline", "recompute"])
def runs(request):
    jax_run = _run("jax", request.param)
    return request.param, jax_run, _run("port", request.param,
                                        init=jax_run["state0"])


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def _port_init(recompute):
    g, m = _graph(pstf, pbert, recompute)
    with g.as_default(), pstf.Session(
            config=pstf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(m["init"])
        return _state(s)


def test_init_matches_jax(runs):
    recompute, j, _ = runs
    jinit, pinit = j["state0"], _port_init(recompute)
    assert sorted(pinit) == sorted(jinit)
    drawn = 0
    for k, jv in jinit.items():
        pv = pinit[k]
        assert pv.dtype == jv.dtype and pv.shape == jv.shape, k
        if k.endswith(("/kernel", "_embeddings")):
            assert _ulps(pv, jv).max() <= 4, k
            assert (pv != jv).mean() < 0.05, k
            drawn += 1
        else:
            np.testing.assert_array_equal(pv, jv, err_msg=k)
    # 6 kernels a layer, the pooler, the MLM transform, NSP; 3 embeddings
    assert drawn == 6 * 2 + 3 + 3


def test_masks_match_jax(runs):
    recompute, j, p = runs
    assert sorted(p["drops"]) == sorted(j["drops"])
    assert len(p["drops"]) == (1 if recompute else 5)
    for k, jv in j["drops"].items():
        np.testing.assert_array_equal(p["drops"][k] == 0, jv == 0,
                                      err_msg=k)
        assert (jv == 0).any(), k
    assert sorted(p["values"]) == sorted(j["values"])
    assert len(p["values"]) == 2
    for k, jv in j["values"].items():
        np.testing.assert_allclose(p["values"][k], jv, rtol=VALUE_TOL,
                                   atol=VALUE_TOL, err_msg=k)


def test_recompute_draws_other_masks_than_the_inline_graph(runs):
    recompute, j, p = runs
    other = _run("port", not recompute, init=j["state0"])
    # the embeddings' dropout is in the root graph in both: the same mask
    emb = "bert/embeddings/dropout"
    np.testing.assert_array_equal(p["drops"][emb] == 0,
                                  other["drops"][emb] == 0)
    # the layers' streams differ: so does the loss
    assert abs(p["loss"] - other["loss"]) > 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_gradients_match_jax(runs):
    _, j, p = runs
    assert p["names"] == j["names"]
    key_biases = 0
    for name, pg, jg in zip(j["names"], p["grads"], j["grads"]):
        if name.endswith("/attention/key/bias"):
            assert np.abs(pg).max() <= ZERO_GRAD_ATOL, name
            assert np.abs(jg).max() <= ZERO_GRAD_ATOL, name
            key_biases += 1
        else:
            assert _rel(pg, jg) <= GRAD_REL, name
    assert key_biases == 2


def test_training_steps_match_jax(runs):
    _, j, p = runs
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=LOSS_RTOL)
    assert p["losses"][-1] < p["losses"][0]
