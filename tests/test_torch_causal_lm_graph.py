"""``models/causal_lm.py``'s graph ``causal_lm_train_model`` through the
port's ``stf.Session`` against the JAX package's, on the CPU at a tiny
config: 2 layers, d_model 32, 2 heads, d_ff 64, vocab 64, dropout 0.1,
batch 2 x 8 with pad tokens in ``tok_out``, graph seed set.

- the graphs built by both packages have the same ops, names, types,
  inputs, seeds and output specs in creation order, at both compute
  dtypes, seeded and unseeded; the ops are a subset of the transformer's
  (no op type is new), the variables under ``causal_lm/decoder/layer_i``
  with ``ln1`` and ``ln3`` and no ``ln2``;
- the initializer run: every uniform-initialised variable and the constant
  ones bit-exact, the normal-initialised embedding within 3 ulp (most
  values bit-equal), as ``tests/test_torch_transformer_graph.py`` holds
  the transformer's;
- from the JAX session's initial state, f32 compute, 3 Adam steps on the
  same feeds at ``warmup_steps`` 64 (the reason for 64, not 4, is
  ``test_torch_transformer_graph.py``'s; the Session captures from its
  second run, so steps 2-3 draw their dropout seeds from the seed
  buffer): losses within rtol 1e-5, every variable and Adam slot within
  relative norm 1e-4 except the attention key biases, whose gradient is
  zero in exact arithmetic and which are held to the summed learning rate
  (the exception stated there);
- bf16 compute, 1 step: the loss within rtol 4e-3 (one bf16 rounding);
- a changed graph seed changes the loss.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import causal_lm as jclm
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import causal_lm as pclm
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jclm), "port": (pstf, pclm)}
SEED = 5
B, S = 2, 8
WARMUP = 64
F32_STEPS = 3
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 4e-3
STATE_RTOL = 1e-4
KEYS = ("loss", "train_op", "learning_rate", "global_step", "tok_in",
        "tok_out")


def _cfg(C):
    return C.TransformerConfig(vocab_size=64, d_model=32, num_heads=2,
                               d_ff=64, num_layers=2, dropout=0.1,
                               max_len=32)


def _graph(stf, C, dtype, seed=SEED):
    g = stf.Graph()
    with g.as_default():
        if seed is not None:
            stf.set_random_seed(seed)
        m = C.causal_lm_train_model(B, S, cfg=_cfg(C),
                                    compute_dtype=getattr(stf, dtype),
                                    warmup_steps=WARMUP)
    return g, m


def _batch():
    rng = np.random.RandomState(0)
    tok = rng.randint(2, 64, (B, S + 1)).astype(np.int32)
    tok_out = tok[:, 1:].copy()
    tok_out[1, -2:] = 0
    return {"tok_in": tok[:, :-1], "tok_out": tok_out}


def _signature(g):
    return [(op._id, op.type, op.name, [t.name for t in op.inputs],
             [c.name for c in op.control_inputs], op.attrs.get("seed"),
             op.attrs.get("_graph_seed"),
             [(str(t.shape), t.dtype.name) for t in op.outputs])
            for op in g.get_operations()]


@pytest.mark.parametrize("seed", [None, SEED])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_match_jax_op_for_op(dtype, seed):
    sigs = {name: _signature(_graph(stf, C, dtype, seed)[0])
            for name, (stf, C) in PKGS.items()}
    assert sigs["port"] == sigs["jax"]
    types = {s[1] for s in sigs["port"]}
    assert {"FlashAttentionDropout", "FusedDropoutBiasResidual",
            "FusedLayerNorm", "FusedSoftmaxXent", "Dropout",
            "RandomStandardNormal", "FusedAdamUpdate"} <= types
    flash = [s for s in sigs["port"] if s[1] == "FlashAttentionDropout"]
    assert len(flash) == 2
    # the transformer graph has every op type the causal LM builds
    from simple_tensorflow_tpu_torch.models import transformer as ptr

    g = pstf.Graph()
    with g.as_default():
        ptr.transformer_train_model(B, S, S, cfg=_cfg(ptr),
                                    compute_dtype=getattr(pstf, dtype))
    assert types <= {op.type for op in g.get_operations()}


def test_graph_builders_return_the_jax_dict_keys():
    from simple_tensorflow_tpu.models import resnet as jres
    from simple_tensorflow_tpu_torch.models import resnet as pres

    for name, (stf, C) in PKGS.items():
        _, m = _graph(stf, C, "float32")
        assert sorted(m) == sorted(KEYS), name
        assert isinstance(m["loss"], stf.Tensor)
    keys = {}
    for name, stf, R in (("jax", jstf, jres), ("port", pstf, pres)):
        with stf.Graph().as_default():
            m = R.resnet50_train_model(batch_size=2, image_size=32,
                                       num_classes=10, dtype=stf.float32)
        keys[name] = sorted(m)
        assert isinstance(m["loss"], stf.Tensor)
    assert keys["port"] == keys["jax"] == sorted(
        ("images", "labels", "logits", "loss", "train_op", "accuracy",
         "global_step"))


def test_recompute_raises():
    # recompute=True is ported (tests/test_torch_recompute_models.py);
    # "auto" no longer raises: the JAX function passes it on, truthy, so
    # every layer recomputes there and here
    n = {}
    for name, stf, M in (("jax", jstf, jclm), ("port", pstf, pclm)):
        g = stf.Graph()
        with g.as_default():
            M.causal_lm_train_model(B, S, cfg=_cfg(M), recompute="auto")
        n[name] = sum(op.type == "RecomputeGradCall"
                      for op in g.get_operations())
    assert n["port"] == n["jax"] == _cfg(pclm).num_layers


def _session(stf):
    return stf.Session(config=stf.ConfigProto(device_count={"GPU": 0}))


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _train(name, dtype, steps, init_from=None, seed=SEED):
    stf, C = PKGS[name]
    g, m = _graph(stf, C, dtype, seed)
    b = _batch()
    with g.as_default(), _session(stf) as s:
        s.run(stf.global_variables_initializer())
        init = _state(s)
        if init_from is not None:
            convert.load_session_variables(s, init_from)
        feeds = {m[k]: b[k] for k in ("tok_in", "tok_out")}
        out = [s.run({"loss": m["loss"], "gs": m["global_step"],
                      "lr": m["learning_rate"], "train": m["train_op"]},
                     feeds)
               for _ in range(steps)]
        return init, out, _state(s), s._run_counter


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request):
    """Per compute dtype: one JAX Session (init, then the steps) and the
    port Session started from the JAX initial state."""
    dtype = request.param
    steps = F32_STEPS if dtype == "float32" else 1
    jax_run = _train("jax", dtype, steps)
    port_run = _train("port", dtype, steps, init_from=jax_run[0])
    return dtype, jax_run, port_run


def _f32(x):
    return np.asarray(x).astype(np.float32)


def test_init_matches_jax(runs):
    _, (jinit, *_), (pinit, *_) = runs
    assert sorted(pinit) == sorted(jinit)
    for k, j in jinit.items():
        p = pinit[k]
        assert p.dtype == j.dtype and p.shape == j.shape, k
        if k.endswith("shared_embedding"):
            pj, jj = _f32(p), _f32(j)
            ulps = np.abs(pj.view(np.int32).astype(np.int64)
                          - jj.view(np.int32))
            assert ulps.max() <= 3 and (ulps != 0).mean() < 0.03
        else:
            np.testing.assert_array_equal(_f32(p), _f32(j), err_msg=k)
    assert len([k for k in jinit if k.endswith("/kernel")]) == 2 * 6
    lns = {k.split("/")[3] for k in jinit if "/ln" in k}
    assert lns == {"ln1", "ln3"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_training_steps_match_jax(runs):
    dtype, (_, jout, jstate, jc), (_, pout, pstate, pc) = runs
    assert pc == jc == 1 + len(jout)
    rtol = LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    for i, (a, b) in enumerate(zip(pout, jout)):
        assert a["train"] is None
        assert int(a["gs"]) == int(b["gs"]) == i
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    if dtype != "float32":
        return
    assert sorted(pstate) == sorted(jstate)
    lr_sum = float(sum(b["lr"] for b in jout))
    key_biases = [k for k in jstate if k.endswith("/k/bias")]
    assert len(key_biases) == 2
    for k in jstate:
        if k in key_biases:
            for st in (pstate, jstate):
                assert np.abs(_f32(st[k])).max() <= lr_sum, k
        else:
            assert _rel(_f32(pstate[k]), _f32(jstate[k])) <= STATE_RTOL, k


def test_a_changed_graph_seed_changes_the_loss(runs):
    dtype, (jinit, jout, _, _), (_, pout, _, _) = runs
    _, other, _, _ = _train("port", dtype, 1, init_from=jinit,
                            seed=SEED + 1)
    assert abs(float(other[0]["loss"]) - float(pout[0]["loss"])) > 1e-4
