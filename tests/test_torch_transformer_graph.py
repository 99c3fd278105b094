"""``models/transformer.py``'s ``transformer_train_model`` through the
port's ``stf.Session`` against the JAX package's, on the CPU at a tiny
config: 2 + 2 layers, d_model 32, 2 heads, d_ff 64, vocab 64, dropout
0.1, batch 2 x 8 / 8 with pad tokens in src and tgt, graph seed set.

- the graphs built by both packages have the same ops, names, types,
  inputs, seeds and output specs in creation order, at both compute
  dtypes, seeded and unseeded;
- the initializer run: every uniform-initialised variable (the Dense
  kernels, bf16 at bf16 compute) and the constant ones bit-exact; the
  normal-initialised embedding within 3 ulp, most values bit-equal (the
  two ``log1p`` differ by an ulp at some inputs);
- from the JAX session's initial state (``convert.load_session_variables``),
  f32 compute, 3 Adam steps on the same feeds at ``warmup_steps`` 64 (the
  noam lr 3.5e-4 to 1.0e-3; at ``warmup_steps`` 4 it reaches 0.066 by step
  3, every weight of this 32-wide model moves ~20% a step, and the
  trajectory amplifies ulp-level differences about tenfold a step: under
  graph seed 5 the step-3 loss drifted 3.2e-5 from JAX's with every
  step-1 and step-2 parameter within half an lr) (the Session captures from
  its second run, so steps 2-3 draw their dropout seeds from the seed
  buffer): losses and accuracy within rtol 1e-5; every variable and Adam
  slot within relative norm 1e-4 (Adam's eps 1e-9 turns ulp-level
  gradient differences into larger update differences where ``v`` is
  tiny), except the attention key biases: their gradient is zero in exact
  arithmetic (a key bias adds q . b_k to every score of a query, which the
  softmax cancels), so both packages move them by roundoff alone, and
  they are held to the bound of that motion, the summed learning rate;
- bf16 compute, 1 step: the loss within rtol 4e-3, one bf16 rounding
  (2^-8): XLA fuses elementwise chains and rounds to bf16 once, PyTorch
  rounds after every op;
- a changed graph seed changes the loss (the dropout masks matter).
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import transformer as ptr
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jtr), "port": (pstf, ptr)}
SEED = 5
B, S = 2, 8
WARMUP = 64
F32_STEPS = 3
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 4e-3
STATE_RTOL = 1e-4


def _cfg(T):
    return T.TransformerConfig(vocab_size=64, d_model=32, num_heads=2,
                               d_ff=64, num_layers=2, dropout=0.1,
                               max_len=32)


def _graph(stf, T, dtype, seed=SEED):
    g = stf.Graph()
    with g.as_default():
        if seed is not None:
            stf.set_random_seed(seed)
        m = T.transformer_train_model(B, S, S, cfg=_cfg(T),
                                      compute_dtype=getattr(stf, dtype),
                                      warmup_steps=WARMUP)
    return g, m


def _batch():
    b = jtr.synthetic_wmt_batch(B, S, S, vocab_size=64, seed=0)
    b["src_ids"][0, -3:] = 0
    b["tgt_in"][1, -1:] = 0
    b["tgt_out"][1, -2:] = 0
    return b


def _signature(g):
    return [(op._id, op.type, op.name, [t.name for t in op.inputs],
             [c.name for c in op.control_inputs], op.attrs.get("seed"),
             op.attrs.get("_graph_seed"),
             [(str(t.shape), t.dtype.name) for t in op.outputs])
            for op in g.get_operations()]


@pytest.mark.parametrize("seed", [None, SEED])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_match_jax_op_for_op(dtype, seed):
    sigs = {name: _signature(_graph(stf, T, dtype, seed)[0])
            for name, (stf, T) in PKGS.items()}
    assert sigs["port"] == sigs["jax"]
    types = {s[1] for s in sigs["port"]}
    assert {"FlashAttentionDropout", "FusedDropoutBiasResidual",
            "FusedLayerNorm", "FusedSoftmaxXent", "RandomStandardNormal",
            "Transpose", "Minimum", "Pow", "NotEqual", "TrueDiv",
            "FusedAdamUpdate"} <= types
    assert ("EmbeddingLookupMixed" if dtype == "bfloat16" else "Gather") \
        in types


def _session(stf):
    return stf.Session(config=stf.ConfigProto(device_count={"GPU": 0}))


def _state(sess):
    store = sess._variable_store
    if hasattr(store, "as_numpy"):
        return {k: store.as_numpy(k) for k in store.values}
    return {k: np.asarray(v) for k, v in store.values.items()}


def _train(name, dtype, steps, init_from=None, seed=SEED):
    stf, T = PKGS[name]
    g, m = _graph(stf, T, dtype, seed)
    b = _batch()
    with g.as_default(), _session(stf) as s:
        s.run(stf.global_variables_initializer())
        init = _state(s)
        if init_from is not None:
            convert.load_session_variables(s, init_from)
        feeds = {m[k]: b[k] for k in ("src_ids", "tgt_in", "tgt_out")}
        out = [s.run({"loss": m["loss"], "acc": m["accuracy"],
                      "gs": m["global_step"], "lr": m["learning_rate"],
                      "train": m["train_op"]}, feeds)
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
    kernels = [k for k in jinit if k.endswith("/kernel")]
    assert len(kernels) == 2 * 6 + 2 * 10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_training_steps_match_jax(runs):
    dtype, (_, jout, jstate, jc), (_, pout, pstate, pc) = runs
    assert pc == jc == 1 + len(jout)
    rtol = LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    for i, (a, b) in enumerate(zip(pout, jout)):
        assert a["train"] is None
        # fetched beside train_op: the step before its increment, in both
        assert int(a["gs"]) == int(b["gs"]) == i
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
        if dtype == "float32":
            np.testing.assert_allclose(a["acc"], b["acc"], rtol=LOSS_RTOL)
    if dtype != "float32":
        return
    assert sorted(pstate) == sorted(jstate)
    lr_sum = float(sum(b["lr"] for b in jout))
    key_biases = [k for k in jstate if k.endswith("/k/bias")]
    assert len(key_biases) == 2 * 3
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


def test_load_session_variables_takes_raw_bf16_bits(runs):
    # a bf16 Dense kernel arrives as bfloat16 numpy values or as their raw
    # 2-byte bits (a checkpoint read without ml_dtypes): both load to the
    # same bf16 tensor; an f32 one loads as it is
    dtype, (jinit, *_), _ = runs
    name = "transformer/encoder/layer_0/self_attn/q/kernel"
    value = jinit[name]
    stf, T = PKGS["port"]
    g, _ = _graph(stf, T, dtype)
    with g.as_default(), _session(stf) as s:
        s.run(stf.global_variables_initializer())
        loaded = []
        forms = [value] + ([value.view(np.dtype("V2"))]
                           if value.itemsize == 2 else [])
        for v in forms:
            convert.load_session_variables(s, {name: v})
            t = s._variable_store.values[name]
            assert str(t.dtype) == f"torch.{dtype}"
            loaded.append(_f32(s._variable_store.as_numpy(name)))
    assert len(loaded) == (2 if dtype == "bfloat16" else 1)
    for got in loaded:
        np.testing.assert_array_equal(got, _f32(value))
