"""The long-context LM, word2vec and DLRM graphs through the port's
``stf.Session`` against the JAX package's, on the CPU.

- ``models/long_context.py`` ``lm_train_model`` at
  ``LongContextConfig.tiny()`` (head dim 16), batch 2, seq 16, f32, with
  and without ``recompute=True``: RoPE, ``RingAttention`` (single-device
  causal flash attention: the port has no mesh), the fused LayerNorm and
  xent, Adam;
- ``models/word2vec.py`` ``skipgram_model`` (vocab 300, 8 wide, batch
  16, 5 sampled): the log-uniform sampler, ``nce_loss``, SGD;
- ``models/dlrm.py`` ``dlrm_model`` at its defaults (batch 8) on Zipf
  batches: ``embedding_bag`` over ``EmbeddingLookupFused``, sigmoid
  cross entropy, SGD.

Held: the graphs op for op; from JAX's initial state 3 steps with losses
within rtol 1e-5 and every variable and slot within relative norm 1e-4;
a captured step (its CPU replay) bit-identical with the eager one; the
fused lookup's pieces against JAX's (``_dedup_ids`` against
``jnp.unique``, ``embedding_bag`` sum and mean and their table gradient,
the ``EmbeddingScatterAddGrad`` op); the no-mesh ``parallel`` surface.
"""

import dataclasses

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import dlrm as jdlrm
from simple_tensorflow_tpu.models import long_context as jlc
from simple_tensorflow_tpu.models import word2vec as jw2v
from simple_tensorflow_tpu.ops import embedding_ops as jemb
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch import parallel as ppar
from simple_tensorflow_tpu_torch.models import dlrm as pdlrm
from simple_tensorflow_tpu_torch.models import long_context as plc
from simple_tensorflow_tpu_torch.models import word2vec as pw2v
from simple_tensorflow_tpu_torch.ops import embedding_ops as pemb
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, dict(lc=jlc, w2v=jw2v, dlrm=jdlrm)),
        "port": (pstf, dict(lc=plc, w2v=pw2v, dlrm=pdlrm))}
STEPS = 3
LOSS_RTOL = 1e-5
STATE_REL = 1e-4
LC_B, LC_S = 2, 16
W2V = dict(vocab_size=300, embedding_size=8, batch_size=16, num_sampled=5)
DLRM_B = 8


def _build(name, model):
    stf, M = PKGS[name]
    if model.startswith("lc"):
        return M["lc"].lm_train_model(
            LC_B, LC_S, M["lc"].LongContextConfig.tiny(),
            compute_dtype=stf.float32, recompute=model == "lc_recompute")
    if model == "w2v":
        return M["w2v"].skipgram_model(**W2V)
    return M["dlrm"].dlrm_model(batch_size=DLRM_B)


def _feeds(name, model, m, i):
    M = PKGS[name][1]
    if model.startswith("lc"):
        ids, tgt = M["lc"].synthetic_lm_batch(LC_B, LC_S, 64, seed=i)
        return {m["input_ids"]: ids, m["targets"]: tgt}
    if model == "w2v":
        x, y = M["w2v"].synthetic_skipgram_batch(16, 300, seed=i)
        return {m["train_inputs"]: x, m["train_labels"]: y}
    return M["dlrm"].feed_dict_for(
        m, M["dlrm"].synthetic_dlrm_batch(DLRM_B, seed=i))


def _graph(name, model):
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(3)
        m = _build(name, model)
        m["init"] = stf.global_variables_initializer()
    return g, m


def _session(stf, g):
    return stf.Session(graph=g,
                       config=stf.ConfigProto(device_count={"GPU": 0}))


def _state(sess):
    store = sess._variable_store
    return {k: np.array(v, dtype=np.float64) for k, v in
            store.values.items()}


def _run(name, model, init=None, capture=True):
    stf = PKGS[name][0]
    g, m = _graph(name, model)
    with g.as_default(), _session(stf, g) as s:
        if name == "port":
            s._capture = capture
        s.run(m["init"])
        state0 = _state(s)
        if init is not None:
            convert.load_session_variables(s, init)
        losses = [float(s.run([m["loss"], m["train_op"]],
                              _feeds(name, model, m, i))[0])
                  for i in range(STEPS)]
        return dict(state0=state0, losses=losses, final=_state(s))


@pytest.fixture(scope="module", params=["lc", "lc_recompute", "w2v",
                                        "dlrm"])
def runs(request):
    j = _run("jax", request.param)
    init = {k: v.astype(np.float32) for k, v in j["state0"].items()}
    return request.param, j, _run("port", request.param, init=init), init


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op.type, op.name, [t.name for t in op.inputs],
                    [c.name for c in op.control_inputs],
                    [(str(t.shape), t.dtype.name) for t in op.outputs],
                    {k: v for k, v in op.attrs.items()
                     if k in ("seed", "_graph_seed", "axis", "causal",
                              "sm_scale", "dedup", "compute_dtype", "table",
                              "_gradient_op_type", "num_sampled", "unique",
                              "range_max", "num_true")}))
        body = op.attrs.get("func_graph")
        if body is not None:
            out.append(_signature(body))
    return out


@pytest.mark.parametrize("model", ["lc", "lc_recompute", "w2v", "dlrm"])
def test_graphs_match_jax_op_for_op(model):
    gj, _ = _graph("jax", model)
    gp, _ = _graph("port", model)
    assert _signature(gp) == _signature(gj)


def test_the_graphs_reach_the_new_ops():
    types = {}
    for model in ("lc", "w2v", "dlrm"):
        g, _ = _graph("port", model)
        types[model] = {op.type for op in g.get_operations()}
    assert "RingAttention" in types["lc"]
    assert {"LogUniformCandidateSampler",
            "SigmoidCrossEntropyWithLogits"} <= types["w2v"]
    assert {"EmbeddingLookupFused",
            "SigmoidCrossEntropyWithLogits"} <= types["dlrm"]


def test_steps_match_jax(runs):
    model, j, p, init = runs
    assert sorted(p["state0"]) == sorted(j["state0"])
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=LOSS_RTOL)
    assert j["losses"][-1] < j["losses"][0]
    for k, ref in j["final"].items():
        got = p["final"][k]
        if k.endswith("qkv/bias"):
            # the key bias's gradient is exactly zero (softmax shift
            # invariance): Adam turns its roundoff into up to lr a step in
            # either package; held to that, the query and value biases to
            # the limit
            d = ref.shape[0] // 3
            assert np.abs(got[d:2 * d] - ref[d:2 * d]).max() <= \
                2 * STEPS * 3e-4, k
            got, ref = np.delete(got, np.s_[d:2 * d]), \
                np.delete(ref, np.s_[d:2 * d])
        d = np.linalg.norm(got - ref)
        assert d <= STATE_REL * max(np.linalg.norm(ref), 1e-30), k


def test_a_captured_step_equals_the_eager_one(runs):
    model, _, p, init = runs
    eager = _run("port", model, init=init, capture=False)
    assert eager["losses"] == p["losses"]
    for k, v in p["final"].items():
        np.testing.assert_array_equal(eager["final"][k], v)


def test_the_sampler_is_unseeded_and_drawn_per_run():
    """Two word2vec graphs under other graph seeds draw other ids: the
    sampler's key follows the graph seed, as in JAX."""
    ids = []
    for seed in (3, 4):
        g = pstf.Graph()
        with g.as_default():
            pstf.set_random_seed(seed)
            m = pw2v.skipgram_model(**W2V)
            init = pstf.global_variables_initializer()
            with _session(pstf, g) as s:
                s.run(init)
                ids.append(s.run("LogUniformCandidateSampler:0",
                                 _feeds("port", "w2v", m, 0)))
    assert not np.array_equal(ids[0], ids[1])


def test_dedup_ids_matches_jnp_unique():
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    # one length: jnp.unique compiles once
    for ids in (rng.zipf(1.3, 24) - 1, rng.randint(0, 5, 24),
                np.arange(24)[::-1], np.zeros(24, np.int64)):
        ids = np.minimum(ids, 999).astype(np.int32)
        u, inv = pemb._dedup_ids(torch.as_tensor(ids).long(), True)
        ju, jinv = jnp.unique(jnp.asarray(ids), size=len(ids), fill_value=0,
                              return_inverse=True)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(inv.numpy(),
                                      np.asarray(jinv).reshape(-1))
    u, inv = pemb._dedup_ids(torch.tensor([4, 2]), False)
    assert inv is None and u.tolist() == [4, 2]


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("lengths", [True, False])
def test_embedding_bag_and_its_gradient_match_jax(combiner, lengths):
    rng = np.random.RandomState(1)
    table = rng.randn(50, 4).astype(np.float32)
    ids = np.full((6, 5), -1, np.int32)
    lens = rng.randint(0, 6, 6).astype(np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = np.minimum(rng.zipf(1.3, n) - 1, 49)
    g_out = rng.randn(6, 4).astype(np.float32)
    got = {}
    for name, (stf, _) in PKGS.items():
        emb = jemb if name == "jax" else pemb
        g = stf.Graph()
        with g.as_default():
            t = stf.Variable(table, name="table")
            ln = stf.constant(lens) if lengths else None
            bag = emb.embedding_bag(t, stf.constant(ids), ln,
                                    combiner=combiner)
            dtab = stf.gradients(bag, [t], grad_ys=[stf.constant(g_out)])[0]
            init = stf.global_variables_initializer()
            with _session(stf, g) as s:
                s.run(init)
                got[name] = s.run([bag, dtab])
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_scatter_add_grad_op_matches_jax():
    rng = np.random.RandomState(2)
    ids = np.array([[3, 3, 0], [7, 3, 9]], np.int32)
    g_rows = rng.randn(2, 3, 4).astype(np.float32)
    got = {}
    for name, (stf, _) in PKGS.items():
        emb = jemb if name == "jax" else pemb
        g = stf.Graph()
        with g.as_default():
            t = stf.Variable(rng.randn(10, 4).astype(np.float32), name="t")
            out = emb.embedding_lookup_fused(t, stf.constant(ids))
            op = out.op
            assert op.attrs["_gradient_op_type"] == "FusedEmbeddingLookupGrad"
            dtab, none = emb._fused_lookup_grad(op, stf.constant(g_rows))
            assert none is None and dtab.op.type == "EmbeddingScatterAddGrad"
            with _session(stf, g) as s:
                got[name] = s.run(dtab)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["port"][3], g_rows[0, 0] + g_rows[0, 1]
                               + g_rows[1, 1], rtol=1e-6)


def test_the_parallel_surface_without_a_mesh():
    assert ppar.current_mesh() is None
    with pytest.raises(NotImplementedError, match="item 11"):
        ppar.Mesh({"dp": 2})
    with pytest.raises(NotImplementedError, match="item 11"):
        ppar.make_mesh({"sp": 2})
    g = pstf.Graph()
    with g.as_default():
        x = pstf.placeholder(pstf.int32, [2, 8], "x")
        ppar.shard_feed(x, "dp", "sp")
        assert x.op.attrs["sharding"] == ppar.P("dp", "sp")
        v = pstf.Variable(np.zeros((4, 2), np.float32), name="v")
        ppar.shard_variable(v, None, "tp")
        assert v._op.attrs["sharding"] == ppar.P(None, "tp")
        q = pstf.constant(np.random.RandomState(0).randn(1, 2, 8, 4)
                          .astype(np.float32))
        ring = ppar.ring_attention(q, q, q, causal=True)
        flash = pstf.nn.fused_attention(q, q, q, causal=True)
        assert ring.op.type == "RingAttention"
        assert ring.op.attrs == {"axis": "sp", "causal": True,
                                 "sm_scale": None}
        with _session(pstf, g) as s:
            a, b = s.run([ring, flash])
    np.testing.assert_array_equal(a, b)


def test_long_context_config_and_rope_match_jax():
    assert dataclasses.asdict(plc.LongContextConfig()) == \
        dataclasses.asdict(jlc.LongContextConfig())
    assert dataclasses.asdict(plc.LongContextConfig.tiny()) == \
        dataclasses.asdict(jlc.LongContextConfig.tiny())
    for a, b in zip(plc.rope_tables(32, 16), jlc.rope_tables(32, 16)):
        np.testing.assert_array_equal(a, b)
    for mod_p, mod_j, args in ((plc.synthetic_lm_batch,
                                jlc.synthetic_lm_batch, (2, 16, 64)),
                               (pw2v.synthetic_skipgram_batch,
                                jw2v.synthetic_skipgram_batch, (16, 300))):
        for a, b in zip(mod_p(*args), mod_j(*args)):
            np.testing.assert_array_equal(a, b)
    bp, bj = pdlrm.synthetic_dlrm_batch(8), jdlrm.synthetic_dlrm_batch(8)
    for k in bj:
        for a, b in zip(np.atleast_1d(bp[k]) if k in ("dense", "labels")
                        else bp[k], np.atleast_1d(bj[k])
                        if k in ("dense", "labels") else bj[k]):
            np.testing.assert_array_equal(a, b)
