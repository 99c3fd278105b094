"""``models/transformer.py``'s ``beam_search_decode`` of the port against
the JAX package's, on the CPU, and the ops it needs.

At ``TransformerConfig.tiny()`` in f32, batch 2, source length 8 with its
last two positions padded, beam 3, ``decode_len`` 8, graph seed 3: both
packages build the naive and the KV-cached search in one graph, the port
Session starts from the JAX Session's initial values, and

- the graphs have the same ops (types, names, inputs) and the same
  ``While`` bodies;
- the ids equal JAX's exactly and the scores lie within atol 1e-4 (the
  JAX suite's bar for cached against naive), on the port's eager run and
  on its captured runs (the CPU replay of the conditional-node loop);
  cached equals naive in the port too;
- at bf16 the cached search runs, its captured runs equal its eager run
  bit for bit, column 0 is EOS and the scores are finite;
- ``DecodeAttention`` (single query, with and without a key bias, and a
  query block with ``causal_offset``) equals JAX's op;
- ``TopKV2`` orders planted ties as ``lax.top_k`` does (the lower index
  first), ``FloorDiv``/``FloorMod`` follow floor semantics on negative
  ints as JAX's, and ``LogSoftmax``, ``Tile``, ``OneHot``,
  ``LogicalAnd`` equal JAX's.
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
B, S, BEAM, LEN = 2, 8, 3, 8
SCORE_ATOL = 1e-4
CPU = {"device_count": {"GPU": 0}}


def _src():
    src = jtr.synthetic_wmt_batch(B, S, S, vocab_size=64)["src_ids"].copy()
    src[:, -2:] = 0
    return src


def _build(name, dtype="float32"):
    stf, T = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(3)
        cfg = T.TransformerConfig.tiny()
        src = stf.placeholder(stf.int32, [B, S], "src")
        dt = getattr(stf, dtype)
        naive = T.beam_search_decode(src, cfg, beam_size=BEAM,
                                     decode_len=LEN, compute_dtype=dt)
        cached = T.beam_search_decode(src, cfg, beam_size=BEAM,
                                      decode_len=LEN, compute_dtype=dt,
                                      use_cache=True)
        init = stf.global_variables_initializer()
    return g, src, {"naive": naive, "cached": cached}, init


def _state(sess):
    return {k: np.asarray(v) for k, v in sess._variable_store.values.items()}


@pytest.fixture(scope="module")
def runs():
    g, src, fetch, init = _build("jax")
    with g.as_default(), jstf.Session(
            config=jstf.ConfigProto(device_count={"GPU": 0})) as s:
        s.run(init)
        state = _state(s)
        jax = s.run(fetch, {src: _src()})
    pg, psrc, pfetch, pinit = _build("port")
    with pg.as_default(), pstf.Session(config=pstf.ConfigProto(**CPU)) as s:
        s.run(pinit)
        convert.load_session_variables(s, state)
        port = [s.run(pfetch, {psrc: _src()}) for _ in range(3)]
        captures = s.captures
    return {"jax": jax, "port": port, "captures": captures,
            "graphs": (g, pg)}


def _ops(g):
    out = []
    for op in g.get_operations():
        out.append((op.type, op.name, [t.name for t in op.inputs]))
        for attr in ("cond_graph", "body_graph"):
            body = op.attrs.get(attr)
            if body is not None:
                out.append(_ops(body))
    return out


def test_beam_graphs_match_jax_op_for_op(runs):
    g, pg = runs["graphs"]
    assert _ops(pg) == _ops(g)
    types = [op.type for op in pg.get_operations()]
    assert types.count("While") == 2
    body = [op for op in pg.get_operations() if op.type == "While"][1] \
        .attrs["body_graph"]
    assert [op.type for op in body.get_operations()].count(
        "DecodeAttention") == 2 * ptr.TransformerConfig.tiny().num_layers


@pytest.mark.parametrize("run", [0, 1, 2])
@pytest.mark.parametrize("path", ["naive", "cached"])
def test_beam_ids_and_scores_match_jax(runs, path, run):
    # run 0 is eager, run 1 the capture, run 2 a replay
    ids, scores = runs["port"][run][path]
    jids, jscores = runs["jax"][path]
    assert ids.dtype == np.int32 and ids.shape == (B, BEAM, LEN)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, atol=SCORE_ATOL)


def test_cached_equals_naive_and_runs_were_captured(runs):
    p = runs["port"][0]
    np.testing.assert_array_equal(p["cached"][0], p["naive"][0])
    np.testing.assert_allclose(p["cached"][1], p["naive"][1],
                               atol=SCORE_ATOL)
    assert (p["cached"][0][:, :, 0] == 1).all()
    assert runs["captures"] == 1


def test_bf16_cached_search_captured_equals_eager():
    pg, psrc, pfetch, pinit = _build("port", "bfloat16")
    outs = {}
    for capture in (False, True):
        with pg.as_default(), pstf.Session(
                config=pstf.ConfigProto(**CPU)) as s:
            s._capture = capture
            s.run(pinit)
            outs[capture] = [s.run(pfetch["cached"], {psrc: _src()})
                             for _ in range(3)]
            assert s.captures == (1 if capture else 0)
            if not capture:
                assert s.host_predicate_reads == 3 * (LEN - 1 + 1)
    for eager, cap in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(eager[0], cap[0])
        np.testing.assert_array_equal(eager[1], cap[1])
    ids, scores = outs[True][-1]
    assert (ids[:, :, 0] == 1).all() and np.isfinite(scores).all()


def _both(build, feeds=None):
    """Build ``build(stf)`` in each package and run it: (jax, port)."""
    out = []
    for name in ("jax", "port"):
        stf = PKGS[name][0]
        with stf.Graph().as_default():
            fetch = build(stf)
            with stf.Session(config=stf.ConfigProto(
                    device_count={"GPU": 0})) as s:
                out.append(s.run(fetch, feeds(stf) if feeds else None))
    return out


def test_decode_attention_op_matches_jax():
    rng = np.random.RandomState(0)
    b, L, h, d, kq = 3, 10, 2, 8, 4
    q1 = rng.randn(b, h, d).astype(np.float32)
    qb = rng.randn(b, kq, h, d).astype(np.float32)
    k = rng.randn(b, L, h, d).astype(np.float32)
    v = rng.randn(b, L, h, d).astype(np.float32)
    lengths = np.array([1, 5, 10], np.int32)
    bias = np.where(rng.rand(b, L) < 0.3, -1e9, 0.0).astype(np.float32)
    base = np.array([0, 3, 6], np.int32)

    def build(stf):
        return {"one": stf.nn.decode_attention(q1, k, v, lengths),
                "bias": stf.nn.decode_attention(q1, k, v, lengths,
                                                bias=bias, sm_scale=0.5),
                "block": stf.nn.decode_attention(qb, k, v, base,
                                                 causal_offset=True)}

    j, p = _both(build)
    for key in ("one", "bias", "block"):
        np.testing.assert_allclose(p[key], j[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_top_k_breaks_ties_as_lax_top_k():
    # planted ties: equal values at several indices, the order of
    # lax.top_k is the lower index first
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0, 2.0, 3.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [5.0, 1.0, 5.0, 5.0, 2.0, 2.0, 9.0, 5.0]], np.float32)
    big = np.random.RandomState(1).randint(0, 4, (4, 3 * 64)).astype(
        np.float32)
    j, p = _both(lambda stf: {
        "small": stf.nn.top_k(x, k=5), "zeros": stf.nn.top_k(x[1:2], k=8),
        "big": stf.nn.top_k(big, k=7),
        "bf16": stf.nn.top_k(stf.cast(stf.constant(big), stf.bfloat16),
                             k=7)})
    for key in ("small", "zeros", "big", "bf16"):
        np.testing.assert_array_equal(p[key][1], j[key][1], err_msg=key)
        assert p[key][1].dtype == np.int32
        np.testing.assert_array_equal(np.asarray(p[key][0], np.float32),
                                      np.asarray(j[key][0], np.float32))
    assert p["small"][1][0].tolist() == [1, 2, 4, 7, 5]
    assert p["zeros"][1][0].tolist() == list(range(8))


def test_floor_division_and_mod_on_negative_ints():
    a = np.array([-7, 7, -8, 3, -1, 0, 9], np.int32)
    b = np.array([2, -2, 3, -3, 5, -4, -4], np.int32)
    fa = a.astype(np.float32) + 0.5
    j, p = _both(lambda stf: {
        "div": stf.constant(a) // stf.constant(b),
        "mod": stf.constant(a) % stf.constant(b),
        "fdiv": stf.floordiv(stf.constant(fa), stf.constant(b.astype(
            np.float32))),
        "fmod": stf.floormod(stf.constant(fa), stf.constant(b.astype(
            np.float32)))})
    for key in ("div", "mod", "fdiv", "fmod"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
        assert p[key].dtype == j[key].dtype
    np.testing.assert_array_equal(p["div"], a // b)
    np.testing.assert_array_equal(p["mod"], a % b)


def test_beam_helper_ops_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5).astype(np.float32) * 4
    idx = np.array([[0, 4, -1], [2, 7, 1]], np.int32)
    j, p = _both(lambda stf: {
        "log_softmax": stf.nn.log_softmax(x, axis=-1),
        "log_softmax0": stf.nn.log_softmax(x, axis=0),
        "tile": stf.tile(stf.constant(x[:2, :2]), [2, 3]),
        "tile_up": stf.tile(stf.expand_dims(stf.constant(x), 1),
                            [1, 2, 1]),
        "one_hot": stf.one_hot(stf.constant(idx), 5),
        "one_hot_int": stf.one_hot(stf.constant(3), 6, dtype=stf.int32),
        "one_hot_axis0": stf.one_hot(stf.constant(idx[0]), 5, axis=0,
                                     on_value=2.0, off_value=-1.0),
        "and": stf.logical_and(stf.constant([True, True, False]),
                               stf.constant([True, False, False])),
        "and_op": stf.constant([True, False]) & stf.constant([True, True]),
        "all": stf.reduce_all(stf.constant([[True, False], [True, True]]),
                              axis=1)})
    for key in j:
        assert p[key].dtype == j[key].dtype, key
        np.testing.assert_allclose(p[key], j[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
