"""``ops/parsing_ops.py`` of the port against the JAX package's, on the CPU,
on the same serialized ``tf.Example`` records (made from a numpy seed):

- the port's ``make_example`` writes the JAX one's bytes;
- ``parse_example_py`` on dense (``FixedLenFeature`` float32 and int64,
  with and without a default), var-len (``VarLenFeature`` int64 and
  string: the COO triple), ragged (``RaggedFeature`` with truncation) and
  string specs gives the JAX arrays exactly, through the native batch
  parse and through the Python wire parse (the native library switched
  off in both packages), and counts each batch on the path it took;
- the graph ops through a CPU ``stf.Session`` against the JAX Session:
  ``parse_example`` and ``parse_single_example`` of a fed string batch
  (a device op reading the parsed values: the host stage's outputs enter
  the step as feeds), ``decode_raw``, ``decode_csv``,
  ``serialize_tensor``/``parse_tensor`` and ``decode_json_example``.
"""

import base64
import json

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.lib import example as jexample
from simple_tensorflow_tpu.ops import parsing_ops as jpo
from simple_tensorflow_tpu.runtime import native as jnative
from simple_tensorflow_tpu_torch.lib import example as pexample
from simple_tensorflow_tpu_torch.ops import parsing_ops as ppo
from simple_tensorflow_tpu_torch.platform import monitoring
from simple_tensorflow_tpu_torch.runtime import native as pnative

N = 12


def _records(make_example, seed=0):
    """``N`` Examples: a float vector, an int64 scalar, a var-len int64
    list (0-6 values: truncated at 4 by the ragged spec), a string, and
    a feature missing from every third record."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(N):
        feats = dict(
            x=rng.randn(4).astype(np.float32).tolist(),
            y=[int(rng.randint(-2**40, 2**40))],
            ids=[int(v) for v in rng.randint(0, 1000, rng.randint(0, 7))],
            name=[f"rec{i}".encode()])
        if i % 3:
            feats["opt"] = [float(i)]
        if not feats["ids"]:
            del feats["ids"]
        out.append(make_example(**feats).SerializeToString())
    return out


@pytest.fixture(scope="module")
def records():
    return _records(jexample.make_example)


def test_port_examples_serialize_to_the_jax_bytes(records):
    assert _records(pexample.make_example) == records
    for r in records:
        pe = pexample.Example.FromString(r).features.feature
        je = jexample.Example.FromString(r).features.feature
        assert sorted(pe) == sorted(je)


def _specs(po, stf, kind):
    if kind == "dense":
        return {"x": po.FixedLenFeature([4], stf.float32),
                "y": po.FixedLenFeature([], stf.int64),
                "opt": po.FixedLenFeature([1], stf.float32,
                                          default_value=-1.0)}
    if kind == "ragged":
        return {"ids": po.RaggedFeature(stf.int64, max_len=4),
                "x": po.RaggedFeature(stf.float32, max_len=6)}
    if kind == "varlen":
        return {"ids": po.VarLenFeature(stf.int64),
                "name": po.VarLenFeature(stf.string)}
    return {"name": po.FixedLenFeature([], stf.string),
            "x": po.FixedLenFeature([4], stf.float32)}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(vb, tuple):
            assert isinstance(va, tuple) and len(va) == len(vb), k
            for p, q in zip(va, vb):
                assert p.dtype == q.dtype, k
                np.testing.assert_array_equal(p, q, err_msg=k)
        else:
            assert va.dtype == vb.dtype, k
            assert va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb, err_msg=k)


def _path_counts():
    m = monitoring.get_metric("/stf/data/parse_example_batches")
    cells = m.snapshot()["cells"] if m is not None else {}
    return cells.get("native", 0), cells.get("python", 0)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("kind", ["dense", "ragged", "varlen", "string"])
def test_parse_example_matches_jax(records, kind, path, monkeypatch):
    if path == "python":
        for mod in (jnative, pnative):
            monkeypatch.setattr(mod, "available", lambda: False)
            monkeypatch.setattr(mod, "ragged_parse_available",
                                lambda: False)
    else:
        assert pnative.available() and jnative.available()
    before = _path_counts()
    got = ppo.parse_example_py(records, _specs(ppo, pstf, kind))
    want = jpo.parse_example_py(records, _specs(jpo, jstf, kind))
    _same(got, want)
    after = _path_counts()
    # the native parse serves dense and ragged specs; var-len and string
    # specs take the Python path in both packages
    native = path == "native" and kind in ("dense", "ragged")
    assert after[0] - before[0] == int(native)
    assert after[1] - before[1] == int(not native)


def test_missing_feature_without_default_raises_as_jax(records):
    for po, stf in ((ppo, pstf), (jpo, jstf)):
        with pytest.raises(ValueError, match="missing and no default"):
            po.parse_example_py(
                records, {"opt": po.FixedLenFeature([1], stf.float32)})


def cpu_session(stf, graph):
    return stf.Session(graph=graph,
                       config=stf.ConfigProto(device_count={"GPU": 0}))


def _graph_run(stf, build, feeds_of):
    g = stf.Graph()
    with g.as_default():
        fetches, ph = build(stf)
    with cpu_session(stf, g) as s:
        return s.run(fetches, feeds_of(ph))


def _parse_graph(stf):
    po = stf.parsing_ops
    ser = stf.placeholder(stf.string, [N], name="serialized")
    one = stf.placeholder(stf.string, [], name="one")
    parsed = po.parse_example(ser, _specs(po, stf, "dense"))
    single = po.parse_single_example(one, _specs(po, stf, "dense"))
    ragged = po.parse_example(ser, _specs(po, stf, "ragged"))
    # device ops reading the host stage's outputs
    total = stf.reduce_sum(parsed["x"]) + stf.reduce_sum(
        stf.cast(ragged["ids_lengths"], stf.float32))
    return ([parsed["x"], parsed["y"], parsed["opt"], single["x"],
             single["y"], ragged["ids"], ragged["ids_lengths"], total],
            (ser, one))


def test_parse_ops_in_a_session_match_jax(records):
    def feeds(ph):
        return {ph[0]: np.asarray(records, dtype=object),
                ph[1]: np.asarray(records[1], dtype=object)}

    got = _graph_run(pstf, _parse_graph, feeds)
    want = _graph_run(jstf, _parse_graph, feeds)
    # the host stage's values exactly, in JAX's dtypes; the device step's
    # sum within float32 roundoff (XLA and PyTorch reduce in other orders)
    for a, b in zip(got[:-1], want[:-1]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-6)


def _decode_graph(stf):
    po = stf.parsing_ops
    raw = stf.placeholder(stf.string, [3], name="raw")
    csv = stf.placeholder(stf.string, [3], name="csv")
    js = stf.placeholder(stf.string, [2], name="json")
    x = stf.placeholder(stf.float32, [2, 3], name="x")
    ints = po.decode_raw(raw, stf.int32)
    cols = po.decode_csv(csv, [[0], [1.5], ["none"]])
    back = po.parse_tensor(po.serialize_tensor(x), stf.float32)
    ex = po.parse_example(po.decode_json_example(js),
                          {"v": po.FixedLenFeature([2], stf.int64)})
    return ([ints, stf.reduce_sum(ints)] + cols + [back, ex["v"]],
            (raw, csv, js, x))


def test_decode_ops_in_a_session_match_jax():
    rng = np.random.RandomState(3)
    raw = rng.randint(-1000, 1000, (3, 5)).astype(np.int32)
    docs = [json.dumps({"features": {"feature": {"v": {"int64List": {
        "value": [str(i), str(i * 7)]}}}}}) for i in range(2)]
    # base64 bytes features go through the JSON path too
    docs[1] = json.dumps({"features": {"feature": {
        "v": {"int64List": {"value": ["5", "6"]}},
        "b": {"bytesList": {"value": [base64.b64encode(b"q").decode()]}}}}})

    values = [np.asarray([r.tobytes() for r in raw], dtype=object),
              np.asarray([b"3,2.5,abc", b",,", b"-7,1e3,"], dtype=object),
              np.asarray(docs, dtype=object),
              rng.randn(2, 3).astype(np.float32)]

    def feeds(ph):
        return dict(zip(ph, values))

    got = _graph_run(pstf, _decode_graph, feeds)
    want = _graph_run(jstf, _decode_graph, feeds)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], raw)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if b.dtype == object:
            assert list(a.ravel()) == list(b.ravel())
        else:
            np.testing.assert_array_equal(a, b)
