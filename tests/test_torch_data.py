"""``stf.data`` of the port against the JAX package's, on the CPU (numpy
streams, no card):

- every ported ``Dataset`` transform yields the JAX element stream
  exactly (arrays by dtype and value, bytes by value): sources
  (``from_tensor_slices``, ``from_generator``, ``range``, ``zip``,
  ``TFRecordDataset`` sequential, with ``num_parallel_reads=AUTOTUNE``
  and GZIP), ``map`` (sequential, ordered parallel, unordered as a
  multiset), ``filter``, ``batch``, ``padded_batch``, ``unbatch``,
  ``shuffle`` (seeded, with and without reshuffling), ``repeat``,
  ``take``, ``skip``, ``prefetch``, ``superbatch``, ``cache``,
  ``interleave`` (sequential and parallel) and ``parse_example`` before
  and after ``batch``;
- each parallel chain yields its own sequential compile's stream;
- the Python record reader yields the native reader's records, and a
  corrupted record raises ``DataLossError`` after the good prefix in
  both packages;
- ``Iterator.save_state``/``restore_state`` resume a parallel shuffled
  chain at the next element, as the JAX iterator does;
- ``prefetch_to_device(device="cpu")`` yields CPU tensors equal to the
  numpy superbatches; ``sharding=`` raises; closing a pipeline mid-stream
  ends its stage threads.
"""

import gzip
import shutil
import threading

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu import data as jdata
from simple_tensorflow_tpu.framework import errors as jerrors
from simple_tensorflow_tpu.lib.example import make_example
from simple_tensorflow_tpu.lib.io.tf_record import TFRecordWriter
from simple_tensorflow_tpu_torch import data as pdata
from simple_tensorflow_tpu_torch.data import pipeline as ppipeline
from simple_tensorflow_tpu_torch.framework import errors as perrors
from simple_tensorflow_tpu_torch.runtime import native as pnative

SHARDS, PER_SHARD = 3, 17
PKGS = {"jax": (jdata, jstf), "port": (pdata, pstf)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three TFRecord shards of Examples (a float vector, an int64 id),
    and a GZIP copy of each."""
    d = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    plain, gz = [], []
    for s in range(SHARDS):
        p = str(d / f"shard{s}.tfrecord")
        with TFRecordWriter(p) as w:
            for i in range(PER_SHARD):
                w.write(make_example(
                    x=rng.randn(3).astype(np.float32).tolist(),
                    y=[s * 1000 + i]).SerializeToString())
        with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
            g.write(f.read())
        plain.append(p)
        gz.append(p + ".gz")
    return plain, gz


def _spec(stf):
    po = stf.parsing_ops
    return {"x": po.FixedLenFeature([3], stf.float32),
            "y": po.FixedLenFeature([], stf.int64)}


def _varlen():
    for i in range(7):
        yield np.arange(i % 4 + 1, dtype=np.int32) * (i + 1)


CHAINS = {
    "slices_dict_map_filter_batch": lambda D, stf, f: (
        D.Dataset.from_tensor_slices(
            {"a": np.arange(11, dtype=np.int32),
             "b": np.arange(22, dtype=np.float32).reshape(11, 2)})
        .map(lambda e: {"a": e["a"] * 3, "b": e["b"] + 0.5})
        .filter(lambda e: e["a"] % 2 == 0)
        .batch(2, drop_remainder=False)),
    "slices_tuple_shuffle_repeat_batch": lambda D, stf, f: (
        D.Dataset.from_tensor_slices(
            (np.arange(13, dtype=np.int64), np.arange(13) * 0.25))
        .shuffle(5, seed=1).repeat(3).batch(4)),
    "range_skip_take_repeat_shuffle_once": lambda D, stf, f: (
        D.Dataset.range(10).skip(2).take(5).repeat(3)
        .shuffle(4, seed=2, reshuffle_each_iteration=False)),
    "zip_batch": lambda D, stf, f: (
        D.Dataset.zip((D.Dataset.range(6),
                       D.Dataset.from_tensor_slices(np.eye(6, 2))))
        .batch(2)),
    "generator_padded_batch": lambda D, stf, f: (
        D.Dataset.from_generator(_varlen).padded_batch(
            3, padded_shapes=[None], drop_remainder=False)),
    "batch_unbatch_superbatch": lambda D, stf, f: (
        D.Dataset.from_tensor_slices(np.arange(24).reshape(12, 2))
        .batch(4).unbatch().batch(2).superbatch(3)),
    "map_cache_repeat": lambda D, stf, f: (
        D.Dataset.range(5).map(lambda i: i * i).cache().repeat(2)),
    "interleave": lambda D, stf, f: (
        D.Dataset.range(4).interleave(
            lambda i: D.Dataset.range(i * 10, i * 10 + 3 + i),
            cycle_length=2, block_length=2)),
    "interleave_parallel": lambda D, stf, f: (
        D.Dataset.range(5).interleave(
            lambda i: D.Dataset.range(i * 10, i * 10 + 2 + i),
            cycle_length=3, block_length=1, num_parallel_calls=2)),
    "map_parallel_prefetch": lambda D, stf, f: (
        D.Dataset.range(40)
        .map(lambda i: np.full((2,), i, np.int64),
             num_parallel_calls=D.AUTOTUNE)
        .prefetch(D.AUTOTUNE)),
    "tfrecord_sequential": lambda D, stf, f: D.TFRecordDataset(f[0]),
    "tfrecord_parallel": lambda D, stf, f: D.TFRecordDataset(
        f[0], num_parallel_reads=D.AUTOTUNE),
    "tfrecord_gzip": lambda D, stf, f: D.TFRecordDataset(
        f[1], compression_type="GZIP", num_parallel_reads=2),
    "tfrecord_shuffle_batch_parse": lambda D, stf, f: (
        D.TFRecordDataset(f[0], num_parallel_reads=D.AUTOTUNE)
        .shuffle(16, seed=5).repeat(2).batch(8).parse_example(_spec(stf))
        .prefetch(2)),
    "tfrecord_parse_then_batch": lambda D, stf, f: (
        D.TFRecordDataset(f[0], buffer_size=4096)
        .parse_example(_spec(stf), num_parallel_calls=2).batch(5)),
}
PARALLEL = ("interleave_parallel", "map_parallel_prefetch",
            "tfrecord_parallel", "tfrecord_gzip",
            "tfrecord_shuffle_batch_parse", "tfrecord_parse_then_batch")


def assert_same(a, b, where="element"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), where
        for k in b:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, (bytes, str)):
        assert a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        if b.dtype == object:
            assert list(a.ravel()) == list(b.ravel()), where
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)


def assert_streams(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert_same(x, y, f"element {i}")


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_transform_streams_match_jax(name, files):
    got = list(CHAINS[name](pdata, pstf, files))
    want = list(CHAINS[name](jdata, jstf, files))
    assert got
    assert_streams(got, want)


@pytest.mark.parametrize("name", PARALLEL)
def test_parallel_chain_equals_its_sequential_stream(name, files):
    # two builds: a shuffle reshuffles when its dataset is iterated again
    ds = CHAINS[name](pdata, pstf, files)
    assert ppipeline.chain_is_parallel(ds._node)
    seq = list(ppipeline.build_iterator(
        CHAINS[name](pdata, pstf, files)._node, sequential=True))
    assert_streams(list(ds), seq)


def test_unordered_parallel_map_yields_the_same_multiset():
    def chain(D):
        return D.Dataset.range(50).map(
            lambda i: i * 7, num_parallel_calls=4, deterministic=False)

    got = sorted(int(v) for v in chain(pdata))
    assert got == sorted(int(v) for v in chain(jdata))
    assert got == [i * 7 for i in range(50)]


def test_python_reader_yields_the_native_records(files, monkeypatch):
    native = list(pdata.TFRecordDataset(files[0]))
    monkeypatch.setattr(pnative, "available", lambda: False)
    for f in (files[0], files[1]):
        assert list(pdata.TFRecordDataset(
            f, num_parallel_reads=2)) == native


@pytest.mark.parametrize("reader", ["native", "python"])
def test_a_corrupted_record_raises_after_the_good_prefix(files, tmp_path,
                                                         reader,
                                                         monkeypatch):
    bad = str(tmp_path / "bad.tfrecord")
    shutil.copy(files[0][0], bad)
    data = bytearray(open(bad, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(data))
    if reader == "python":
        monkeypatch.setattr(pnative, "available", lambda: False)
    for D, err in ((pdata, perrors.DataLossError),
                   (jdata, jerrors.DataLossError)):
        got = []
        with pytest.raises(err):
            for r in D.TFRecordDataset(bad):
                got.append(r)
        assert 0 < len(got) < PER_SHARD


def _resume_chain(D, stf, f):
    return (D.TFRecordDataset(f[0], num_parallel_reads=D.AUTOTUNE)
            .shuffle(16, seed=4).repeat().batch(4).parse_example(_spec(stf))
            .map(lambda b: {"x": b["x"] * 2, "y": b["y"]},
                 num_parallel_calls=2)
            .prefetch(2))


def test_iterator_state_resumes_the_stream_as_jax(files):
    out = {}
    for name, (D, stf) in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            it = _resume_chain(D, stf, files).make_one_shot_iterator()
            head = [it._next_value() for _ in range(7)]
            state = it.save_state()
            tail = [it._next_value() for _ in range(4)]
            it.close()
        g2 = stf.Graph()
        with g2.as_default():
            it2 = _resume_chain(D, stf, files).make_one_shot_iterator()
            it2.restore_state(state)
            resumed = [it2._next_value() for _ in range(4)]
            it2.close()
        assert state == {"position": 7}
        assert_streams(resumed, tail)
        out[name] = head + tail
    assert_streams(out["port"], out["jax"])


def test_prefetch_to_device_on_the_cpu(files):
    base = (pdata.TFRecordDataset(files[0], num_parallel_reads=2)
            .batch(4).parse_example(_spec(pstf)))
    want = list(base.superbatch(2))
    got = list(base.prefetch_to_device(2, superbatch=2, device="cpu"))
    assert len(got) == len(want) == SHARDS * PER_SHARD // 8
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == \
                "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        base.prefetch_to_device(2, sharding=object())


def test_closing_a_pipeline_mid_stream_ends_its_threads(files):
    before = set(threading.enumerate())
    ds = (pdata.TFRecordDataset(files[0], num_parallel_reads=pdata.AUTOTUNE)
          .repeat().batch(3).parse_example(_spec(pstf))
          .map(lambda b: b, num_parallel_calls=2)
          .prefetch(pdata.AUTOTUNE)
          .prefetch_to_device(2, device="cpu"))
    it = iter(ds)
    for _ in range(5):
        next(it)
    stages = [t for t in set(threading.enumerate()) - before
              if not t.name.startswith("stf_data_worker")]
    # shard readers, the autotuner, the host and device prefetch stages
    assert len(stages) >= 4
    assert all(t.daemon and t.name.startswith("stf_data_") for t in stages)
    it.close()
    assert not [t.name for t in stages if t.is_alive()]
