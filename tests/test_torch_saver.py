"""``train.Saver`` of the port against the JAX package's, on the CPU.

- a checkpoint of f32, int64 (narrowed to int32 in both packages) and
  bf16 variables: every ``.npy`` header inside the port's ``.stfz`` is
  byte-identical to the JAX saver's (bf16: ``'<V2'`` over the raw 2-byte
  values), and so are the data file's size and the index document but
  for ``time`` and ``checksum`` (the zip entries carry a write time);
- each package restores the other's checkpoint and both continue to the
  same losses (within rtol 1e-5) from it: ``convnet_model`` (f32, Adam
  with its flat slots, ``global_step``, the Dropout stream through the
  saved ``rng_run_counter``) and ``transformer_train_model`` at 2 + 2
  layers, d_model 64, batch 4 x 8 / 8, dropout 0.1;
- ``max_to_keep``, the ``checkpoint`` state file, ``latest_checkpoint``
  and ``keep_checkpoint_every_n_hours`` leave the same files and state as
  the JAX saver's after the same saves;
- a flipped payload byte raises ``DataLossError`` in either package's
  file; ``verify_checkpoint`` names it;
- the backend that is not ported (orbax) raises ``NotImplementedError``
  (``backend="async"``: ``tests/test_torch_checkpoint.py``).
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.models import mnist as jmnist
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.train import saver as jsaver
from simple_tensorflow_tpu_torch.checkpoint import snapshot
from simple_tensorflow_tpu_torch.framework import errors as perrors
from simple_tensorflow_tpu_torch.models import mnist as pmnist
from simple_tensorflow_tpu_torch.models import transformer as ptr
from simple_tensorflow_tpu_torch.train import saver as psaver
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jstf, jmnist, jtr), "port": (pstf, pmnist, ptr)}
OTHER = {"jax": "port", "port": "jax"}
LOSS_RTOL = 1e-5


def _session(stf, graph=None):
    return stf.Session(graph=graph,
                       config=stf.ConfigProto(device_count={"GPU": 0}))


def _npy_headers(prefix):
    """``{entry: .npy header bytes}`` of a ``.stfz``."""
    out = {}
    with zipfile.ZipFile(prefix + ".stfz") as zf:
        for name in zf.namelist():
            raw = zf.read(name)
            out[name] = raw[:raw.index(b"\n") + 1]
    return out


def _typed_checkpoint(name, directory):
    stf = PKGS[name][0]
    g = stf.Graph()
    with g.as_default():
        stf.Variable(np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
                     name="w_f32")
        stf.Variable(np.array([3, -2, 7], np.int64), dtype=stf.int64,
                     name="n_int64")
        stf.Variable(np.linspace(-2, 2, 8, dtype=np.float32).reshape(4, 2),
                     dtype=stf.bfloat16, name="h_bf16")
        saver = stf.train.Saver()
        init = stf.global_variables_initializer()
    with g.as_default(), _session(stf, g) as s:
        s.run(init)
        return saver.save(s, os.path.join(directory, "typed"),
                          global_step=5)


@pytest.fixture(scope="module")
def typed(tmp_path_factory):
    return {name: _typed_checkpoint(name, str(tmp_path_factory.mktemp(name)))
            for name in PKGS}


@pytest.mark.parametrize("entry", ["w_f32.npy", "n_int64.npy",
                                   "h_bf16.npy"])
def test_npy_entries_equal_the_jax_savers(typed, entry):
    # the header and the payload of each entry, byte for byte
    headers = {name: _npy_headers(p) for name, p in typed.items()}
    assert set(headers["port"]) == set(headers["jax"])
    assert headers["port"][entry] == headers["jax"][entry]
    raw = {name: zipfile.ZipFile(p + ".stfz").read(entry)
           for name, p in typed.items()}
    assert raw["port"] == raw["jax"]
    if entry == "h_bf16.npy":
        assert b"'descr': '<V2'" in headers["port"][entry]


def test_index_documents_agree_but_time_and_checksum(typed):
    docs = {name: json.load(open(p + ".index.json"))
            for name, p in typed.items()}
    for d in docs.values():
        assert d.pop("time") > 0 and d.pop("checksum").startswith("sha256:")
    assert docs["port"] == docs["jax"]
    assert docs["port"]["tensors"]["h_bf16"]["dtype"] == "bfloat16"
    assert docs["port"]["tensors"]["n_int64"]["dtype"] == "int32"
    assert docs["port"]["data_bytes"] == os.path.getsize(
        typed["port"] + ".stfz")


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_typed_values_read_back_in_both_packages(typed, reader):
    # the JAX Saver restores no bf16 variable, of its own files either
    # (its store cannot cast numpy's raw 'V2' entry: ROADMAP Queue 3);
    # the entries are byte-identical (above), so it reads the port's f32
    # and int64 ones here
    want = {"w_f32": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
            "n_int64": np.array([3, -2, 7], np.int32),
            "h_bf16": np.linspace(-2, 2, 8, dtype=np.float32).reshape(4, 2)}
    if reader == "jax":
        del want["h_bf16"]
    stf = PKGS[reader][0]
    for writer, prefix in typed.items():
        g = stf.Graph()
        with g.as_default():
            vs = {"w_f32": stf.Variable(np.zeros((2, 3), np.float32),
                                        name="w_f32"),
                  "n_int64": stf.Variable(np.zeros(3, np.int64),
                                          dtype=stf.int64, name="n_int64"),
                  "h_bf16": stf.Variable(np.zeros((4, 2), np.float32),
                                         dtype=stf.bfloat16, name="h_bf16")}
            saver = stf.train.Saver(var_list=[vs[k] for k in want])
        with g.as_default(), _session(stf, g) as s:
            saver.restore(s, prefix)
            got = s.run({k: vs[k].value() for k in want})
        for k, v in want.items():
            np.testing.assert_array_equal(
                np.asarray(got[k], np.float32),
                np.asarray(v, np.float32).astype(
                    got[k].dtype).astype(np.float32), err_msg=(writer, k))


# -- save in one package, resume in the other ------------------------------

def _convnet(stf, mnist):
    m = mnist.convnet_model()
    x, labels, _ = jmnist.synthetic_mnist(8, seed=0)
    return m, {m["x"]: x.reshape(-1, 28, 28, 1), m["y_"]: labels,
               m["keep_prob"]: 0.5}


def _transformer(stf, T):
    cfg = T.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                              d_ff=128, num_layers=2, dropout=0.1,
                              max_len=32)
    m = T.transformer_train_model(4, 8, 8, cfg=cfg,
                                  compute_dtype=stf.float32,
                                  warmup_steps=64)
    b = jtr.synthetic_wmt_batch(4, 8, 8, vocab_size=64, seed=0)
    return m, {m[k]: b[k] for k in ("src_ids", "tgt_in", "tgt_out")}


MODELS = {"convnet": lambda stf, mnist, T: _convnet(stf, mnist),
          "transformer": lambda stf, mnist, T: _transformer(stf, T)}
STEPS_BEFORE, STEPS_AFTER = 2, 2


def _trainer(name, model, seed=3):
    """An initialized Session of ``model`` under graph seed ``seed``:
    ``(step(), save(path), restore(path), session)``."""
    stf, mnist, T = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(seed)
        m, feeds = MODELS[model](stf, mnist, T)
        saver = stf.train.Saver()
        init = stf.global_variables_initializer()
    s = _session(stf, g)
    with g.as_default():
        s.run(init)

    def step():
        return float(s.run([m["train_op"], m["loss"]], feeds)[1])

    def save(path):
        with g.as_default():
            return saver.save(s, path, global_step=m["global_step"])

    def restore(path):
        with g.as_default():
            saver.restore(s, path)

    return step, save, restore, s


@pytest.fixture(scope="module", params=list(MODELS))
def resumed(request, tmp_path_factory):
    """Per model and writer: the losses of STEPS_AFTER steps the writer
    ran after saving at step STEPS_BEFORE, and those the other package ran
    after restoring that checkpoint into its live session (which had
    trained its own run first)."""
    model = request.param
    d = tmp_path_factory.mktemp(model)
    sessions, prefix, own = {}, {}, {}
    for name in ("port", "jax"):
        step, save, restore, s = sessions[name] = _trainer(name, model)
        for _ in range(STEPS_BEFORE):
            step()
        prefix[name] = save(str(d / f"{name}.ckpt"))
        assert prefix[name].endswith(f"-{STEPS_BEFORE}")
        own[name] = [step() for _ in range(STEPS_AFTER)]
    other = {}
    for writer in ("port", "jax"):
        step, _, restore, s = sessions[OTHER[writer]]
        restore(prefix[writer])
        other[writer] = [step() for _ in range(STEPS_AFTER)]
        assert s._run_counter == 1 + STEPS_BEFORE + STEPS_AFTER
    for *_, s in sessions.values():
        s.close()
    return model, own, other


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(resumed, writer):
    _, own, other = resumed
    np.testing.assert_allclose(other[writer], own[writer], rtol=LOSS_RTOL)


# -- retention and the state file ------------------------------------------

def _retention(name, directory, monkeypatch):
    stf = PKGS[name][0]
    mod = jsaver if name == "jax" else psaver
    t = [1000.0]
    monkeypatch.setattr(mod.time, "time", lambda: t[0])
    g = stf.Graph()
    with g.as_default():
        stf.Variable(stf.zeros([]), name="k_v")
        keep2 = stf.train.Saver(max_to_keep=2)
        hourly = stf.train.Saver(max_to_keep=1,
                                 keep_checkpoint_every_n_hours=1.0)
        init = stf.global_variables_initializer()
    with g.as_default(), _session(stf, g) as s:
        s.run(init)
        a = [keep2.save(s, os.path.join(directory, "ck"), global_step=i)
             for i in range(4)]
        b = []
        for dt in (1800.0, 3600.0, 600.0, 0.0):
            b.append(hourly.save(s, os.path.join(directory, "hr"),
                                 global_step=len(b) + 1,
                                 latest_filename="hourly"))
            t[0] += dt
        st = stf.train.get_checkpoint_state(directory)
        hst = stf.train.get_checkpoint_state(directory, "hourly")
    rel = lambda ps: [os.path.relpath(p, directory) for p in ps]  # noqa
    files = sorted(f for f in os.listdir(directory)
                   if not f.endswith(".meta"))
    return dict(
        files=files, paths=rel(a + b),
        latest=rel([stf.train.latest_checkpoint(directory)]),
        state=(rel([st.model_checkpoint_path]),
               rel(st.all_model_checkpoint_paths)),
        hourly=(rel([hst.model_checkpoint_path]),
                rel(hst.all_model_checkpoint_paths)),
        last=rel(keep2.last_checkpoints + hourly.last_checkpoints),
        exists=[stf.train.checkpoint_exists(p) for p in a + b])


def test_retention_and_state_file_match_the_jax_saver(tmp_path,
                                                       monkeypatch):
    out = {}
    for name in PKGS:
        d = tmp_path / name
        d.mkdir()
        out[name] = _retention(name, str(d), monkeypatch)
    assert out["port"] == out["jax"]
    assert out["port"]["exists"] == [False, False, True, True,
                                     False, False, True, True]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flipped_payload_byte_raises_data_loss(typed, tmp_path, writer):
    src = typed[writer]
    bad = str(tmp_path / "bad")
    for suffix in (".stfz", ".index.json"):
        with open(src + suffix, "rb") as f, open(bad + suffix, "wb") as o:
            o.write(f.read())
    raw = bytearray(open(bad + ".stfz", "rb").read())
    raw[len(raw) // 2] ^= 0x40
    open(bad + ".stfz", "wb").write(bytes(raw))
    assert snapshot.verify_checkpoint(src) == []
    assert "checksum" in " ".join(snapshot.verify_checkpoint(bad))
    g = pstf.Graph()
    with g.as_default():
        pstf.Variable(np.zeros((2, 3), np.float32), name="w_f32")
        saver = pstf.train.Saver()
    with _session(pstf, g) as s:
        with pytest.raises(perrors.DataLossError, match="corrupt"):
            saver.restore(s, bad)
        assert "w_f32" not in s._variable_store.values


@pytest.mark.parametrize("backend", ["orbax"])
def test_unported_backends_raise(backend):
    with pstf.Graph().as_default():
        with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
            pstf.train.Saver(backend=backend)


def test_encode_npz_loads_with_numpy(typed):
    arrays = {"a/b": np.arange(5, dtype=np.float32),
              "c": np.arange(4, dtype=np.uint16).view(np.dtype("V2"))}
    with np.load(io.BytesIO(snapshot.encode_npz(arrays))) as data:
        assert sorted(data.files) == ["a|b", "c"]
        np.testing.assert_array_equal(data["a|b"], arrays["a/b"])
        assert data["c"].view(np.uint16).tolist() == [0, 1, 2, 3]
