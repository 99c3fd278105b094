"""The port's static cost model (``framework/cost_model.py``), its chip
table (``utils/perf.py``), ``recompute="auto"`` and the MFU report
against the JAX package's, on the CPU.

Held: ``estimate`` of the port's graphs equals JAX's estimate of the
same user code (FLOPs, bytes, peak and resident bytes within rtol 1e-9,
the heaviest ops by name) for MNIST, the transformer, BERT, ResNet-50,
PTB (a ``Scan`` body), the long-context LM (with and without recompute
bodies), word2vec, DLRM and a ``While``/``Cond`` graph;
``predicted_vs_measured`` equal; ``recompute="auto"`` decides as JAX
does on the CPU (the JAX nominal 1 TFLOP/s, 100 GB/s, 4 GB) at the five
entry points, on both sides of the limit; the table gives the H100 its
data-sheet figures and its own memory, and refuses a card it does not
know; a ``StepCounterHook`` in a ``MonitoredTrainingSession`` reports the
JAX hook's prediction with ``mfu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu.framework import cost_model as jcm
from simple_tensorflow_tpu.models import (bert as jbert, dlrm as jdlrm,
                                          long_context as jlc, mnist as jmn,
                                          ptb_lstm as jptb, resnet as jres,
                                          transformer as jtr,
                                          word2vec as jw2v)
from simple_tensorflow_tpu.utils import perf as jperf
from simple_tensorflow_tpu_torch.framework import cost_model as pcm
from simple_tensorflow_tpu_torch.models import (bert as pbert, dlrm as pdlrm,
                                                long_context as plc,
                                                mnist as pmn,
                                                ptb_lstm as pptb,
                                                resnet as pres,
                                                transformer as ptr,
                                                word2vec as pw2v)
from simple_tensorflow_tpu_torch.utils import perf as pperf

PKGS = {"jax": (jstf, jcm, dict(mnist=jmn, tr=jtr, bert=jbert, res=jres,
                                ptb=jptb, lc=jlc, w2v=jw2v, dlrm=jdlrm)),
        "port": (pstf, pcm, dict(mnist=pmn, tr=ptr, bert=pbert, res=pres,
                                 ptb=pptb, lc=plc, w2v=pw2v, dlrm=pdlrm))}
RTOL = 1e-9


def _while_cond(stf, M):
    x = stf.placeholder(stf.float32, [4, 8], "x")
    w = stf.Variable(np.ones((8, 8), np.float32) * 0.1, name="w")

    def body(i, h):
        h = stf.cond(i < 2, lambda: stf.matmul(h, w), lambda: h * 2.0)
        return i + 1, h

    _, h = stf.while_loop(lambda i, h: i < 5, body, [stf.constant(0), x],
                          maximum_iterations=5)
    return {"loss": stf.reduce_sum(h)}


MODELS = {
    "mnist": lambda stf, M: M["mnist"].convnet_model(8),
    "transformer": lambda stf, M: M["tr"].transformer_train_model(
        2, 8, 8, cfg=M["tr"].TransformerConfig.tiny(),
        compute_dtype=stf.float32, warmup_steps=64),
    "bert": lambda stf, M: M["bert"].bert_pretrain_model(
        2, 16, 4, cfg=M["bert"].BertConfig.tiny(), compute_dtype=stf.float32,
        recompute=True),
    "resnet": lambda stf, M: M["res"].resnet50_train_model(
        batch_size=2, image_size=32, num_classes=10, dtype=stf.bfloat16),
    "ptb": lambda stf, M: M["ptb"].ptb_lm_model(4, M["ptb"].PTBConfig.tiny()),
    "long_context": lambda stf, M: M["lc"].lm_train_model(
        1, 16, M["lc"].LongContextConfig.tiny()),
    "long_context_recompute": lambda stf, M: M["lc"].lm_train_model(
        1, 16, M["lc"].LongContextConfig.tiny(), compute_dtype=stf.float32,
        recompute=True),
    "word2vec": lambda stf, M: M["w2v"].skipgram_model(300, 8, 16, 5),
    "dlrm": lambda stf, M: M["dlrm"].dlrm_model(batch_size=8),
    "while_cond": _while_cond,
}


def _build(name, model):
    stf, cm, M = PKGS[name]
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        m = MODELS[model](stf, M)
    feeds = [op.outputs[0] for op in g.get_operations()
             if op.type == "Placeholder"]
    fetches = [m["loss"]] + ([m["train_op"]] if "train_op" in m else [])
    return g, fetches, feeds


def _estimate(name, model, **kw):
    g, fetches, feeds = _build(name, model)
    with g.as_default():
        return PKGS[name][1].estimate(fetches, feeds=feeds, top_k=5, **kw)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_estimate_matches_jax(model):
    j, p = _estimate("jax", model), _estimate("port", model)
    assert j.flops > 0 and j.bytes_accessed > 0
    for k in ("flops", "bytes_accessed", "peak_bytes", "resident_bytes"):
        np.testing.assert_allclose(getattr(p, k), getattr(j, k), rtol=RTOL,
                                   err_msg=k)
    assert [(o.name, o.op_type) for o in p.per_op] == \
        [(o.name, o.op_type) for o in j.per_op]
    np.testing.assert_allclose([o.flops + o.bytes for o in p.per_op],
                               [o.flops + o.bytes for o in j.per_op],
                               rtol=RTOL)


def test_predicted_vs_measured_matches_jax():
    got = {}
    for name in PKGS:
        g, fetches, _ = _build(name, "long_context")
        with g.as_default():
            got[name] = PKGS[name][1].predicted_vs_measured(
                fetches, measured_seconds=0.0123)
    assert got["port"] == got["jax"]
    assert got["port"]["mfu"] > 0 and got["port"]["dispatch_floor_bound"]


# (entry point, size, JAX's decision on the CPU): activations past 0.7 x
# half of the nominal 4 GB remat, tiny ones do not
AUTO = {
    ("transformer", "big"): True, ("transformer", "tiny"): False,
    ("bert_pretrain", "big"): True, ("bert_pretrain", "tiny"): False,
    ("bert_encoder", "big"): True, ("bert_encoder", "tiny"): False,
    ("resnet", "big"): True, ("resnet", "tiny"): False,
    ("long_context", "big"): True, ("long_context", "tiny"): False,
}


def _auto_graph(stf, M, entry, size):
    b, s = (512, 1024) if size == "big" else (2, 8)
    if entry == "transformer":
        cfg = dataclasses.replace(M["tr"].TransformerConfig.tiny(),
                                  max_len=s)
        M["tr"].transformer_train_model(b, s, s, cfg=cfg,
                                        compute_dtype=stf.float32,
                                        recompute="auto")
    elif entry in ("bert_pretrain", "bert_encoder"):
        cfg = dataclasses.replace(M["bert"].BertConfig.tiny(),
                                  max_position=s)
        if entry == "bert_pretrain":
            M["bert"].bert_pretrain_model(b, s, 4, cfg=cfg,
                                          compute_dtype=stf.float32,
                                          recompute="auto")
        else:
            M["bert"].bert_encoder(
                stf.placeholder(stf.int32, [b, s]),
                stf.placeholder(stf.int32, [b, s]), None, cfg,
                compute_dtype=stf.float32, recompute="auto")
    elif entry == "resnet":
        M["res"].resnet50_train_model(
            batch_size=512 if size == "big" else 1,
            image_size=224 if size == "big" else 32, num_classes=10,
            dtype=stf.float32, recompute="auto")
    else:
        M["lc"].lm_train_model(1, 32768 if size == "big" else 16,
                               M["lc"].LongContextConfig() if size == "big"
                               else M["lc"].LongContextConfig.tiny(),
                               recompute="auto")


@pytest.mark.parametrize("entry,size", sorted(AUTO))
def test_recompute_auto_decides_as_jax(entry, size):
    got = {}
    for name, (stf, _, M) in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            _auto_graph(stf, M, entry, size)
        got[name] = sum(op.type == "RecomputeGradCall"
                        for op in g.get_operations())
    assert got["port"] == got["jax"]
    assert bool(got["port"]) == AUTO[(entry, size)]


@pytest.mark.parametrize("act,flops", [
    (1e9, 0.0), (1.5e9, 0.0), (1e6, 1e6), (1e6, 3e6), (1e8, 1e12)])
def test_resolve_recompute_matches_jax(act, flops):
    for flag in ("auto", True, False):
        assert pcm.resolve_recompute(flag, act, flops) == \
            jcm.resolve_recompute(flag, act, flops)


def test_chip_table(monkeypatch):
    # the CPU keeps the JAX package's nominal figures
    assert pperf.chip_spec() == jperf.chip_spec() == (1e12, 100e9)
    assert pperf.chip_hbm_bytes() == jperf.chip_hbm_bytes() == 4e9
    assert pperf.mfu(2e12, 0.5) == jperf.mfu(2e12, 0.5)
    assert pperf.roofline(3e12, 2e10) == jperf.roofline(3e12, 2e10)
    # a card: its data-sheet rates and its own memory
    props = type("P", (), {"total_memory": 85_031_714_816})()
    name = ["NVIDIA H100 80GB HBM3"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name[0])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: props)
    assert pperf.chip_spec() == (989e12, 3.35e12)
    assert pperf.chip_hbm_bytes() == 85_031_714_816
    assert pperf.mfu(989e12, 1.0) == 1.0
    assert pperf.chip_spec("cpu") == (1e12, 100e9)
    name[0] = "NVIDIA A100-SXM4-80GB"
    with pytest.raises(ValueError, match="A100"):
        pperf.chip_spec()
    with pytest.raises(ValueError, match="A100"):
        pperf.chip_hbm_bytes()


def test_step_counter_hook_reports_the_jax_prediction():
    perf = {}
    for name, (stf, cm, M) in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            stf.set_random_seed(1)
            m = M["lc"].lm_train_model(1, 16, M["lc"].LongContextConfig.tiny(),
                                       compute_dtype=stf.float32)
            ids, tgt = M["lc"].synthetic_lm_batch(1, 16, 64)
            hook = stf.train.StepCounterHook(every_n_steps=2)
            fetch = [m["train_op"], m["loss"]]
            kw = {"config": stf.ConfigProto(device_count={"GPU": 0})} \
                if name == "port" else {}
            with stf.train.MonitoredTrainingSession(
                    hooks=[hook], save_summaries_steps=None, **kw) as ms:
                for _ in range(5):
                    ms.run(fetch, {m["input_ids"]: ids,
                                   m["targets"]: tgt})
            perf[name] = hook.last_perf
            if name == "port":
                ref = cm.predicted_vs_measured(
                    fetch, measured_seconds=perf[name][
                        "measured_sec_per_step"])
    p, j = perf["port"], perf["jax"]
    assert p is not None and "mfu" in p and p["mfu"] > 0
    pred = [k for k in j if k.startswith("predicted")
            or k == "dispatch_floor_bound"]
    assert pred and {k: p[k] for k in pred} == {k: j[k] for k in pred}
    # the hook's measured figures come from its unrounded seconds, ref's
    # from the 4 significant digits it reports
    measured = ("mfu", "measured_over_predicted")
    assert {k: p[k] for k in ref if k not in measured} == \
        {k: v for k, v in ref.items() if k not in measured}
    for k in measured:
        np.testing.assert_allclose(p[k], ref[k], rtol=1e-3)
