"""Guards of the PyTorch port's boundaries: the port imports neither JAX
nor the JAX package, its entry points run on the GPU unless the caller
asks for the CPU, and ``chip_smoke.py`` stands on the port alone."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from simple_tensorflow_tpu_torch.models import causal_lm as clm
from simple_tensorflow_tpu_torch.models import resnet
from simple_tensorflow_tpu_torch.models import transformer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "simple_tensorflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "simple_tensorflow_tpu")


def _imported_roots(path):
    """Top-level names of every module a file imports (absolute imports;
    relative ones stay inside its package)."""
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_importing_the_port_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys
        before = set(sys.modules)
        sys.path.insert(0, {REPO!r})
        import simple_tensorflow_tpu_torch
        from simple_tensorflow_tpu_torch import convert, serving
        from simple_tensorflow_tpu_torch.models import causal_lm, resnet
        from simple_tensorflow_tpu_torch.layers import (convolutional,
                                                        core, normalization,
                                                        pooling)
        from simple_tensorflow_tpu_torch.ops import (embedding_ops,
                                                     fused_ops, kernels,
                                                     kv_cache, nn_impl,
                                                     nn_ops)
        from simple_tensorflow_tpu_torch.framework import (prng,
                                                           random_seed)
        from simple_tensorflow_tpu_torch.train import optimizers
        from simple_tensorflow_tpu_torch.framework import (
            config_pb, constant_op, dtypes, errors, gradients, graph,
            lowering, op_registry, tensor_shape)
        from simple_tensorflow_tpu_torch.client import session
        from simple_tensorflow_tpu_torch.ops import (
            array_ops, control_flow_ops, init_ops, math_ops, op_util,
            random_ops, state_ops, variable_scope, variables)
        from simple_tensorflow_tpu_torch.layers import base
        from simple_tensorflow_tpu_torch.train import (optimizer,
                                                       training_util)
        from simple_tensorflow_tpu_torch.models import mnist, transformer
        from simple_tensorflow_tpu_torch import kernels, nn, layers, train
        from simple_tensorflow_tpu_torch.compiler import aot
        from simple_tensorflow_tpu_torch.analysis import hazards
        from simple_tensorflow_tpu_torch import checkpoint, summary
        from simple_tensorflow_tpu_torch.analysis import loop_safety
        from simple_tensorflow_tpu_torch.checkpoint import (atomic,
                                                            preemption,
                                                            snapshot)
        from simple_tensorflow_tpu_torch.lib import crc32c, proto
        from simple_tensorflow_tpu_torch.lib.io import tf_record
        from simple_tensorflow_tpu_torch.ops import logging_ops
        from simple_tensorflow_tpu_torch.summary import (summary_iterator,
                                                         writer)
        from simple_tensorflow_tpu_torch.train import (
            basic_session_run_hooks, checkpoint_utils, coordinator,
            monitored_session, saver, session_run_hook)
        from simple_tensorflow_tpu_torch.framework import function
        from simple_tensorflow_tpu_torch.models import bert, common
        from simple_tensorflow_tpu_torch.ops import (clip_ops,
                                                     functional_ops, rnn,
                                                     rnn_cell)
        from simple_tensorflow_tpu_torch.models import (ptb_lstm,
                                                        rnn_seq2seq)
        from simple_tensorflow_tpu_torch.ops import (kv_cache_ops,
                                                     tensor_array_ops)
        from simple_tensorflow_tpu_torch.ops.kernels import control_flow
        from simple_tensorflow_tpu_torch import data, platform, runtime
        from simple_tensorflow_tpu_torch.data import (dataset, pipeline,
                                                      staging)
        from simple_tensorflow_tpu_torch.ops import parsing_ops
        from simple_tensorflow_tpu_torch.runtime import native
        from simple_tensorflow_tpu_torch.platform import monitoring, sync
        from simple_tensorflow_tpu_torch.lib import example
        from simple_tensorflow_tpu_torch.lib.io import file_io
        from simple_tensorflow_tpu_torch.framework import sparse_tensor
        from simple_tensorflow_tpu_torch import debug
        from simple_tensorflow_tpu_torch.checkpoint import (manager,
                                                            metrics,
                                                            writer)
        from simple_tensorflow_tpu_torch.debug import (analyzer, io_utils,
                                                       numerics)
        from simple_tensorflow_tpu_torch.framework import graph_io
        from simple_tensorflow_tpu_torch.ops import numerics
        from simple_tensorflow_tpu_torch.ops.kernels import numeric_summary
        from simple_tensorflow_tpu_torch.train import health
        new = set(sys.modules) - before
        bad = sorted(m for m in new if m.split(".")[0] in {FORBIDDEN!r})
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, REPO) for p in _port_sources()))
def test_port_source_imports_no_jax(path):
    assert not _imported_roots(os.path.join(REPO, path)) & set(FORBIDDEN)


def test_the_training_loop_modules_are_guarded():
    # the training loop's modules are among the files the guard reads
    guarded = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"lib/crc32c.py", "lib/io/tf_record.py", "lib/proto.py",
            "summary/summary.py", "summary/summary_iterator.py",
            "summary/writer/writer.py", "checkpoint/atomic.py",
            "checkpoint/snapshot.py", "checkpoint/preemption.py",
            "train/saver.py", "train/checkpoint_utils.py",
            "train/session_run_hook.py", "train/basic_session_run_hooks.py",
            "train/monitored_session.py", "train/coordinator.py",
            "analysis/loop_safety.py", "ops/logging_ops.py"} <= guarded


def test_the_bert_slice_modules_are_guarded():
    # graph functions (FuncGraph, Defun, recompute_grad) and BERT are among
    # the files the guard reads, and a BERT Session runs on the card
    # unless the caller asks for the CPU
    guarded = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"framework/function.py", "framework/graph.py",
            "framework/lowering.py", "analysis/effects.py",
            "models/bert.py", "models/common.py"} <= guarded


def test_the_rnn_slice_modules_are_guarded():
    # the loops (Scan, MapFn, Foldl), the RNN library and the two RNN
    # graphs are among the files the guard reads
    guarded = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"ops/functional_ops.py", "ops/rnn.py", "ops/rnn_cell.py",
            "ops/clip_ops.py", "ops/control_flow_ops.py",
            "models/ptb_lstm.py", "models/rnn_seq2seq.py"} <= guarded


def test_the_control_flow_slice_modules_are_guarded():
    # control flow, TensorArray, the DecodeAttention op and the
    # conditional-node plumbing are among the files the guard reads, and
    # the node setter's source exists beside the other kernels
    guarded = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"ops/control_flow_ops.py", "ops/tensor_array_ops.py",
            "ops/kv_cache_ops.py", "ops/kernels/control_flow.py",
            "models/transformer.py"} <= guarded
    src = open(os.path.join(PKG, "csrc", "control_flow.cu")).read()
    assert "cudaGraphSetConditional" in src
    assert not any(w in src for w in FORBIDDEN[:2])


def test_the_input_pipeline_modules_are_guarded():
    # the input pipeline, the parse ops, the native binding and the
    # platform helpers are among the files the guard reads
    guarded = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"data/__init__.py", "data/dataset.py", "data/pipeline.py",
            "data/staging.py", "ops/parsing_ops.py", "runtime/native.py",
            "platform/monitoring.py", "platform/sync.py", "lib/example.py",
            "lib/io/file_io.py", "framework/sparse_tensor.py"} <= guarded


def test_prefetch_to_device_defaults_to_the_gpu(monkeypatch):
    import simple_tensorflow_tpu_torch as stf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = stf.data.Dataset.from_tensor_slices(
        np.arange(8, dtype=np.float32)).batch(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(ds.prefetch_to_device(2))
    got = list(ds.prefetch_to_device(2, device="cpu"))
    assert [t.device.type for t in got] == ["cpu"] * 4


def test_a_beam_search_session_defaults_to_the_gpu(monkeypatch):
    import simple_tensorflow_tpu_torch as stf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tr.TransformerConfig.tiny()
    with stf.Graph().as_default():
        src = stf.placeholder(stf.int32, [1, 6], "src")
        ids, scores = tr.beam_search_decode(src, cfg, beam_size=2,
                                            decode_len=4,
                                            compute_dtype=stf.float32,
                                            use_cache=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stf.Session()
        with stf.Session(config=stf.ConfigProto(
                device_count={"GPU": 0})) as s:
            s.run(stf.global_variables_initializer())
            out = s.run(ids, {src: np.full((1, 6), 5, np.int32)})
            assert s.device.type == "cpu" and out.shape == (1, 2, 4)


def test_an_rnn_session_defaults_to_the_gpu(monkeypatch):
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import ptb_lstm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ptb_lstm.PTBConfig.tiny()
    with stf.Graph().as_default():
        m = ptb_lstm.ptb_lm_model(2, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stf.Session()
        with stf.Session(config=stf.ConfigProto(
                device_count={"GPU": 0})) as s:
            s.run(stf.global_variables_initializer())
            x, y = ptb_lstm.synthetic_ptb_batch(2, cfg.seq_len,
                                                cfg.vocab_size)
            feeds = {m["input_ids"]: x, m["target_ids"]: y}
            feeds.update(ptb_lstm.state_feed(m, ptb_lstm.zero_state(2, cfg)))
            loss = s.run(m["loss"], feeds)
            assert s.device.type == "cpu" and np.isfinite(loss)


def test_a_bert_session_defaults_to_the_gpu(monkeypatch):
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import bert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with stf.Graph().as_default():
        m = bert.bert_pretrain_model(2, 8, 2, cfg=bert.BertConfig.tiny(),
                                     use_input_mask=True, recompute=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stf.Session()
        with stf.Session(config=stf.ConfigProto(
                device_count={"GPU": 0})) as s:
            s.run(stf.global_variables_initializer())
            batch = bert.synthetic_pretrain_batch(2, 8, 2, vocab_size=99,
                                                  input_mask=True)
            loss = s.run(m["loss"], {m[k]: v for k, v in batch.items()})
            assert s.device.type == "cpu" and np.isfinite(loss)
        for kw in ({"recompute": "auto"}, {"data_parallel": True}):
            with pytest.raises(NotImplementedError,
                               match="cost_model|parallel/"):
                bert.bert_pretrain_model(2, 8, 2, cfg=bert.BertConfig.tiny(),
                                         **kw)


def test_chip_smoke_imports_nothing_of_jax():
    path = os.path.join(REPO, "chip_smoke.py")
    roots = _imported_roots(path)
    assert "simple_tensorflow_tpu_torch" in roots
    assert not roots & set(FORBIDDEN)
    src = open(path).read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert not any(w.startswith(("jax", "simple_tensorflow_tpu."))
                           or w == "simple_tensorflow_tpu" for w in words)


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_model_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clm.CausalLMGenerativeModel(tr.TransformerConfig.tiny(),
                                    init_fresh=True, page_len=4,
                                    pages_per_seq=4, num_pages=8,
                                    max_live=2)
    m = clm.CausalLMGenerativeModel(tr.TransformerConfig.tiny(),
                                    init_fresh=True, page_len=4,
                                    pages_per_seq=4, num_pages=8,
                                    max_live=2, device="cpu")
    assert m.device.type == "cpu"
    assert m.caches[0][0].data.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        clm.CausalLMGenerativeModel(tr.TransformerConfig.tiny(),
                                    init_fresh=True, device="meta")


def test_trainer_defaults_to_the_gpu_and_refuses_dropout(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tr.TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clm.causal_lm_trainer(batch_size=2, seq_len=8, cfg=cfg)
    t = clm.causal_lm_trainer(batch_size=2, seq_len=8, cfg=cfg,
                              device="cpu")
    assert t.stack.shared_embedding.device.type == "cpu"
    assert t.optimizer.flat_groups[0].m.device.type == "cpu"
    # dropout trains (slice 3); a rate the masks cannot take is refused
    cfg.dropout = 1.0
    with pytest.raises(ValueError, match="dropout"):
        clm.causal_lm_trainer(batch_size=2, seq_len=8, cfg=cfg,
                              device="cpu")


def test_session_defaults_to_the_gpu(monkeypatch):
    """``stf.Session()`` runs on the card and raises without one; only
    ``ConfigProto(device_count={"GPU": 0})`` asks for the CPU."""
    import simple_tensorflow_tpu_torch as stf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with stf.Graph().as_default():
        c = stf.constant(2.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stf.Session()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stf.Session(config=stf.ConfigProto(device_count={"GPU": 1}))
        with stf.Session(config=stf.ConfigProto(
                device_count={"GPU": 0})) as s:
            assert s.device.type == "cpu"
            assert s.run(c) == 2.0


def test_resnet_trainer_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.resnet50_trainer()
    t = resnet.resnet50_trainer(batch_size=2, image_size=32,
                                num_classes=10, device="cpu")
    assert t.model.conv0.kernel.device.type == "cpu"
    assert t.optimizer.flat_groups[0].momentum.device.type == "cpu"
