#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``simple_tensorflow_tpu_torch``) on one
NVIDIA GPU and check every kernel of its serving and training paths
(causal LM and ResNet-50) and of its TF-1 front end (``stf.Session``
training the MNIST convnet and the seq2seq transformer).

    python3 chip_smoke.py [--serving]

``--serving`` runs only phase 3 (no kernel phases, no ``{"ok": ...}``
line) and asks its traces for no kernel by name, so this script placed
beside another tree's package measures that tree's serving path.

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written CUDA kernels from ``simple_tensorflow_tpu_torch/csrc/``
   with ``nvcc`` for ``sm_90a``.
2. Kernel phases: each kernel against its plain PyTorch version on the
   card, at the serving and training paths' shapes (f32: rtol 1e-5, atol
   1e-5; bf16: 2e-2; QuantMatMul and Adam bit-exact; the training
   kernels' outputs within a bound scaled by the largest reference value:
   f32 1e-5 for forward values and 1e-4 for gradients and column sums,
   bf16 2e-2; the xent backward, whose values span many orders of
   magnitude, element by element within 1e-5 (f32) or 1e-2 (bf16) of
   each value plus that times the mean magnitude, a limit the phase shows
   failing planted faults; the dropout kernels, whose masks are integer
   functions of a seed or key, bit-exact, with 0 mask mismatches on x =
   ones and a planted fault (another salt, key or seed) that must fail;
   Momentum bit-exact over ResNet-50's two flat groups, plain and
   Nesterov, from non-zero accumulators, with ``mu`` one ulp off and the
   Nesterov flag flipped as planted faults that must differ; the xent
   kernels also at ResNet-50's f32 256 x 1000 logits),
   with its device time, its bound (the larger of bytes over 3.35 TB/s
   and operations over the peak of their type), the plain
   version's time and one PyTorch library call's time as a yardstick
   (never called by the port). Times come from CUDA graphs of
   back-to-back launches timed with CUDA events, over input copies that
   together exceed the 50 MB L2 where the inputs are large, so large
   inputs are read cold as the paths read them; library calls that run
   an optimizer or PyTorch's dropout RNG are timed with CUDA events around
   repeated calls instead. The flash backward kernels' yardstick is SDPA's
   backward alone (its flash backward on a saved forward, which computes
   dq, dk and dv in one call), graph-timed, beside SDPA forward +
   backward captured in a graph. The bf16 flash forward's dropout mask is
   also read off its output (q = 0, v one-hot) at the training shape, and
   the bf16 backward's off each of dV, dK and dQ (``keep_mask_readoff``):
   0 mismatches with the plain mask, and the next seed's mask must differ.
   DecodeAttention runs at every decode bucket (Kq = 1, B = 1, 4, 16,
   each with the splits of the cache axis it takes) and a ragged L in
   f32 and bf16, beside SDPA with the same mask;
   QuantMatMul runs on a K-major weight at m = 1, 4, 16 and 32 (a
   row-major weight must be refused);
   the LayerNorm forward on both of its paths (the vector path at n =
   1024, f32 and bf16, 16 to 4096 rows, the row statistics checked at
   4096; the general one at n = 1000), the backward on both of its paths
   (the vector path at n = 1024, the general one at n = 1000 and forced
   at 1024), its dgamma and dbeta bitwise equal over two runs; the fused
   dropout-residual (K4) on both of its paths at four shapes; the threefry
   Dropout forward (values and keep bits) and its backward from those
   bits at both training shapes, the next key's values, bits and backward
   as planted faults. The registers and spills ``ptxas`` reports for the
   tensor-core backward kernels, QuantMatMul, the LayerNorm kernels, the
   Kq = 1 DecodeAttention and the dropout kernels are printed after the
   build. The redesigned kernels (the Dropout and K4) and
   those that must hold their times get one line each at the end: the
   time before the redesign (``EARLIER_MS``), this run's, the bound and
   the library call's; the LM training phase prints its device time a
   step beside the one before and one step's peak memory at both dropout
   rates, and its profiler windows must show both LayerNorm kernels and,
   at dropout 0.1, the three dropout kernels on their vector paths.
3. Serving phase: ``GenerativeEngine`` over ``CausalLMGenerativeModel``
   at ``TransformerConfig.big()`` width (6 layers, d_model 1024, 16
   heads, vocab 32768) with seeded random weights, 12 requests of 17-96
   prompt tokens (four share a 32-token prefix), 24 new tokens each,
   once with the f32 logits head and once with ``int8=True``. Launch
   counters are zeroed just before each run and read just after; every
   kernel of the run must have launched. Every emitted token is checked,
   teacher-forced on the engine's own stream, against a plain full
   re-forward on the card (PyTorch ops only, no kernel). Then 16 more
   requests fill decode bucket 16 and a ``torch.profiler`` window over
   ``TRACE_STEPS`` engine steps gives the device ms a decode step beside
   the host p50 step, and the top kernels. The model captures every
   decode and prefill bucket as a CUDA graph when it is built
   (``aot_warmup``, the default); its launches count through the
   replays. Then, per head, the model with ``aot_warmup`` on and off on
   one fixed script of prefill and decode calls (every bucket, partial
   buckets, a small batch right after a larger one): tokens int-exact
   and log-probs bit-identical. Last, the f32 head served with
   ``aot_warmup=False`` (eager dispatch) on the same prompts, its
   tokens/s, p50 decode step, p50 time to first token and traced
   bucket-16 step printed beside the graphs'.
4. Training phase: ``causal_lm_train_model`` at ``TransformerConfig.big()``,
   batch 16 x 256, weights from ``init_params(seed=0)``. At dropout 0 and
   at the shipped 0.1: one f32 step through the kernels against the same
   step through the plain versions (a trainer built with ``plain=True``,
   drawing the same dropout masks): the loss within rtol 1e-5, every
   parameter's gradient within relative norm 1e-3 (2e-3 at dropout 0.1;
   the attention key biases, whose exact gradient is zero, below 1e-5 of
   the key kernel's gradient norm on both sides). That limit covers the
   few FFN-input units whose ReLU gate flips on f32 roundoff between the
   runs, which the phase counts; with the plain run's ReLU masks shared
   the limit is
   1e-4, and two planted faults (dQ x 1.001, the xent backward without
   smoothing) must fail it. Then ``TRAIN_STEPS`` bf16 steps of
   ``TransformerConfig.big()`` as shipped (dropout 0.1) on one repeated
   batch with a ``TRAIN_WARMUP``-step noam warm-up: every loss finite, the
   mean of the last ``LOSS_MEAN_OF`` below the mean of the first ones and
   the last loss below the first (dropout makes the loss noisy from step
   to step), the exact launches per step, the p50 step time, tokens/s,
   the kernels' device time per step, the host time to derive a step's
   dropout keys and seeds, and the peak device memory. Interleaved step
   by step with it, the same window at dropout 0 (its loss must fall at
   every step), for the cost of dropout in one call: the p50 steps and
   the device time a step from a profiler window of each.

5. ResNet-50 phase: ``resnet50_train_model`` (batch 256 x 224^2, 1000
   classes, bf16, lr 0.1, Momentum 0.9, weight decay 1e-4) with weights
   from ``init_resnet_params(seed=0)`` on one repeated
   ``synthetic_imagenet`` batch (seed 0). First ``RESNET_F32_STEPS`` f32
   steps at ``RESNET_F32_B`` x 224^2 through the kernels against the same
   steps through the plain versions, cuDNN deterministic: each loss
   within rtol 1e-5, every parameter and the accumulators within the
   ``RESNET_*_TOL`` relative norms, which two planted Momentum faults must
   fail. Then ``RESNET_STEPS`` bf16 steps at full size: every loss finite,
   the mean of steps 5-8 below that of steps 1-4 (the recipe overshoots on
   a repeated batch later in the window), exactly
   2 Momentum and 1 + 1 xent launches a step; the p50 step, images/s and
   its share of the bf16 peak at 3 x ``resnet_flops_per_image``, the
   peak memory, and a profiler window of 3 steps with its top kernels.

6. Session phase (the TF-1 front end): ``models/mnist.py`` built with the
   port's ``stf`` API and run by ``stf.Session`` on the card. First the
   path's kernels at its shapes against their plain versions (the xent
   forward and backward at f32 512 x 10, Adam over the convnet's f32
   group of 3,274,634 parameters, bit-exact, the threefry Dropout at f32
   (512, 1024), keep_prob 0.5, bit-exact), each with its time, bound and
   library call. Then ``SESSION_CHECK_STEPS`` ``convnet_model`` steps
   (batch 512, f32, keep_prob 0.5) through the kernels against the same
   steps under ``fused_ops.plain_versions()``, cuDNN deterministic: each
   loss within rtol 1e-5, the first step's Dropout output equal, every
   step's masks equal on live units, every variable and Adam slot within
   relative norm 1e-5; Adam's beta1 x (1 + 1e-4) and the Dropout op's
   stream id + 1 are planted faults that must fail (these steps
   dispatch eagerly, ``_capture`` off). The Dropout forward's device-key
   entry (the key read through a pointer, as a captured step launches
   it) is held bit for bit against the launch-argument entry and the
   plain version at the MNIST shape and at both training shapes. Then the
   Session's CUDA graphs: ``GRAPH_CHECK_STEPS`` convnet steps of a
   Session that captures its step (step 1 eager, step 2 captured, then
   replays) against the same steps dispatched eagerly from the same run
   counters: losses, Dropout outputs, every variable and Adam slot
   bit-identical, exactly one capture; a planted fault (the key buffer
   not refilled before the replays) must change the Dropout outputs.
   Then two windows of ``SESSION_STEPS`` ``Session.run([train_op,
   loss])`` steps on one repeated ``synthetic_mnist(512, seed=0)`` batch
   fed as numpy, the graph one first, then the eager one: the loss falls,
   exactly 1 + 1 xent, 1 Adam and 1 + 1 Dropout launches a step (in the
   graph window the first step's Dropout is the launch-argument entry,
   the other 15 the device-key entry, all counted through the replays),
   no plan-cache miss and no further capture after the first step; each
   window's p50 step, images/s, the device ms a step from a
   ``torch.profiler`` window of 3 steps, the host ms a step (p50 minus
   device) and the host time by kind (op dispatch, autograd, feeds; for
   the graph, staging and replay). Last, ``softmax_model``
   (GradientDescent at ``SOFTMAX_LR``) for ``SESSION_STEPS`` steps, its
   loss falling at every step.
7. Transformer Session phase: ``models/transformer.py``
   ``transformer_train_model`` (the reference's headline model) built with
   the port's ``stf`` API and trained by ``stf.Session``. First its new
   kernel shapes against their plain versions: the bf16 flash kernels at
   64 x 16 heads of S = 64, D = 64, non-causal with a pad bias, dropout
   0.1, through the launch-argument entry and the seed-pointer entry
   (bit-identical; both timed in the same call; the next seed's mask must
   fail), the dropout-residual kernel and its dx through the seed-pointer
   entry at bf16 4096 x 1024 (bit-exact, beside the launch-argument
   entry's time), Adam over the transformer's bf16 group (176,295,936
   bf16 parameters, f32 m and v). Then ``TF_CHECK_STEPS`` f32 steps at
   ``TransformerConfig.big()`` widths with the depth cut to
   ``TF_CHECK_LAYERS`` + ``TF_CHECK_LAYERS`` layers, batch ``TF_CHECK_B``
   x 64 / 64 with pads in src and tgt, dropout 0.1, through the kernels
   against the same steps under ``plain_versions()`` (eager): the losses
   within rtol 1e-5, the parameters (as the flat vector the Adam kernel
   updates) and the beta powers within relative norm 1e-4, the flat Adam
   slots (gradient averages) within the LM check's f32 gradient limit at
   dropout 0.1 (2e-3: ReLU gates that flip on roundoff), and a planted
   fault (the decoder's first cross-attention drawn
   with its self-attention's seed) that must fail. Then the shipped config uncut (bf16, 6 + 6 layers, batch 64, 64
   / 64, ``warmup_steps`` ``TF_WARMUP``) on one repeated
   ``synthetic_wmt_batch(64, 64, 64, seed=0)``: ``TF_GRAPH_STEPS`` steps
   captured and replayed against the same steps dispatched eagerly,
   losses, the first encoder flash and dropout-residual outputs, every
   variable and Adam slot bit-identical, one capture; replays whose seed
   buffer is not refilled (a planted fault) must change the flash and
   dropout-residual outputs. Last, two windows of ``TF_STEPS``
   ``Session.run([loss, train_op])`` steps, the graph one first: every
   loss finite and the mean of steps 9-16 below that of steps 1-8; the
   exact launches a step (18 of each flash kernel, 30 + 30 LayerNorm, 1 +
   1 xent, 18 + 18 dropout-residual, 14 + 14 Dropout, 2 Adam; in the graph
   window step 1 through the launch-argument entries and the 15 replays
   through the seed-pointer and device-key ones); one capture and no
   plan-cache miss after step 1; each window's p50 step, target tokens/s,
   source + target tokens/s and the share of the dense bf16 peak at 3 x
   ``transformer_flops_per_token`` a token (the reference's count), the
   device ms a step from a ``torch.profiler`` window of 3 steps, the host
   ms a step and the host time by kind.

Each path (the three serving runs, the two f32 kernel steps, the two
causal-LM bf16 windows, the ResNet f32 kernel steps, the ResNet bf16
window, the Session's checked steps and its two windows, the transformer's
f32 kernel steps and its two windows) is counted from zero just before
it; a kernel's ``launches`` sum over the paths, the flash rows split by
the path's dropout rate (the seed-pointer entries are rows of their
own). Prints a
``{"kernels": [...]}`` line and ends with ``{"ok": true, "device":
{...}}``. Exits non-zero, without that last line, on any
failure, when no CUDA device is available, or without the package
beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,      # f32 outside tensor cores
                  torch.bfloat16: 989e12,    # dense bf16 tensor cores
                  torch.int8: 1979e12}       # dense int8 tensor cores
# 32-bit integer operations: an SM issues at most 4 warp instructions (128
# lane operations) a clock, half the 67e12 f32 rate, which counts an FMA as
# two operations. Adds, multiplies, shifts and rotates may issue on the FMA
# pipe (IMAD, IMAD.SHL, IMAD.HI, IMAD.WIDE) as well as the integer ALU;
# logic ops and compares (LOP3, ISETP) run only on the ALU, 64 lanes a clock
# an SM: half that rate.
INT32_OPS_PER_S = 67e12 / 2
ALU_OPS_PER_S = INT32_OPS_PER_S / 2
# integer operations an element: K0 (the counter-hash keep mask, two
# murmur finalizers of 3 shifts, 3 xors and 2 multiplies, two xors and a
# compare; the per-(seed, salt) hash hoisted)
K0_OPS = 19
# threefry-2x32 and the keep test, an element, in the fewest instructions:
# 20 round adds, 5 injections into b, the last injection into a (the other
# four fold into the next round's IADD3), the counter's add and 20 rotates,
# any of which may issue on the FMA pipe (a rotate as IMAD.WIDE.U32 by 2^r,
# its two halves OR-ed inside the round's 3-input xor); only the 20 xors of
# the rounds, the final xor and the integer compare need the ALU
THREEFRY_ALU_OPS = 22
THREEFRY_OPS = 69
DROPOUT_RATE = 0.1               # TransformerConfig.big() as it ships
# times before the redesign of the threefry Dropout and the fused
# dropout-residual (K4), and of the kernels that must hold theirs within 5%
# (this script's run 4 of the previous redesign on an NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md §6); the ragged K4 rows come from the same run
EARLIER_MS = {"dropout": (0.07672, "redesigned"),
              "dropout_bwd": (0.07645, "redesigned"),
              "dropout@embedding": (0.02124, "redesigned"),
              "dropout_bwd@embedding": (0.02127, "redesigned"),
              "dropout_residual": (0.01564, "redesigned"),
              "dropout_residual_bwd": (0.01459, "redesigned"),
              "dropout_residual@ragged_f32": (0.00173, "redesigned"),
              "dropout_residual_bwd@ragged_f32": (0.00163, "redesigned"),
              "dropout_residual@ragged_bf16": (0.00172, "redesigned"),
              "dropout_residual_bwd@ragged_bf16": (0.00170, "redesigned"),
              "dropout_residual@f32": (None, "redesigned"),
              "decode_attention": (0.01025, "unchanged"),
              "decode_attention@B1": (0.00659, "unchanged"),
              "decode_attention@B4": (0.00771, "unchanged"),
              "decode_attention@bf16": (0.00794, "unchanged"),
              "layer_norm": (0.00251, "unchanged"),
              "layer_norm@train": (0.00741, "unchanged"),
              "layer_norm@train_f32": (0.01177, "unchanged"),
              "layer_norm@general": (0.01606, "unchanged"),
              "quant_matmul": (0.01869, "unchanged"),
              "layer_norm_bwd": (0.01363, "unchanged"),
              "flash_attention_dkdv": (0.03412, "unchanged"),
              "flash_attention_dq": (0.02863, "unchanged"),
              "flash_attention_dkdv_dropout": (0.04034, "unchanged"),
              "flash_attention_dq_dropout": (0.03524, "unchanged"),
              "flash_attention_fwd": (0.03059, "unchanged"),
              "flash_attention_fwd_dropout": (0.03430, "unchanged"),
              "flash_attention_fwd@f32": (0.16162, "unchanged"),
              "flash_attention_dkdv@f32": (0.27513, "unchanged"),
              "flash_attention_dq@f32": (0.22393, "unchanged"),
              "decode_attention_block": (0.01416, "unchanged"),
              "softmax_xent_fwd": (0.15245, "unchanged"),
              "softmax_xent_bwd": (0.20225, "unchanged"),
              "softmax_xent_fwd@resnet": (0.00388, "unchanged"),
              "softmax_xent_bwd@resnet": (0.00309, "unchanged"),
              "adam_update": (0.70266, "unchanged"),
              "momentum_update": (0.13832, "unchanged")}
# LM training device ms a step at dropout 0.1 and 0 before this redesign
# (the same run)
EARLIER_TRAIN_DEVICE_MS = {0.1: 10.9258, 0.0: 9.5895}
L2_BYTES = 50 * 2 ** 20
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
SRC = "simple_tensorflow_tpu_torch/csrc/"
TPU = "simple_tensorflow_tpu/ops/pallas/"


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def device_ms(fns, rounds=5, min_calls=16):
    """Device time of one call, from a CUDA graph that runs ``fns``
    (closures over different input copies) round-robin, timed with CUDA
    events; the median over ``rounds`` replays."""
    calls = [fns[i % len(fns)] for i in range(max(min_calls, len(fns)))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def n_copies(bytes_per_call: int) -> int:
    """Input copies whose total is twice the L2 (capped)."""
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def bound_ms(nbytes: float, ops: float, op_dtype, int_ops: float = 0.0,
             alu_ops: float = 0.0) -> tuple:
    """The least time for ``nbytes`` moved, ``ops`` operations of
    ``op_dtype`` and ``int_ops`` 32-bit integer operations, ``alu_ops`` of
    them ALU-only (the kinds of operation run on separate units: the
    slowest one bounds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / PEAK_OPS_PER_S[op_dtype], int_ops / INT32_OPS_PER_S,
                alu_ops / ALU_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- kernel phases -----------------------------------------------------------

def check_close(name, out, ref, dtype):
    rtol, atol = TOL[dtype]
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    return err


def check_scaled(name, out, ref, tol):
    """max |out - ref| <= tol * max(1, max |ref|); returns the error."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    bound = tol * max(1.0, ref.abs().max().item())
    if not err <= bound:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e} > {bound:.3e})")
    return err


def elementwise_ratio(out, ref, tol):
    """The largest |out - ref| / (tol * (|ref| + mean |ref|)): each value
    held to ``tol`` of its own size, with a floor of ``tol`` times the
    mean magnitude where the reference cancels to near zero. Above 1
    fails."""
    ref = ref.float()
    bound = tol * (ref.abs() + ref.abs().mean())
    diff = (out.float() - ref).abs()
    return (diff / bound.clamp_min(torch.finfo(torch.float32).tiny)).max(
        ).item(), diff.max().item()


def check_elementwise(name, out, ref, tol):
    """``elementwise_ratio`` within 1; returns the max abs error."""
    ratio, err = elementwise_ratio(out, ref, tol)
    if not ratio <= 1.0:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e}; worst element at {ratio:.3e} of its bound)")
    return err


def event_ms(fn, reps=5):
    """Time of one call from CUDA events around ``reps`` calls, after one
    warm-up call: for library calls that run autograd or an optimizer,
    which the graph-based timer does not capture."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_row(err, ms, plain, bnd, lib, shape):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "shape": shape}


def report(name, err, ms, plain, bnd, lib):
    b_ms, b_by = bnd
    lib_txt = "null" if lib is None else f"{lib:.5f}"
    print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.5f} ms  "
          f"plain {plain:.5f} ms  bound {b_ms:.5f} ms ({b_by})  "
          f"library {lib_txt} ms", flush=True)


def phase_decode_attention(K, rng, dev):
    """DecodeAttention at the decode (Kq=1, B = decode buckets 1, 4, 16)
    and page-block prefill (Kq=16, causal_offset, B = prefill buckets)
    shapes, L = 16 pages x 16 = 256, H=16, D=64; one biased case each;
    a ragged L for each (Kq=1: B=4, L=200, which splits the cache axis;
    Kq=16: B=2) to cover the tails. Each Kq=1 case prints the splits of
    the cache axis its B takes."""
    import torch.nn.functional as F

    kda = importlib.import_module(KMOD + "decode_attention")
    H, D = 16, 64
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for kq, causal, bs in ((1, False, (1, 4, 16)),
                               (16, True, (1, 4, 16))):
            for b in bs:
                cases.append((dtype, kq, causal, b, 256, False))
            cases.append((dtype, kq, causal, 16, 256, True))
        cases.append((dtype, 1, False, 4, 200, False))
        cases.append((dtype, 16, True, 2, 200, False))
    main = {}
    for dtype, kq, causal, b, L, biased in cases:
        qshape = (b, H, D) if kq == 1 else (b, kq, H, D)
        lo, hi = 1, L - (kq if causal else 0)
        lens = rng.randint(lo, hi + 1, size=b)
        lens[0] = hi                        # one row walks the whole cache
        if b > 1:
            lens[-1] = 1                    # a scratch-page padding row
        per_call = (2 * b * L * H * D + 2 * int(np.prod(qshape))) * \
            torch.tensor([], dtype=dtype).element_size()
        copies = []
        for _ in range(n_copies(per_call)):
            q = torch.from_numpy(rng.standard_normal(qshape)).to(dev, dtype)
            k = torch.from_numpy(
                rng.standard_normal((b, L, H, D))).to(dev, dtype)
            v = torch.from_numpy(
                rng.standard_normal((b, L, H, D))).to(dev, dtype)
            copies.append((q, k, v))
        lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
        bias = (torch.from_numpy(rng.standard_normal((b, L))).to(
            dev, torch.float32) if biased else None)
        q, k, v = copies[0]
        out = K.decode_attention(q, k, v, lengths, bias=bias,
                                 causal_offset=causal)
        ref = K.decode_attention_plain(q, k, v, lengths, bias=bias,
                                       causal_offset=causal)
        torch.cuda.synchronize()
        name = (f"decode_attention{'_block' if kq > 1 else ''} "
                f"{str(dtype)[6:]} B={b} Kq={kq} L={L}"
                f"{' bias' if biased else ''}")
        if kq == 1:
            splits = math.ceil(L / kda.one_split_len(
                b, H, L, torch.cuda.get_device_properties(
                    dev).multi_processor_count))
            name += f" ({splits} split{'s' if splits > 1 else ''})"
        err = check_close(name, out, ref, dtype)

        def kern(c):
            return lambda: K.decode_attention(c[0], c[1], c[2], lengths,
                                              bias=bias,
                                              causal_offset=causal)

        def plain(c):
            return lambda: K.decode_attention_plain(
                c[0], c[1], c[2], lengths, bias=bias, causal_offset=causal)

        # the yardstick: one SDPA call on the same tensors as (B, H, Kq,
        # D) views, with the same mask (and bias) as an additive mask
        span = torch.arange(L, device=dev).view(1, 1, L)
        allowed = lengths.view(b, 1, 1).long()
        if causal:
            allowed = allowed + 1 + torch.arange(kq, device=dev).view(
                1, kq, 1)
        add = torch.where(span < allowed, 0.0, float("-inf"))
        if bias is not None:
            add = add + bias.view(b, 1, L)
        add = add.view(b, 1, kq, L).to(dtype)

        def lib(c):
            qv = (c[0].view(b, 1, H, D) if kq == 1 else c[0]).transpose(1, 2)
            kv, vv = c[1].transpose(1, 2), c[2].transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(
                qv, kv, vv, attn_mask=add)

        ms = device_ms([kern(c) for c in copies])
        plain_ms = device_ms([plain(c) for c in copies])
        lib_ms = device_ms([lib(c) for c in copies])
        # the bytes and operations this run's lengths need: each query
        # reads its allowed positions; K and V rows up to the furthest
        # allowed position of the row, once
        reach = np.minimum(lens + (kq if causal else 0), L)
        allowed_pos = sum(min(int(n) + (j + 1 if causal else 0), L)
                          for n in lens for j in range(kq))
        elem = q.element_size()
        moved = (int(reach.sum()) * H * D * 2 * elem + 2 * q.numel() * elem
                 + lengths.numel() * 4 + (b * L * 4 if biased else 0))
        ops = 4 * allowed_pos * H * D
        bnd = bound_ms(moved, ops, dtype)
        report(name, err, ms, plain_ms, bnd, lib_ms)
        row = kernel_row(err, ms, plain_ms, bnd, lib_ms, name)
        if biased or L != 256:
            continue
        # the JSON rows: f32, the largest decode / prefill bucket; the
        # other Kq=1 buckets and bf16 for the summary
        if kq > 1 and dtype == torch.float32 and b == 4:
            main["decode_attention_block"] = row
        if kq == 1 and dtype == torch.float32:
            main["decode_attention" + ("" if b == 16 else f"@B{b}")] = row
        if kq == 1 and dtype == torch.bfloat16 and b == 16:
            main["decode_attention@bf16"] = row
    return main


def phase_layer_norm(K, rng, dev):
    """LayerNorm forward at n = d_model 1024: rows 16 (decode bucket 16,
    one prefill chunk), 64 (prefill bucket 4 x page_len), 256, and 4096
    (a training batch of 16 x 256 tokens), f32 and bf16, all on the
    vector path (a warp per row); then n = 1000 at 4096 rows, which
    takes the general path. The row statistics (mean, rstd) are checked
    too at 4096 rows, where the training path asks for them."""
    import torch.nn.functional as F

    kln = importlib.import_module(KMOD + "layer_norm")
    main = {}
    cases = [(dtype, rows, 1024) for dtype in (torch.float32, torch.bfloat16)
             for rows in (16, 64, 256, 4096)]
    cases.append((torch.bfloat16, 4096, 1000))
    for dtype, rows, n in cases:
        elem = torch.tensor([], dtype=dtype).element_size()
        copies = [torch.from_numpy(rng.standard_normal((rows, n))).to(
            dev, dtype) for _ in range(n_copies(2 * rows * n * elem))]
        gamma = torch.from_numpy(
            1.0 + 0.1 * rng.standard_normal(n)).to(dev, torch.float32)
        beta = torch.from_numpy(
            0.1 * rng.standard_normal(n)).to(dev, torch.float32)
        x = copies[0]
        nv = kln.vectors_per_lane(n, dtype, x, gamma, beta)
        path = f"vector path, {nv} vectors a lane" if nv else "general path"
        name = f"layer_norm {str(dtype)[6:]} rows={rows} n={n}"
        if rows == 4096:
            y, mean, rstd = K.layer_norm_fwd(x, gamma, beta,
                                             return_stats=True)
            ry, rmean, rrstd = K.layer_norm_plain(x, gamma, beta,
                                                  return_stats=True)
            err = max(check_close(name, y, ry, dtype),
                      check_close(f"{name} mean", mean, rmean,
                                  torch.float32),
                      check_close(f"{name} rstd", rstd, rrstd,
                                  torch.float32))
        else:
            err = check_close(name, K.layer_norm(x, gamma, beta),
                              K.layer_norm_plain(x, gamma, beta), dtype)
        ms = device_ms([lambda c=c: K.layer_norm(c, gamma, beta)
                        for c in copies])
        plain_ms = device_ms([
            lambda c=c: K.layer_norm_plain(c, gamma, beta)
            for c in copies])
        g_t, b_t = gamma.to(dtype), beta.to(dtype)
        lib_ms = device_ms([
            lambda c=c: F.layer_norm(c, (n,), g_t, b_t, eps=1e-6)
            for c in copies])
        # read x, gamma, beta once, write y; ~8 flops an element
        bnd = bound_ms(2 * x.numel() * elem + 2 * n * 4,
                       8 * rows * n, torch.float32)
        report(f"{name} ({path})", err, ms, plain_ms, bnd, lib_ms)
        row = kernel_row(err, ms, plain_ms, bnd, lib_ms, name)
        if n != 1024:
            main["layer_norm@general"] = row
        elif dtype == torch.float32 and rows == 16:
            main["layer_norm"] = row
        elif rows == 4096:
            main["layer_norm@train" + (
                "" if dtype == torch.bfloat16 else "_f32")] = row
    return main


def phase_quant_matmul(K, rng, dev):
    """Int8 QuantMatMul, the int8 logits head: x (m, 1024) f32 against
    wq (1024, 32768) int8 in the K-major layout the kernel takes (strides
    (1, k): the .t() of a contiguous (32768, 1024) tensor), m = decode
    buckets 1, 4, 16 and 32 (where ``torch._int_mm`` runs the same rows).
    Bit-exact; a row-major weight must be refused."""
    k, n = 1024, 32768
    main = {}
    copies = [torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(
        np.int8)).to(dev).t() for _ in range(n_copies(k * n))]
    w_scale = torch.from_numpy(
        (rng.random_sample(n) * 0.01 + 1e-4).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((4, k))).to(dev, torch.float32)
    try:
        K.quant_matmul(x, copies[0].contiguous(), w_scale)
    except ValueError as e:
        if "K-major" not in str(e):
            fail(f"quant_matmul: a row-major weight raised {e!r}")
        print("  quant_matmul refuses a row-major (k, n) weight: "
              f"{str(e)[:60]}...", flush=True)
    else:
        fail("quant_matmul: the kernel took a row-major weight")
    for m in (1, 4, 16, 32):
        x = torch.from_numpy(rng.standard_normal((m, k))).to(
            dev, torch.float32)
        wq = copies[0]
        name = f"quant_matmul f32 m={m} k={k} n={n}"
        out = K.quant_matmul(x, wq, w_scale)
        ref = K.quant_matmul_plain(x, wq, w_scale)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"{name}: kernel is not bit-exact with its plain version "
                 f"(max abs err "
                 f"{(out - ref).abs().max().item():.3e})")
        err = 0.0
        ms = device_ms([lambda w=w: K.quant_matmul(x, w, w_scale)
                        for w in copies])
        plain_ms = device_ms([lambda w=w: K.quant_matmul_plain(x, w,
                                                               w_scale)
                              for w in copies])
        # yardstick: torch._int_mm on the quantized rows (it takes more
        # than 16 rows, so below 32 they are zero-padded to 32) and the
        # same K-major weights, the layout cuBLASLt's int8 GEMM takes
        xq, _ = K.quantize_rowwise_plain(x)
        xq32 = torch.zeros((max(m, 32), k), dtype=torch.int8, device=dev)
        xq32[:m] = xq
        lib_ms = device_ms([lambda w=w: torch._int_mm(xq32, w)
                            for w in copies])
        bnd = bound_ms(x.numel() * 4 + k * n + n * 4 + m * n * 4,
                       2 * m * k * n, torch.int8)
        report(name, err, ms, plain_ms, bnd, lib_ms)
        if m == 16:
            main["quant_matmul"] = kernel_row(err, ms, plain_ms, bnd,
                                              lib_ms, name)
    del copies
    return main


# -- training kernel phases --------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D = 16, 256, 16, 64


KMOD = "simple_tensorflow_tpu_torch.ops.kernels."


def elem_size(dtype):
    return torch.tensor([], dtype=dtype).element_size()


FLASH_SEED = 424242


def check_flash_fault(K, q, k, v, do, rlse, delta, args, outs, tols, tag):
    """The limits above must fail the plain versions run under the next
    seed (a wrong mask): each of o, dK, dV and dQ."""
    bad = dict(args, dropout_seed=args["dropout_seed"] + 1)
    bo, _ = K.flash_attention_fwd_plain(q, k, v, **bad)
    bdk, bdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **bad)
    bdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **bad)
    readings = []
    for part, out, ref, tol in zip(("o", "dk", "dv", "dq"), outs,
                                   (bo, bdk, bdv, bdq), tols):
        ref = ref.float()
        ratio = ((out.float() - ref).abs().max().item()
                 / (tol * max(1.0, ref.abs().max().item())))
        if not ratio > 1.0:
            fail(f"flash {tag}: the check passes the mask of seed + 1 "
                 f"({part} at {ratio:.3e} of its bound)")
        readings.append(f"{part} {ratio:.3e}x")
    print(f"  flash {tag}: the check fails the mask of seed + 1: "
          f"{', '.join(readings)} its bound", flush=True)


def phase_flash_attention(K, gen, dev):
    """FlashAttention forward, dK/dV and dQ at the training shape (B=16,
    H=16, D=64: 256 heads of S=256, causal) without and with dropout 0.1
    (seed ``FLASH_SEED``; the limits must fail the next seed's mask), at a
    ragged S=200, and non-causal with a (B, S) key bias; f32 and bf16. The
    backward kernels get the plain forward's lse and delta = rowsum(dO *
    O)."""
    import torch.nn.functional as F

    B, H, D = TRAIN_B, TRAIN_H, TRAIN_D
    bh = B * H
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tol_f, tol_g = (1e-5, 1e-4) if f32 else (2e-2, 2e-2)
        elem = elem_size(dtype)
        for s, causal, biased, rate in ((256, True, False, 0.0),
                                        (256, True, False, DROPOUT_RATE),
                                        (200, True, False, 0.0),
                                        (256, False, True, 0.0)):
            copies = [tuple(torch.randn((bh, s, D), generator=gen,
                                        device=dev).to(dtype)
                            for _ in range(4))
                      for _ in range(n_copies(4 * bh * s * D * elem))]
            bias = (torch.randn((B, s), generator=gen, device=dev)
                    if biased else None)
            args = dict(heads=H, sm_scale=D ** -0.5, causal=causal,
                        bias=bias)
            if rate:
                args.update(dropout_rate=rate, dropout_seed=FLASH_SEED)
            stats = []
            for q, k, v, do in copies:
                ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
                stats.append((ro, rlse, (do.float() * ro.float()).sum(-1)))
            q, k, v, do = copies[0]
            ro, rlse, delta = stats[0]
            o, lse = K.flash_attention_fwd(q, k, v, **args)
            dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
            rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta,
                                                    **args)
            dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
            rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
            torch.cuda.synchronize()
            tag = (f"{str(dtype)[6:]} BH={bh} S={s} D={D}"
                   f"{' causal' if causal else ''}{' bias' if biased else ''}"
                   f"{f' dropout {rate}' if rate else ''}")
            err = {
                "fwd": max(check_scaled(f"flash fwd o {tag}", o, ro, tol_f),
                           check_scaled(f"flash fwd lse {tag}", lse, rlse,
                                        1e-5)),
                "dkdv": max(check_scaled(f"flash dk {tag}", dk, rdk, tol_g),
                            check_scaled(f"flash dv {tag}", dv, rdv, tol_g)),
                "dq": check_scaled(f"flash dq {tag}", dq, rdq, tol_g)}
            if rate:
                check_flash_fault(K, q, k, v, do, rlse, delta, args,
                                  (o, dk, dv, dq),
                                  (tol_f, tol_g, tol_g, tol_g), tag)
            del o, lse, dk, dv, rdk, rdv, dq, rdq
            fns = {
                "fwd": (K.flash_attention_fwd, K.flash_attention_fwd_plain,
                        lambda c, st: c[:3]),
                "dkdv": (K.flash_attention_dkdv,
                         K.flash_attention_dkdv_plain,
                         lambda c, st: (*c, st[1], st[2])),
                "dq": (K.flash_attention_dq, K.flash_attention_dq_plain,
                       lambda c, st: (*c, st[1], st[2]))}
            times = {}
            for part, (kern, plain, pick) in fns.items():
                times[part] = tuple(device_ms([
                    lambda f=f, c=c, st=st: f(*pick(c, st), **args)
                    for c, st in zip(copies, stats)]) for f in (kern, plain))
            # yardsticks on the same tensors as (B, H, S, D) views: SDPA
            # forward; SDPA's backward alone (bf16 without a bias: its
            # flash backward on the saved out and logsumexp), which
            # computes dq, dk and dv in one call; SDPA forward + backward
            # (torch.autograd.grad). At rate 0 all graph-timed; with
            # dropout, SDPA's own dropout (similar work, another mask)
            # timed with CUDA events around eager calls (its RNG is kept
            # out of a graph) and no backward alone
            mask = bias.view(B, 1, 1, s).to(dtype) if biased else None

            def sdpa(c):
                q4, k4, v4 = (t.view(B, H, s, D) for t in c[:3])
                return lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, is_causal=causal,
                    dropout_p=rate)

            def sdpa_fb(c):
                qg, kg, vg = (t.view(B, H, s, D).detach().requires_grad_()
                              for t in c[:3])
                do4 = c[3].view(B, H, s, D)
                return lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(
                        qg, kg, vg, attn_mask=mask, is_causal=causal,
                        dropout_p=rate), (qg, kg, vg), do4)

            lib_bwd = None
            if rate:
                lib_fwd = event_ms(sdpa(copies[0]), reps=20)
                lib_fb = event_ms(sdpa_fb(copies[0]))
            else:
                lib_fwd = device_ms([sdpa(c) for c in copies])
                lib_fb = device_ms([sdpa_fb(c) for c in copies])
                if not f32 and not biased:
                    lib_bwd = device_ms([sdpa_bwd(c, B, H, s, D, causal)
                                         for c in copies])
            # the work these inputs need: live (query, key) pairs only
            pairs = bh * (s * (s + 1) // 2 if causal else s * s)
            io = bh * s * D * elem
            extra = (B * s * 4 if biased else 0)
            hashes = K0_OPS * pairs if rate else 0   # one mask per pair
            bnds = {"fwd": bound_ms(4 * io + bh * s * 4 + extra,
                                    4 * D * pairs, dtype, hashes),
                    "dkdv": bound_ms(6 * io + 2 * bh * s * 4 + extra,
                                     8 * D * pairs, dtype, hashes),
                    "dq": bound_ms(5 * io + 2 * bh * s * 4 + extra,
                                   6 * D * pairs, dtype, hashes)}
            lib_g = lib_fb if lib_bwd is None else lib_bwd
            libs = {"fwd": lib_fwd, "dkdv": lib_g, "dq": lib_g}
            for part in ("fwd", "dkdv", "dq"):
                name = f"flash_attention_{part} {tag}"
                report(name, err[part], times[part][0], times[part][1],
                       bnds[part], libs[part])
                row = kernel_row(err[part], times[part][0], times[part][1],
                                 bnds[part], libs[part], name)
                if not f32 and s == 256 and causal:
                    main[f"flash_attention_{part}"
                         + ("_dropout" if rate else "")] = row
                if f32 and s == 256 and causal and not rate:
                    main[f"flash_attention_{part}@f32"] = row
            bwd_txt = "n/a" if lib_bwd is None else f"{lib_bwd:.5f}"
            print(f"  flash library {tag}: SDPA backward alone {bwd_txt} ms,"
                  f" forward + backward {lib_fb:.5f} ms "
                  f"({'CUDA events, eager' if rate else 'graph-timed'})",
                  flush=True)
            if lib_bwd is not None and s == 256 and causal:
                c = copies[0]
                print(f"  flash library {tag}: kernels of SDPA forward + "
                      f"backward {device_kernels(sdpa_fb(c))}; of the "
                      f"backward alone "
                      f"{device_kernels(sdpa_bwd(c, B, H, s, D, causal))}",
                      flush=True)
            if not f32 and s == 256 and causal and not rate:
                pair = times["dkdv"][0] + times["dq"][0]
                print(f"  flash bwd {tag}: dK/dV + dQ {pair:.5f} ms, "
                      f"{pair / lib_bwd:.3f}x SDPA's backward alone "
                      f"({lib_bwd:.5f} ms)", flush=True)
            if not f32 and s == 256 and causal and rate:
                check_flash_fwd_mask(K, dev, bh, s, rate)
                check_flash_bwd_mask(K, dev, bh, s, rate)
                for part in ("fwd", "dkdv", "dq"):
                    ratio = (times[part][0]
                             / main[f"flash_attention_{part}"]["ms"])
                    print(f"  flash {part} {tag}: {times[part][0]:.5f} ms, "
                          f"{ratio:.3f}x the rate-0 kernel", flush=True)
            del copies, stats
        print("  (flash library: fwd = SDPA forward; dkdv/dq = SDPA's "
              "backward alone where it runs (bf16, no bias, rate 0), else "
              "SDPA forward + backward: one call computes dq, dk and dv "
              "together; with dropout, SDPA's dropout_p: similar work, "
              "another mask)", flush=True)
    return main


def device_kernels(fn):
    """The names (cut to 60 characters) of the device kernels one call of
    ``fn`` runs, from a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def sdpa_bwd(c, B, H, s, D, causal):
    """SDPA's flash backward alone on the saved output and logsumexp of
    one forward call over the (BH, S, D) tensors ``c`` (q, k, v, dO)."""
    q4, k4, v4, do4 = (t.view(B, H, s, D) for t in c)
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=D ** -0.5)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset,
        scale=D ** -0.5)


def check_flash_fwd_mask(K, dev, bh, s, rate):
    """The bf16 forward's dropout mask read off its output at the
    training shape: with q = 0 every live score is 0 and p = 1, and v
    one-hot over a block of D keys makes o[:, r, d] nonzero exactly where
    key blk * D + d of row r was live and kept. 0 mismatches against the
    plain K0 mask; the next seed's mask must differ (a planted fault)."""
    fa = importlib.import_module(KMOD + "flash_attention")
    D = TRAIN_D
    q = torch.zeros((bh, s, D), device=dev, dtype=torch.bfloat16)
    k = torch.ones((bh, s, D), device=dev, dtype=torch.bfloat16)
    parts = []
    for blk in range(s // D):
        keys = torch.arange(s, device=dev)[:, None] - blk * D
        v = (keys == torch.arange(D, device=dev)[None, :]).to(torch.bfloat16)
        o, _ = K.flash_attention_fwd(
            q, k, v.expand(bh, s, D).contiguous(), heads=TRAIN_H,
            sm_scale=D ** -0.5, causal=True, dropout_rate=rate,
            dropout_seed=FLASH_SEED)
        parts.append(o != 0)
    got = torch.cat(parts, dim=-1)
    live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    want = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED, dev) & live
    bad = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED + 1, dev) & live
    miss, fault = mismatches(got, want), mismatches(got, bad)
    print(f"  flash fwd bf16 BH={bh} S={s} dropout {rate}: mask read off "
          f"the output, mismatches {miss} of {got.numel()} (kept "
          f"{got.sum().item()} of {live.sum().item() * bh} live); against "
          f"the mask of seed + 1 {fault}", flush=True)
    if miss or not fault:
        fail(f"flash fwd mask: {miss} mismatches, seed + 1 fault "
             f"mismatches {fault}")


def check_flash_bwd_mask(K, dev, bh, s, rate):
    """The bf16 backward's dropout mask read off each of dV, dK and dQ at
    the training shape (``keep_mask_readoff``: lse = delta = 0, a zero q
    or k so every live p is 1, one-hot dO, Q or K over blocks of D rows):
    0 mismatches with the plain K0 mask; the next seed's mask must differ
    (a planted fault)."""
    fa = importlib.import_module(KMOD + "flash_attention")
    args = dict(heads=TRAIN_H, sm_scale=TRAIN_D ** -0.5, causal=True,
                dropout_rate=rate, dropout_seed=FLASH_SEED)

    def bwd(q, k, v, do, lse, delta):
        dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta, **args)
        return dk, dv, K.flash_attention_dq(q, k, v, do, lse, delta, **args)

    live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    want = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED, dev) & live
    bad = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED + 1, dev) & live
    got = fa.keep_mask_readoff(bwd, bh, s, TRAIN_D, torch.bfloat16, dev)
    for part, mask in zip(("dV", "dK", "dQ"), got):
        miss, fault = mismatches(mask, want), mismatches(mask, bad)
        print(f"  flash bwd bf16 BH={bh} S={s} dropout {rate}: mask read "
              f"off {part}, mismatches {miss} of {mask.numel()} (kept "
              f"{mask.sum().item()}); against the mask of seed + 1 {fault}",
              flush=True)
        if miss or not fault:
            fail(f"flash bwd mask from {part}: {miss} mismatches, seed + 1 "
                 f"fault mismatches {fault}")


K4_SEED = 918273
DROPOUT_KEY = (123456789, 987654321)


def mismatches(a, b) -> int:
    return int((a != b).sum().item())


def check_exact(name, out, ref):
    """Bit-exact (``torch.equal``); returns the max abs error, 0."""
    if not torch.equal(out, ref):
        fail(f"{name}: kernel is not bit-exact with its plain version "
             f"({mismatches(out, ref)} elements differ)")
    return 0.0


def phase_dropout_residual(K, gen, dev):
    """The fused dropout-residual kernel (K4) at the training shape, bf16
    (4096, 1024) without a bias (the attention tail of every layer), at
    ragged f32 (300, 96) and bf16 (37, 1000) with a bias, and at f32
    (4096, 1024); forward and the backward's dx through the wrappers
    (``dropout_residual_fwd``, ``dropout_residual_bwd``: the path
    ``vectors_per_lane`` picks, the vector path, a warp per row, but for
    37 rows) and with the other path forced. Bit-exact with the plain
    versions on both paths, on random inputs and on x = ones, where the
    output is the mask itself (0 mismatches); the mask of salt 1 must
    differ (a planted fault). Yardstick: ``F.dropout(x) +
    residual`` and ``F.dropout(g)``, similar work with another mask."""
    import torch.nn.functional as F

    kdr = importlib.import_module(KMOD + "dropout_residual")
    main = {}
    for dtype, rows, n, biased, key in (
            (torch.bfloat16, 4096, 1024, False, ""),
            (torch.float32, 300, 96, True, "@ragged_f32"),
            (torch.bfloat16, 37, 1000, True, "@ragged_bf16"),
            (torch.float32, 4096, 1024, False, "@f32")):
        elem = elem_size(dtype)
        copies = [tuple(torch.randn((rows, n), generator=gen, device=dev)
                        .to(dtype) for _ in range(2))
                  for _ in range(n_copies(3 * rows * n * elem))]
        bias = (torch.randn(n, generator=gen, device=dev).to(dtype)
                if biased else None)
        kw = dict(rate=DROPOUT_RATE, seed=K4_SEED)
        x, res = copies[0]
        tensors = [x, res] + ([bias] if biased else [])
        picked = kdr.vectors_per_lane(rows, n, dtype, *tensors)
        # the vector path's count at this width, taken at any row count
        nv = kdr.vectors_per_lane(max(rows, kdr.VEC_MIN_ROWS), n, dtype,
                                  *tensors)
        tag = (f"{str(dtype)[6:]} rows={rows} n={n}"
               f"{' bias' if biased else ''}")
        if not nv:
            fail(f"dropout_residual {tag}: no vector path at this width")

        # path None: the wrappers, which pick the path; else the path forced
        def fwd(c, path, b=bias):
            if path is None:
                return K.dropout_residual_fwd(c[0], c[1], b, **kw)
            return kdr.launch("dropout_residual", c[0], c[1], b,
                              DROPOUT_RATE, K4_SEED, path)

        def bwd(c, path):
            if path is None:
                return K.dropout_residual_bwd(c[0], **kw)
            return kdr.launch("dropout_residual_bwd", c[0], None, None,
                              DROPOUT_RATE, K4_SEED, path)

        ones = torch.ones((rows, n), dtype=dtype, device=dev)
        zeros = torch.zeros_like(ones)
        rr = torch.arange(rows, device=dev)[:, None]
        cc = torch.arange(n, device=dev)[None, :]
        salt1 = K.counter_keep_mask_plain(K4_SEED, 1, rr, cc,
                                          1.0 - DROPOUT_RATE)
        paths = ((None, f"vector path, {nv} vectors a lane, picked"),
                 (0, "general path, forced")) if picked else \
            ((None, "general path, picked"),
             (nv, f"vector path, {nv} vectors a lane, forced"))
        for path, label in paths:
            err_f = check_exact(f"dropout_residual {tag} ({label})",
                                fwd(copies[0], path),
                                K.dropout_residual_fwd_plain(x, res, bias,
                                                             **kw))
            err_b = check_exact(f"dropout_residual_bwd {tag} ({label})",
                                bwd(copies[0], path),
                                K.dropout_residual_bwd_plain(x, **kw))
            got = fwd((ones, zeros), path, None)
            miss = mismatches(got, K.dropout_residual_fwd_plain(
                ones, zeros, None, **kw))
            miss_b = mismatches(bwd((ones,), path),
                                K.dropout_residual_bwd_plain(ones, **kw))
            fault = mismatches(got != 0, salt1)
            kept = (got != 0).float().mean().item()
            print(f"  dropout_residual {tag} ({label}): x = ones, kernel vs "
                  f"plain mismatches fwd {miss} bwd {miss_b}; against the "
                  f"salt-1 mask {fault}; kept {kept:.5f}", flush=True)
            if miss or miss_b or not fault:
                fail(f"dropout_residual {tag} ({label}): mask mismatches "
                     f"{miss}/{miss_b}, salt-1 fault mismatches {fault}")
            ms_f = device_ms([lambda c=c: fwd(c, path) for c in copies])
            ms_b = device_ms([lambda c=c: bwd(c, path) for c in copies])
            if path is None:
                plain_f = device_ms([
                    lambda c=c: K.dropout_residual_fwd_plain(
                        c[0], c[1], bias, **kw) for c in copies])
                plain_b = device_ms([
                    lambda c=c: K.dropout_residual_bwd_plain(c[0], **kw)
                    for c in copies])
                lib_f = event_ms(lambda: F.dropout(x, DROPOUT_RATE) + res,
                                 reps=20)
                lib_b = event_ms(lambda: F.dropout(x, DROPOUT_RATE),
                                 reps=20)
            nb = elem * (n if biased else 0)
            bnd_f = bound_ms(3 * rows * n * elem + nb, 2 * rows * n,
                             torch.float32, K0_OPS * rows * n)
            bnd_b = bound_ms(2 * rows * n * elem, rows * n, torch.float32,
                             K0_OPS * rows * n)
            report(f"dropout_residual {tag} ({label})", err_f, ms_f,
                   plain_f, bnd_f, lib_f)
            report(f"dropout_residual_bwd {tag} ({label})", err_b, ms_b,
                   plain_b, bnd_b, lib_b)
            if path is None:
                main["dropout_residual" + key] = kernel_row(
                    err_f, ms_f, plain_f, bnd_f, lib_f,
                    f"dropout_residual {tag}")
                main["dropout_residual_bwd" + key] = kernel_row(
                    err_b, ms_b, plain_b, bnd_b, lib_b,
                    f"dropout_residual_bwd {tag}")
        del copies
    print("  (dropout_residual library: F.dropout(x) + residual and "
          "F.dropout(g), similar work with another mask, CUDA events "
          "around eager calls; the forced path's plain and library "
          "columns are the picked path's)", flush=True)
    return main


def key_tensor(key, dev):
    """A threefry key's two uint32 words as the ``(2,)`` int32 device
    tensor the device-key entry reads."""
    return torch.tensor(np.array(key, np.uint32).view(np.int32), device=dev)


def device_key_row(K, kdo, key, tag, copies, keep_prob, dtype, dev, main):
    """The Dropout forward's device-key entry (the key read through a
    pointer, as a captured Session step launches it) against the
    launch-argument entry and the plain version on the same key, at the
    same inputs: values and bits bit-identical, 0 mask mismatches on x =
    ones, and the next key (the buffer refilled) must differ. Times it and
    the plain version with the key tensor. Returns the row's pieces for
    :func:`report_device_key`."""
    kt = key_tensor(DROPOUT_KEY, dev)
    nxt = key_tensor((DROPOUT_KEY[0], DROPOUT_KEY[1] + 1), dev)
    x = copies[0]
    want, want_bits = K.dropout_fwd(x, keep_prob, DROPOUT_KEY,
                                    return_bits=True)
    got, got_bits = K.dropout_fwd(x, keep_prob, kt, return_bits=True)
    err = check_exact(f"dropout_device_key {tag}", got, want)
    check_exact(f"dropout_device_key {tag} bits", got_bits, want_bits)
    check_exact(f"dropout_device_key {tag} vs plain", got,
                kdo.dropout_plain(x, keep_prob, kt))
    ones = torch.ones(x.shape, dtype=dtype, device=dev)
    miss = mismatches(K.dropout_fwd(ones, keep_prob, kt),
                      K.dropout_fwd(ones, keep_prob, DROPOUT_KEY))
    fault = mismatches(K.dropout_fwd(ones, keep_prob, nxt),
                       K.dropout_fwd(ones, keep_prob, DROPOUT_KEY))
    print(f"  dropout_device_key {tag}: x = ones, device-key vs "
          f"launch-argument entry mismatches {miss}; the next key in the "
          f"buffer: {fault}", flush=True)
    if miss or not fault:
        fail(f"dropout_device_key {tag}: mismatches {miss}, next-key "
             f"fault {fault}")
    ms = device_ms([lambda c=c: K.dropout_fwd(c, keep_prob, kt,
                                              return_bits=True)
                    for c in copies])
    plain = device_ms([lambda c=c: kdo.dropout_plain(c, keep_prob, kt)
                       for c in copies])
    name = key.replace("dropout", "dropout_device_key")
    return name, err, ms, plain, tag


def report_device_key(main, kkey, bnd, lib):
    name, err, ms, plain, tag = kkey
    report(f"dropout_device_key {tag}", err, ms, plain, bnd, lib)
    main[name] = kernel_row(err, ms, plain, bnd, lib,
                            f"dropout_device_key {tag}")


def phase_dropout(K, gen, dev):
    """The threefry Dropout kernels at the training shapes, bf16: (16,
    256, 4096) after each FFN-input ReLU and (16, 256, 1024) on the
    embedding; the forward (values and keep bits) and the backward from
    those bits. Bit-exact with the plain versions, on random inputs and on
    x = ones (0 mismatches); the key's second word plus one must differ in
    the values and in the bits (planted faults). Yardsticks: ``F.dropout``
    (similar work, another mask) and ``aten.native_dropout_backward`` on a
    bool mask (the backward's same work, a mask byte an element)."""
    import torch.nn.functional as F

    kdo = importlib.import_module(KMOD + "dropout")
    main = {}
    keep_prob = 1.0 - DROPOUT_RATE
    other = (DROPOUT_KEY[0], DROPOUT_KEY[1] + 1)
    for shape, key in (((TRAIN_B, TRAIN_S, 4096), "dropout"),
                       ((TRAIN_B, TRAIN_S, 1024), "dropout@embedding")):
        dtype = torch.bfloat16
        elem = elem_size(dtype)
        numel = math.prod(shape)
        copies = [torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for _ in range(n_copies(2 * numel * elem))]
        x = copies[0]
        tag = f"bf16 {shape} keep_prob {keep_prob}"
        if not kdo.vector_path(numel, x):
            fail(f"dropout {tag}: not on the vector path")
        keep = kdo.keep_mask_plain(shape, keep_prob, DROPOUT_KEY, dev)
        out, bits = K.dropout_fwd(x, keep_prob, DROPOUT_KEY,
                                  return_bits=True)
        err_f = check_exact(f"dropout {tag}", out,
                            K.dropout_plain(x, keep_prob, DROPOUT_KEY))
        check_exact(f"dropout {tag} bits", bits,
                    kdo.pack_keep_bits_plain(keep))
        g = copies[-1]
        err_b = check_exact(f"dropout_bwd {tag}",
                            K.dropout_bwd(g, keep_prob, bits),
                            K.dropout_plain(g, keep_prob, DROPOUT_KEY))
        ones = torch.ones(shape, dtype=dtype, device=dev)
        got, got_bits = K.dropout_fwd(ones, keep_prob, DROPOUT_KEY,
                                      return_bits=True)
        miss = mismatches(got, K.dropout_plain(ones, keep_prob,
                                                DROPOUT_KEY))
        miss_b = mismatches(K.dropout_bwd(ones, keep_prob, got_bits),
                            K.dropout_plain(ones, keep_prob, DROPOUT_KEY))
        fault = mismatches(got, K.dropout_plain(ones, keep_prob, other))
        bad_bits = kdo.pack_keep_bits_plain(
            kdo.keep_mask_plain(shape, keep_prob, other, dev))
        fault_bits = mismatches(got_bits, bad_bits)
        fault_b = mismatches(K.dropout_bwd(ones, keep_prob, got_bits),
                             kdo.dropout_bwd_bits_plain(ones, bad_bits,
                                                        keep_prob))
        kept = (got != 0).float().mean().item()
        print(f"  dropout {tag}: x = ones, kernel vs plain mismatches fwd "
              f"{miss} bwd {miss_b}; against the next key: values {fault}, "
              f"mask bytes {fault_bits}, backward {fault_b}; kept "
              f"{kept:.5f}, kept value {got.max().item()}", flush=True)
        if miss or miss_b or not (fault and fault_bits and fault_b):
            fail(f"dropout {tag}: mask mismatches {miss}/{miss_b}, "
                 f"next-key faults {fault}/{fault_bits}/{fault_b}")
        del ones, got, got_bits, bad_bits, keep
        kkey = device_key_row(K, kdo, key, tag, copies, keep_prob, dtype,
                              dev, main)
        saved = [K.dropout_fwd(c, keep_prob, DROPOUT_KEY,
                               return_bits=True)[1] for c in copies]
        ms_f = device_ms([lambda c=c: K.dropout_fwd(
            c, keep_prob, DROPOUT_KEY, return_bits=True) for c in copies])
        plain_f = device_ms([lambda c=c: K.dropout_plain(c, keep_prob,
                                                          DROPOUT_KEY)
                             for c in copies])
        ms_b = device_ms([lambda c=c, b=b: K.dropout_bwd(c, keep_prob, b)
                          for c, b in zip(copies, saved)])
        plain_b = device_ms([
            lambda c=c, b=b: kdo.dropout_bwd_bits_plain(c, b, keep_prob)
            for c, b in zip(copies, saved)])
        lib_f = event_ms(lambda: F.dropout(x, DROPOUT_RATE), reps=20)
        masks = [torch.rand(shape, generator=gen, device=dev) < keep_prob
                 for _ in copies]
        lib_b = device_ms([
            lambda c=c, m=m: torch.ops.aten.native_dropout_backward(
                c, m, 1.0 / keep_prob) for c, m in zip(copies, masks)])
        del masks, saved
        bits_bytes = -(-numel // 8)
        bnd_f = bound_ms(2 * numel * elem + bits_bytes, 0, torch.float32,
                         THREEFRY_OPS * numel, THREEFRY_ALU_OPS * numel)
        bnd_b = bound_ms(2 * numel * elem + bits_bytes, numel,
                         torch.float32)
        report(f"dropout {tag}", err_f, ms_f, plain_f, bnd_f, lib_f)
        report(f"dropout_bwd {tag} (from the bits)", err_b, ms_b, plain_b,
               bnd_b, lib_b)
        bkey = key.replace("dropout", "dropout_bwd")
        print(f"  dropout_bwd {tag}: from the saved bits {ms_b:.5f} ms, "
              f"by regenerating the mask before this redesign "
              f"{EARLIER_MS[bkey][0]:.5f} ms", flush=True)
        main[key] = kernel_row(err_f, ms_f, plain_f, bnd_f, lib_f,
                               f"dropout {tag}")
        main[bkey] = kernel_row(err_b, ms_b, plain_b, bnd_b, lib_b,
                                f"dropout_bwd {tag}")
        report_device_key(main, kkey, bnd_f, lib_f)
        del copies
    print(f"  (dropout bounds: the forward's the largest of its bytes "
          f"(2 + 2 + 1/8 an element), {THREEFRY_OPS} integer instructions "
          f"an element at 128 lanes a clock an SM and {THREEFRY_ALU_OPS} "
          f"ALU-only ones at 64; the backward's its bytes. Library: "
          f"F.dropout, similar work with another mask, CUDA events around "
          f"eager calls; native_dropout_backward on a bool mask)",
          flush=True)
    return main


def phase_layer_norm_bwd(K, gen, dev):
    """LayerNorm backward at the training shape, rows 4096, n 1024, bf16
    and f32 (the vector path: a warp per row); then n = 1000 bf16, which
    takes the general path, and the general path forced at n = 1024 for
    the two designs side by side. dgamma and dbeta must be bitwise equal
    over two runs."""
    kln = importlib.import_module(KMOD + "layer_norm")
    rows = TRAIN_B * TRAIN_S
    main = {}
    cases = ((torch.bfloat16, 1024, None), (torch.float32, 1024, None),
             (torch.bfloat16, 1000, None), (torch.bfloat16, 1024, 0))
    for dtype, n, force in cases:
        elem = elem_size(dtype)
        copies = [(torch.randn((rows, n), generator=gen, device=dev)
                   .mul(2).add(0.5).to(dtype),
                   torch.randn((rows, n), generator=gen, device=dev)
                   .to(dtype))
                  for _ in range(n_copies(3 * rows * n * elem))]
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
        beta = 0.1 * torch.randn(n, generator=gen, device=dev)
        stats = [K.layer_norm_plain(x, gamma, beta, return_stats=True)[1:]
                 for x, _ in copies]
        (x, dy), (mean, rstd) = copies[0], stats[0]
        nv = kln.vectors_per_lane(n, dtype, x, dy, gamma)
        if force is not None:
            nv = force

        def bwd(c, st):
            return kln.launch_bwd(c[0], gamma, st[0], st[1], c[1], nv)

        path = f"vector path, {nv} vectors a lane" if nv else "general path"
        dx, dg, db = bwd(copies[0], stats[0])
        again = bwd(copies[0], stats[0])
        rdx, rdg, rdb = K.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
        torch.cuda.synchronize()
        name = f"layer_norm_bwd {str(dtype)[6:]} rows={rows} n={n}"
        if not (torch.equal(dg, again[1]) and torch.equal(db, again[2])):
            fail(f"{name}: dgamma/dbeta differ between two runs")
        err = max(check_scaled(f"{name} dx", dx, rdx,
                               1e-4 if dtype == torch.float32 else 2e-2),
                  check_scaled(f"{name} dgamma", dg, rdg, 1e-4),
                  check_scaled(f"{name} dbeta", db, rdb, 1e-4))
        ms = device_ms([lambda c=c, st=st: bwd(c, st)
                        for c, st in zip(copies, stats)])
        plain_ms = device_ms([lambda c=c, st=st: K.layer_norm_bwd_plain(
            c[0], gamma, st[0], st[1], c[1])
            for c, st in zip(copies, stats)])
        g_t, b_t = gamma.to(dtype), beta.to(dtype)
        lib_ms = device_ms([
            lambda c=c, st=st: torch.ops.aten.native_layer_norm_backward(
                c[1], c[0], [n], st[0][:, None], st[1][:, None], g_t, b_t,
                [True, True, True])
            for c, st in zip(copies, stats)])
        # read x, dO, gamma and the row statistics, write dx, dgamma,
        # dbeta; ~12 flops an element
        bnd = bound_ms(3 * rows * n * elem + 12 * n + 8 * rows,
                       12 * rows * n, torch.float32)
        report(f"{name} ({path})", err, ms, plain_ms, bnd, lib_ms)
        if dtype == torch.bfloat16 and n == 1024 and force is None:
            main["layer_norm_bwd"] = kernel_row(err, ms, plain_ms, bnd,
                                                lib_ms, name)
        del copies, stats
    print("  (layer_norm_bwd library: aten native_layer_norm_backward with "
          "gamma/beta in the input dtype; dgamma/dbeta bitwise equal over "
          "two runs on every path)", flush=True)
    return main


# (rows, vocab, dtypes, smoothings, key suffix of the JSON row): the causal
# LM's logits (4096, 32768) and ResNet-50's (batch 256, 1000 classes, f32
# after the fc, no smoothing)
XENT_CASES = ((TRAIN_B * TRAIN_S, 32768, (torch.bfloat16, torch.float32),
               (0.1, 0.0), ""),
              (256, 1000, (torch.float32,), (0.0,), "@resnet"))


def phase_softmax_xent(K, gen, dev):
    """Softmax cross-entropy forward and backward at the training shapes
    of ``XENT_CASES``."""
    main = {}
    for rows, vocab, dtypes, smoothings, suffix in XENT_CASES:
        main.update(xent_case(K, gen, dev, rows, vocab, dtypes, smoothings,
                              suffix))
    print("  (xent library: F.cross_entropy with label_smoothing=0, a "
          "different smoothing convention; bwd = its forward + backward)",
          flush=True)
    return main


def xent_case(K, gen, dev, rows, vocab, dtypes, smoothings, suffix):
    import torch.nn.functional as F

    main = {}
    labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels_l = labels.long()
    g = torch.rand(rows, generator=gen, device=dev)
    for dtype in dtypes:
        f32 = dtype == torch.float32
        elem = elem_size(dtype)
        copies = [(3.0 * torch.randn((rows, vocab), generator=gen,
                                     device=dev)).to(dtype)
                  for _ in range(n_copies(rows * vocab * elem))]
        for smoothing in smoothings:
            x = copies[0]
            loss, lse = K.softmax_xent_fwd(x, labels, smoothing=smoothing)
            rloss, rlse = K.softmax_xent_fwd_plain(x, labels,
                                                   smoothing=smoothing)
            dx = K.softmax_xent_bwd(x, labels, rlse, g, smoothing=smoothing)
            rdx = K.softmax_xent_bwd_plain(x, labels, rlse, g,
                                           smoothing=smoothing)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} rows={rows} V={vocab} ls={smoothing}"
            err_f = max(check_scaled(f"xent loss {tag}", loss, rloss, 1e-5),
                        check_scaled(f"xent lse {tag}", lse, rlse, 1e-5))
            tol_b = 1e-5 if f32 else 1e-2
            err_b = check_elementwise(f"xent dx {tag}", dx, rdx, tol_b)
            if smoothing > 0:
                check_xent_bwd_faults(x, labels, rlse, g, rdx, smoothing,
                                      tol_b, tag)
            del dx, rdx
            lses = [K.softmax_xent_fwd_plain(c, labels,
                                             smoothing=smoothing)[1]
                    for c in copies]
            ms_f = device_ms([lambda c=c: K.softmax_xent_fwd(
                c, labels, smoothing=smoothing) for c in copies])
            plain_f = device_ms([lambda c=c: K.softmax_xent_fwd_plain(
                c, labels, smoothing=smoothing) for c in copies])
            ms_b = device_ms([lambda c=c, ls=ls: K.softmax_xent_bwd(
                c, labels, ls, g, smoothing=smoothing)
                for c, ls in zip(copies, lses)])
            plain_b = device_ms([lambda c=c, ls=ls: K.softmax_xent_bwd_plain(
                c, labels, ls, g, smoothing=smoothing)
                for c, ls in zip(copies, lses)])
            # yardstick: F.cross_entropy WITHOUT smoothing (PyTorch's
            # smoothing convention is another function), forward, and
            # forward + backward
            lib_f = device_ms([lambda c=c: F.cross_entropy(
                c, labels_l, reduction="none") for c in copies])
            xg = x.detach().requires_grad_()
            lib_fb = event_ms(lambda: torch.autograd.grad(
                F.cross_entropy(xg, labels_l, reduction="none"), xg, g))
            bnd_f = bound_ms(rows * vocab * elem + 12 * rows,
                             5 * rows * vocab, torch.float32)
            bnd_b = bound_ms(2 * rows * vocab * elem + 12 * rows,
                             4 * rows * vocab, torch.float32)
            report(f"softmax_xent_fwd {tag}", err_f, ms_f, plain_f, bnd_f,
                   lib_f)
            report(f"softmax_xent_bwd {tag}", err_b, ms_b, plain_b, bnd_b,
                   lib_fb)
            if suffix or (not f32 and smoothing > 0):
                main["softmax_xent_fwd" + suffix] = kernel_row(
                    err_f, ms_f, plain_f, bnd_f, lib_f,
                    f"softmax_xent_fwd {tag}")
                main["softmax_xent_bwd" + suffix] = kernel_row(
                    err_b, ms_b, plain_b, bnd_b, lib_fb,
                    f"softmax_xent_bwd {tag}")
            del xg
        del copies
    return main


def check_xent_bwd_faults(x, labels, lse, g, rdx, smoothing, tol, tag):
    """The dx check above must fail a backward that leaves out the
    smoothing mass ``low * g`` of every non-label column, and (at f32,
    where the values resolve it) one that scales ``p`` by 1.001: both
    faults built from the plain version on this phase's inputs."""
    low = smoothing / (x.shape[-1] - 1)
    gl = low * g
    faults = {"no low": rdx.float() + gl[:, None]}
    faults["no low"].scatter_add_(1, labels.long()[:, None], -gl[:, None])
    if x.dtype == torch.float32:
        p = torch.exp(x.float() - lse[:, None])
        faults["p x 1.001"] = rdx.float() + 1e-3 * p * g[:, None]
        del p
    readings = []
    for fault, dx in faults.items():
        ratio, err = elementwise_ratio(dx.to(x.dtype), rdx, tol)
        if not ratio > 1.0:
            fail(f"xent dx {tag}: the check passes a planted fault "
                 f"({fault}: max abs err {err:.3e}, {ratio:.3e} of the "
                 f"bound)")
        readings.append(f"{fault} at {ratio:.3e}x its bound")
    print(f"  xent dx {tag}: the check fails planted faults: "
          f"{', '.join(readings)}", flush=True)


def adam_group_sizes(cfg):
    """Elements of the (f32, f32) and (bf16, f32) Adam groups of the
    causal LM under bf16 compute: the embedding and LayerNorm parameters,
    and the Dense kernels and biases."""
    from simple_tensorflow_tpu_torch import convert

    sizes = [0, 0]
    for name, shape in convert._shapes(cfg).items():
        dense = name.endswith((".kernel", ".bias"))
        sizes[int(dense)] += math.prod(shape)
    return sizes


def phase_adam(K, gen, dev, cfg):
    """Fused Adam over the two flat groups of the bf16 training path: f32
    parameters (embedding, LayerNorm) and bf16 parameters (Dense), f32
    slots. Bit-exact with the plain version."""
    main = {}
    kw = dict(beta1=0.9, beta2=0.997, eps=1e-9)
    alpha = torch.tensor(1e-3, device=dev)
    for dtype, n in zip((torch.float32, torch.bfloat16),
                        adam_group_sizes(cfg)):
        p = torch.randn(n, generator=gen, device=dev).to(dtype)
        m = 0.1 * torch.randn(n, generator=gen, device=dev)
        v = 0.01 * torch.rand(n, generator=gen, device=dev)
        g = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
        ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                                  **kw)
        torch.cuda.synchronize()
        name = f"adam_update {str(dtype)[6:]} params n={n}"
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name}: kernel is not bit-exact with its plain version")
        del got, ref
        err = 0.0
        ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
        plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                          **kw)])
        pt = torch.nn.Parameter(p.clone())
        pt.grad = g.clone()
        opt = torch.optim.Adam([pt], lr=1e-3, betas=(0.9, 0.997), eps=1e-9,
                               fused=True)
        lib_ms = event_ms(opt.step)
        pe = elem_size(dtype)
        # read p, g, m, v; write p, m, v; ~12 flops an element
        bnd = bound_ms(n * (3 * pe + 16), 12 * n, torch.float32)
        report(name, err, ms, plain_ms, bnd, lib_ms)
        if dtype == torch.bfloat16:
            main["adam_update"] = kernel_row(err, ms, plain_ms, bnd, lib_ms,
                                             name)
        del p, m, v, g, pt, opt
    print("  (adam library: torch.optim.Adam(fused=True).step, whose slots "
          "take the parameter's dtype)", flush=True)
    return main


def resnet_group_sizes():
    """Elements of ResNet-50's two Momentum groups under bf16: the conv
    kernels (bf16 parameters) and BatchNorm gamma/beta with the fc (f32)."""
    from simple_tensorflow_tpu_torch.models import resnet

    model = resnet.ResNet(50, 1000, device="meta")
    sizes = [0, 0]
    for p in model.parameters():
        sizes[int(p.dim() != 4)] += p.numel()
    return sizes


MOMENTUM_LR, MOMENTUM_MU = 0.1, 0.9           # resnet50_train_model's recipe


def phase_momentum(K, gen, dev):
    """Fused Momentum over the two flat groups of the ResNet-50 path:
    bf16 parameters (the conv kernels) and f32 parameters (BatchNorm and
    fc), f32 accumulators, plain and Nesterov, from non-zero accumulators
    (a step from zero never reads ``mu``). Bit-exact with the plain
    version (0 mismatches in p and acc); two planted faults, ``mu`` one
    ulp larger and the Nesterov flag flipped, must each differ."""
    main = {}
    lr = torch.tensor(MOMENTUM_LR, device=dev)
    mu = torch.tensor(MOMENTUM_MU, device=dev)
    mu_off = torch.nextafter(mu, torch.tensor(1.0, device=dev))
    for dtype, n in zip((torch.bfloat16, torch.float32),
                        resnet_group_sizes()):
        p = torch.randn(n, generator=gen, device=dev).to(dtype)
        acc = 0.5 * torch.randn(n, generator=gen, device=dev)
        g = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        pe = elem_size(dtype)
        for nesterov in (False, True):
            # the timed launches update copies in place: repeated steps
            # with one g drive acc to g / (1 - mu), where Nesterov and
            # plain Momentum take the same step, so the checks below
            # always see the fresh inputs
            name = (f"momentum_update {str(dtype)[6:]} params n={n}"
                    f"{' nesterov' if nesterov else ''}")
            got = K.momentum_update(p.clone(), acc.clone(), g, lr, mu,
                                    use_nesterov=nesterov)
            ref = K.momentum_update_plain(p.clone(), acc.clone(), g, lr, mu,
                                          use_nesterov=nesterov)
            torch.cuda.synchronize()
            miss = [mismatches(a, b) for a, b in zip(got, ref)]
            faults = {
                "mu + 1 ulp": K.momentum_update_plain(
                    p.clone(), acc.clone(), g, lr, mu_off,
                    use_nesterov=nesterov),
                "nesterov flipped": K.momentum_update_plain(
                    p.clone(), acc.clone(), g, lr, mu,
                    use_nesterov=not nesterov)}
            seen = {f: [mismatches(a, b) for a, b in zip(got, bad)]
                    for f, bad in faults.items()}
            print(f"  {name}: kernel vs plain mismatches p {miss[0]} acc "
                  f"{miss[1]}; planted faults (p, acc) {seen}", flush=True)
            if any(miss):
                fail(f"{name}: kernel is not bit-exact with its plain "
                     f"version ({miss} elements of p, acc differ)")
            missed = [f for f, m in seen.items() if not any(m)]
            if missed:
                fail(f"{name}: the check passes planted faults {missed}")
            del got, ref, faults
            # copies past the L2 (the f32 group's 42 MB fits in it), read
            # cold as the step after a backward reads them
            copies = [(p.clone(), acc.clone(), g.clone()) for _ in
                      range(n_copies(n * (3 * pe + 8)))]
            ms = device_ms([lambda c=c: K.momentum_update(
                *c, lr, mu, use_nesterov=nesterov) for c in copies])
            plain_ms = device_ms([lambda c=c: K.momentum_update_plain(
                *c, lr, mu, use_nesterov=nesterov) for c in copies])
            del copies
            pt = torch.nn.Parameter(p.clone())
            pt.grad = g.clone()
            opt = torch.optim.SGD([pt], lr=MOMENTUM_LR,
                                  momentum=MOMENTUM_MU, nesterov=nesterov,
                                  fused=True)
            lib_ms = event_ms(opt.step)
            # read p, g, acc; write p, acc; mu * acc + g, lr * acc and the
            # subtraction (Nesterov: two more) an element
            bnd = bound_ms(n * (3 * pe + 8), (6 if nesterov else 4) * n,
                           torch.float32)
            report(name, 0.0, ms, plain_ms, bnd, lib_ms)
            if dtype == torch.bfloat16 and not nesterov:
                main["momentum_update"] = kernel_row(0.0, ms, plain_ms, bnd,
                                                     lib_ms, name)
            del pt, opt
        del p, acc, g
    print("  (momentum library: torch.optim.SGD(momentum=0.9, fused=True)"
          ".step, whose buffer takes the parameter's dtype: bf16 for the "
          "bf16 group)", flush=True)
    return main


# -- serving phase -------------------------------------------------------------

PROMPT_LENS = (17, 23, 96, 31, 40, 48, 55, 63, 70, 77, 85, 90)
SHARED_AT = (2, 4, 7, 9)         # these four start with the same 32 tokens
# request 9 is the head of request 2: its cached tail is a proper prefix
# of one of request 2's pages, so admission builds it by copy-on-write
PREFIX_OF = {9: 2}
MAX_NEW = 24
# the traced decode window: this many requests (bucket 16) of TRACE_PROMPT
# tokens and TRACE_NEW new ones (slack for the profiler's start while the
# engine steps on), traced over TRACE_STEPS engine steps
TRACE_REQUESTS, TRACE_PROMPT, TRACE_NEW, TRACE_STEPS = 16, 20, 96, 16


def make_prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(2, vocab, 32))
    prompts = []
    for i, n in enumerate(PROMPT_LENS):
        if i in PREFIX_OF:
            prompts.append(prompts[PREFIX_OF[i]][:n])
            continue
        head = shared if i in SHARED_AT else []
        prompts.append(head + list(rng.randint(2, vocab, n - len(head))))
    return prompts


def check_stream(model, prompt, result, int8):
    """Teacher-forced check of one request against the plain re-forward
    on the card: every emitted token is an argmax of the plain logits
    within rel 1e-4 of the largest |logit|, and its log-prob is within
    1e-3 of the plain one. With the int8 head, one activation element
    that rounds the other way (the hidden states differ by f32 round-off)
    moves a logit by up to x_scale * max|w_scale * wq|, so each bound
    also takes twice that step."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.ops import kernels as K

    toks = [int(t) for t in result["tokens"]]
    seq = list(prompt) + toks
    ids = torch.tensor([seq[:-1]], dtype=torch.long, device=model.device)
    h = clm.causal_lm_hidden_plain(model.stack, ids)[0, len(prompt) - 1:]
    if int8:
        logits = K.quant_matmul_plain(h, model.wq, model.w_scale).float()
        _, xs = K.quantize_rowwise_plain(h)
        wmax = (model.w_scale[None, :] * model.wq.abs().float()).max()
        extra = 2.0 * xs * wmax
    else:
        logits = torch.matmul(h, model.stack.shared_embedding.t()).float()
        extra = torch.zeros(len(toks), device=h.device)
    tok_t = torch.tensor(toks, dtype=torch.long, device=h.device)
    chosen = logits.gather(1, tok_t[:, None])[:, 0]
    top = logits.max(dim=1).values
    arg_tol = 1e-4 * logits.abs().max(dim=1).values + extra
    logp_ref = torch.log_softmax(logits, dim=1).gather(
        1, tok_t[:, None])[:, 0]
    logp = torch.from_numpy(np.asarray(result["logprobs"],
                                       np.float32)).to(h.device)
    lp_err = (logp - logp_ref).abs()
    bad_arg = (chosen < top - arg_tol).nonzero().flatten().tolist()
    bad_lp = (lp_err > 1e-3 + extra).nonzero().flatten().tolist()
    if bad_arg or bad_lp:
        fail(f"token stream disagrees with the plain re-forward "
             f"(int8={int8}): not argmax at steps {bad_arg}, logp off at "
             f"steps {bad_lp} (max logp err {lp_err.max().item():.3e})")
    return lp_err.max().item()


def wait_for(cond, what, timeout=120.0):
    t_end = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > t_end:
            fail(f"timed out waiting for {what}")
        time.sleep(0.0005)


def trace_window(eng, vocab, seed):
    """One traced window (``trace_decode``): ``(device_times, engine
    steps, host step seconds)``. The profiler starts and stops only while
    the engine thread is parked in a token callback, between two steps:
    stopping it while that thread launched a CUDA graph deadlocked the
    two (the profiler's flush and the graph launch)."""
    from torch.profiler import ProfilerActivity, profile

    gate, parked = threading.Event(), threading.Event()
    gate.set()

    def park(tok, lp):
        if not gate.is_set():
            parked.set()
            gate.wait()

    def pause():
        parked.clear()
        gate.clear()
        if not parked.wait(120):
            fail("the engine did not reach a token callback")

    rng = np.random.RandomState(seed)
    futs = [eng.generate(list(rng.randint(2, vocab, TRACE_PROMPT)),
                         max_new_tokens=TRACE_NEW, on_token=park)
            for _ in range(TRACE_REQUESTS)]
    wait_for(lambda: eng.metrics.slots_active == TRACE_REQUESTS,
             "the traced requests to start decoding")
    s0 = eng.metrics.steps
    wait_for(lambda: eng.metrics.steps > s0, "a decode step")
    pause()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s1, n0 = eng.metrics.steps, len(eng.metrics.step_seconds)
            gate.set()
            wait_for(lambda: eng.metrics.steps >= s1 + TRACE_STEPS,
                     "the traced decode steps")
            pause()
            steps = eng.metrics.steps - s1
            host = list(eng.metrics.step_seconds)[n0:]
    finally:
        gate.set()
    for f in futs:
        f.result(timeout=600)
    return device_times(prof), steps, host


def trace_decode(eng, vocab, head, need, attempts=3):
    """Device time a decode step of the engine at bucket 16: once
    ``TRACE_REQUESTS`` fresh requests are all decoding, a
    ``torch.profiler`` window (CUDA activity, which CUPTI records for the
    engine's thread too) spans at least ``TRACE_STEPS`` engine steps,
    counted by the engine; the window opens and closes while the engine
    is parked between two steps (``trace_window``), so it holds exactly
    those steps; device ms a step is the trace's device time over them. A window whose trace
    kept fewer kernel launches than steps lost its kernel records (seen
    once in five windows: only the copies were traced) and is taken again
    with fresh requests, up to ``attempts`` windows. Prints the device ms
    a step beside the host p50 step of the same window and the top
    kernels; fails when a kernel named in ``need`` is not in the trace.
    The engine runs as it does without the trace but for the two parks,
    which fall outside its steps' timed spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # set the tracer up
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    tag = f"serving[{head}] trace"
    for attempt in range(attempts):
        by_name, steps, host = trace_window(eng, vocab, 5 + attempt)
        launches = sum(k for nm, (_, k) in by_name.items()
                       if not nm.startswith(("Memcpy", "Memset")))
        if launches >= steps:
            break
        print(f"{tag}: window {attempt + 1} kept {launches} kernel "
              f"launches in {steps} steps (records lost); tracing again",
              flush=True)
    else:
        print(f"{tag}: every window lost its kernel records; device ms a "
              f"decode step not measured", flush=True)
        return None
    check_traced(tag, by_name, need)
    dev_ms = sum(ms for ms, _ in by_name.values()) / steps
    p50 = statistics.median(host) * 1e3
    print(f"{tag}: {steps} decode steps at bucket {TRACE_REQUESTS} "
          f"traced, device {dev_ms:.4f} ms a step beside a host p50 step "
          f"of {p50:.4f} ms in the same window ({100 * dev_ms / p50:.1f}% "
          f"busy)", flush=True)
    for nm, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ms / steps:9.4f} ms/step  {k / steps:5.2f} launches/step"
              f"  {nm[:100]}", flush=True)
    return dev_ms, p50


def serve(params, cfg, int8, prompts, dev, need, aot=True):
    """Serve ``prompts`` through ``GenerativeEngine`` at the model's
    published width, the decode and prefill buckets captured as CUDA
    graphs (``aot_warmup``) or, with ``aot`` False, dispatched eagerly.
    Returns the run's launches and its numbers: tokens/s, p50 decode
    step, p50 time to first token, device ms a decode step at bucket 16
    and the host p50 step of that traced window."""
    from simple_tensorflow_tpu_torch import serving
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.ops import kernels as K

    head = ("int8" if int8 else "f32") + ("" if aot else " eager")
    t_build = time.perf_counter()
    model = clm.CausalLMGenerativeModel(
        cfg, page_len=16, pages_per_seq=16, num_pages=256, max_live=16,
        decode_bucket_sizes=[1, 4, 16], prefill_bucket_sizes=[1, 4],
        int8=int8, params=params, aot_warmup=aot, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t_build
    policy = serving.DecodePolicy(num_slots=16, max_decode_len=256,
                                  bucket_sizes=[1, 4, 16],
                                  max_new_tokens=MAX_NEW)
    with serving.GenerativeEngine(f"smoke_{head}", model, policy) as eng:
        # warm-up: one unrelated request (library loads, cuBLAS handles)
        eng.generate(list(range(2, 20)), max_new_tokens=2).result(600)
        torch.cuda.synchronize()
        steps0 = eng.metrics.steps
        samples0 = len(eng.metrics.step_seconds)
        pc0 = eng.statusz_info()["prefix_cache"]
        hits0 = pc0["hit_pages"] + pc0["cow_hits"]
        first = [None] * len(prompts)

        def on_token(i):
            def cb(tok, lp):
                if first[i] is None:
                    first[i] = time.perf_counter()
            return cb

        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [eng.generate(p, max_new_tokens=MAX_NEW, on_token=on_token(i))
                for i, p in enumerate(prompts)]
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        steps = eng.metrics.steps - steps0
        step_s = list(eng.metrics.step_seconds)[samples0:]
        pc = eng.statusz_info()["prefix_cache"]
        hits = pc["hit_pages"] + pc["cow_hits"] - hits0
        traced = trace_decode(eng, cfg.vocab_size, head, need)
    ttft = statistics.median(f - t0 for f in first if f is not None) * 1e3
    emitted = sum(len(r["tokens"]) for r in results)
    p50 = statistics.median(step_s) * 1e3
    print(f"serving[{head}]: {len(results)} requests, {emitted} tokens in "
          f"{wall:.4f} s = {emitted / wall:.2f} tokens/s, {steps} decode "
          f"steps, p50 decode step {p50:.4f} ms, p50 time to first token "
          f"{ttft:.4f} ms (the 12 requests submitted together), "
          f"prefix-cache hit pages {hits} (cow {pc['cow_hits']}), outcomes "
          f"{sorted({r['outcome'] for r in results})}; model built "
          f"{'with its bucket graphs captured ' if aot else ''}in "
          f"{t_build:.3f} s", flush=True)
    print(f"serving[{head}]: launches {counts}", flush=True)
    need = ["decode_attention", "decode_attention_block", "layer_norm"]
    if int8:
        need.append("quant_matmul")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        fail(f"serving[{head}]: kernels {missing} were not launched")
    # per decode step: one DecodeAttention and two LayerNorms per layer
    # (and one QuantMatMul with the int8 head); per prefill chunk: one
    # block DecodeAttention and two LayerNorms per layer
    n_layers = cfg.num_layers
    if counts["decode_attention"] != n_layers * steps or \
            counts["layer_norm"] != 2 * (counts["decode_attention"]
                                         + counts["decode_attention_block"]) \
            or counts["quant_matmul"] != (steps if int8 else 0):
        fail(f"serving[{head}]: launch counts {counts} do not match "
             f"{steps} decode steps of {n_layers} layers")
    if hits == 0:
        fail(f"serving[{head}]: no prefix-cache hit")
    worst = 0.0
    for p, r in zip(prompts, results):
        if r["outcome"] not in ("eos", "length") or not len(r["tokens"]):
            fail(f"serving[{head}]: bad result {r}")
        if not np.all(np.isfinite(r["logprobs"])):
            fail(f"serving[{head}]: non-finite log-probs")
        err = check_stream(model, p, r, int8)
        worst = max(worst, err)
    print(f"serving[{head}]: every token matches the plain re-forward "
          f"(max logp err {worst:.3e})", flush=True)
    return counts, {"tokens_s": emitted / wall, "p50_ms": p50,
                    "ttft_ms": ttft, "traced": traced}


# the fixed call script of check_serving_graphs: decode batch sizes (rows
# 0 .. n-1), every bucket, partial buckets, and a small batch replayed
# right after a larger one in the same bucket
GRAPH_DECODE_ROWS = (16, 3, 1, 9, 4, 2, 16, 1, 3)


def check_serving_graphs(params, cfg, dev):
    """The serving model with ``aot_warmup=True`` against ``False`` at the
    published width, both heads, on one fixed script of calls: prefill of
    16 sequences' first page (four bucket-4 replays), five sequences'
    second page (buckets 4 and 1), then decode steps of
    ``GRAPH_DECODE_ROWS`` rows. Tokens int-exact and log-probs
    bit-identical at every step."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    rng = np.random.RandomState(3)
    n, pl = 16, 16
    chunks = rng.randint(2, cfg.vocab_size, (n, 2, pl)).astype(np.int32)
    for int8 in (False, True):
        got = {}
        for aot in (True, False):
            model = clm.CausalLMGenerativeModel(
                cfg, page_len=pl, pages_per_seq=16, num_pages=256,
                max_live=16, decode_bucket_sizes=[1, 4, 16],
                prefill_bucket_sizes=[1, 4], int8=int8, params=params,
                aot_warmup=aot, device=dev)
            tables = np.full((n, 16), model.scratch_page, np.int32)
            tables[:, :3] = np.arange(3 * n).reshape(n, 3)
            model.prefill_chunk(chunks[:, 0], np.zeros(n, np.int32), tables,
                                tables[:, 0])
            model.prefill_chunk(chunks[:5, 1], np.full(5, pl, np.int32),
                                tables[:5], tables[:5, 1])
            pos = np.where(np.arange(n) < 5, 2 * pl, pl).astype(np.int32)
            last = np.where(np.arange(n) < 5, chunks[:, 1, -1],
                            chunks[:, 0, -1]).astype(np.int32)
            outs = []
            for rows in GRAPH_DECODE_ROWS:
                tok, lp, _ = model.decode(last[:rows], pos[:rows],
                                          tables[:rows])
                outs.append((tok.copy(), lp.copy()))
                last[:rows], pos[:rows] = tok, pos[:rows] + 1
            got[aot] = outs
            model.close()
            del model
        tok_eq = all(np.array_equal(a[0], b[0])
                     for a, b in zip(got[True], got[False]))
        lp_eq = all(np.array_equal(a[1], b[1])
                    for a, b in zip(got[True], got[False]))
        rel = max(float(np.max(np.abs(a[1] - b[1])
                               / np.maximum(np.abs(b[1]), 1e-30)))
                  for a, b in zip(got[True], got[False]))
        head = "int8" if int8 else "f32"
        print(f"serving graphs[{head}]: aot_warmup True vs False over "
              f"{len(GRAPH_DECODE_ROWS)} decode steps of {GRAPH_DECODE_ROWS}"
              f" rows after 6 prefill replays: tokens identical {tok_eq}, "
              f"log-probs bit-identical {lp_eq} (max relative difference "
              f"{rel:.3e})", flush=True)
        if not (tok_eq and lp_eq):
            fail(f"serving graphs[{head}]: the captured buckets are off the "
                 f"eager ones")


# -- training phase ------------------------------------------------------------

TRAIN_STEPS = 16
# a warm-up this long keeps the learning rate (1.2e-4 at step 16) below
# the point where Adam overshoots on one repeated batch: with 16 the loss
# stalled after five steps (at dropout 0)
TRAIN_WARMUP = 256
# the bf16 window's loss check compares the means of its first and last
# this many steps: with dropout, each step draws other masks, so the loss
# on the repeated batch is noisy from step to step
LOSS_MEAN_OF = 4


def per_step(cfg):
    """Launches of one training step: per layer one flash attention (fwd,
    dK/dV, dQ) and two LayerNorms (fwd, bwd); one xent (fwd, bwd); with
    dropout, per layer one dropout-residual (fwd, bwd) and one FFN
    Dropout, and one embedding Dropout (fwd, bwd). Adam is counted apart
    (one launch per flat group)."""
    n = cfg.num_layers
    want = {"flash_attention_fwd": n, "flash_attention_dkdv": n,
            "flash_attention_dq": n, "layer_norm": 2 * n,
            "layer_norm_bwd": 2 * n, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}
    if cfg.dropout > 0:
        want.update(dropout_residual=n, dropout_residual_bwd=n,
                    dropout=n + 1, dropout_bwd=n + 1)
    return want


def expected_counts(names, steps, adam_groups, cfg):
    want = {k: 0 for k in names}
    for k, v in per_step(cfg).items():
        want[k] = v * steps
    want["adam_update"] = adam_groups * steps
    return want


def train_batch(vocab, seed=7):
    """One LM batch: random tokens, targets shifted by one, the last
    target of every row the pad id (weight 0)."""
    rng = np.random.RandomState(seed)
    tok_in = rng.randint(2, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    tok_out = np.roll(tok_in, -1, axis=1)
    tok_out[:, -1] = 0
    return tok_in, tok_out


def grad_rel_errs(a, b):
    """{parameter: relative norm error of a's gradient against b's}, the
    attention key biases apart (their exact gradient is zero: a softmax
    does not change when the same q . b_k is added to every score of a
    row, so both sides hold roundoff only)."""
    grads_b = dict(b.stack.named_parameters())
    out = {}
    for name, pa in a.stack.named_parameters():
        if not name.endswith("self_attn.k.bias"):
            ga, gb = pa.grad.float(), grads_b[name].grad.float()
            out[name] = ((ga - gb).norm() / gb.norm()).item()
    return out


def relu_recording(trainer, signs=None, masks=None):
    """Swap each layer's FFN-input ReLU for one that appends its
    pre-activation's sign mask to ``signs``; with ``masks`` (one per
    layer), gate by those masks instead of the pre-activation's own
    signs."""
    for i, layer in enumerate(trainer.stack.layers):
        def act(y, i=i):
            if signs is not None:
                signs.append(y.detach() > 0)
            if masks is not None:
                return y * masks[i].to(y.dtype)
            return torch.relu(y)
        layer.ffn["in"].activation = act


@contextlib.contextmanager
def planted(module, name, wrap):
    """Within the block, ``module.name`` is ``wrap(module.name)``."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


# kernels vs plain, each run with its own ReLU gates: the few gates that
# flip on f32 roundoff carry their whole gradient row into the error. On an
# H100 80GB HBM3 at 700 W dropout 0 reads 5.194e-4 (a few flips per layer)
# and dropout 0.1 reads 1.170e-3 (two flips in layer 1, its activations
# scaled by 1 / 0.9), so that rate takes 2e-3. The limit that planted
# faults must fail is the shared-mask one, the same at both rates.
F32_GRAD_TOL = {0.0: 1e-3, DROPOUT_RATE: 2e-3}
F32_SHARED_TOL = 1e-4        # kernels vs plain, the plain run's ReLU mask


def check_f32_step(K, cfg, params, batch, dev):
    """One f32 step through the kernels against the same step through
    the plain versions, both on the card: the loss, and every parameter's
    gradient by relative norm. Three more readings explain and test the
    gradient limit: the FFN-input units whose ReLU gate differs between
    the two runs; the kernel step again with the plain run's ReLU masks,
    held to the tighter ``F32_SHARED_TOL``; and two planted faults under
    those shared masks (dQ scaled by 1.001, the xent backward without
    smoothing), each of which must fail that limit. A second plain step
    gives the floor: the plain step is deterministic on the card. With
    ``cfg.dropout > 0`` every trainer starts at the same RNG counter, so
    each run draws the same dropout masks. Returns the kernel run's
    launches."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    # the modules (the package re-exports functions under their names)
    flash_attention = importlib.import_module(KMOD + "flash_attention")
    softmax_xent = importlib.import_module(KMOD + "softmax_xent")

    def run(plain=False, signs=None, masks=None):
        t = clm.causal_lm_train_model(
            TRAIN_B, TRAIN_S, cfg, compute_dtype=torch.float32,
            params=params, device=dev, plain=plain)
        relu_recording(t, signs, masks)
        return t, t.step(*batch).item()

    tag = f"train[f32 dropout {cfg.dropout}]"
    grad_tol = F32_GRAD_TOL[cfg.dropout]
    signs_p, signs_k = [], []
    tp, loss_p = run(plain=True, signs=signs_p)
    before = K.launch_counts()
    tp2, _ = run(plain=True)
    floor = max(grad_rel_errs(tp2, tp).values())
    del tp2
    if K.launch_counts() != before:
        fail(f"{tag}: the plain step launched kernels")
    K.reset_launch_counts()
    tk, loss_k = run(signs=signs_k)
    counts = K.launch_counts()
    want = expected_counts(counts, 1, 1, cfg)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected per step {want}")
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        fail(f"{tag}: loss {loss_k} through the kernels, {loss_p} "
             f"through the plain versions")
    grads_p = dict(tp.stack.named_parameters())
    for name, pk in tk.stack.named_parameters():
        if name.endswith("self_attn.k.bias"):
            scale = grads_p[name[:-4] + "kernel"].grad.float().norm().item()
            for g in (pk.grad, grads_p[name].grad):
                if g.float().norm().item() > 1e-5 * scale:
                    fail(f"{tag}: {name} gradient is not roundoff")
    errs = grad_rel_errs(tk, tp)
    del tk
    flips = [int((a != b).sum().item()) for a, b in zip(signs_k, signs_p)]
    tm, _ = run(masks=signs_p)
    shared = grad_rel_errs(tm, tp)
    del tm
    faults = {}
    for fault, module, name, wrap in (
            ("dq x 1.001", flash_attention, "flash_attention_dq",
             lambda f: lambda *a, **k: f(*a, **k) * 1.001),
            ("xent bwd without smoothing", softmax_xent, "softmax_xent_bwd",
             lambda f: lambda *a, **k: f(*a, **dict(k, smoothing=0.0)))):
        with planted(module, name, wrap):
            tf, _ = run(masks=signs_p)
        faults[fault] = max(grad_rel_errs(tf, tp).values())
        del tf
    del tp

    def worst(e, n=3):
        return [(k, f"{v:.3e}") for k, v in
                sorted(e.items(), key=lambda kv: -kv[1])[:n]]

    units = signs_p[0].numel()
    print(f"{tag}: loss {loss_k:.7f} (kernels) vs {loss_p:.7f} "
          f"(plain); launches {counts}", flush=True)
    print(f"{tag}: gradient rel err, worst: {worst(errs)} (limit "
          f"{grad_tol}); plain vs plain worst {floor:.3e}", flush=True)
    print(f"{tag}: FFN-input ReLU gates that differ, kernels vs plain, "
          f"per layer (of {units}): {flips}", flush=True)
    print(f"{tag}: with the plain run's ReLU masks shared, gradient "
          f"rel err, worst: {worst(shared)} (limit {F32_SHARED_TOL})",
          flush=True)
    print(f"{tag}: planted faults, shared masks, worst gradient rel "
          f"err: {', '.join(f'{k} {v:.3e}' for k, v in faults.items())}",
          flush=True)
    bad = {n: e for n, e in errs.items() if not e <= grad_tol}
    if bad:
        fail(f"{tag}: gradient rel err above {grad_tol}: {bad}")
    bad = {n: e for n, e in shared.items() if not e <= F32_SHARED_TOL}
    if bad:
        fail(f"{tag}: with shared ReLU masks, gradient rel err above "
             f"{F32_SHARED_TOL}: {bad}")
    missed = [k for k, v in faults.items() if not v > F32_SHARED_TOL]
    if missed:
        fail(f"{tag}: the shared-mask limit passes planted faults "
             f"{missed}: {faults}")
    return counts


def key_derivation_us(trainer, reps=20):
    """Host microseconds a step to derive its dropout keys and seeds, as
    the trainer does: one :meth:`StepRNG.for_steps` pass over a block of
    ``RNG_BLOCK`` steps, divided by the block; the median of ``reps``
    blocks."""
    from simple_tensorflow_tpu_torch.framework.random_seed import StepRNG
    from simple_tensorflow_tpu_torch.models.causal_lm import RNG_BLOCK

    times = []
    for i in range(reps):
        block = range(i * RNG_BLOCK + 1, (i + 1) * RNG_BLOCK + 1)
        t0 = time.perf_counter()
        StepRNG.for_steps(block, trainer._key_sites, trainer._seed_sites)
        times.append((time.perf_counter() - t0) / RNG_BLOCK)
    return statistics.median(times) * 1e6


def train_phase(K, cfg, params, dev, kernel_rows):
    """The training main paths (module docstring, phase 4). Returns
    ``[(path, dropout, launches)]``: the two f32 kernel steps and the two
    bf16 windows, each counted from zero just before it."""
    batch = train_batch(cfg.vocab_size)
    paths = []
    for rate in (0.0, cfg.dropout):
        cfg_f32 = dataclasses.replace(cfg, dropout=rate)
        paths.append((f"train f32 dropout {rate}", rate,
                      check_f32_step(K, cfg_f32, params, batch, dev)))
        torch.cuda.empty_cache()

    # the shipped config's window and, interleaved step by step in the
    # same call, the same window at dropout 0: the cost of dropout
    rates = (cfg.dropout, 0.0)
    runs = bf16_windows(K, [dataclasses.replace(cfg, dropout=r)
                            for r in rates], params, batch, dev)
    (trainer, losses, times, counts), (trainer0, losses0, times0,
                                       counts0) = runs
    peak = torch.cuda.max_memory_allocated()
    n_groups = len(trainer.optimizer.flat_groups)
    paths.append(("train bf16", cfg.dropout, counts))
    paths.append(("train bf16 dropout 0", 0.0, counts0))
    first = statistics.mean(losses[:LOSS_MEAN_OF])
    last = statistics.mean(losses[-LOSS_MEAN_OF:])
    if not (last < first and losses[-1] < losses[0]):
        fail(f"train[bf16]: the loss does not fall (mean of the first "
             f"{LOSS_MEAN_OF} {first}, of the last {last}): {losses}")
    if not all(b < a for a, b in zip(losses0, losses0[1:])):
        fail(f"train[bf16 dropout 0]: the loss does not fall at every "
             f"step: {losses0}")
    p50, p50_0 = statistics.median(times), statistics.median(times0)
    tokens = TRAIN_B * TRAIN_S
    steps = per_step(cfg)
    suffix = "_dropout" if cfg.dropout > 0 else ""
    rows = {k: kernel_rows[k + suffix if k.startswith("flash") else k]
            for k in steps if k != "layer_norm"}
    rows["layer_norm"] = kernel_rows["layer_norm@train"]
    rows["adam_update"] = kernel_rows["adam_update"]
    kern_ms = sum(rows[k]["ms"] * v for k, v in steps.items())
    kern_ms += rows["adam_update"]["ms"] * n_groups
    if cfg.dropout > 0:
        # one of the Dropouts (fwd and bwd) is the embedding's, narrower
        for k in ("dropout", "dropout_bwd"):
            kern_ms += kernel_rows[k + "@embedding"]["ms"] - rows[k]["ms"]
    rng_us = key_derivation_us(trainer)
    print(f"train[bf16]: TransformerConfig.big() as shipped (dropout "
          f"{cfg.dropout}), batch {TRAIN_B} x {TRAIN_S}, warmup_steps "
          f"{TRAIN_WARMUP}, {TRAIN_STEPS} steps on one repeated batch, "
          f"each step followed by a step of a second trainer at dropout 0",
          flush=True)
    print(f"train[bf16]: losses {[round(x, 5) for x in losses]} (mean of "
          f"the first {LOSS_MEAN_OF} {first:.5f}, of the last {last:.5f})",
          flush=True)
    print(f"train[bf16]: p50 step {p50 * 1e3:.4f} ms (min "
          f"{min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}), "
          f"{tokens / p50:.1f} tokens/s; the kernels at their phase times "
          f"{kern_ms:.4f} ms a step ({100 * kern_ms / (p50 * 1e3):.1f}% of "
          f"the p50 step; Adam counted once per group at the bf16 group's "
          f"time); peak device memory, both trainers resident, "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"train[bf16]: deriving the step's {len(trainer.dropout_sites)} "
          f"dropout keys and seeds on the host: {rng_us:.2f} us a step "
          f"(one pass over a block of steps, median of 20 blocks)",
          flush=True)
    print(f"train[bf16]: launches {counts}", flush=True)
    print(f"train[bf16 dropout 0]: losses {[round(x, 5) for x in losses0]}"
          f"; p50 step {p50_0 * 1e3:.4f} ms (min {min(times0) * 1e3:.4f}, "
          f"max {max(times0) * 1e3:.4f}), {tokens / p50_0:.1f} tokens/s; "
          f"dropout {cfg.dropout} takes {(p50 - p50_0) * 1e3:.4f} ms more "
          f"at the p50", flush=True)
    # the LayerNorm forward and backward on their vector paths
    ln_vec = ("layer_norm_fwd_vec_kernel", "layer_norm_bwd_vec_kernel")
    # and at dropout 0.1 the three dropout kernels on theirs
    drop_vec = ("dropout_vec_kernel", "dropout_bwd_vec_kernel",
                "dropout_residual_vec_kernel")
    busy = profile_steps(trainer, batch, f"dropout {cfg.dropout}",
                         need=ln_vec + (drop_vec if cfg.dropout else ()))
    busy0 = profile_steps(trainer0, batch, "dropout 0", top=5, need=ln_vec)
    if busy is not None and busy0 is not None:
        print(f"train[bf16]: dropout {cfg.dropout} adds {busy - busy0:.4f} "
              f"ms of device time a step", flush=True)
        for rate, ms in ((cfg.dropout, busy), (0.0, busy0)):
            old = EARLIER_TRAIN_DEVICE_MS[rate]
            print(f"train[bf16]: device time a step at dropout {rate}: "
                  f"{ms:.4f} ms, before the redesign {old:.4f} ms "
                  f"({ms - old:+.4f} ms)", flush=True)
    peaks = {rate: step_peak_mib(t, batch)
             for rate, t in ((cfg.dropout, trainer), (0.0, trainer0))}
    tok = TRAIN_B * TRAIN_S
    bits_mib = (cfg.num_layers * -(-tok * cfg.d_ff // 8)
                + -(-tok * cfg.d_model // 8)) / 2 ** 20
    print(f"train[bf16]: peak device memory of one step above the "
          f"trainer's resident state: {peaks[cfg.dropout]:.3f} MiB at "
          f"dropout {cfg.dropout}, {peaks[0.0]:.3f} MiB at 0 "
          f"({peaks[cfg.dropout] - peaks[0.0]:+.3f} MiB); the Dropout keep "
          f"bits saved for the backward take {bits_mib:.3f} MiB of it",
          flush=True)
    return paths


def step_peak_mib(trainer, batch):
    """MiB one training step allocates at its peak above what was
    allocated before it (activations saved for the backward, gradients'
    temporaries)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.step(*batch)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def bf16_windows(K, cfgs, params, batch, dev):
    """``TRAIN_STEPS`` bf16 steps of one fresh trainer per config on one
    repeated batch, interleaved step by step (so both see the same host),
    each step timed on the host clock to its ``synchronize`` and its
    launches counted around it; every loss finite and the launches exact.
    Returns ``[(trainer, losses, times, launches)]``."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    runs = []
    for cfg in cfgs:
        trainer = clm.causal_lm_train_model(
            TRAIN_B, TRAIN_S, cfg, compute_dtype=torch.bfloat16,
            params=params, warmup_steps=TRAIN_WARMUP, device=dev)
        runs.append((trainer, [], [], {k: 0 for k in K.launch_counts()}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        for trainer, losses, times, counts in runs:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            loss = trainer.step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, v in K.launch_counts().items():
                counts[k] += v
            losses.append(loss.item())
    for cfg, (trainer, losses, _, counts) in zip(cfgs, runs):
        tag = f"train[bf16 dropout {cfg.dropout}]"
        n_groups = len(trainer.optimizer.flat_groups)
        want = expected_counts(counts, TRAIN_STEPS, n_groups, cfg)
        if n_groups != 2 or counts != want:
            fail(f"{tag}: {n_groups} Adam groups, launches {counts}, "
                 f"expected {want}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"{tag}: non-finite loss in {losses}")
    return runs


def device_times(prof):
    """``{name: (ms, launches)}`` of the device kernels, copies and fills
    in a ``torch.profiler`` trace; not the user-annotation ranges (e.g.
    the optimizer's step) that span kernels already counted."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    return by_name


def check_traced(tag, by_name, need):
    """Fail unless every name in ``need`` is part of a traced kernel's."""
    missing = [k for k in need if not any(k in nm for nm in by_name)]
    if missing:
        fail(f"{tag}: no {missing} kernel in the trace (the path did not "
             f"take it)")


def profile_steps(trainer, batch, tag, n=3, top=10, label="train",
                  need=()):
    """Device time of ``n`` more training steps from a ``torch.profiler``
    trace (CUDA kernels, copies and fills, summed), against the host
    clock around them, and the ``top`` kernels that take the most of it;
    returns the device ms a step (None when the trace saw no device
    time). Run after the counted window; the profiler's host-side tracing
    slows the host, so the busy share here is a lower bound. Fails when
    a trace with device time lacks a kernel named in ``need``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = {k: ms / n for k, (ms, _) in device_times(prof).items()}
    if not by_name:
        print(f"{label}[bf16 {tag}]: the profiler saw no device time; the "
              f"device busy share is not measured", flush=True)
        return None
    check_traced(f"{label}[bf16 {tag}]", by_name, need)
    dev_ms = sum(by_name.values())
    print(f"{label}[bf16 {tag}]: profiler, {n} steps: device busy "
          f"{dev_ms:.4f} ms a step of {wall_ms:.4f} ms on the host clock "
          f"({100 * dev_ms / wall_ms:.1f}%)", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.4f} ms/step  {name[:110]}", flush=True)
    return dev_ms


# -- ResNet-50 training phase ---------------------------------------------------

RESNET_B, RESNET_SIZE = 256, 224       # resnet50_train_model as shipped
RESNET_F32_B = 32                      # the f32 kernels-vs-plain check
RESNET_F32_STEPS = 2                   # the second step reads mu
RESNET_STEPS = 16
# kernels vs plain after RESNET_F32_STEPS f32 steps, by relative norm per
# parameter (parameters) and over the group (accumulators). cuDNN runs in
# its deterministic mode there (plain vs plain reads 0), so the two runs
# differ only by the softmax-xent kernels' roundoff, which the BatchNorm
# backward amplifies: it cancels most of every gradient, and a parameter
# that starts at 0 (bn0's beta) holds nothing but those gradients. On an
# H100 80GB HBM3 at 700 W that reads 4.733e-2 (bn0.beta) and 2.264e-2;
# the planted faults read 0.256-1.58 and 0.434-0.513
RESNET_PARAM_TOL, RESNET_ACC_TOL = 0.15, 0.1
# launches a step besides Momentum's one per flat group (2 under bf16:
# the conv kernels, and BatchNorm with the fc; 1 under f32)
RESNET_PER_STEP = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1}


def resnet_launches(counts, steps, groups):
    """The launches ``steps`` ResNet steps must make: every other kernel
    0."""
    want = {k: 0 for k in counts}
    want.update({k: v * steps for k, v in RESNET_PER_STEP.items()})
    want["momentum_update"] = groups * steps
    return want


def resnet_trainer(params, batch, dtype, dev, plain=False):
    from simple_tensorflow_tpu_torch.models import resnet

    return resnet.resnet50_train_model(
        batch_size=batch, image_size=RESNET_SIZE, dtype=dtype,
        params=params, device=dev, plain=plain)


def resnet_state(trainer):
    """Every parameter and the flat accumulators, as f32 copies."""
    params = {n: p.detach().float().clone()
              for n, p in trainer.model.named_parameters()}
    accs = [grp.momentum.clone() for grp in trainer.optimizer.flat_groups]
    return params, accs


def resnet_errs(a, b):
    """(worst parameter rel-norm error and its name, worst accumulator
    rel-norm error) of state ``a`` against state ``b``."""
    (pa, aa), (pb, ab) = a, b
    errs = {n: ((pa[n] - pb[n]).norm() / pb[n].norm()).item() for n in pb}
    worst = max(errs, key=errs.get)
    acc = max(((x - y).norm() / y.norm()).item() for x, y in zip(aa, ab))
    return errs[worst], worst, acc


def check_resnet_f32(K, params, images, labels, dev):
    """``RESNET_F32_STEPS`` f32 steps at ``RESNET_F32_B`` x 224^2 through
    the kernels against the same steps through the plain versions
    (``plain=True``), both on the card with cuDNN deterministic: the loss
    of each step within rtol 1e-5, then every parameter and the
    accumulators within ``RESNET_PARAM_TOL``/``RESNET_ACC_TOL`` by
    relative norm. A second plain run gives the floor; two planted
    Momentum faults (the Nesterov flag flipped, ``mu`` x 0.5) must fail
    the limits. Returns the kernel run's launches."""
    from simple_tensorflow_tpu_torch.models import resnet

    tag = f"train resnet[f32 {RESNET_F32_B} x {RESNET_SIZE}^2]"
    x, y = images[:RESNET_F32_B], labels[:RESNET_F32_B]

    def run(plain=False):
        t = resnet_trainer(params, RESNET_F32_B, torch.float32, dev, plain)
        losses = [t.step(x, y).item() for _ in range(RESNET_F32_STEPS)]
        state = resnet_state(t)
        if len(t.optimizer.flat_groups) != 1:
            fail(f"{tag}: {len(t.optimizer.flat_groups)} Momentum groups "
                 f"under f32, expected 1")
        del t
        return losses, state

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss_p, state_p = run(plain=True)
        before = K.launch_counts()
        _, state_p2 = run(plain=True)
        if K.launch_counts() != before:
            fail(f"{tag}: the plain steps launched kernels")
        K.reset_launch_counts()
        loss_k, state_k = run()
        counts = K.launch_counts()
        faults = {}
        for fault, wrap in (
                ("nesterov flipped", lambda f: lambda *a, **k: f(
                    *a, **dict(k, use_nesterov=not k["use_nesterov"]))),
                ("mu x 0.5", lambda f: lambda p, acc, g, lr, mu, **k: f(
                    p, acc, g, lr, mu * 0.5, **k))):
            with planted(resnet, "momentum_update", wrap):
                faults[fault] = resnet_errs(run()[1], state_p)
    finally:
        torch.backends.cudnn.deterministic = prev
    want = resnet_launches(counts, RESNET_F32_STEPS, 1)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    floor = resnet_errs(state_p2, state_p)
    errs = resnet_errs(state_k, state_p)
    print(f"{tag}: losses {loss_k} (kernels) vs {loss_p} (plain)",
          flush=True)
    print(f"{tag}: after {RESNET_F32_STEPS} steps, worst parameter rel err "
          f"{errs[0]:.3e} ({errs[1]}), accumulators {errs[2]:.3e} (limits "
          f"{RESNET_PARAM_TOL}, {RESNET_ACC_TOL}); plain vs plain "
          f"{floor[0]:.3e} / {floor[2]:.3e}", flush=True)
    print(f"{tag}: planted Momentum faults, (parameter, accumulator) rel "
          f"err: " + ", ".join(f"{k} ({v[0]:.3e} {v[1]}, {v[2]:.3e})"
                               for k, v in faults.items()), flush=True)
    bad = [f"step {i + 1}: {a} vs {b}" for i, (a, b) in
           enumerate(zip(loss_k, loss_p)) if not abs(a - b) <= 1e-5 * abs(b)]
    if bad:
        fail(f"{tag}: losses through the kernels vs the plain versions: "
             f"{bad}")
    if not (errs[0] <= RESNET_PARAM_TOL and errs[2] <= RESNET_ACC_TOL):
        fail(f"{tag}: state after {RESNET_F32_STEPS} steps off the plain "
             f"run's: {errs}")
    missed = [k for k, v in faults.items()
              if v[0] <= RESNET_PARAM_TOL and v[2] <= RESNET_ACC_TOL]
    if missed:
        fail(f"{tag}: the limits pass planted faults {missed}: {faults}")
    return counts


def resnet_phase(K, dev):
    """The ResNet-50 training path (module docstring, phase 5). Returns
    ``[(path, dropout, launches)]``: the f32 kernel steps and the bf16
    window, each counted from zero just before it."""
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import resnet

    params = convert.init_resnet_params(seed=0)
    images, labels = resnet.synthetic_imagenet(RESNET_B, RESNET_SIZE)
    paths = [("train resnet f32", 0.0,
              check_resnet_f32(K, params, images, labels, dev))]
    # the batch lives on the card, as a data pipeline would leave it
    images = torch.from_numpy(images).to(dev, torch.bfloat16)
    labels = torch.from_numpy(labels).to(dev)
    torch.cuda.empty_cache()

    tag = f"train resnet[bf16 {RESNET_B} x {RESNET_SIZE}^2]"
    trainer = resnet_trainer(params, RESNET_B, torch.bfloat16, dev)
    sizes = [len(grp) for grp in trainer.optimizer.flat_groups]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    counts = {k: 0 for k in K.launch_counts()}
    K.reset_launch_counts()
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    paths.append(("train resnet bf16", 0.0, counts))
    want = resnet_launches(counts, RESNET_STEPS, 2)
    if len(sizes) != 2 or counts != want:
        fail(f"{tag}: Momentum groups {sizes}, launches {counts}, expected "
             f"{want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss in {losses}")
    # the recipe as shipped (lr 0.1, momentum 0.9, no warm-up) overshoots
    # on one repeated batch after some ten steps, in the JAX package as in
    # the port (PERF.md §6), so the window's first half is held to a
    # falling loss: the mean of its second LOSS_MEAN_OF steps below that of
    # its first
    first = statistics.mean(losses[:LOSS_MEAN_OF])
    second = statistics.mean(losses[LOSS_MEAN_OF:2 * LOSS_MEAN_OF])
    last = statistics.mean(losses[-LOSS_MEAN_OF:])
    if not second < first:
        fail(f"{tag}: the loss does not fall (mean of steps 1-{LOSS_MEAN_OF}"
             f" {first}, of steps {LOSS_MEAN_OF + 1}-{2 * LOSS_MEAN_OF} "
             f"{second}): {losses}")
    p50 = statistics.median(times)
    ips = RESNET_B / p50
    flops = 3 * resnet.resnet_flops_per_image(50, RESNET_SIZE)
    print(f"{tag}: resnet50_train_model as shipped (lr 0.1, momentum 0.9, "
          f"weight decay 1e-4), Momentum groups {sizes}, {RESNET_STEPS} "
          f"steps on one repeated synthetic_imagenet batch (seed 0)",
          flush=True)
    print(f"{tag}: losses {[round(v, 5) for v in losses]} (means of "
          f"{LOSS_MEAN_OF}: the first {first:.5f}, the next {second:.5f}, "
          f"the last {last:.5f})", flush=True)
    print(f"{tag}: p50 step {p50 * 1e3:.4f} ms (min {min(times) * 1e3:.4f},"
          f" max {max(times) * 1e3:.4f}), {ips:.2f} images/s; 3 x "
          f"resnet_flops_per_image at that rate: "
          f"{ips * flops / 1e12:.2f} TFLOP/s, "
          f"{100 * ips * flops / PEAK_OPS_PER_S[torch.bfloat16]:.2f}% of the "
          f"dense bf16 peak; peak device memory {peak / 2 ** 30:.3f} GiB",
          flush=True)
    print(f"{tag}: launches {counts}", flush=True)
    profile_steps(trainer, (images, labels), "resnet", top=12,
                  label="train resnet")
    return paths


# -- Session (TF-1 front end) phase ------------------------------------------

MNIST_B = 512                 # convnet_model at batch 512, f32 as shipped
MNIST_CLASSES = 10
MNIST_ADAM_N = 3_274_634      # the convnet's trainable parameters
SESSION_STEPS = 16
SESSION_CHECK_STEPS = 3
SESSION_KEEP_PROB = 0.5
# softmax_model's shipped learning rate, 0.5, diverges on synthetic_mnist's
# uniform pixels in the JAX package as in the port (PERF.md §6); 0.05 falls
SOFTMAX_LR = 0.05
# kernels vs plain after SESSION_CHECK_STEPS steps: each loss by rtol, every
# variable (the Adam slots included) by relative norm
SESSION_LOSS_RTOL, SESSION_STATE_TOL = 1e-5, 1e-5
SESSION_PER_STEP = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                    "adam_update": 1, "dropout": 1, "dropout_bwd": 1}
MNIST_DROP_SHAPE = (MNIST_B, 1024)   # fc1's activations


def session_kernel_rows(K, gen, dev):
    """The Session path's kernels at its shapes, against their plain
    versions: the xent forward and backward at f32 512 x 10, Adam over
    the convnet's one f32 group (n = 3,274,634; 28 bytes an element) and
    the threefry Dropout at f32 (512, 1024), keep_prob 0.5."""
    import torch.nn.functional as F

    kdo = importlib.import_module(KMOD + "dropout")
    main = xent_case(K, gen, dev, MNIST_B, MNIST_CLASSES, (torch.float32,),
                     (0.0,), "@mnist")
    n = MNIST_ADAM_N
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    alpha = torch.tensor(1e-3, device=dev)
    p = 0.05 * torch.randn(n, generator=gen, device=dev)
    m = 0.01 * torch.randn(n, generator=gen, device=dev)
    v = 1e-4 * torch.rand(n, generator=gen, device=dev)
    g = 0.01 * torch.randn(n, generator=gen, device=dev)
    got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
    ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                              **kw)
    torch.cuda.synchronize()
    name = f"adam_update float32 params n={n} (mnist)"
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        fail(f"{name}: kernel is not bit-exact with its plain version")
    del got, ref
    ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
    plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                      **kw)])
    pt = torch.nn.Parameter(p.clone())
    pt.grad = g.clone()
    opt = torch.optim.Adam([pt], lr=1e-3, fused=True)
    lib_ms = event_ms(opt.step)
    bnd = bound_ms(28 * n, 12 * n, torch.float32)
    report(name, 0.0, ms, plain_ms, bnd, lib_ms)
    main["adam_update@mnist"] = kernel_row(0.0, ms, plain_ms, bnd, lib_ms,
                                           name)
    del p, m, v, g, pt, opt

    kp, key = SESSION_KEEP_PROB, DROPOUT_KEY
    numel = math.prod(MNIST_DROP_SHAPE)
    copies = [torch.randn(MNIST_DROP_SHAPE, generator=gen, device=dev)
              for _ in range(n_copies(8 * numel))]
    x = copies[0]
    tag = f"float32 {MNIST_DROP_SHAPE} keep_prob {kp} (mnist)"
    if not kdo.vector_path(numel, x):
        fail(f"dropout {tag}: not on the vector path")
    out, bits = K.dropout_fwd(x, kp, key, return_bits=True)
    err_f = check_exact(f"dropout {tag}", out, K.dropout_plain(x, kp, key))
    check_exact(f"dropout {tag} bits", bits, kdo.pack_keep_bits_plain(
        kdo.keep_mask_plain(MNIST_DROP_SHAPE, kp, key, dev)))
    err_b = check_exact(f"dropout_bwd {tag}", K.dropout_bwd(x, kp, bits),
                        K.dropout_plain(x, kp, key))
    kkey = device_key_row(K, kdo, "dropout@mnist", tag, copies, kp,
                          torch.float32, dev, main)
    saved = [K.dropout_fwd(c, kp, key, return_bits=True)[1] for c in copies]
    ms_f = device_ms([lambda c=c: K.dropout_fwd(c, kp, key, return_bits=True)
                      for c in copies])
    plain_f = device_ms([lambda c=c: K.dropout_plain(c, kp, key)
                         for c in copies])
    ms_b = device_ms([lambda c=c, b=b: K.dropout_bwd(c, kp, b)
                      for c, b in zip(copies, saved)])
    plain_b = device_ms([lambda c=c, b=b: kdo.dropout_bwd_bits_plain(
        c, b, kp) for c, b in zip(copies, saved)])
    lib_f = event_ms(lambda: F.dropout(x, 1.0 - kp), reps=20)
    masks = [torch.rand(MNIST_DROP_SHAPE, generator=gen, device=dev) < kp
             for _ in copies]
    lib_b = device_ms([
        lambda c=c, mk=mk: torch.ops.aten.native_dropout_backward(
            c, mk, 1.0 / kp) for c, mk in zip(copies, masks)])
    bits_bytes = -(-numel // 8)
    bnd_f = bound_ms(8 * numel + bits_bytes, 0, torch.float32,
                     THREEFRY_OPS * numel, THREEFRY_ALU_OPS * numel)
    bnd_b = bound_ms(8 * numel + bits_bytes, numel, torch.float32)
    report(f"dropout {tag}", err_f, ms_f, plain_f, bnd_f, lib_f)
    report(f"dropout_bwd {tag} (from the bits)", err_b, ms_b, plain_b, bnd_b,
           lib_b)
    main["dropout@mnist"] = kernel_row(err_f, ms_f, plain_f, bnd_f, lib_f,
                                       f"dropout {tag}")
    main["dropout_bwd@mnist"] = kernel_row(err_b, ms_b, plain_b, bnd_b,
                                           lib_b, f"dropout_bwd {tag}")
    report_device_key(main, kkey, bnd_f, lib_f)
    return main


def mnist_session(stf, build):
    """A graph from ``build()``, a Session on the card and its initializer
    run: ``(graph, model dict, session)``."""
    g = stf.Graph()
    with g.as_default():
        m = build()
        init = stf.global_variables_initializer()
    sess = stf.Session(graph=g)
    sess.run(init)
    return g, m, sess


def session_state(sess):
    return {k: v.detach().clone()
            for k, v in sess._variable_store.values.items()}


def session_errs(a, b):
    """The worst relative-norm difference over the variables, and which."""
    errs = {k: ((a[k].double() - b[k].double()).norm()
                / b[k].double().norm().clamp_min(1e-30)).item() for k in b}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def check_session_steps(K, stf, mnist, feeds):
    """``SESSION_CHECK_STEPS`` convnet steps through ``stf.Session`` with
    the kernels against the same steps under
    ``fused_ops.plain_versions()``, each from the same initializer run
    (the same run counter, so the same Dropout masks), cuDNN
    deterministic: each loss within ``SESSION_LOSS_RTOL``, the first
    step's Dropout output equal, every step's mask equal where both ReLUs
    are live, every variable and slot within ``SESSION_STATE_TOL`` by
    relative norm. Two planted faults must fail: Adam's beta1 x (1 +
    1e-4) and the Dropout op's stream id + 1."""
    from simple_tensorflow_tpu_torch.framework import random_seed
    from simple_tensorflow_tpu_torch.ops import fused_ops

    tag = f"session convnet[f32 {MNIST_B}]"

    def run(plain=False, fault=None):
        g, m, sess = mnist_session(stf, mnist.convnet_model)
        sess._capture = False
        if fault == "adam beta1":
            op = g.get_operation_by_name("Adam/fused_adam_update")
            op.attrs["beta1"] = op.attrs["beta1"] * (1 + 1e-4)
        elif fault == "dropout stream + 1":
            op = g.get_operation_by_name("convnet/dropout")
            op.attrs["_graph_seed"] = 0
            op.attrs["seed"] = random_seed.fold_in_value(op.name) + 1
        fetch = [m["train_op"], m["loss"], "convnet/dropout:0",
                 "convnet/fc1/Relu:0"]
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()):
            outs = [sess.run(fetch, feeds(m))[1:]
                    for _ in range(SESSION_CHECK_STEPS)]
        state = session_state(sess)
        sess.close()
        return outs, state

    def compare(outs, state, ref, ref_state):
        """``(bad losses, first-step dropout mismatches, mask mismatches
        on live units, (worst relative state error, variable))``."""
        bad = [(a[0], b[0]) for a, b in zip(outs, ref)
               if not abs(a[0] - b[0]) <= SESSION_LOSS_RTOL * abs(b[0])]
        first = int((outs[0][1] != ref[0][1]).sum())
        masks = 0
        for a, b in zip(outs, ref):
            live = (a[2] != 0) & (b[2] != 0)
            masks += int(((a[1] != 0) != (b[1] != 0))[live].sum())
        return bad, first, masks, session_errs(state, ref_state)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state = run(plain=True)
        before = K.launch_counts()
        floor = compare(*run(plain=True), ref, ref_state)
        if K.launch_counts() != before:
            fail(f"{tag}: the plain steps launched kernels")
        K.reset_launch_counts()
        got = compare(*run(), ref, ref_state)
        counts = K.launch_counts()
        faults = {f: compare(*run(fault=f), ref, ref_state)
                  for f in ("adam beta1", "dropout stream + 1")}
    finally:
        torch.backends.cudnn.deterministic = prev
    want = {k: 0 for k in counts}
    want.update({k: v * SESSION_CHECK_STEPS
                 for k, v in SESSION_PER_STEP.items()})
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    print(f"{tag}: {SESSION_CHECK_STEPS} steps, kernels vs plain: losses "
          f"{[float(o[0]) for o in ref]} (plain); off the plain run: "
          f"{got[0]} losses, first-step dropout values {got[1]}, masks "
          f"{got[2]}, worst variable rel err {got[3][0]:.3e} ({got[3][1]}); "
          f"plain vs plain {floor[3][0]:.3e}", flush=True)
    print(f"{tag}: planted faults (bad losses, dropout values, masks, "
          f"worst variable): " + "; ".join(
              f"{k}: {len(v[0])}, {v[1]}, {v[2]}, {v[3][0]:.3e} ({v[3][1]})"
              for k, v in faults.items()), flush=True)

    def ok(r):
        return not r[0] and r[1] == 0 and r[2] == 0 and \
            r[3][0] <= SESSION_STATE_TOL

    if not ok(got):
        fail(f"{tag}: the kernels' steps are off the plain steps: {got}")
    missed = [k for k, v in faults.items() if ok(v)]
    if missed:
        fail(f"{tag}: the check passes planted faults {missed}: {faults}")
    return counts


GRAPH_CHECK_STEPS = 5   # a warm-up, a capture, then 3 replayed steps


def check_session_graph(K, stf, mnist, feeds):
    """``GRAPH_CHECK_STEPS`` convnet steps through a Session that captures
    its step as a CUDA graph (step 1 eager, the warm-up; step 2 captured
    and replayed; then replays) against the same steps with ``_capture``
    off, each session from its own initializer run (so the same run
    counters), cuDNN deterministic: every loss, Dropout output and, after
    the steps, every variable and Adam slot bit-identical. The planted
    fault replays without refilling the key buffer (``_refresh_keys``
    off after the capture): its Dropout outputs must differ."""
    tag = f"session graph convnet[f32 {MNIST_B}]"

    def run(capture, stale_keys=False):
        _, m, sess = mnist_session(stf, mnist.convnet_model)
        sess._capture = capture
        fetch = [m["train_op"], m["loss"], "convnet/dropout:0"]
        outs = []
        for i in range(GRAPH_CHECK_STEPS):
            if stale_keys and i == 2:
                sess._refresh_keys = False
            outs.append(sess.run(fetch, feeds(m))[1:])
        state = session_state(sess)
        captures = sess.captures
        sess.close()
        return outs, state, captures

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state, _ = run(False)
        got, state, captures = run(True)
        stale, _, _ = run(True, stale_keys=True)
    finally:
        torch.backends.cudnn.deterministic = prev
    losses = sum(a[0] != b[0] for a, b in zip(got, ref))
    drops = [mismatches(torch.from_numpy(a[1]), torch.from_numpy(b[1]))
             for a, b in zip(got, ref)]
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    fault = [mismatches(torch.from_numpy(a[1]), torch.from_numpy(b[1]))
             for a, b in zip(stale, ref)]
    print(f"{tag}: {GRAPH_CHECK_STEPS} steps (eager warm-up, capture, "
          f"{GRAPH_CHECK_STEPS - 2} replays) vs the eager session: losses "
          f"{[float(a[0]) for a in got]}, {losses} differ; Dropout output "
          f"mismatches by step {drops}; variables and slots differing "
          f"{bad_vars} of {len(ref_state)}; captures {captures}", flush=True)
    print(f"{tag}: planted fault, the key buffer not refilled from step 3: "
          f"Dropout output mismatches by step {fault}", flush=True)
    if losses or any(drops) or bad_vars or captures != 1:
        fail(f"{tag}: the replayed steps are off the eager steps")
    if not all(fault[2:]):
        fail(f"{tag}: the check passes replays with stale keys: {fault}")


def session_window(K, sess, fetch, feeds, steps, capture, n_prof=3):
    """``steps`` steps of ``sess.run(fetch, feeds)`` (``fetch[0]`` the
    loss), the step captured as a CUDA graph or (``capture`` False)
    dispatched eagerly, then a ``torch.profiler`` window of ``n_prof``
    steps: losses, step seconds, launches (counted from zero just before
    the window), plan-cache misses and captures after the first step, the
    host seconds a step by kind (``Session._timings``) and the device ms a
    step by kernel."""
    from torch.profiler import ProfilerActivity, profile

    sess._capture = capture
    losses, times = [], []
    sess._timings = {}
    K.reset_launch_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        loss = sess.run(fetch, feeds)[0]
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            misses, captures = sess.plan_cache_misses, sess.captures
    counts = K.launch_counts()
    split = {k: v / steps for k, v in sess._timings.items()}
    sess._timings = None
    late = (sess.plan_cache_misses - misses, sess.captures - captures)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            sess.run(fetch, feeds)
        torch.cuda.synchronize()
    by_name = {k: ms / n_prof for k, (ms, _) in device_times(prof).items()}
    return dict(losses=losses, times=times, counts=counts, split=split,
                late=late, by_name=by_name, captures=sess.captures,
                steps=steps + n_prof)


def report_window(tag, w, expect, items, unit, mean_of=LOSS_MEAN_OF,
                  last_below_first=True):
    """Check one Session window (launches ``expect``, no plan-cache miss
    after the first step, every loss finite, the mean of the last
    ``mean_of`` losses below that of the first ``mean_of`` and, with
    ``last_below_first``, the last loss below the first) and print its
    numbers, ``items`` ``unit`` a step; returns its p50 step and device ms
    a step (None when the trace saw no device time)."""
    counts = w["counts"]
    want = {k: 0 for k in counts}
    want.update(expect)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    losses = w["losses"]
    if w["late"][0]:
        fail(f"{tag}: {w['late'][0]} plan-cache misses after the first step")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss in {losses}")
    first = statistics.mean(losses[:mean_of])
    last = statistics.mean(losses[-mean_of:])
    if not (last < first and (losses[-1] < losses[0]
                              or not last_below_first)):
        fail(f"{tag}: the loss does not fall: {losses}")
    times = w["times"]
    p50 = statistics.median(times)
    print(f"{tag}: losses {[round(v, 5) for v in losses]} (means of "
          f"{mean_of}: the first {first:.5f}, the last {last:.5f})",
          flush=True)
    print(f"{tag}: launches {counts}; after the first step: plan-cache "
          f"misses {w['late'][0]}, captures {w['late'][1]} (in all "
          f"{w['captures']})", flush=True)
    by_name = w["by_name"]
    dev_ms = sum(by_name.values()) if by_name else None
    split = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in
                      sorted(w["split"].items()))
    if dev_ms is None:
        print(f"{tag}: p50 step {p50 * 1e3:.4f} ms, {items / p50:.2f} "
              f"{unit}/s; the profiler saw no device time: device and "
              f"host ms a step not measured; host ms a step by kind "
              f"(window mean): {split}", flush=True)
        return p50, None
    print(f"{tag}: p50 step {p50 * 1e3:.4f} ms (min "
          f"{min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}), "
          f"{items / p50:.2f} {unit}/s; device {dev_ms:.4f} ms a step "
          f"(torch.profiler, 3 steps), host {p50 * 1e3 - dev_ms:.4f} ms a "
          f"step (p50 minus device); host ms a step by kind (window "
          f"mean, Session._timings): {split}", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.4f} ms/step  {name[:110]}", flush=True)
    return p50, dev_ms


def mnist_window(K, stf, mnist, feeds, capture):
    """``SESSION_STEPS`` convnet steps (:func:`session_window`) of a new
    Session; checks the global step after them."""
    _, m, sess = mnist_session(stf, mnist.convnet_model)
    w = session_window(K, sess, [m["loss"], m["train_op"]], feeds(m),
                       SESSION_STEPS, capture)
    gs = int(sess.run(m["global_step"]))
    sess.close()
    if gs != w["steps"]:
        fail(f"session convnet: global_step {gs} after {w['steps']} steps")
    return w


def session_phase(K, dev, kernel_rows):
    """The TF-1 front end on the card (module docstring, phase 6).
    Returns ``[(path, dropout, launches)]``: the checked steps and the
    training windows, each counted from zero just before it."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import mnist

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    print("session kernels at the MNIST shapes:", flush=True)
    kernel_rows.update(session_kernel_rows(K, gen, dev))
    x, labels, onehot = mnist.synthetic_mnist(MNIST_B, seed=0)
    x4 = x.reshape(-1, 28, 28, 1)

    def feeds(m):
        return {m["x"]: x4, m["y_"]: labels, m["keep_prob"]:
                SESSION_KEEP_PROB}

    paths = [("session convnet f32 check", 0.0,
              check_session_steps(K, stf, mnist, feeds))]
    check_session_graph(K, stf, mnist, feeds)
    print(f"session convnet[f32 {MNIST_B}]: models/mnist.py convnet_model "
          f"through stf.Session, Adam lr 1e-3, keep_prob "
          f"{SESSION_KEEP_PROB}, {SESSION_STEPS} steps of Session.run("
          f"[train_op, loss]) on one repeated synthetic_mnist({MNIST_B}, "
          f"seed=0) batch fed as numpy; the graph window first (step 1 "
          f"eager, step 2 captured), then the eager one", flush=True)
    graph = mnist_window(K, stf, mnist, feeds, capture=True)
    eager = mnist_window(K, stf, mnist, feeds, capture=False)
    per = {k: v * SESSION_STEPS for k, v in SESSION_PER_STEP.items()}
    # the graph window's first step is its eager warm-up: one launch of
    # the launch-argument Dropout entry, then the device-key entry
    want_graph = dict(per, dropout=1,
                      dropout_device_key=SESSION_STEPS - 1)
    # one bucket and one keep_prob: exactly one capture, at step 2
    if graph["late"][1] != 1 or graph["captures"] != 1:
        fail(f"session graph: captures {graph['captures']} (after the "
             f"first step {graph['late'][1]}), expected exactly 1")
    if eager["captures"]:
        fail(f"session eager: {eager['captures']} captures")
    g50, gdev = report_window(f"session graph convnet[f32 {MNIST_B}]",
                              graph, want_graph, MNIST_B, "images")
    e50, edev = report_window(f"session eager convnet[f32 {MNIST_B}]",
                              eager, per, MNIST_B, "images")
    if graph["by_name"]:
        check_traced("session graph", graph["by_name"],
                     ("dropout_vec_kernel",))
    if eager["by_name"]:
        check_traced("session eager", eager["by_name"],
                     ("dropout_vec_kernel",))
    print(f"session convnet[f32 {MNIST_B}]: graph vs eager p50 step "
          f"{g50 * 1e3:.4f} vs {e50 * 1e3:.4f} ms ({e50 / g50:.3f}x), "
          f"images/s {MNIST_B / g50:.2f} vs {MNIST_B / e50:.2f}; device ms "
          f"a step {gdev} vs {edev}", flush=True)
    paths += [("session convnet f32 graph", 0.0, graph["counts"]),
              ("session convnet f32 eager", 0.0, eager["counts"])]

    stag = f"session softmax[f32 {MNIST_B}]"
    _, sm, ssess = mnist_session(
        stf, lambda: mnist.softmax_model(learning_rate=SOFTMAX_LR))
    slosses = [float(ssess.run([sm["train_op"], sm["loss"]],
                               {sm["x"]: x, sm["y_"]: onehot})[1])
               for _ in range(SESSION_STEPS)]
    acc = float(ssess.run(sm["accuracy"], {sm["x"]: x, sm["y_"]: onehot}))
    ssess.close()
    print(f"{stag}: softmax_model, GradientDescent lr {SOFTMAX_LR}, "
          f"{SESSION_STEPS} steps (captured from the second): losses "
          f"{[round(v, 5) for v in slosses]}, accuracy after {acc:.4f}",
          flush=True)
    if not all(b < a for a, b in zip(slosses, slosses[1:])):
        fail(f"{stag}: the loss does not fall at every step: {slosses}")
    return paths


# -- the transformer Session phase (TF-1, the seq2seq headline model) -------

TF_B, TF_SRC, TF_TGT = 64, 64, 64   # transformer_train_model's defaults
TF_WARMUP = 256                 # the LM smoke's choice (module docstring)
TF_CHECK_B, TF_CHECK_LAYERS, TF_CHECK_STEPS = 8, 2, 2
TF_GRAPH_STEPS = 5              # a warm-up, a capture, then 3 replays
TF_STEPS = 16
TF_LOSS_RTOL, TF_STATE_TOL = 1e-5, 1e-4
# the graph's fused and dropout ops per layer of encoder and decoder
FLASH_PARTS = ("flash_attention_fwd", "flash_attention_dkdv",
               "flash_attention_dq")
SEEDED = FLASH_PARTS + ("dropout_residual", "dropout_residual_bwd")


def tf_per_step(layers, adam_groups):
    """Launches a training step of ``transformer_train_model`` with
    ``layers`` + ``layers`` layers at dropout > 0: 3 flash ops a layer pair
    (encoder self, decoder self and cross), 2 + 3 LayerNorms, 1 + 2
    dropout-residual tails, a Dropout on each embedding and FFN
    activation, the xent, one Adam per group (at bf16 compute two: the
    bf16 Dense variables, the f32 embedding and LayerNorm ones; at f32
    one)."""
    per = {k: 3 * layers for k in SEEDED}
    per.update(layer_norm=5 * layers, layer_norm_bwd=5 * layers,
               dropout=2 + 2 * layers, dropout_bwd=2 + 2 * layers,
               softmax_xent_fwd=1, softmax_xent_bwd=1,
               adam_update=adam_groups)
    return per


def tf_batch(b, src, tgt, vocab, pads):
    """``synthetic_wmt_batch(b, src, tgt, vocab, seed=0)``; with ``pads``
    the ends of two rows padded (id 0) in src, tgt_in and tgt_out."""
    from simple_tensorflow_tpu_torch.models import transformer as tr

    batch = tr.synthetic_wmt_batch(b, src, tgt, vocab_size=vocab, seed=0)
    if pads:
        batch["src_ids"][0, -9:] = 0
        batch["src_ids"][b - 1, -2:] = 0
        batch["tgt_in"][1, -5:] = 0
        batch["tgt_out"][1, -6:] = 0
    return batch


def tf_session(stf, tr, cfg, b, dtype, graph_seed=1, fault=False):
    """``transformer_train_model(b, TF_SRC, TF_TGT, cfg, warmup_steps=
    TF_WARMUP, compute_dtype=dtype)`` under ``set_random_seed(
    graph_seed)`` and a Session on the card after its initializer run:
    ``(model dict, session)``. ``fault``: the decoder's first
    cross-attention op is given its self-attention op's seed (a planted
    fault: another mask)."""
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(graph_seed)
        m = tr.transformer_train_model(b, TF_SRC, TF_TGT, cfg=cfg,
                                       warmup_steps=TF_WARMUP,
                                       compute_dtype=dtype)
        init = stf.global_variables_initializer()
    if fault:
        at = "transformer_1/decoder/layer_0/"
        cross = g.get_operation_by_name(at + "cross_attn/flash_attention")
        own = g.get_operation_by_name(at + "self_attn/flash_attention")
        cross.attrs["seed"] = own.attrs["seed"]
    sess = stf.Session(graph=g)
    sess.run(init)
    return m, sess


def tf_feeds(m, batch):
    return {m[k]: batch[k] for k in ("src_ids", "tgt_in", "tgt_out")}


def tf_group_errs(state, ref):
    """``{part: relative-norm error}`` of a transformer Session state
    against ``ref``: each Adam group's parameters as one flat vector (the
    buffer the kernel updates: the variables of one dtype, in name order)
    and each of the other store entries (the flat ``m`` and ``v`` slots,
    the beta powers, the global step) on its own."""
    def rel(a, b):
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp_min(1e-30)).item()

    slots = [k for k in ref if k.startswith("Adam/") or k == "global_step"]
    groups = {}
    for k in sorted(ref):
        if k not in slots:
            groups.setdefault(str(ref[k].dtype), []).append(k)
    errs = {f"params {dt} ({len(ks)} variables)": rel(
        torch.cat([state[k].reshape(-1) for k in ks]),
        torch.cat([ref[k].reshape(-1) for k in ks]))
        for dt, ks in groups.items()}
    errs.update({k: rel(state[k], ref[k]) for k in slots})
    return errs


def check_transformer_f32(K, stf, tr):
    """``TF_CHECK_STEPS`` f32 steps of ``transformer_train_model`` at
    ``TransformerConfig.big()`` widths cut to ``TF_CHECK_LAYERS`` +
    ``TF_CHECK_LAYERS`` layers, batch ``TF_CHECK_B`` x 64 / 64 with pads,
    dropout 0.1, through the kernels against the same steps under
    ``fused_ops.plain_versions()`` (eager dispatch, one graph seed: the
    same initial values and masks): each loss within ``TF_LOSS_RTOL``;
    the parameters, as the flat vector the Adam kernel updates, and the
    beta powers within ``TF_STATE_TOL`` by relative norm
    (:func:`tf_group_errs`; the worst single variable is printed: the key
    biases, whose gradient is zero in exact arithmetic, hold only Adam's
    lr-sized steps on roundoff); the flat ``m`` and ``v`` slots, averages
    of the gradients and their squares, within the f32 gradient limit of
    the LM check at dropout 0.1 (``F32_GRAD_TOL``: a few FFN-input units
    whose ReLU gate flips on f32 roundoff between the two runs move their
    gradients). A planted fault, the decoder's first cross-attention
    drawn with another op's seed, must fail."""
    from simple_tensorflow_tpu_torch.ops import fused_ops

    cfg = dataclasses.replace(tr.TransformerConfig.big(),
                              num_layers=TF_CHECK_LAYERS)
    batch = tf_batch(TF_CHECK_B, TF_SRC, TF_TGT, cfg.vocab_size, pads=True)
    tag = (f"transformer[f32 {TF_CHECK_LAYERS}+{TF_CHECK_LAYERS} layers "
           f"{TF_CHECK_B}x{TF_SRC}/{TF_TGT}]")

    def run(plain=False, fault=False):
        m, sess = tf_session(stf, tr, cfg, TF_CHECK_B, stf.float32,
                             fault=fault)
        sess._capture = False
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()):
            outs = [sess.run([m["loss"], m["train_op"]],
                             tf_feeds(m, batch))[0]
                    for _ in range(TF_CHECK_STEPS)]
        state = session_state(sess)
        sess.close()
        return outs, state

    def compare(outs, state, ref, ref_state):
        """``(bad losses, {part: error}, (worst variable error, name))``."""
        bad = [(float(a), float(b)) for a, b in zip(outs, ref)
               if not abs(a - b) <= TF_LOSS_RTOL * abs(b)]
        return bad, tf_group_errs(state, ref_state), session_errs(
            state, ref_state)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state = run(plain=True)
        K.reset_launch_counts()
        got = compare(*run(), ref, ref_state)
        counts = K.launch_counts()
        fault = compare(*run(fault=True), ref, ref_state)
    finally:
        torch.backends.cudnn.deterministic = prev
    want = {k: 0 for k in counts}
    want.update({k: v * TF_CHECK_STEPS
                 for k, v in tf_per_step(TF_CHECK_LAYERS, 1).items()})
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")

    def txt(errs):
        return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())

    print(f"{tag}: {TF_CHECK_STEPS} steps, kernels vs plain: losses "
          f"{[float(o) for o in ref]} (plain); off the plain run: "
          f"{got[0]} losses; relative norms: {txt(got[1])}; the worst "
          f"single variable {got[2][0]:.3e} ({got[2][1]})", flush=True)
    print(f"{tag}: planted fault (the decoder's first cross-attention "
          f"drawn with its self-attention's seed): bad losses {fault[0]}; "
          f"{txt(fault[1])}", flush=True)

    def ok(r):
        return not r[0] and all(
            v <= (F32_GRAD_TOL[DROPOUT_RATE] if "/fused_" in k
                  else TF_STATE_TOL) for k, v in r[1].items())

    if not ok(got):
        fail(f"{tag}: the kernels' steps are off the plain steps: {got}")
    if ok(fault):
        fail(f"{tag}: the check passes the planted seed fault: {fault}")
    return counts


def check_transformer_graph(K, stf, tr, cfg, batch):
    """``TF_GRAPH_STEPS`` bf16 steps of ``transformer_train_model`` as
    shipped through a Session that captures its step (step 1 eager, the
    warm-up; step 2 captured and replayed; then replays) against the same
    steps with ``_capture`` off, each from its own initializer run under
    one graph seed: every loss, the first encoder flash op's and
    dropout-residual tail's outputs, and after the steps every variable
    and Adam slot bit-identical; one capture. The planted fault replays
    without refilling the seed buffer (``_refresh_seeds`` off): the flash
    and tail outputs of the replayed steps must differ."""
    tag = f"transformer graph[bf16 {TF_B}x{TF_SRC}/{TF_TGT}]"
    at = "transformer/encoder/layer_0/"
    probes = [at + "self_attn/flash_attention:0",
              at + "fused_dropout_residual:0"]

    def run(capture, refresh=True):
        m, sess = tf_session(stf, tr, cfg, TF_B, stf.bfloat16)
        sess._capture = capture
        sess._refresh_seeds = refresh
        outs = [sess.run([m["loss"], m["train_op"]] + probes,
                         tf_feeds(m, batch))
                for _ in range(TF_GRAPH_STEPS)]
        state = session_state(sess) if refresh else None
        captures = sess.captures
        sess.close()
        return outs, state, captures

    ref, ref_state, _ = run(False)
    got, state, captures = run(True)
    stale, _, _ = run(True, refresh=False)

    def diffs(outs):
        return [(int(a[0] != b[0]),
                 mismatches(torch.from_numpy(a[2].astype(np.float32)),
                            torch.from_numpy(b[2].astype(np.float32))),
                 mismatches(torch.from_numpy(a[3].astype(np.float32)),
                            torch.from_numpy(b[3].astype(np.float32))))
                for a, b in zip(outs, ref)]

    d_got, d_stale = diffs(got), diffs(stale)
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    print(f"{tag}: {TF_GRAPH_STEPS} steps (eager warm-up, capture, "
          f"{TF_GRAPH_STEPS - 2} replays) vs the eager session: losses "
          f"{[float(a[0]) for a in got]}; (loss differs, flash output "
          f"mismatches, tail mismatches) by step {d_got}; variables and "
          f"slots differing {bad_vars[:5]} ({len(bad_vars)} of "
          f"{len(ref_state)}); captures {captures}", flush=True)
    print(f"{tag}: planted fault, the seed buffer not refilled before the "
          f"replays: by step {d_stale}", flush=True)
    if any(any(d) for d in d_got) or bad_vars or captures != 1:
        fail(f"{tag}: the replayed steps are off the eager steps")
    if not all(d[1] and d[2] for d in d_stale[1:]):
        fail(f"{tag}: the check passes replays with stale seeds: {d_stale}")


def tf_kernel_rows(K, gen, dev, tf_adam_n):
    """The transformer path's new kernel shapes against their plain
    versions: the bf16 flash kernels at B x H = 64 x 16 heads of S = 64,
    D = 64, non-causal with a (B, S) pad bias (-1e9 on padded keys; the
    encoder and cross-attention case), dropout 0.1, through the
    launch-argument entry and the seed-pointer entry (bit-identical, both
    timed); the dropout-residual kernel and its dx at bf16 4096 x 1024
    through the seed-pointer entry beside the launch-argument one; Adam
    over the transformer's bf16 group (bf16 parameters, f32 m and v)."""
    import torch.nn.functional as F

    kdr = importlib.import_module(KMOD + "dropout_residual")
    B, H, s, D = TF_B, 16, TF_SRC, 64
    bh, rate = B * H, DROPOUT_RATE
    dtype, elem = torch.bfloat16, 2
    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device=dev)
    copies = [tuple(torch.randn((bh, s, D), generator=gen, device=dev).to(
        dtype) for _ in range(4))
        for _ in range(n_copies(4 * bh * s * D * elem))]
    bias = torch.zeros((B, s), device=dev)
    bias[::3, -11:] = -1e9
    args = dict(heads=H, sm_scale=D ** -0.5, causal=False, bias=bias,
                dropout_rate=rate)
    host = dict(args, dropout_seed=FLASH_SEED)
    ptr = dict(args, dropout_seed=seed_t)
    stats = []
    for q, k, v, do in copies:
        ro, rlse = K.flash_attention_fwd_plain(q, k, v, **host)
        stats.append((ro, rlse, (do.float() * ro.float()).sum(-1)))
    q, k, v, do = copies[0]
    ro, rlse, delta = stats[0]
    tag = f"bf16 BH={bh} S={s} D={D} bias dropout {rate} (transformer)"
    outs = {}
    for entry, a in (("host", host), ("ptr", ptr)):
        o, lse = K.flash_attention_fwd(q, k, v, **a)
        dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **a)
        dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **a)
        outs[entry] = (o, lse, dk, dv, dq)
    torch.cuda.synchronize()
    for a, b_ in zip(outs["host"], outs["ptr"]):
        if not torch.equal(a, b_):
            fail(f"flash {tag}: the seed-pointer entry is not bit-identical "
                 "to the launch-argument entry")
    o, lse, dk, dv, dq = outs["ptr"]
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **host)
    rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **host)
    err = {"fwd": max(check_scaled(f"flash fwd o {tag}", o, ro, 2e-2),
                      check_scaled(f"flash fwd lse {tag}", lse, rlse, 1e-5)),
           "dkdv": max(check_scaled(f"flash dk {tag}", dk, rdk, 2e-2),
                       check_scaled(f"flash dv {tag}", dv, rdv, 2e-2)),
           "dq": check_scaled(f"flash dq {tag}", dq, rdq, 2e-2)}
    check_flash_fault(K, q, k, v, do, rlse, delta, host, (o, dk, dv, dq),
                      (2e-2,) * 4, tag)
    del outs, o, lse, dk, dv, dq, rdk, rdv, rdq
    fns = {"fwd": (K.flash_attention_fwd, K.flash_attention_fwd_plain,
                   lambda c, st: c[:3]),
           "dkdv": (K.flash_attention_dkdv, K.flash_attention_dkdv_plain,
                    lambda c, st: (*c, st[1], st[2])),
           "dq": (K.flash_attention_dq, K.flash_attention_dq_plain,
                  lambda c, st: (*c, st[1], st[2]))}
    mask = bias.view(B, 1, 1, s).to(dtype)
    q4, k4, v4 = (t.view(B, H, s, D) for t in copies[0][:3])
    lib_fwd = event_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, dropout_p=rate), reps=20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    do4 = copies[0][3].view(B, H, s, D)
    lib_fb = event_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                       dropout_p=rate), (qg, kg, vg), do4))
    pairs = bh * s * s
    io = bh * s * D * elem
    hashes = K0_OPS * pairs
    bnds = {"fwd": bound_ms(4 * io + bh * s * 4 + B * s * 4, 4 * D * pairs,
                            dtype, hashes),
            "dkdv": bound_ms(6 * io + 2 * bh * s * 4 + B * s * 4,
                             8 * D * pairs, dtype, hashes),
            "dq": bound_ms(5 * io + 2 * bh * s * 4 + B * s * 4,
                           6 * D * pairs, dtype, hashes)}
    libs = {"fwd": lib_fwd, "dkdv": lib_fb, "dq": lib_fb}
    main = {}
    for part, (kern, plain, pick) in fns.items():
        t = {entry: device_ms([
            lambda c=c, st=st, a=a: kern(*pick(c, st), **a)
            for c, st in zip(copies, stats)]) for entry, a in
            (("host", host), ("ptr", ptr))}
        plain_ms = device_ms([lambda c=c, st=st: plain(*pick(c, st), **host)
                              for c, st in zip(copies, stats)])
        name = f"flash_attention_{part}"
        report(f"{name} {tag}", err[part], t["host"], plain_ms, bnds[part],
               libs[part])
        report(f"{name}_device_seed {tag}", err[part], t["ptr"], plain_ms,
               bnds[part], libs[part])
        print(f"  {name} {tag}: seed-pointer entry {t['ptr']:.5f} ms, "
              f"{t['ptr'] / t['host']:.3f}x the launch-argument entry "
              f"{t['host']:.5f} ms (same call)", flush=True)
        main[f"{name}@transformer"] = kernel_row(
            err[part], t["host"], plain_ms, bnds[part], libs[part],
            f"{name} {tag}")
        main[f"{name}_device_seed"] = kernel_row(
            err[part], t["ptr"], plain_ms, bnds[part], libs[part],
            f"{name}_device_seed {tag}")
    print("  (flash library at the transformer shape: SDPA with the pad "
          "mask and dropout_p, CUDA events; dkdv/dq = SDPA forward + "
          "backward)", flush=True)
    del copies, stats

    rows, n = TF_B * TF_TGT, 1024
    tag = f"bf16 rows={rows} n={n} (transformer, seed pointer)"
    kc = [tuple(torch.randn((rows, n), generator=gen, device=dev).to(dtype)
                for _ in range(2)) for _ in range(n_copies(6 * rows * n))]
    x, res = kc[0]
    for name, fn, pl in (
            ("dropout_residual",
             lambda c, sd: kdr.dropout_residual_fwd(c[0], c[1], rate=rate,
                                                    seed=sd),
             lambda c: kdr.dropout_residual_fwd_plain(c[0], c[1], rate=rate,
                                                      seed=FLASH_SEED)),
            ("dropout_residual_bwd",
             lambda c, sd: kdr.dropout_residual_bwd(c[0], rate=rate,
                                                    seed=sd),
             lambda c: kdr.dropout_residual_bwd_plain(c[0], rate=rate,
                                                      seed=FLASH_SEED))):
        err_d = check_exact(f"{name} {tag}", fn(kc[0], seed_t), pl(kc[0]))
        check_exact(f"{name} {tag} vs the launch-argument entry",
                    fn(kc[0], seed_t), fn(kc[0], FLASH_SEED))
        t_ptr = device_ms([lambda c=c: fn(c, seed_t) for c in kc])
        t_host = device_ms([lambda c=c: fn(c, FLASH_SEED) for c in kc])
        plain_ms = device_ms([lambda c=c: pl(c) for c in kc])
        fwd = name == "dropout_residual"
        bnd = bound_ms((6 if fwd else 4) * rows * n, 0, dtype,
                       K0_OPS * rows * n)
        lib = device_ms([lambda c=c: F.dropout(c[0], rate) + c[1]
                         for c in kc]) if fwd else \
            device_ms([lambda c=c: F.dropout(c[0], rate) for c in kc])
        report(f"{name}_device_seed {tag}", err_d, t_ptr, plain_ms, bnd, lib)
        print(f"  {name} {tag}: seed-pointer entry {t_ptr:.5f} ms, "
              f"{t_ptr / t_host:.3f}x the launch-argument entry "
              f"{t_host:.5f} ms (same call)", flush=True)
        main[f"{name}_device_seed"] = kernel_row(
            err_d, t_ptr, plain_ms, bnd, lib, f"{name}_device_seed {tag}")
    del kc, x, res

    n = tf_adam_n
    kw = dict(beta1=0.9, beta2=0.997, eps=1e-9)
    alpha = torch.tensor(1e-4, device=dev)
    p = (0.03 * torch.randn(n, generator=gen, device=dev)).to(dtype)
    m = 0.01 * torch.randn(n, generator=gen, device=dev)
    v = 1e-4 * torch.rand(n, generator=gen, device=dev)
    g = (0.01 * torch.randn(n, generator=gen, device=dev)).to(dtype)
    got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
    ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                              **kw)
    torch.cuda.synchronize()
    name = f"adam_update bfloat16 params n={n} f32 m/v (transformer)"
    if not all(torch.equal(a, b_) for a, b_ in zip(got, ref)):
        fail(f"{name}: kernel is not bit-exact with its plain version")
    del got, ref
    ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
    plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                      **kw)])
    pt = torch.nn.Parameter(p.clone())
    pt.grad = g.clone()
    opt = torch.optim.Adam([pt], lr=1e-4, betas=(0.9, 0.997), eps=1e-9,
                           fused=True)
    lib_ms = event_ms(opt.step)
    # p, g bf16 read, p written; m, v f32 read and written: 14 + 8 bytes
    bnd = bound_ms(22 * n, 12 * n, torch.float32)
    report(name, 0.0, ms, plain_ms, bnd, lib_ms)
    main["adam_update@transformer"] = kernel_row(0.0, ms, plain_ms, bnd,
                                                 lib_ms, name)
    del p, m, v, g, pt, opt
    torch.cuda.empty_cache()
    return main


def tf_adam_groups(cfg):
    """The element counts of ``transformer_train_model``'s two Adam groups
    at ``cfg``: the bf16 Dense kernels and biases, and the f32 embedding
    with the LayerNorm gammas and betas."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    attn = 4 * (d * d + d)
    ffn = d * ff + ff + ff * d + d
    bf16 = L * (attn + ffn) + L * (2 * attn + ffn)
    f32 = cfg.vocab_size * d + L * 2 * 2 * d + L * 3 * 2 * d
    return bf16, f32


def transformer_session_phase(K, dev, kernel_rows):
    """The reference's headline model through the TF-1 front end
    (module docstring, phase 7). Returns ``[(path, dropout,
    launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig.big()
    bf16_n, f32_n = tf_adam_groups(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    print("transformer kernels at the transformer_train_model shapes:",
          flush=True)
    kernel_rows.update(tf_kernel_rows(K, gen, dev, bf16_n))
    paths = [("transformer f32 check", DROPOUT_RATE,
              check_transformer_f32(K, stf, tr))]
    torch.cuda.empty_cache()
    batch = tf_batch(TF_B, TF_SRC, TF_TGT, cfg.vocab_size, pads=False)
    check_transformer_graph(K, stf, tr, cfg, batch)
    torch.cuda.empty_cache()
    tag = f"transformer[bf16 {TF_B}x{TF_SRC}/{TF_TGT}]"
    print(f"{tag}: transformer_train_model(TransformerConfig.big()) as "
          f"shipped ({cfg.num_layers}+{cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, dropout {cfg.dropout}, label smoothing "
          f"{cfg.label_smoothing}, bf16, Adam 0.9/0.997/1e-9, noam lr with "
          f"warmup_steps {TF_WARMUP}), Adam groups bf16 {bf16_n} and f32 "
          f"{f32_n} elements; {TF_STEPS} steps of Session.run([loss, "
          f"train_op]) on one repeated synthetic_wmt_batch({TF_B}, "
          f"{TF_SRC}, {TF_TGT}, seed=0) fed as numpy; the graph window "
          f"first (step 1 eager, step 2 captured), then the eager one",
          flush=True)
    windows = {}
    for capture in (True, False):
        m, sess = tf_session(stf, tr, cfg, TF_B, stf.bfloat16)
        windows[capture] = session_window(
            K, sess, [m["loss"], m["train_op"]], tf_feeds(m, batch),
            TF_STEPS, capture)
        gs = int(sess.run(m["global_step"]))
        sess.close()
        if gs != windows[capture]["steps"]:
            fail(f"{tag}: global_step {gs} after "
                 f"{windows[capture]['steps']} steps")
        torch.cuda.empty_cache()
    graph, eager = windows[True], windows[False]
    per = {k: v * TF_STEPS
           for k, v in tf_per_step(cfg.num_layers, 2).items()}
    # the graph window's first step is its eager warm-up (launch-argument
    # entries), the 15 replays launch the device-key and seed-pointer ones
    want_graph = dict(per)
    for k in SEEDED:
        want_graph[k] = per[k] // TF_STEPS
        want_graph[k + "_device_seed"] = per[k] // TF_STEPS * (TF_STEPS - 1)
    want_graph["dropout"] = per["dropout"] // TF_STEPS
    want_graph["dropout_device_key"] = \
        per["dropout"] // TF_STEPS * (TF_STEPS - 1)
    if graph["late"][1] != 1 or graph["captures"] != 1:
        fail(f"{tag}: captures {graph['captures']} (after the first step "
             f"{graph['late'][1]}), expected exactly 1")
    if eager["captures"]:
        fail(f"{tag}: the eager window captured {eager['captures']} times")
    tokens = TF_B * TF_TGT
    half = TF_STEPS // 2
    g50, gdev = report_window(f"transformer graph[bf16 {TF_B}x{TF_SRC}/"
                              f"{TF_TGT}]", graph, want_graph, tokens,
                              "target tokens", mean_of=half,
                              last_below_first=False)
    e50, edev = report_window(f"transformer eager[bf16 {TF_B}x{TF_SRC}/"
                              f"{TF_TGT}]", eager, per, tokens,
                              "target tokens", mean_of=half,
                              last_below_first=False)
    for w, name in ((graph, "graph"), (eager, "eager")):
        if w["by_name"]:
            check_traced(f"transformer {name}", w["by_name"],
                         ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                          "flash_bwd_dq_mma_kernel",
                          "dropout_residual_vec_kernel"))
    flops = 3 * tr.transformer_flops_per_token(cfg, TF_SRC, TF_TGT)
    both = TF_B * (TF_SRC + TF_TGT)
    for name, p50 in (("graph", g50), ("eager", e50)):
        print(f"{tag} {name}: p50 {p50 * 1e3:.4f} ms, {tokens / p50:.2f} "
              f"target tokens/s, {both / p50:.2f} source + target tokens/s "
              f"(the reference's transformer_big_tokens_per_sec_per_chip "
              f"count), {both * flops / p50 / 1e12:.2f} TFLOP/s at 3 x "
              f"transformer_flops_per_token a source + target token "
              f"({100 * both * flops / p50 / PEAK_OPS_PER_S[torch.bfloat16]:.2f}% "
              f"of the dense bf16 peak)", flush=True)
    print(f"{tag}: graph vs eager p50 step {g50 * 1e3:.4f} vs "
          f"{e50 * 1e3:.4f} ms ({e50 / g50:.3f}x); device ms a step {gdev} "
          f"vs {edev}", flush=True)
    return paths + [("transformer bf16 graph", DROPOUT_RATE,
                     graph["counts"]),
                    ("transformer bf16 eager", DROPOUT_RATE,
                     eager["counts"])]


def kernel_props(log, prefix):
    """``[(kernel<template args>, "N registers, spill stores/loads")]`` of
    the kernels whose name starts with ``prefix``, from ``ptxas -v``."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            sym = m.group(1)
            # the kernel's name follows its length in the mangled symbol
            k = re.search(r"\d(" + prefix + r"\w*?kernel)I(\w*?)EE", sym)
            name = None
            if k:
                targs = re.findall(r"L[ib](\d+)", k.group(2))
                if "__nv_bfloat16" in k.group(2):
                    targs.insert(0, "bf16")
                elif k.group(2).startswith("f"):
                    targs.insert(0, "f32")
                name = f"{k.group(1)}<{', '.join(targs)}>"
            spill = None
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append((name, f"{regs} registers; {spill}"))
            name = None
    return out


# kernels the serving traces must show: the Kq = 1 DecodeAttention and the
# LayerNorm forward on its vector path
SERVING_KERNELS = ("decode_one_kernel", "layer_norm_fwd_vec_kernel")


# a hang (a kernel or a capture that never returns) dumps every thread's
# stack and exits non-zero this long after the start, inside the 1200 s
# the run is given
HANG_DUMP_S = 1140


def main():
    faulthandler.dump_traceback_later(HANG_DUMP_S, exit=True)
    serving_only = sys.argv[1:] == ["--serving"]
    if sys.argv[1:] and not serving_only:
        fail(f"usage: {sys.argv[0]} [--serving]")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures "
             "the port on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import transformer as tr
    from simple_tensorflow_tpu_torch.models.common import resolve_device
    from simple_tensorflow_tpu_torch.ops import kernels as K
    from simple_tensorflow_tpu_torch.ops.kernels import _build

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built from {SRC} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # the nvcc log of this build, or of the one that made the library
    build_log = _build.build_log or (_build.BUILD_DIR / "build.log"
                                     ).read_text()
    spills, entry = [], ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill" \
                not in ln:
            spills.append(f"{entry}: {ln.strip()}")
    print(f"  ptxas: {len(spills)} kernels spill registers {spills}",
          flush=True)
    for prefix in ("flash_bwd_", "qmm_", "layer_norm_", "decode_one",
                   "dropout"):
        for name, props in kernel_props(build_log, prefix):
            print(f"  ptxas {name}: {props}", flush=True)

    cfg = tr.TransformerConfig.big()
    if serving_only:
        # the serving phase alone, of whichever tree's package sits beside
        # this script: its traces ask for no kernel by name
        params = convert.init_params(cfg, seed=0)
        for int8 in (False, True):
            serve(params, cfg, int8, make_prompts(cfg.vocab_size), dev, ())[0]
        print("chip_smoke: the serving phase passed (--serving)", flush=True)
        return
    rng = np.random.RandomState(0)
    print("kernel phases (times are per call, on the card):", flush=True)
    main_rows = {}
    main_rows.update(phase_decode_attention(K, rng, dev))
    main_rows.update(phase_layer_norm(K, rng, dev))
    main_rows.update(phase_quant_matmul(K, rng, dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    main_rows.update(phase_flash_attention(K, gen, dev))
    main_rows.update(phase_dropout_residual(K, gen, dev))
    main_rows.update(phase_dropout(K, gen, dev))
    main_rows.update(phase_layer_norm_bwd(K, gen, dev))
    main_rows.update(phase_softmax_xent(K, gen, dev))
    main_rows.update(phase_adam(K, gen, dev, cfg))
    main_rows.update(phase_momentum(K, gen, dev))
    torch.cuda.empty_cache()

    params = convert.init_params(cfg, seed=0)
    prompts = make_prompts(cfg.vocab_size)
    # (path, dropout rate, launches counted from zero around it)
    paths, stats = [], {}
    for int8 in (False, True):
        counts, stats[int8] = serve(params, cfg, int8, prompts, dev,
                                    SERVING_KERNELS)
        paths.append((f"serve {'int8' if int8 else 'f32'}", 0.0, counts))
    check_serving_graphs(params, cfg, dev)
    counts, eager = serve(params, cfg, False, prompts, dev, SERVING_KERNELS,
                          aot=False)
    paths.append(("serve f32 eager", 0.0, counts))
    g = stats[False]
    print(f"serving[f32] graph vs eager: tokens/s {g['tokens_s']:.2f} vs "
          f"{eager['tokens_s']:.2f}, p50 decode step {g['p50_ms']:.4f} vs "
          f"{eager['p50_ms']:.4f} ms, p50 time to first token "
          f"{g['ttft_ms']:.4f} vs {eager['ttft_ms']:.4f} ms; bucket-16 "
          f"traced (device ms, host p50 ms) a decode step {g['traced']} vs "
          f"{eager['traced']}", flush=True)
    torch.cuda.empty_cache()
    paths += train_phase(K, cfg, params, dev, main_rows)
    del params
    torch.cuda.empty_cache()
    paths += resnet_phase(K, dev)
    torch.cuda.empty_cache()
    paths += session_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    paths += transformer_session_phase(K, dev, main_rows)
    # a kernel's launches over every path; the flash rows split by the
    # path's dropout (the dropout branch runs only at rate > 0; the
    # seed-pointer entries only with dropout)
    launches = {}
    for _, rate, counts in paths:
        for k, v in counts.items():
            if k.startswith("flash_attention") and rate > 0 and \
                    not k.endswith("_device_seed"):
                k += "_dropout"
            launches[k] = launches.get(k, 0) + v
    print(f"launches over the paths {[p for p, _, _ in paths]}: {launches}",
          flush=True)

    where = {
        "decode_attention": ("decode_attention.cu",
                             "decode_attention.py:57"),
        "decode_attention_block": ("decode_attention.cu",
                                   "decode_attention.py:108"),
        "layer_norm": ("layer_norm.cu", "layer_norm.py:29"),
        "quant_matmul": ("quant_matmul.cu", "quant_matmul.py:45"),
        "flash_attention_fwd": ("flash_fwd_mma.cu",
                                "flash_attention.py:102"),
        "flash_attention_dkdv": ("flash_bwd_mma.cu",
                                 "flash_attention.py:210"),
        "flash_attention_dq": ("flash_bwd_mma.cu",
                               "flash_attention.py:264"),
        "layer_norm_bwd": ("layer_norm.cu", "layer_norm.py:42"),
        "softmax_xent_fwd": ("softmax_xent.cu", "softmax_xent.py:32"),
        "softmax_xent_bwd": ("softmax_xent.cu", "softmax_xent.py:78"),
        "adam_update": ("fused_update.cu", "fused_update.py:59"),
        "momentum_update": ("fused_update.cu", "fused_update.py:135"),
        "flash_attention_fwd_dropout": ("flash_fwd_mma.cu",
                                        "flash_attention.py:141"),
        "flash_attention_dkdv_dropout": ("flash_bwd_mma.cu",
                                         "flash_attention.py:244"),
        "flash_attention_dq_dropout": ("flash_bwd_mma.cu",
                                       "flash_attention.py:297"),
        "dropout_residual": ("dropout_residual.cu",
                             "dropout_residual.py:41"),
        "dropout_residual_bwd": ("dropout_residual.cu",
                                 "dropout_residual.py:99"),
        "flash_attention_fwd_device_seed": ("flash_fwd_mma.cu",
                                            "flash_attention.py:141"),
        "flash_attention_dkdv_device_seed": ("flash_bwd_mma.cu",
                                             "flash_attention.py:244"),
        "flash_attention_dq_device_seed": ("flash_bwd_mma.cu",
                                           "flash_attention.py:297"),
        "dropout_residual_device_seed": ("dropout_residual.cu",
                                         "dropout_residual.py:41"),
        "dropout_residual_bwd_device_seed": ("dropout_residual.cu",
                                             "dropout_residual.py:99"),
        "dropout": ("dropout.cu", "../nn_ops.py:388"),
        "dropout_device_key": ("dropout.cu", "../nn_ops.py:388"),
        "dropout_bwd": ("dropout.cu", "../nn_ops.py:388"),
    }
    missing = [k for k in where if not launches.get(k)]
    if missing:
        fail(f"kernels {missing} were not launched on any path")
    rows = []
    for name, (src, tpu) in where.items():
        r = main_rows[name]
        rows.append({"name": name, "route": "cuda", "source": SRC + src,
                     "replaces": os.path.normpath(TPU + tpu),
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    for name, (old, what) in EARLIER_MS.items():
        r = main_rows[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        ratio = "" if old is None else f" ({r['ms'] / old:.3f}x)"
        if old is not None and what == "unchanged" and r["ms"] > 1.05 * old:
            ratio += " OUTSIDE 5%"
        before = "n/a" if old is None else f"{old:.5f} ms"
        print(f"{what} {name} ({r['shape']}): before {before}, now "
              f"{r['ms']:.5f} ms{ratio}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), library {lib} ms", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
