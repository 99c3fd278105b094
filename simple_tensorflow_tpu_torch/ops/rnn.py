"""RNN loops (port of ``simple_tensorflow_tpu/ops/rnn.py``; ref:
tensorflow/python/ops/rnn.py): ``dynamic_rnn`` is one ``scan`` over time
(``ops/functional_ops.py``) instead of the reference's while_loop and
TensorArray, with ``sequence_length`` select-masking; ``static_rnn`` is
unrolled in Python; ``bidirectional_dynamic_rnn`` runs two of them, the
second on the reversed inputs. As in JAX, ``dynamic_rnn`` calls the cell
once outside the loop (the probe) so that its variables are made in the
root graph and captured into the body; the probe's output feeds only a
``ZerosLike`` of static shape, so a run does not compute it
(``lowering.shape_only``). ``raw_rnn`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..framework import constant_op
from ..framework import graph as ops_mod
from . import array_ops, functional_ops, math_ops
from . import variable_scope as vs
from .control_flow_ops import _flatten, _pack_like


def dynamic_rnn(cell, inputs, sequence_length=None, initial_state=None,
                dtype=None, parallel_iterations=None, swap_memory=False,
                time_major=False, scope=None):
    """(ref: rnn.py:443 ``dynamic_rnn``)."""
    inputs = ops_mod.convert_to_tensor(inputs)
    if not time_major:
        inputs = array_ops.transpose(inputs, [1, 0, 2])  # -> [T, B, D]
    T = inputs.shape[0].value
    batch = inputs.shape[1].value
    if T is None or batch is None:
        raise ValueError("dynamic_rnn needs a static [T, B]")
    if initial_state is not None:
        state = initial_state
    else:
        if dtype is None:
            dtype = inputs.dtype
        state = cell.zero_state(batch, dtype)
    if sequence_length is not None:
        sequence_length = math_ops.cast(
            ops_mod.convert_to_tensor(sequence_length), "int32")

    with vs.variable_scope(scope or "rnn", reuse=vs.AUTO_REUSE):
        # First call creates the variables in the root graph (outside the
        # scan body trace); later calls reuse them.
        out0, _ = cell(inputs[0], state)
        zero_out = array_ops.zeros_like(out0)
        times = constant_op.constant(np.arange(T, dtype=np.int32))

        def body(carry, elem):
            st, _prev_out = carry
            x, t = elem
            out, new_state = cell(x, st)
            if sequence_length is not None:
                # select, not arithmetic masking: NaN/Inf from the cell on
                # post-sequence-end steps must not poison frozen values
                # (NaN * 0.0 == NaN)
                active = math_ops.less(t, sequence_length)
                act = array_ops.expand_dims(active, -1)
                out = array_ops.where(act, out, array_ops.zeros_like(out))
                merged = []
                for old, new in zip(_flatten(st), _flatten(new_state)):
                    merged.append(array_ops.where(act, new, old))
                new_state = _pack_like(new_state, merged)
            return (new_state, out)

        stacked = functional_ops.scan(body, (inputs, times),
                                      initializer=(state, zero_out),
                                      name="rnn_scan")
    state_seq, outputs = stacked
    final_state = _pack_like(state, [s[T - 1] for s in _flatten(state_seq)])
    if not time_major:
        outputs = array_ops.transpose(outputs, [1, 0, 2])
    return outputs, final_state


def static_rnn(cell, inputs, initial_state=None, dtype=None,
               sequence_length=None, scope=None):
    """(ref: rnn.py ``static_rnn``): python-unrolled (XLA still fuses)."""
    if not inputs:
        raise ValueError("inputs must not be empty")
    batch = inputs[0].shape[0].value
    if initial_state is not None:
        state = initial_state
    else:
        if dtype is None:
            dtype = inputs[0].dtype
        state = cell.zero_state(batch, dtype)
    outputs = []
    with vs.variable_scope(scope or "rnn", reuse=vs.AUTO_REUSE):
        for x in inputs:
            out, state = cell(x, state)
            outputs.append(out)
    return outputs, state


def bidirectional_dynamic_rnn(cell_fw, cell_bw, inputs, sequence_length=None,
                              initial_state_fw=None, initial_state_bw=None,
                              dtype=None, parallel_iterations=None,
                              swap_memory=False, time_major=False, scope=None):
    """(ref: rnn.py ``bidirectional_dynamic_rnn``)."""
    with vs.variable_scope(scope or "bidirectional_rnn"):
        with vs.variable_scope("fw"):
            out_fw, st_fw = dynamic_rnn(cell_fw, inputs, sequence_length,
                                        initial_state_fw, dtype,
                                        time_major=time_major)
        inputs_rev = array_ops.reverse(ops_mod.convert_to_tensor(inputs),
                                       [0 if time_major else 1])
        with vs.variable_scope("bw"):
            out_bw, st_bw = dynamic_rnn(cell_bw, inputs_rev, sequence_length,
                                        initial_state_bw, dtype,
                                        time_major=time_major)
        out_bw = array_ops.reverse(out_bw, [0 if time_major else 1])
    return (out_fw, out_bw), (st_fw, st_bw)


def raw_rnn(cell, loop_fn, parallel_iterations=None, swap_memory=False,
            scope=None, maximum_iterations=None):
    """(ref: rnn.py ``raw_rnn``): not ported. Its emit-driven loop is a
    ``while_loop`` with a ``TensorArray``, whose trip count depends on the
    data (ROADMAP Queue 1, front-end item 1)."""
    raise NotImplementedError(
        "raw_rnn is not ported: it needs while_loop and TensorArray on "
        "FuncGraph bodies, ROADMAP Queue 1, front-end item 1 (cond, "
        "while_loop, raw_rnn); dynamic_rnn runs on stf.scan")
