"""RNN loops (port of ``simple_tensorflow_tpu/ops/rnn.py``; ref:
tensorflow/python/ops/rnn.py): ``dynamic_rnn`` is one ``scan`` over time
(``ops/functional_ops.py``) instead of the reference's while_loop and
TensorArray, with ``sequence_length`` select-masking; ``static_rnn`` is
unrolled in Python; ``bidirectional_dynamic_rnn`` runs two of them, the
second on the reversed inputs. As in JAX, ``dynamic_rnn`` calls the cell
once outside the loop (the probe) so that its variables are made in the
root graph and captured into the body; the probe's output feeds only a
``ZerosLike`` of static shape, so a run does not compute it
(``lowering.shape_only``). ``raw_rnn`` is the JAX function's
``while_loop`` with a ``TensorArray`` of ``maximum_iterations`` slots.
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
    """(ref: rnn.py ``raw_rnn``): the emit-driven RNN loop over
    ``while_loop`` and a ``TensorArray``, as the JAX function (rnn.py
    :116-205) builds it.

    loop_fn(time, cell_output, cell_state, loop_state) ->
        (finished, next_input, next_cell_state, emit_output, next_loop_state)

    ``maximum_iterations`` is required: the emit TensorArray has exactly
    that many slots, and the loop stops early when every sequence reports
    finished. The bound also makes the loop differentiable. Returns
    (emit_ta, final_state, final_loop_state).
    """
    from . import control_flow_ops as cf
    from . import tensor_array_ops as ta_ops

    if maximum_iterations is None:
        raise ValueError(
            "raw_rnn on TPU needs maximum_iterations= (XLA loops are "
            "bounded; the reference grows TensorArrays dynamically)")
    T = int(maximum_iterations)

    with vs.variable_scope(scope or "rnn", reuse=vs.AUTO_REUSE):
        time0 = constant_op.constant(0, dtype="int32")
        finished0, input0, state0, emit0, loop_state0 = loop_fn(
            time0, None, None, None)
        finished0 = ops_mod.convert_to_tensor(finished0)
        # the cell traced once outside the loop: its variables are made in
        # the enclosing scope, and the emit structure is known when
        # loop_fn(0) returned None for it
        out_probe, _ = cell(input0, state0)
        if emit0 is None:
            emit0 = array_ops.zeros_like(out_probe)
        has_loop_state = loop_state0 is not None

        emit_ta0 = ta_ops.TensorArray(emit0.dtype, size=T,
                                      element_shape=emit0.shape)
        carry0 = [time0, finished0, input0, state0, emit_ta0._buffer]
        if has_loop_state:
            carry0.append(loop_state0)

        def _cond(t, finished, *_rest):
            return math_ops.logical_and(
                t < T, math_ops.logical_not(math_ops.reduce_all(finished)))

        def _body(t, finished, inp, state, emit_buf, *maybe_ls):
            ls = maybe_ls[0] if has_loop_state else None
            # traced inside the enclosing AUTO_REUSE scope: the cell reuses
            # the probe's variables
            output, new_state = cell(inp, state)
            (next_finished, next_input, next_state, emit,
             next_ls) = loop_fn(t + 1, output, new_state, ls)
            if emit is None:
                emit = array_ops.zeros_like(output)
            # finished sequences emit zeros and freeze their state, by
            # select, so a NaN the cell makes past the end cannot leak
            live = array_ops.reshape(math_ops.logical_not(finished),
                                     [-1] + [1] * (emit.shape.rank - 1))
            emit = array_ops.where(live, emit, array_ops.zeros_like(emit))
            frozen = []
            for old, new in zip(_flatten(state), _flatten(next_state)):
                m = array_ops.reshape(
                    math_ops.logical_not(finished),
                    [-1] + [1] * (new.shape.rank - 1))
                frozen.append(array_ops.where(m, new, old))
            next_state = _pack_like(next_state, frozen)
            ta = ta_ops.TensorArray(emit.dtype, size=T, _buffer=emit_buf)
            new_buf = ta.write(t, emit)._buffer
            next_finished = math_ops.logical_or(
                finished, ops_mod.convert_to_tensor(next_finished))
            out = [t + 1, next_finished, next_input, next_state, new_buf]
            if has_loop_state:
                out.append(next_ls)
            return out

        final = cf.while_loop(_cond, _body, carry0, maximum_iterations=T)
        _, _, _, state_f, emit_buf_f = final[:5]
        loop_state_f = final[5] if has_loop_state else None
        emit_ta = ta_ops.TensorArray(emit0.dtype, size=T,
                                     _buffer=emit_buf_f)
        return emit_ta, state_f, loop_state_f
