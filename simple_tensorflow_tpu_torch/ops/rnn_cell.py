"""RNN cells (port of ``simple_tensorflow_tpu/ops/rnn_cell.py``; ref:
tensorflow/python/ops/rnn_cell_impl.py).

Cells are graph-building callables as in the reference: ``_linear``,
``BasicRNNCell``, ``GRUCell``, ``BasicLSTMCell`` (``LSTMCell``),
``MultiRNNCell``, ``DropoutWrapper`` and ``ResidualWrapper``, with JAX's
op types, names, variable names (``.../basic_lstm_cell/linear/kernel``)
and default initializers, so a graph seed draws the same initial values.
The loop around them is ``ops/rnn.py``. The LSTM's matrix products are
plain ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import collections

from . import array_ops, init_ops, math_ops, nn_ops
from . import variable_scope as vs

LSTMStateTuple = collections.namedtuple("LSTMStateTuple", ("c", "h"))


class RNNCell:
    """(ref: rnn_cell_impl.py:104 ``class RNNCell``)."""

    @property
    def state_size(self):
        raise NotImplementedError

    @property
    def output_size(self):
        raise NotImplementedError

    def __call__(self, inputs, state, scope=None):
        raise NotImplementedError

    def zero_state(self, batch_size, dtype):
        def mk(size):
            return array_ops.zeros([int(batch_size), int(size)], dtype)

        ss = self.state_size
        if isinstance(ss, LSTMStateTuple):
            return LSTMStateTuple(mk(ss.c), mk(ss.h))
        if isinstance(ss, (list, tuple)):
            return tuple(s.zero_state(batch_size, dtype)
                         if isinstance(s, RNNCell) else mk(s) for s in ss)
        return mk(ss)


def _linear(args, output_size, bias, bias_start=0.0, scope_name="linear"):
    if not isinstance(args, (list, tuple)):
        args = [args]
    total = sum(a.shape[-1].value for a in args)
    dtype = args[0].dtype.base_dtype
    w = vs.get_variable(f"{scope_name}/kernel", [total, output_size],
                        dtype=dtype)
    x = args[0] if len(args) == 1 else array_ops.concat(list(args), 1)
    out = math_ops.matmul(x, w._ref)
    if bias:
        b = vs.get_variable(f"{scope_name}/bias", [output_size], dtype=dtype,
                            initializer=init_ops.Constant(bias_start,
                                                          dtype=dtype))
        out = nn_ops.bias_add(out, b._ref)
    return out


class BasicRNNCell(RNNCell):
    def __init__(self, num_units, activation=math_ops.tanh, reuse=None):
        self._num_units = num_units
        self._activation = activation

    @property
    def state_size(self):
        return self._num_units

    @property
    def output_size(self):
        return self._num_units

    def __call__(self, inputs, state, scope=None):
        with vs.variable_scope(scope or "basic_rnn_cell",
                               reuse=vs.AUTO_REUSE):
            out = self._activation(_linear([inputs, state], self._num_units,
                                           True))
        return out, out


class GRUCell(RNNCell):
    """(ref: rnn_cell_impl.py ``GRUCell``)."""

    def __init__(self, num_units, activation=math_ops.tanh, reuse=None):
        self._num_units = num_units
        self._activation = activation

    @property
    def state_size(self):
        return self._num_units

    @property
    def output_size(self):
        return self._num_units

    def __call__(self, inputs, state, scope=None):
        with vs.variable_scope(scope or "gru_cell", reuse=vs.AUTO_REUSE):
            gates = math_ops.sigmoid(_linear([inputs, state],
                                             2 * self._num_units, True, 1.0,
                                             "gates"))
            r = gates[:, :self._num_units]
            u = gates[:, self._num_units:]
            c = self._activation(_linear([inputs, r * state], self._num_units,
                                         True, 0.0, "candidate"))
            new_h = u * state + (1 - u) * c
        return new_h, new_h


class BasicLSTMCell(RNNCell):
    """(ref: rnn_cell_impl.py ``BasicLSTMCell``)."""

    def __init__(self, num_units, forget_bias=1.0, state_is_tuple=True,
                 activation=math_ops.tanh, reuse=None):
        self._num_units = num_units
        self._forget_bias = forget_bias
        self._state_is_tuple = state_is_tuple
        self._activation = activation

    @property
    def state_size(self):
        if self._state_is_tuple:
            return LSTMStateTuple(self._num_units, self._num_units)
        return 2 * self._num_units

    @property
    def output_size(self):
        return self._num_units

    def __call__(self, inputs, state, scope=None):
        with vs.variable_scope(scope or "basic_lstm_cell",
                               reuse=vs.AUTO_REUSE):
            if self._state_is_tuple:
                c, h = state
            else:
                c = state[:, :self._num_units]
                h = state[:, self._num_units:]
            concat = _linear([inputs, h], 4 * self._num_units, True)
            n = self._num_units
            i, j, f, o = (concat[:, :n], concat[:, n:2 * n],
                          concat[:, 2 * n:3 * n], concat[:, 3 * n:])
            new_c = (c * math_ops.sigmoid(f + self._forget_bias) +
                     math_ops.sigmoid(i) * self._activation(j))
            new_h = self._activation(new_c) * math_ops.sigmoid(o)
            if self._state_is_tuple:
                return new_h, LSTMStateTuple(new_c, new_h)
            return new_h, array_ops.concat([new_c, new_h], 1)


LSTMCell = BasicLSTMCell


class MultiRNNCell(RNNCell):
    def __init__(self, cells, state_is_tuple=True):
        self._cells = list(cells)
        self._state_is_tuple = state_is_tuple

    @property
    def state_size(self):
        return tuple(c.state_size for c in self._cells)

    @property
    def output_size(self):
        return self._cells[-1].output_size

    def zero_state(self, batch_size, dtype):
        return tuple(c.zero_state(batch_size, dtype) for c in self._cells)

    def __call__(self, inputs, state, scope=None):
        new_states = []
        cur = inputs
        with vs.variable_scope(scope or "multi_rnn_cell",
                               reuse=vs.AUTO_REUSE):
            for i, cell in enumerate(self._cells):
                with vs.variable_scope(f"cell_{i}", reuse=vs.AUTO_REUSE):
                    cur, new_s = cell(cur, state[i])
                    new_states.append(new_s)
        return cur, tuple(new_states)


class DropoutWrapper(RNNCell):
    def __init__(self, cell, input_keep_prob=1.0, output_keep_prob=1.0,
                 state_keep_prob=1.0, seed=None):
        self._cell = cell
        self._ikp, self._okp, self._skp = (input_keep_prob, output_keep_prob,
                                           state_keep_prob)
        self._seed = seed

    @property
    def state_size(self):
        return self._cell.state_size

    @property
    def output_size(self):
        return self._cell.output_size

    def zero_state(self, batch_size, dtype):
        return self._cell.zero_state(batch_size, dtype)

    def __call__(self, inputs, state, scope=None):
        if self._ikp < 1.0:
            inputs = nn_ops.dropout(inputs, keep_prob=self._ikp,
                                    seed=self._seed)
        out, new_state = self._cell(inputs, state, scope)
        if self._okp < 1.0:
            out = nn_ops.dropout(out, keep_prob=self._okp, seed=self._seed)
        return out, new_state


class ResidualWrapper(RNNCell):
    def __init__(self, cell):
        self._cell = cell

    @property
    def state_size(self):
        return self._cell.state_size

    @property
    def output_size(self):
        return self._cell.output_size

    def zero_state(self, batch_size, dtype):
        return self._cell.zero_state(batch_size, dtype)

    def __call__(self, inputs, state, scope=None):
        out, new_state = self._cell(inputs, state, scope)
        return inputs + out, new_state
