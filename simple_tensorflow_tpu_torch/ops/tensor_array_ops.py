"""``TensorArray``: a stacked dense buffer of static ``size``.

Port of ``simple_tensorflow_tpu/ops/tensor_array_ops.py`` (ref:
tensorflow/python/ops/tensor_array_ops.py). The reference's per-step
resource of separately sized buffers becomes, as in JAX, one ``(size,
*element_shape)`` buffer threaded functionally: every mutator returns a
new ``TensorArray`` over the op's output buffer (the buffer is the flow).
``TensorArrayWrite`` is ``index_copy`` of one row, ``TensorArrayRead``
the row at a device index (``index_select``, no host read of the index),
``TensorArrayScatter`` ``index_copy`` of several rows. Inside a
``while_loop`` the buffer is a loop var, which a captured loop carries in
one buffer that each iteration's write is copied into
(``ops/control_flow_ops.py``). ``size`` and ``element_shape`` are
static; ``dynamic_size=True`` raises, as in JAX.
"""

from __future__ import annotations

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from .op_util import make_op


def _write(buf, index, value):
    return buf.index_copy(0, index.reshape(1).long(),
                          value.to(buf.dtype).unsqueeze(0))


def _read(buf, index):
    return buf.index_select(0, index.reshape(1).long()).squeeze(0)


def _scatter(buf, indices, values):
    return buf.index_copy(0, indices.reshape(-1).long(),
                          values.to(buf.dtype))


op_registry.register_pure("TensorArrayWrite", _write)
op_registry.register_pure("TensorArrayRead", _read)
op_registry.register_pure("TensorArrayScatter", _scatter)


class TensorArray:
    """Functional TensorArray; every mutator returns a new TensorArray
    sharing the graph (the reference mutates a resource and returns a flow
    token, ref tensor_array_ops.py:120; here the buffer is the flow)."""

    def __init__(self, dtype, size=None, element_shape=None,
                 dynamic_size=False, clear_after_read=True,
                 tensor_array_name=None, infer_shape=True, name=None,
                 _buffer=None):
        if dynamic_size:
            raise NotImplementedError(
                "dynamic_size=True needs dynamic shapes; XLA/TPU requires "
                "a static size (use a python list at graph-build time)")
        self._dtype = dtypes_mod.as_dtype(dtype)
        self._name = name or "TensorArray"
        if _buffer is not None:
            self._buffer = _buffer
            self._size = int(_buffer.shape[0])
            return
        if size is None:
            raise ValueError("TensorArray needs a static size")
        self._size = int(size) if not isinstance(size, ops_mod.Tensor) \
            else int(size.op.attrs.get("value"))
        if element_shape is None:
            raise ValueError(
                "TPU TensorArray needs element_shape up front (static "
                "shapes); pass element_shape= or use ta.unstack")
        es = shape_mod.TensorShape(element_shape).as_list()
        from . import array_ops

        self._buffer = array_ops.zeros([self._size] + es, dtype=self._dtype,
                                       name=f"{self._name}_buf")

    @property
    def dtype(self):
        return self._dtype

    @property
    def flow(self):
        """The buffer doubles as the flow token (ref flow_out)."""
        return self._buffer

    def size(self, name=None):
        from ..framework import constant_op

        return constant_op.constant(self._size, dtype=dtypes_mod.int32)

    def _with(self, buffer):
        return TensorArray(self._dtype, name=self._name, _buffer=buffer)

    def write(self, index, value, name=None):
        index = ops_mod.convert_to_tensor(index, dtype=dtypes_mod.int32)
        value = ops_mod.convert_to_tensor(value, dtype=self._dtype)
        buf = make_op("TensorArrayWrite", [self._buffer, index, value],
                      name=name or f"{self._name}_write")
        return self._with(buf)

    def read(self, index, name=None):
        index = ops_mod.convert_to_tensor(index, dtype=dtypes_mod.int32)
        return make_op("TensorArrayRead", [self._buffer, index],
                       name=name or f"{self._name}_read")

    def stack(self, name=None):
        from . import array_ops

        return array_ops.identity(self._buffer,
                                  name=name or f"{self._name}_stack")

    def unstack(self, value, name=None):
        value = ops_mod.convert_to_tensor(value, dtype=self._dtype)
        return self._with(value)

    def gather(self, indices, name=None):
        from . import array_ops

        return array_ops.gather(self._buffer, indices,
                                name=name or f"{self._name}_gather")

    def scatter(self, indices, value, name=None):
        indices = ops_mod.convert_to_tensor(indices, dtype=dtypes_mod.int32)
        value = ops_mod.convert_to_tensor(value, dtype=self._dtype)
        buf = make_op("TensorArrayScatter", [self._buffer, indices, value],
                      name=name or f"{self._name}_scatter")
        return self._with(buf)

    def concat(self, name=None):
        from . import array_ops

        shp = self._buffer.shape.as_list()
        return array_ops.reshape(
            self._buffer, [-1] + shp[2:],
            name=name or f"{self._name}_concat")

    def split(self, value, lengths, name=None):
        """Equal-length split only (static shapes)."""
        from . import array_ops

        value = ops_mod.convert_to_tensor(value, dtype=self._dtype)
        n = self._size
        shp = value.shape.as_list()
        if shp[0] is None or shp[0] % n != 0:
            raise ValueError("TPU TensorArray.split needs equal static "
                             f"lengths; got leading dim {shp[0]} over {n}")
        return self._with(array_ops.reshape(
            value, [n, shp[0] // n] + shp[1:],
            name=name or f"{self._name}_split"))

    def grad(self, source, flow=None, name=None):
        return self  # gradients flow through the buffer

    def identity(self):
        return self

    def close(self, name=None):
        from . import control_flow_ops

        return control_flow_ops.no_op(name=name or f"{self._name}_close")
