"""``SparseTensor`` (ref: tensorflow/python/framework/sparse_tensor.py); the
part of ``simple_tensorflow_tpu/framework/sparse_tensor.py`` that
``parse_example``'s ``VarLenFeature`` outputs need: the COO triple
(indices, values, dense_shape) of graph tensors. Left out:
``SparseTensorValue`` and the sparse ops."""

from __future__ import annotations

from . import dtypes as dtypes_mod
from . import graph as ops_mod


class SparseTensor:
    def __init__(self, indices, values, dense_shape):
        self._indices = ops_mod.convert_to_tensor(indices,
                                                  dtype=dtypes_mod.int64)
        self._values = ops_mod.convert_to_tensor(values)
        self._dense_shape = ops_mod.convert_to_tensor(dense_shape,
                                                      dtype=dtypes_mod.int64)

    @property
    def indices(self):
        return self._indices

    @property
    def values(self):
        return self._values

    @property
    def dense_shape(self):
        return self._dense_shape

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def graph(self):
        return self._values.graph

    def __repr__(self):
        return (f"SparseTensor(indices={self._indices!r}, "
                f"values={self._values!r}, "
                f"dense_shape={self._dense_shape!r})")
