"""Graph layer base class (port of ``simple_tensorflow_tpu/layers/
base.py``; ref: tensorflow/python/layers/base.py). Variables are created
through ``get_variable`` under the layer's variable scope, so their names
are the JAX package's (``convnet/conv1/kernel``); calling a layer builds
graph ops."""

from __future__ import annotations

from ..framework import graph as ops_mod
from ..ops import variable_scope as vs

GraphKeys = ops_mod.GraphKeys


class Layer:
    """(ref: base.py:64 ``class Layer``)."""

    def __init__(self, trainable=True, name=None, dtype=None):
        self.trainable = trainable
        self._name = name or self.__class__.__name__.lower()
        self.dtype = dtype
        self.built = False
        self._trainable_weights = []
        self._non_trainable_weights = []
        self._scope_name = None

    @property
    def name(self):
        return self._name

    @property
    def trainable_weights(self):
        return list(self._trainable_weights)

    @property
    def non_trainable_weights(self):
        return list(self._non_trainable_weights)

    @property
    def weights(self):
        return self.trainable_weights + self.non_trainable_weights

    def add_variable(self, name, shape, dtype=None, initializer=None,
                     trainable=True):
        v = vs.get_variable(name, shape=shape, dtype=dtype or self.dtype,
                            initializer=initializer,
                            trainable=trainable and self.trainable)
        if trainable and self.trainable:
            self._trainable_weights.append(v)
        else:
            self._non_trainable_weights.append(v)
        return v

    def build(self, input_shape):
        self.built = True

    def call(self, inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, inputs, *args, **kwargs):
        with vs.variable_scope(self._name, reuse=vs.AUTO_REUSE) as scope:
            self._scope_name = scope.name
            if not self.built:
                t = inputs[0] if isinstance(inputs, (list, tuple)) \
                    else inputs
                if self.dtype is None:
                    self.dtype = t.dtype.base_dtype
                self.build(t.shape)
            return self.call(inputs, *args, **kwargs)
