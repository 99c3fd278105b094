"""Graph layer base class (port of ``simple_tensorflow_tpu/layers/
base.py``; ref: tensorflow/python/layers/base.py). Variables are created
through ``get_variable`` under the layer's variable scope, so their names
are the JAX package's (``convnet/conv1/kernel``); calling a layer builds
graph ops. ``add_update`` and ``add_loss`` put a layer's update ops in
``GraphKeys.UPDATE_OPS`` and its losses in ``REGULARIZATION_LOSSES``
(:66-80), which nothing runs unless the user fetches them."""

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
        self._updates = []
        self._losses = []
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

    @property
    def updates(self):
        return list(self._updates)

    @property
    def losses(self):
        return list(self._losses)

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

    def add_update(self, updates):
        if not isinstance(updates, (list, tuple)):
            updates = [updates]
        self._updates.extend(updates)
        g = ops_mod.get_default_graph()
        for u in updates:
            g.add_to_collection(GraphKeys.UPDATE_OPS, u)

    def add_loss(self, losses):
        if not isinstance(losses, (list, tuple)):
            losses = [losses]
        self._losses.extend(losses)
        g = ops_mod.get_default_graph()
        for loss in losses:
            g.add_to_collection(GraphKeys.REGULARIZATION_LOSSES, loss)

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
