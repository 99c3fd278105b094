"""ResNet-50 v1.5 for ImageNet, trained with Momentum.

Port of ``simple_tensorflow_tpu/models/resnet.py``, twice:

- the training graph, the JAX code with the port's imports:
  :func:`resnet_forward` (:56) and :func:`resnet50_train_model` (:120),
  which return the JAX dict ``{images, labels, logits, loss, train_op,
  accuracy, global_step}`` for ``stf.Session`` (``FusedBatchNorm`` with
  its moving-average assigns in ``UPDATE_OPS``, which the ``train_op``
  never runs; ``L2Loss`` over every ``kernel`` variable cast to f32;
  ``add_n``; one ``FusedMomentumUpdate`` over two flat groups, the bf16
  convolution kernels and the f32 BatchNorm and ``fc`` variables);
- eager PyTorch, below.

- :class:`ResNet` is ``resnet_forward`` (:56): NHWC activations (the JAX
  layout; in PyTorch's NCHW terms, channels_last memory), conv kernels and
  activations in the model dtype (bf16 for training), f32 BatchNorm
  parameters, the global pool in f32 returning the model dtype, then an
  f32 ``fc``. v1.5: a projection block strides in its 3x3 conv
  (:51). Module names follow the JAX variable scopes, so a
  ``state_dict`` key is the JAX variable path under ``resnet/`` with
  ``.`` for ``/`` (``stage0_block0.conv1.kernel``); a projection block
  creates ``proj_conv``/``proj_bn`` before ``conv1`` (:46-49), and
  ``parameters()`` keeps that creation order, which is the order of the
  optimizer's flat layout.
- :func:`resnet50_trainer` and :class:`ResNetTrainer`, the
  counterpart of the JAX dict ``{loss, train_op, accuracy,
  global_step}``: the mean sparse softmax cross-entropy (through the
  softmax-xent kernels) plus ``weight_decay`` times the l2 of every
  ``kernel`` variable in f32 (not BatchNorm, not the fc bias), and one
  :class:`..train.optimizers.FlatMomentum` step (the fused Momentum
  kernel, one launch per flat group).

BatchNorm's moving statistics are not updated by a training step, as the
JAX ``train_op`` leaves them (:mod:`..layers.normalization`).
``recompute=True`` puts each bottleneck block of the graph under
``stf.recompute_grad`` (``common.maybe_recompute``); the bodies'
moving-average assigns never run, as in JAX;
``resnet50_train_model(recompute="auto")`` resolves it from the static
cost model against the attached device (``framework/cost_model.py``).
``data_parallel`` and ``conv0_space_to_depth`` are not ported yet: both
entry points raise ``NotImplementedError`` when one is set (the eager
trainer takes no ``recompute`` either).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch import nn

import simple_tensorflow_tpu_torch as stf

from ..layers.convolutional import Conv2DModule
from ..layers.core import DenseModule
from ..layers.normalization import BatchNormalizationModule
from ..layers.pooling import _max_pooling2d_impl
from ..ops import fused_ops, nn_ops
from ..ops.kernels.fused_update import momentum_update, momentum_update_plain
from ..train.optimizers import FlatMomentum
from . import common
from .common import resolve_device

_BLOCKS = {  # per-stage bottleneck counts
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def _not_ported(data_parallel, recompute, conv0_space_to_depth, fn):
    for flag, value in (("data_parallel", data_parallel),
                        ("recompute", recompute),
                        ("conv0_space_to_depth", conv0_space_to_depth)):
        if value:
            raise NotImplementedError(
                f"{fn}({flag}={value!r}) is not ported yet: it comes with a "
                "later slice of the port (data parallelism with the Graph "
                "front end, the space-to-depth stem after it)")


# ---------------------------------------------------------------------------
# The training graph (TF-1 front end)
# ---------------------------------------------------------------------------

def _conv(x, filters, ksize, stride, name):
    init = stf.init_ops.VarianceScaling(2.0, "fan_out", "truncated_normal")
    return stf.layers.conv2d(
        x, filters, ksize, strides=stride,
        padding="same", use_bias=False, kernel_initializer=init, name=name)


def _bn(x, training, name):
    return stf.layers.batch_normalization(
        x, momentum=0.9, epsilon=1e-5, training=training, fused=True,
        name=name)


def _bottleneck(x, filters, stride, training, projection, name):
    with stf.variable_scope(name):
        shortcut = x
        if projection:
            shortcut = _conv(x, 4 * filters, 1, stride, "proj_conv")
            shortcut = _bn(shortcut, training, "proj_bn")
        y = _conv(x, filters, 1, 1, "conv1")
        y = stf.nn.relu(_bn(y, training, "bn1"))
        y = _conv(y, filters, 3, stride, "conv2")  # v1.5: stride here
        y = stf.nn.relu(_bn(y, training, "bn2"))
        y = _conv(y, 4 * filters, 1, 1, "conv3")
        y = _bn(y, training, "bn3")
        return stf.nn.relu(y + shortcut)


def resnet_forward(x, num_classes=1000, depth=50, training=True,
                   recompute=False, conv0_space_to_depth=False):
    """The forward graph (:56): NHWC ``x`` -> f32 logits."""
    # the graph takes recompute=True (and "auto", truthy, as in JAX)
    _not_ported(False, False, conv0_space_to_depth, "resnet_forward")
    blocks = _BLOCKS[depth]
    with stf.variable_scope("resnet", reuse=stf.AUTO_REUSE):
        h = _conv(x, 64, 7, 2, "conv0")
        h = stf.nn.relu(_bn(h, training, "bn0"))
        h = stf.layers.max_pooling2d(h, 3, 2, padding="same", name="pool0")
        block_idx = 0
        for stage, n_blocks in enumerate(blocks):
            filters = 64 * (2 ** stage)
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1

                def block_fn(hh, _bi, filters=filters, stride=stride,
                             projection=(i == 0),
                             name=f"stage{stage}_block{i}"):
                    return _bottleneck(hh, filters, stride, training,
                                       projection=projection, name=name)

                h = common.maybe_recompute(block_fn, h, block_idx,
                                           recompute, "resnet_block")
                block_idx += 1
        h = stf.reduce_mean(h, axis=[1, 2], name="global_pool")  # NHWC pool
        h = stf.cast(h, stf.float32)
        logits = stf.layers.dense(
            h, num_classes,
            kernel_initializer=stf.init_ops.RandomNormal(stddev=0.01),
            name="fc")
    return logits


def resnet50_train_model(batch_size=64, image_size=224, num_classes=1000,
                         dtype=stf.bfloat16, learning_rate=0.1,
                         momentum=0.9, weight_decay=1e-4,
                         data_parallel=False, recompute=False,
                         conv0_space_to_depth=False):
    """Full training graph (:120): images -> loss -> momentum-SGD update.
    recompute="auto" resolves from the static per-chip activation estimate
    against the attached device (framework/cost_model.py)."""
    _not_ported(data_parallel, False, conv0_space_to_depth,
                "resnet50_train_model")
    x = stf.placeholder(dtype, [batch_size, image_size, image_size, 3],
                        name="images")
    labels = stf.placeholder(stf.int32, [batch_size], name="labels")
    from ..framework import cost_model as _cm

    _shards = _cm.mesh_shard_factor(["dp"] if data_parallel else [])
    recompute = _cm.resolve_recompute(
        recompute,
        _cm.resnet_activation_bytes(batch_size, image_size,
                                    dtype_bytes=dtype.size) / _shards,
        forward_flops=resnet_flops_per_image(50, image_size)
        * batch_size / _shards)
    logits = resnet_forward(x, num_classes=num_classes, training=True,
                            recompute=recompute)
    xent = stf.reduce_mean(stf.nn.sparse_softmax_cross_entropy_with_logits(
        labels=labels, logits=logits))
    # L2 on conv/fc kernels only (reference recipe: no BN params)
    l2 = [stf.nn.l2_loss(stf.cast(v._ref, stf.float32))
          for v in stf.trainable_variables()
          if "kernel" in v.var_name]
    loss = xent + weight_decay * stf.add_n(l2)
    gs = stf.train.get_or_create_global_step()
    opt = stf.train.MomentumOptimizer(learning_rate, momentum)
    train_op = opt.minimize(loss, global_step=gs)
    acc = stf.reduce_mean(stf.cast(
        stf.equal(stf.cast(stf.argmax(logits, 1, output_type=stf.int32),
                           stf.int32), labels), stf.float32))
    return {"images": x, "labels": labels, "logits": logits, "loss": loss,
            "train_op": train_op, "accuracy": acc, "global_step": gs}


# ---------------------------------------------------------------------------
# Eager PyTorch
# ---------------------------------------------------------------------------

def _conv_module(in_ch, filters, ksize, stride, dtype, device):
    return Conv2DModule(in_ch, filters, ksize, stride, padding="same",
                        use_bias=False, dtype=dtype, device=device)


def _bn_module(channels, device):
    return BatchNormalizationModule(channels, epsilon=1e-5, device=device)


class Bottleneck(nn.Module):
    """``_bottleneck`` (:41): 1x1, 3x3 (stride here, v1.5), 1x1 to four
    times ``filters``, each followed by BatchNorm; a projection shortcut
    on a stage's first block."""

    def __init__(self, in_ch, filters, stride, projection, dtype, device):
        super().__init__()
        if projection:
            self.proj_conv = _conv_module(in_ch, 4 * filters, 1, stride,
                                          dtype, device)
            self.proj_bn = _bn_module(4 * filters, device)
        else:
            self.proj_conv = self.proj_bn = None
        self.conv1 = _conv_module(in_ch, filters, 1, 1, dtype, device)
        self.bn1 = _bn_module(filters, device)
        self.conv2 = _conv_module(filters, filters, 3, stride, dtype,
                                  device)
        self.bn2 = _bn_module(filters, device)
        self.conv3 = _conv_module(filters, 4 * filters, 1, 1, dtype, device)
        self.bn3 = _bn_module(4 * filters, device)

    def forward(self, x):
        shortcut = x
        if self.proj_conv is not None:
            shortcut = self.proj_bn(self.proj_conv(x))
        y = nn_ops._relu_impl(self.bn1(self.conv1(x)))
        y = nn_ops._relu_impl(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return nn_ops._relu_impl(y + shortcut)


class ResNet(nn.Module):
    """``resnet_forward`` (module docstring): NHWC images ``(B, H, W, 3)``
    in ``dtype`` -> f32 logits ``(B, num_classes)``. BatchNorm uses the
    batch statistics in training mode (``module.train()``, the default)
    and the moving ones in ``module.eval()``."""

    def __init__(self, depth=50, num_classes=1000, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        if depth not in _BLOCKS:
            raise ValueError(f"depth must be one of {sorted(_BLOCKS)}: "
                             f"{depth}")
        self.conv0 = _conv_module(3, 64, 7, 2, dtype, device)
        self.bn0 = _bn_module(64, device)
        in_ch = 64
        self.blocks = []
        for stage, n_blocks in enumerate(_BLOCKS[depth]):
            filters = 64 * 2 ** stage
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                block = Bottleneck(in_ch, filters, stride, i == 0, dtype,
                                   device)
                self.add_module(f"stage{stage}_block{i}", block)
                self.blocks.append(block)
                in_ch = 4 * filters
        self.fc = DenseModule(in_ch, num_classes, dtype=torch.float32,
                              device=device)

    def forward(self, x):
        h = nn_ops._relu_impl(self.bn0(self.conv0(x)))
        h = _max_pooling2d_impl(h, 3, 2, padding="same")
        for block in self.blocks:
            h = block(h)
        # jnp.mean over H, W: summed in f32, returned in h's dtype
        h = h.float().mean(dim=(1, 2)).to(h.dtype)
        return self.fc(h.float())


class ResNetTrainer:
    """The port's counterpart of the JAX training dict (module
    docstring): the model (:attr:`model`), a
    :class:`..train.optimizers.FlatMomentum` (:attr:`optimizer`) and
    the global step. :meth:`step` runs forward, backward and the fused
    Momentum update, then increments the global step.

    ``plain=True`` runs the whole step (the softmax-xent under
    :func:`..ops.fused_ops.plain_versions` and the plain Momentum update)
    through the kernels' plain PyTorch versions on any device: the
    reference the kernel step is held against on the card."""

    def __init__(self, batch_size, image_size, num_classes, dtype,
                 learning_rate, momentum, weight_decay, state, device,
                 plain=False):
        self.device = device
        self.batch_size = int(batch_size)
        self.image_size = int(image_size)
        self.dtype = dtype
        self.weight_decay = float(weight_decay)
        self.plain = bool(plain)
        self.model = ResNet(50, num_classes, dtype, device)
        self.model.load_state_dict(state)
        self.model.train()
        # the variables the recipe's weight decay covers: every conv and
        # the fc kernel, in creation order
        self.kernels = [p for name, p in self.model.named_parameters()
                        if name.endswith("kernel")]
        self.optimizer = FlatMomentum(
            self.model.parameters(), learning_rate, momentum,
            update=momentum_update_plain if self.plain else momentum_update)
        self.global_step = 0

    def _batch(self, images, labels):
        images = torch.as_tensor(images).to(self.device, self.dtype)
        labels = torch.as_tensor(labels).to(self.device, torch.int32)
        want = (self.batch_size, self.image_size, self.image_size, 3)
        if tuple(images.shape) != want or \
                tuple(labels.shape) != (self.batch_size,):
            raise ValueError(f"images must be {want} and labels "
                             f"({self.batch_size},), got "
                             f"{tuple(images.shape)}, {tuple(labels.shape)}")
        return images, labels

    def loss(self, images, labels):
        """The f32 training loss of one batch, recorded for autograd:
        mean xent plus ``weight_decay`` times the summed l2 of the
        kernels, each cast to f32 (summed in creation order, as
        ``add_n``)."""
        images, labels = self._batch(images, labels)
        with (fused_ops.plain_versions() if self.plain
              else contextlib.nullcontext()):
            logits = self.model(images)
            xent = nn_ops._sparse_softmax_xent_impl(
                labels, logits).mean()
        l2 = [nn_ops._l2_loss_impl(k.float()) for k in self.kernels]
        return xent + self.weight_decay * sum(l2[1:], l2[0])

    def loss_and_grads(self, images, labels):
        """Forward and backward without an update: the loss, with the
        gradients left in the optimizer's flat buffers (each parameter's
        ``.grad``)."""
        self.optimizer.zero_grad()
        loss = self.loss(images, labels)
        loss.backward()
        return loss.detach()

    def step(self, images, labels):
        """One training step; returns the step's f32 loss (a device
        scalar: reading it waits for the step)."""
        loss = self.loss_and_grads(images, labels)
        self.optimizer.step()
        self.global_step += 1
        return loss

    @torch.no_grad()
    def accuracy(self, images, labels):
        """The share of the batch whose argmax logit is its label (f32
        device scalar), from a training-mode forward as the JAX dict's
        ``accuracy`` (batch statistics; nothing is updated)."""
        images, labels = self._batch(images, labels)
        logits = self.model(images)
        return (torch.argmax(logits, dim=1).to(torch.int32)
                == labels).float().mean()


def resnet50_trainer(batch_size=64, image_size=224, num_classes=1000,
                     dtype=torch.bfloat16, learning_rate=0.1, momentum=0.9,
                     weight_decay=1e-4, data_parallel=False, recompute=False,
                     conv0_space_to_depth=False, *, params=None,
                     checkpoint: Optional[str] = None, seed=0,
                     device="cuda", plain=False) -> ResNetTrainer:
    """The eager training model: a :class:`ResNetTrainer` for NHWC
    ``(batch_size, image_size, image_size, 3)`` image batches with the JAX
    function's recipe (ResNet-50 v1.5, Momentum, weight decay on the
    kernels); :func:`resnet50_train_model` builds the same step as a
    graph.

    Weights come from ``checkpoint=`` (a JAX ``.stfz`` prefix; a training
    checkpoint also carries the global step and the flat Momentum slots),
    ``params=`` (a ``state_dict``), or :func:`..convert.init_resnet_params`
    with ``seed``. ``device`` defaults to ``"cuda"`` and raises without a
    card; pass ``device="cpu"`` to run the kernels' plain versions on the
    CPU. ``plain=True`` runs them on any device."""
    from .. import convert

    _not_ported(data_parallel, recompute, conv0_space_to_depth,
                "resnet50_trainer")
    device = resolve_device(device)
    named = None
    if checkpoint is not None:
        named = convert.load_stfz(checkpoint)
        state = convert.resnet_params_from_jax(named, dtype)
    elif params is not None:
        state = params
    else:
        state = convert.init_resnet_params(seed, num_classes=num_classes)
    trainer = ResNetTrainer(batch_size, image_size, num_classes, dtype,
                            learning_rate, momentum, weight_decay, state,
                            device, plain=plain)
    if named is not None:
        convert.load_resnet_training_state(trainer, named)
    return trainer


def resnet_flops_per_image(depth=50, image_size=224, num_classes=1000):
    """Analytic forward FLOPs an image (2 x MACs); a training step is about
    3x the forward."""
    table = {50: 4.089e9, 18: 1.82e9, 34: 3.67e9, 101: 7.8e9, 152: 11.5e9}
    scale = (image_size / 224.0) ** 2
    return table[depth] * scale


def synthetic_imagenet(batch_size, image_size=224, seed=0, dtype=np.float32):
    """Random NHWC images in [0, 1) and labels in [0, 1000), from
    ``numpy.random.RandomState(seed)``: the JAX function's batch."""
    rng = np.random.RandomState(seed)
    images = rng.rand(batch_size, image_size, image_size, 3).astype(dtype)
    labels = rng.randint(0, 1000, size=batch_size).astype(np.int32)
    return images, labels
