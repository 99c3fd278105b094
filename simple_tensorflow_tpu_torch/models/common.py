"""Building blocks of the port's transformer models.

Port of ``simple_tensorflow_tpu/models/common.py`` (:13-55) and the port's
device rule. The graph helpers ``layer_norm`` (f32 ``gamma``/``beta``
variables and the ``FusedLayerNorm`` op) and ``dense`` (``stf.layers.dense``)
build graph ops, as the JAX functions do; ``split_heads`` and
``merge_heads`` take graph tensors (``Reshape`` and ``Transpose`` ops, as
in JAX) or torch tensors (the eager models). The eager modules are
:class:`LayerNorm` and :class:`..layers.core.DenseModule`. Parameter
names follow the JAX variables, so a module's ``state_dict`` key is the
JAX variable path with ``.`` for ``/`` (``…/ln1/gamma``, ``…/q/kernel``,
``…/q/bias``). Dense kernels are ``(in, out)`` as in JAX. Parameters are
trainable; the serving model switches their gradients off.
:func:`maybe_recompute` puts a layer under ``stf.recompute_grad``, as the
graph models' ``recompute=True`` asks. The two generative models share
:func:`greedy_emit` and :class:`BucketProgram` (one captured program a
serving bucket).
"""

from __future__ import annotations

import torch
from torch import nn

from ..compiler import DeviceGraph, StagedInput, on_side_stream
from ..layers import core
from ..ops import array_ops, init_ops
from ..ops import variable_scope as vs
from ..ops.fused_ops import fused_layer_norm, is_graph_value


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device needs a card: no
    silent move to the CPU. On CUDA, f32 matrix products and cuDNN's f32
    convolutions (the ResNet path's) are pinned to full f32, no TF32: the
    precision the JAX package runs its f32 programs at."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on an NVIDIA "
                "GPU by default — pass device='cpu' to run the kernels' "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class LayerNorm(nn.Module):
    """f32 ``gamma``/``beta`` (whatever the activations' dtype, as
    ``common.layer_norm`` creates them) and the LayerNorm kernels over the
    last axis."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return fused_layer_norm(x, self.gamma, self.beta, eps=self.eps)


def greedy_emit(logits):
    """Greedy pick and its log-probability: ``(tok (n,), logp (n,))``.
    Ties go to the first maximal index, as ``argmax`` does in JAX."""
    logp_all = torch.log_softmax(logits, dim=-1)
    tok = torch.argmax(logits, dim=-1)
    return tok, logp_all.gather(-1, tok[:, None])[:, 0]


class BucketProgram:
    """One serving bucket's program over static inputs (``{name: (shape,
    dtype)}``), captured as a CUDA graph: :meth:`build` warms it up on
    ``pad`` rows and captures it, :meth:`run` stages a bucket's rows and
    replays it, returning the static outputs. On the CPU every run calls
    the function into the same outputs."""

    def __init__(self, fn, specs, device):
        self.inputs = {k: StagedInput(shape, dtype, device)
                       for k, (shape, dtype) in specs.items()}
        self._fn = fn
        self.graph = DeviceGraph(self._call, device)

    def _call(self):
        return self._fn(**{k: v.static for k, v in self.inputs.items()})

    def build(self, pad):
        for k, v in pad.items():
            self.inputs[k].stage(v)
        on_side_stream(self._call, self.graph.device)
        self.graph.capture()

    def run(self, values):
        for k, v in values.items():
            self.inputs[k].stage(v)
        return self.graph.replay()


def layer_norm(x, name, eps=1e-6):
    """gamma/beta (f32) + the fused layer norm over the last axis (graph
    tensors)."""
    with vs.variable_scope(name):
        d = int(x.shape[-1])
        g = vs.get_variable("gamma", [d],
                            initializer=init_ops.ones_initializer())
        b = vs.get_variable("beta", [d],
                            initializer=init_ops.zeros_initializer())
        return fused_layer_norm(x, g, b, eps=eps)


def dense(x, units, initializer, name, activation=None):
    """``stf.layers.dense`` with the given kernel initializer (graph
    tensors; variables in ``x``'s dtype)."""
    return core.dense(x, units, activation=activation,
                      kernel_initializer=initializer, name=name)


def split_heads(x, b, s, heads, head_dim):
    """(B,S,H*D) -> (B,H,S,D)."""
    if is_graph_value(x):
        return array_ops.transpose(
            array_ops.reshape(x, [b, s, heads, head_dim]), [0, 2, 1, 3])
    return x.reshape(b, s, heads, head_dim).permute(0, 2, 1, 3)


def merge_heads(x, b, s, hidden):
    """(B,H,S,D) -> (B,S,H*D)."""
    if is_graph_value(x):
        return array_ops.reshape(array_ops.transpose(x, [0, 2, 1, 3]),
                                 [b, s, hidden])
    return x.permute(0, 2, 1, 3).reshape(b, s, hidden)


def maybe_recompute(layer_fn, h, i, recompute, tag):
    """``layer_fn(h, i)``, under ``stf.recompute_grad`` when ``recompute``
    (:37-55). The throwaway call first creates the layer's variables in
    the root graph (its ops are pruned: nothing fetches them); the loop
    index binds as a default argument, so each layer's lambda is its own
    object (the trace cache keys on the function object)."""
    if not recompute:
        return layer_fn(h, i)
    from ..framework.function import recompute_grad

    layer_fn(h, i)
    return recompute_grad(lambda hh, i=i: layer_fn(hh, i),
                          name=f"{tag}_{i}_rc")(h)
