"""Random ops of the port (port of the part of ``simple_tensorflow_tpu/
ops/random_ops.py`` the initializers reach: ``RandomUniform`` and
``RandomStandardNormal``).

No mutable generator state: each op folds its stream id
(``framework/random_seed.fold_in_value``) into the run's root key, and
``_ru`` draws JAX's bits (``framework/prng.py``), so a run draws what the
JAX package's run at the same session run counter draws, bit for bit. The
float form is ``jax.random.uniform``'s: ``u`` in [0, 1) from the bits,
then ``max(minval, u * (maxval - minval) + minval)`` with both bounds in
f32. ``RandomStandardNormal`` is ``_rn`` (:64): ``jax.random.normal`` in
f32 (``prng.normal_torch``, drawn on the device), ``x * stddev + mean``
as XLA compiles it (the constant factors folded, one fused multiply-add),
then the cast to the op's dtype.
Left out: ``truncated_normal``, shuffles and the other samplers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import prng
from ..framework import random_seed as random_seed_mod
from ..framework import tensor_shape as shape_mod


def _ru(key, op, device):
    a = op.attrs
    shape = tuple(a["shape"])
    dt = a["dtype"]
    if dt.is_integer:
        vals = prng.randint(key, shape, int(a["minval"]), int(a["maxval"]))
        return torch.as_tensor(vals).to(device=device, dtype=dt.torch_dtype)
    u = prng.uniform_torch(key, shape, device)
    lo = torch.full((), a["minval"], dtype=torch.float32, device=device)
    hi = torch.full((), a["maxval"], dtype=torch.float32, device=device)
    return torch.maximum(lo, prng.fma_f32_torch(u, hi - lo, lo)).to(
        dt.torch_dtype)


def _lower_random_uniform(ctx, op, inputs):
    """The float draw takes its key on the device in a compiled step
    (:meth:`LoweringContext.rng_key`); the integer draw forms it on the
    host (``prng.randint``), which a compiled step refuses."""
    key = ctx.rng_key(op) if op.attrs["dtype"].is_floating \
        else ctx.rng_for(op)
    return [_ru(key, op, ctx.device)]


op_registry.register("RandomUniform", lower=_lower_random_uniform,
                     effects=op_registry.Effects(rng=True))


def _rn(key, op, device):
    a = op.attrs
    return prng.normal_torch(key, tuple(a["shape"]), device, a["stddev"],
                             a["mean"]).to(a["dtype"].torch_dtype)


op_registry.register(
    "RandomStandardNormal",
    lower=lambda ctx, op, inputs: [_rn(ctx.rng_key(op), op, ctx.device)],
    effects=op_registry.Effects(rng=True))


def _rand_op(op_type, shape, dtype, seed, name, extra):
    from .array_ops import _static_shape_arg

    dt = dtypes_mod.as_dtype(dtype)
    g = ops_mod.get_default_graph()
    graph_seed, op_seed = random_seed_mod.get_seed(seed)
    sh = _static_shape_arg(shape, "random op")
    attrs = {"shape": sh, "dtype": dt, "seed": op_seed,
             "_graph_seed": graph_seed}
    attrs.update(extra)
    op = g.create_op(op_type, [], attrs=attrs, name=name or op_type,
                     output_specs=[(shape_mod.TensorShape(list(sh)), dt)])
    return op.outputs[0]


def random_uniform(shape, minval=0, maxval=None, dtype=dtypes_mod.float32,
                   seed=None, name=None):
    dt = dtypes_mod.as_dtype(dtype)
    if maxval is None:
        if dt.is_integer:
            raise ValueError("Must specify maxval for integer random_uniform")
        maxval = 1.0
    return _rand_op("RandomUniform", shape, dt, seed, name,
                    {"minval": minval, "maxval": maxval})


def random_normal(shape, mean=0.0, stddev=1.0, dtype=dtypes_mod.float32,
                  seed=None, name=None):
    return _rand_op("RandomStandardNormal", shape, dtype, seed, name,
                    {"mean": float(mean), "stddev": float(stddev)})
