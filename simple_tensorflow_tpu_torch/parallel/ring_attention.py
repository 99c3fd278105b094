"""Ring attention: port of the ``RingAttention`` graph op of
``simple_tensorflow_tpu/parallel/ring_attention.py`` (:246-273), with the
JAX op's inputs ``(q, k, v)`` of shape (B, H, S, D), attrs ``axis``,
``causal`` and ``sm_scale``, and name.

With no mesh axis to ring over (the port has no mesh:
``mesh.current_mesh``), the op lowers as the JAX package's does (:185-195)
to single-device flash attention at rate 0: causal or not, no bias,
``sm_scale`` defaulting to ``1/sqrt(D)`` in the kernels. On a CUDA tensor
that launches the flash kernels (``csrc/flash_fwd_mma.cu``,
``csrc/flash_bwd_mma.cu`` in bf16); the gradient is their backward through
the kernels' ``autograd.Function``. With a mesh the lowering raises: the
ring itself comes with the multi-card slice (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from ..framework import graph as ops_mod
from ..framework import op_registry
from ..ops import fused_ops
from .mesh import current_mesh


def _lower_ring_attention(ctx, op, inputs):
    q, k, v = inputs
    if current_mesh() is not None:
        raise NotImplementedError(
            "RingAttention over a mesh axis is not ported yet (ROADMAP "
            "Queue 1 item 11)")
    return [fused_ops.fused_attention(
        q, k, v, causal=bool(op.attrs["causal"]),
        sm_scale=op.attrs["sm_scale"])]


op_registry.register("RingAttention", lower=_lower_ring_attention)


def ring_attention(q, k, v, *, axis="sp", causal=False, sm_scale=None,
                   name=None):
    """Graph op: sequence-parallel attention over mesh axis ``axis``.
    q, k, v: (B, H, S, D). With no mesh (always, in the port) it is
    single-device flash attention."""
    q = ops_mod.convert_to_tensor(q)
    k = ops_mod.convert_to_tensor(k)
    v = ops_mod.convert_to_tensor(v)
    g = ops_mod.get_default_graph()
    node = g.create_op(
        "RingAttention", [q, k, v],
        attrs={"axis": axis, "causal": bool(causal),
               "sm_scale": None if sm_scale is None else float(sm_scale)},
        name=name or "ring_attention", output_specs=[(q.shape, q.dtype)])
    return node.outputs[0]
