"""The ``DecodeAttention`` graph op: attention for one query position, or
a query block, against gathered cache rows.

Port of ``decode_attention`` and its lowering in
``simple_tensorflow_tpu/ops/kv_cache_ops.py`` (:383-435): the same op
type, input order (``q, k_cache, v_cache, lengths`` and an optional
``bias``), attrs (``sm_scale``, ``causal_offset``) and name. It lowers to
the decode attention kernel's wrapper (``ops/kernels/decode_attention.py``:
``q (B, H, D)`` runs the single-query kernel, ``(B, Kq, H, D)`` the
query-block kernel; a CPU tensor takes the plain version). Inference
only: the JAX op registers no gradient. Left out: the cache-variable ops
of the JAX file (``KVCache`` and its append and gather ops).
"""

from __future__ import annotations

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from .kernels.decode_attention import decode_attention as _kernel


def decode_attention(q, k_cache, v_cache, lengths, *, bias=None,
                     sm_scale=None, causal_offset=False, name=None):
    """q: ``(B, heads, head_dim)`` (one new query per sequence) or ``(B,
    Kq, heads, head_dim)`` (a block); k_cache/v_cache: ``(B, max_len,
    heads, head_dim)``; lengths: ``(B,)`` int32 live prefix; bias: an
    optional additive ``(B, max_len)`` key bias. With a query block,
    ``causal_offset=True`` means query j attends positions ``<
    lengths[b] + j + 1``; otherwise every query sees positions ``<
    lengths[b]``."""
    g = ops_mod.get_default_graph()
    q = ops_mod.convert_to_tensor(q)
    k_cache = ops_mod.convert_to_tensor(k_cache)
    v_cache = ops_mod.convert_to_tensor(v_cache)
    lengths = ops_mod.convert_to_tensor(lengths, dtype=dtypes_mod.int32)
    if causal_offset and q.shape.rank != 4:
        raise ValueError("causal_offset=True requires a query block "
                         f"(B, Kq, H, D); got q rank {q.shape.rank}")
    inputs = [q, k_cache, v_cache, lengths]
    if bias is not None:
        inputs.append(ops_mod.convert_to_tensor(bias))
    op = g.create_op("DecodeAttention", inputs,
                     attrs={"sm_scale": sm_scale,
                            "causal_offset": bool(causal_offset)},
                     name=name or "decode_attention",
                     output_specs=[(q.shape, q.dtype)])
    return op.outputs[0]


def _lower_decode_attention(ctx, op, input_values):
    q, k, v, lengths = input_values[:4]
    bias = input_values[4] if len(input_values) > 4 else None
    return [_kernel(
        q, k, v, lengths, bias=bias,
        sm_scale=op.attrs.get("sm_scale"),
        causal_offset=op.attrs.get("causal_offset", False))]


op_registry.register("DecodeAttention", lower=_lower_decode_attention)
