"""Embedding lookup: port of ``simple_tensorflow_tpu/ops/embedding_ops.py:
embedding_lookup`` (:56) with its mixed-precision ``compute_dtype``.

With ``compute_dtype`` the rows are gathered in that dtype (the JAX
function casts the table first; gathering then casting is the same value
and reads only the rows), while the gradient is scatter-added into a dense
zero table in the table's own precision, so repeated ids accumulate in f32
(the JAX ``_emb_mixed_impl`` VJP). Plain PyTorch: the JAX package has no
Pallas kernel here.
"""

from __future__ import annotations

import torch


class _MixedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return table[ids].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = ctx.table_shape[-1]
        dtab = torch.zeros(ctx.table_shape, dtype=ctx.table_dtype,
                           device=g.device)
        dtab.index_add_(0, ids.reshape(-1),
                        g.reshape(-1, d).to(ctx.table_dtype))
        return dtab, None, None


def embedding_lookup(params, ids, compute_dtype=None):
    """Rows of ``params (vocab, d)`` at integer ``ids (...)``: ``(...,
    d)``, in ``compute_dtype`` when given (module docstring)."""
    ids = ids.long()
    if compute_dtype is None or compute_dtype == params.dtype:
        return params[ids]
    return _MixedLookup.apply(params, ids, compute_dtype)
