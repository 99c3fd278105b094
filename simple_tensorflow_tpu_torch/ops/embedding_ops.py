"""Embedding lookup: port of ``simple_tensorflow_tpu/ops/embedding_ops.py:
embedding_lookup`` (:56) with its mixed-precision ``compute_dtype``, on
torch tensors (the eager models) or on graph tensors (the TF-1 front end:
the ``EmbeddingLookupMixed`` op of :83 with ``compute_dtype`` other than
the table's, lowered to :class:`_MixedLookup`, else ``Gather``, as the JAX
function builds them).

With ``compute_dtype`` the rows are gathered in that dtype (the JAX
function casts the table first; gathering then casting is the same value
and reads only the rows), while the gradient is scatter-added into a dense
zero table in the table's own precision, so repeated ids accumulate in f32
(the JAX ``_emb_mixed_impl`` VJP), in one order on every run. Plain PyTorch: the JAX package has no
Pallas kernel here.
"""

from __future__ import annotations

import torch

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from .fused_ops import is_graph_value


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
        # index_put_ with accumulate sums each row's contributions in one
        # order on every run (it sorts the ids); index_add_ adds them with
        # atomics on the card, whose order, and so the f32 sum of a
        # repeated id, changes from run to run
        dtab.index_put_((ids.reshape(-1),),
                        g.reshape(-1, d).to(ctx.table_dtype), accumulate=True)
        return dtab, None, None


op_registry.register(
    "EmbeddingLookupMixed", lower=lambda ctx, op, inputs: [
        _MixedLookup.apply(inputs[0], inputs[1].long(), dtypes_mod.as_dtype(
            op.attrs["compute_dtype"]).torch_dtype)])


def embedding_lookup(params, ids, partition_strategy="mod", name=None,
                     validate_indices=True, max_norm=None,
                     compute_dtype=None):
    """Rows of ``params (vocab, d)`` at integer ``ids (...)``: ``(...,
    d)``, in ``compute_dtype`` when given (module docstring). On graph
    tensors (``params`` a Variable or graph tensor) it builds the graph
    op; ``compute_dtype`` is then a graph dtype, else a torch dtype.
    ``max_norm`` and lists of shards are not ported."""
    from . import array_ops

    if max_norm is not None or isinstance(params, (list, tuple)):
        raise NotImplementedError("embedding_lookup with max_norm or a "
                                  "sharded table is not ported")
    if is_graph_value(params):
        table = ops_mod.convert_to_tensor(params)
        ids = ops_mod.convert_to_tensor(ids)
        if compute_dtype is not None and dtypes_mod.as_dtype(
                compute_dtype) != table.dtype.base_dtype:
            dt = dtypes_mod.as_dtype(compute_dtype)
            op = ops_mod.get_default_graph().create_op(
                "EmbeddingLookupMixed", [table, ids],
                attrs={"compute_dtype": dt.name},
                name=name or "embedding_lookup_mixed",
                output_specs=[(ids.shape.concatenate(table.shape[1:]), dt)])
            return op.outputs[0]
        return array_ops.gather(table, ids, name=name)
    ids = ids.long()
    if compute_dtype is None or compute_dtype == params.dtype:
        return params[ids]
    return _MixedLookup.apply(params, ids, compute_dtype)
