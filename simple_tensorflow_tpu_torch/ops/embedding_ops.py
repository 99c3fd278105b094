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

The fused lookup of the DLRM graph (:198-478 there), without a mesh:
``embedding_lookup_fused`` builds ``EmbeddingLookupFused`` (attrs
``axis``, ``dedup``, ``compute_dtype``, ``table`` and the
``_gradient_op_type`` JAX stamps), ``embedding_bag`` pools padded (B, L)
id matrices over it (sum or mean, ``lengths`` masks, ``-1`` padding).
The lowering is JAX's single-device one (:274-277, :334-341):
:func:`_dedup_ids` (``jnp.unique(size=b, fill_value=0,
return_inverse=True)``: sorted, static size, built from one stable sort so
that a captured step needs no host sync), a clipped gather of the unique
rows in the compute dtype and the inverse gather; its gradient
(:func:`scatter_add_grad`, also the ``EmbeddingScatterAddGrad`` op that
``_fused_lookup_grad`` builds) upcasts the cotangents to the table's
dtype before any sum, sums them per unique id over the inverse
(:func:`_segment_sum`) and scatter-adds the sums into a dense table. Both
sums go through ``index_put_`` with accumulate (sorted, no float
atomics): captured and eager steps stay bit-identical. With a mesh the
lowering raises (ROADMAP Queue 1 item 11). Left out: the ``all_to_all``
route over the ``ep`` axis and the ``/stf/embedding/*`` counters, which
the JAX lowering feeds from a host callback (a CUDA graph runs none).
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


# -- the fused lookup (JAX embedding_ops.py:198-478), single device --------

def _dedup_ids(ids_flat, dedup):
    """``(uniq, inverse or None)`` of a flat id vector, as JAX's
    ``jnp.unique(ids, size=b, fill_value=0, return_inverse=True)``: the
    distinct ids sorted, padded with 0 to ``b``, and each id's index
    into them."""
    b = ids_flat.shape[0]
    if not dedup or b <= 1:
        return ids_flat, None
    srt, perm = torch.sort(ids_flat, stable=True)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(new, 0) - 1
    inv = torch.empty_like(seg).scatter_(0, perm, seg)
    uniq = torch.zeros_like(srt).scatter_(0, seg, srt)
    return uniq, inv


def _segment_sum(gm, inv, n):
    """``jax.ops.segment_sum(gm, inv, num_segments=n)``, in one order on
    every run (``index_put_`` with accumulate sorts)."""
    out = torch.zeros((n,) + tuple(gm.shape[1:]), dtype=gm.dtype,
                      device=gm.device)
    return out.index_put_((inv,), gm, accumulate=True)


def scatter_add_grad(ids, g, table_shape, table_dtype, dedup=True):
    """The table's gradient of a fused lookup of ``ids`` given the rows'
    cotangents ``g``: the ``EmbeddingScatterAddGrad`` lowering (JAX
    :303-341, no mesh)."""
    vocab, dim = (int(d) for d in table_shape)
    ids_flat = ids.reshape(-1).long()
    b = ids_flat.shape[0]
    # upcast BEFORE any accumulation: repeated ids sum in the table's own
    # precision
    gm = g.reshape(b, dim).to(table_dtype)
    uniq, inv = _dedup_ids(ids_flat, dedup)
    if inv is not None:
        gm = _segment_sum(gm, inv, b)
    valid = ((uniq >= 0) & (uniq < vocab))[:, None]
    dtab = torch.zeros((vocab, dim), dtype=table_dtype, device=g.device)
    return dtab.index_put_((uniq.clamp(0, vocab - 1),),
                           torch.where(valid, gm, torch.zeros_like(gm)),
                           accumulate=True)


class _FusedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids, dtype, dedup):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        ctx.dedup = dedup
        vocab, dim = table.shape
        ids_flat = ids.reshape(-1).long()
        uniq, inv = _dedup_ids(ids_flat, dedup)
        rows = table[uniq.clamp(0, vocab - 1)].to(dtype)
        out = rows if inv is None else rows[inv]
        return out.reshape(tuple(ids.shape) + (dim,))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return (scatter_add_grad(ids, g, ctx.table_shape, ctx.table_dtype,
                                 ctx.dedup), None, None, None)


def _no_mesh(op):
    from ..parallel.mesh import current_mesh

    if current_mesh() is not None:
        raise NotImplementedError(
            f"{op.type} over a mesh axis is not ported yet (ROADMAP Queue 1 "
            "item 11)")


def _lower_fused_lookup(ctx, op, inputs):
    _no_mesh(op)
    table, ids = inputs
    dt = dtypes_mod.as_dtype(op.attrs["compute_dtype"]).torch_dtype
    return [_FusedLookup.apply(table, ids, dt,
                               bool(op.attrs.get("dedup", True)))]


def _lower_scatter_add_grad(ctx, op, inputs):
    _no_mesh(op)
    ids, g = inputs
    return [scatter_add_grad(
        ids, g, op.attrs["table_shape"],
        dtypes_mod.as_dtype(op.attrs["table_dtype"]).torch_dtype,
        bool(op.attrs.get("dedup", True)))]


op_registry.register("EmbeddingLookupFused", lower=_lower_fused_lookup)
op_registry.register("EmbeddingScatterAddGrad",
                     lower=_lower_scatter_add_grad)


def _fused_lookup_grad(op, grad):
    """d(lookup)/d(table) of an ``EmbeddingLookupFused`` op as a
    first-class ``EmbeddingScatterAddGrad`` op (JAX :347-366, the
    ``FusedEmbeddingLookupGrad`` the op's ``_gradient_op_type`` names);
    ids carry no gradient. The Session differentiates the lookup through
    :class:`_FusedLookup`, whose backward is the same function."""
    g = ops_mod.get_default_graph()
    table_t, ids_t = op.inputs[0], op.inputs[1]
    node = g.create_op(
        "EmbeddingScatterAddGrad", [ids_t, grad],
        attrs={"axis": op.attrs.get("axis", "ep"),
               "dedup": bool(op.attrs.get("dedup", True)),
               "table_shape": tuple(int(d.value)
                                    for d in table_t.shape.dims),
               "table_dtype": table_t.dtype.base_dtype.name},
        name=op.name + "_scatter_add",
        output_specs=[(table_t.shape, table_t.dtype.base_dtype)])
    return [node.outputs[0], None]


def _resolve_table(params):
    if isinstance(params, (list, tuple)):
        if len(params) > 1:
            raise NotImplementedError("a sharded table is not ported")
        params = params[0]
    return (params._ref if hasattr(params, "_ref")
            else ops_mod.convert_to_tensor(params))


def embedding_lookup_fused(params, ids, *, axis="ep", dedup=True,
                           compute_dtype=None, name=None):
    """Fused sharded-embedding lookup: ``embedding_lookup`` restricted to
    a rank-2 table of static shape and in-range ids. Single device (the
    port has no mesh): a clipped gather of the deduplicated ids."""
    table = _resolve_table(params)
    ids = ops_mod.convert_to_tensor(ids)
    if table.shape.rank != 2 or not all(
            d.value for d in table.shape.dims):
        raise ValueError(
            "embedding_lookup_fused needs a statically-shaped rank-2 "
            f"table, got {table.shape}")
    dt = (dtypes_mod.as_dtype(compute_dtype) if compute_dtype is not None
          else table.dtype.base_dtype)
    g = ops_mod.get_default_graph()
    op = g.create_op(
        "EmbeddingLookupFused", [table, ids],
        attrs={"axis": axis, "dedup": bool(dedup),
               "compute_dtype": dt.name,
               "table": table.op.name,
               "_gradient_op_type": "FusedEmbeddingLookupGrad"},
        name=name or "embedding_lookup_fused",
        output_specs=[(ids.shape.concatenate(table.shape[1:]), dt)])
    return op.outputs[0]


def embedding_bag(params, ids, lengths=None, *, combiner="mean",
                  axis="ep", dedup=True, compute_dtype=None, name=None):
    """Pooled bag lookup over padded (B, L) id matrices: row i pools
    ``ids[i, :lengths[i]]``; padding slots (any id; the parser emits -1)
    contribute zero. combiner: "sum" | "mean"."""
    import numpy as np

    from . import array_ops, math_ops

    if combiner not in ("sum", "mean"):
        raise ValueError(f"embedding_bag combiner must be sum|mean, "
                         f"got {combiner!r}")
    ids = ops_mod.convert_to_tensor(ids)
    if ids.shape.rank != 2 or ids.shape.dims[1].value is None:
        raise ValueError(
            f"embedding_bag needs (B, L) ids with static L, got {ids.shape}")
    zero = ops_mod.convert_to_tensor(0, dtype=ids.dtype.base_dtype)
    emb = embedding_lookup_fused(
        params, math_ops.maximum(ids, zero), axis=axis, dedup=dedup,
        compute_dtype=compute_dtype, name=name)  # (B, L, D)
    fdt = emb.dtype.base_dtype
    if lengths is not None:
        seq = ops_mod.convert_to_tensor(
            np.arange(int(ids.shape.dims[1].value)),
            dtype=lengths.dtype.base_dtype)
        mask = math_ops.cast(
            math_ops.less(array_ops.expand_dims(seq, 0),
                          array_ops.expand_dims(lengths, 1)), fdt)
    else:
        mask = math_ops.cast(math_ops.greater_equal(ids, zero), fdt)
    weighted = emb * array_ops.expand_dims(mask, -1)
    summed = math_ops.reduce_sum(weighted, axis=1)  # (B, D)
    if combiner == "sum":
        return summed
    counts = math_ops.reduce_sum(mask, axis=1, keepdims=True)
    one = ops_mod.convert_to_tensor(1.0, dtype=fdt)
    return summed / math_ops.maximum(counts, one)
