"""Sharding annotations: port of ``simple_tensorflow_tpu/parallel/api.py``
``shard_variable`` and ``shard_feed`` (:96-106). Each records its spec as
the JAX function does (the variable's ``sharding``, the placeholder op's
``sharding`` attr); with no mesh (``mesh.current_mesh``) nothing reads
it. Left out: the scope rules, constraints, autoshard and the pod
trainer."""

from __future__ import annotations

from .mesh import P


def shard_variable(variable, *spec):
    variable.set_sharding(P(*spec))
    return variable


def shard_feed(placeholder, *spec):
    """Annotate a placeholder with the spec its fed batch shards by (e.g.
    ``shard_feed(x, 'dp')``: dim 0 over the data-parallel axis)."""
    placeholder.op.attrs["sharding"] = P(*spec)
    return placeholder
