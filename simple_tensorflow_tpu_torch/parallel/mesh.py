"""The device mesh: port of ``simple_tensorflow_tpu/parallel/mesh.py``,
without a mesh. ``current_mesh()`` is None: the port runs one card, and a
graph built here takes the JAX package's no-mesh paths (a ``RingAttention``
lowers to the flash kernels, a fused embedding lookup to one gather).
``PartitionSpec`` (:143) is kept, so that ``shard_feed`` and
``shard_variable`` record a spec as the JAX functions do; with no mesh
nothing reads it. ``Mesh`` and ``make_mesh`` raise: meshes come with the
multi-card slice (ROADMAP Queue 1 item 11)."""

from __future__ import annotations

CANONICAL_AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")

_NOT_PORTED = ("a device mesh is not ported yet: it comes with the "
               "multi-card slice (ROADMAP Queue 1 item 11)")


class Mesh:
    """Named device mesh (not ported: raises)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


def make_mesh(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED)


def current_mesh():
    """The active mesh: None, since the port has none."""
    return None


class PartitionSpec(tuple):
    """A sharding spec: one mesh axis name (or None) per dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec
