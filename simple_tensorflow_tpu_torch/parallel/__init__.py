"""stf.parallel of the port: the no-mesh surface the single-card graphs
call (``current_mesh``, ``shard_feed``, ``shard_variable``,
``ring_attention``). Meshes, collectives and the parallel strategies are
not ported yet (ROADMAP Queue 1 item 11): ``Mesh`` and ``make_mesh``
raise."""

from .api import shard_feed, shard_variable
from .mesh import (CANONICAL_AXES, Mesh, P, PartitionSpec, current_mesh,
                   make_mesh)
from .ring_attention import ring_attention

__all__ = ["CANONICAL_AXES", "Mesh", "P", "PartitionSpec", "current_mesh",
           "make_mesh", "ring_attention", "shard_feed", "shard_variable"]
