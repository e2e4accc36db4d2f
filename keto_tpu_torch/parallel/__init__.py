"""Sharded serving on one card: row-range shards of the graph, the halo
exchange between them, and the sharded device programs (K10).

The counterpart of keto_tpu/parallel: ``mesh`` builds the ``graph`` axis
of shards (``make_mesh``), ``sharded`` routes rows to their shards and
runs the three sharded programs — the BFS fixpoint, the label
intersection and the label-build sweep.
"""

from keto_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, ShardMesh, make_mesh

__all__ = ["make_mesh", "ShardMesh", "DATA_AXIS", "GRAPH_AXIS"]
