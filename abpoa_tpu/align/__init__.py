"""Alignment engines.

``align_sequence_to_graph/subgraph`` dispatch between the exact NumPy host
oracle (reference-bit-exact, see engine_np.py) and the device engine
(engine_jax.py). With ``--engine jax`` every alignment runs one device round
(B = 1): whole-graph alignments on the end the platform and input pick,
subgraph windows (-S) as an XLA planes round. parallel/batch.BatchPOA batches
both across instances.
"""
from __future__ import annotations

from ..params import SRC_NODE_ID, SINK_NODE_ID
from .engine_np import AlignResult, align_sequence_to_subgraph as _np_subgraph


def align_sequence_to_subgraph(graph, params, beg_node_id, end_node_id,
                               query, arena=None) -> AlignResult:
    """ref abpoa_align_sequence_to_subgraph (src/abpoa_align.c:178-183)."""
    if graph.node_n <= 2:
        return None
    if not graph.is_topological_sorted:
        graph.topological_sort(params)
    if getattr(params, "engine", "auto") == "jax":
        from .engine_jax import align_device
        return align_device(graph, params, query, beg_node_id, end_node_id)
    return _np_subgraph(graph, params, beg_node_id, end_node_id, query,
                        arena=arena)


def align_sequence_to_graph(graph, params, query, arena=None) -> AlignResult:
    return align_sequence_to_subgraph(graph, params, SRC_NODE_ID,
                                      SINK_NODE_ID, query, arena=arena)
