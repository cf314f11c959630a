"""pdGRASS core of the port: graph substrate and the sparsifier's steps.

    Graph / build_graph / generators   (repro_torch.core.graph)
    DeviceGraph                        (repro_torch.core.device_graph)
    graph_ops primitives, sharded too  (repro_torch.core.graph_ops)
    collectives over a mesh's shards   (repro_torch.core.collectives)
    recover_mixed and its engines      (repro_torch.core.distributed)
    Prepared, Sparsifier, prepare, pdgrass (repro_torch.core.sparsify)
    fegrass                            (repro_torch.core.fegrass)  baseline
    pcg_host, pcg_torch, quality_iters (repro_torch.core.pcg)
"""
from repro_torch.core.graph import (Graph, build_graph, grid2d, mesh2d,
                                    barabasi_albert, watts_strogatz,
                                    random_regular, star_hub, suite)
from repro_torch.core.device_graph import DeviceGraph
from repro_torch.core.graph_ops import (coalesce_edges, compact_labels,
                                        handshake, pointer_jump,
                                        propose_accept_matching,
                                        segment_argmax,
                                        sharded_coalesce_edges,
                                        sharded_matching,
                                        sharded_segment_argmax)
from repro_torch.core.sparsify import Prepared, Sparsifier, prepare, pdgrass
from repro_torch.core.fegrass import fegrass
from repro_torch.core.pcg import pcg_host, pcg_torch, quality_iters
from repro_torch.core.distributed import (build_outer_shards,
                                          partition_subtasks, recover_mixed)

__all__ = [
    "Graph", "DeviceGraph", "build_graph", "grid2d", "mesh2d",
    "barabasi_albert", "watts_strogatz", "random_regular", "star_hub",
    "suite",
    "segment_argmax", "handshake", "propose_accept_matching",
    "pointer_jump", "compact_labels", "coalesce_edges",
    "sharded_segment_argmax", "sharded_matching", "sharded_coalesce_edges",
    "partition_subtasks", "build_outer_shards", "recover_mixed",
    "Prepared", "Sparsifier", "prepare", "pdgrass", "fegrass",
    "pcg_host", "pcg_torch", "quality_iters",
]
