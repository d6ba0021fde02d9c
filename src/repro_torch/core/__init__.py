"""LGRASS core on PyTorch: graph containers, the numpy oracle, the
single-graph and batched pipelines, the recovery replays, batch-axis and
group sharding over a mesh of devices and the solver-free quality tier.
Imports torch and numpy only."""
from repro_torch.core.baseline import (BaselineResult, baseline_sparsify,
                                       default_budget)
from repro_torch.core.distributed import (Mesh, ShardedGroupPlan,
                                          batch_mesh,
                                          lgrass_phase1_distributed,
                                          make_phase1_sharded, mesh_size,
                                          partition_groups,
                                          shard_batch_leading)
from repro_torch.core.graph import (OFFICIAL_CASE_SHAPES, Graph, GraphBatch,
                                    feeder_like_graph, from_reference,
                                    official_case, powergrid_like_graph,
                                    random_connected_graph, trivial_graph)
from repro_torch.core.pow2 import log2_ceil, next_pow2
from repro_torch.core.recovery import (recover_device,
                                       recover_device_batched, recover_host)
from repro_torch.core.sparsify import (SparsifyResult, lgrass_device,
                                       lgrass_device_batched,
                                       lgrass_device_batched_donated,
                                       lgrass_sparsify,
                                       lgrass_sparsify_batch, phase1_device,
                                       phase1_device_batched)
from repro_torch.core.spectral_probe import (laplacian_spmv,
                                             probe_criticality,
                                             probe_edge_resistance,
                                             probe_edge_resistance_batched,
                                             trace_similarity)

__all__ = [
    "BaselineResult", "baseline_sparsify", "default_budget",
    "Mesh", "ShardedGroupPlan", "batch_mesh", "lgrass_phase1_distributed",
    "make_phase1_sharded", "mesh_size", "partition_groups",
    "shard_batch_leading",
    "OFFICIAL_CASE_SHAPES", "Graph", "GraphBatch", "feeder_like_graph",
    "from_reference", "official_case", "powergrid_like_graph",
    "random_connected_graph", "trivial_graph", "log2_ceil", "next_pow2",
    "recover_device", "recover_device_batched", "recover_host",
    "SparsifyResult", "lgrass_device", "lgrass_device_batched",
    "lgrass_device_batched_donated", "lgrass_sparsify",
    "lgrass_sparsify_batch", "phase1_device", "phase1_device_batched", "laplacian_spmv", "probe_criticality",
    "probe_edge_resistance", "probe_edge_resistance_batched",
    "trace_similarity",
]
