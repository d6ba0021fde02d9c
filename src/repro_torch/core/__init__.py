"""LGRASS core on PyTorch: graph containers, the numpy oracle and the
single-graph pipeline (`lgrass_sparsify`). Imports torch and numpy only."""
from repro_torch.core.baseline import (BaselineResult, baseline_sparsify,
                                       default_budget)
from repro_torch.core.graph import (OFFICIAL_CASE_SHAPES, Graph,
                                    feeder_like_graph, from_reference,
                                    official_case, powergrid_like_graph,
                                    random_connected_graph, trivial_graph)
from repro_torch.core.sparsify import (SparsifyResult, lgrass_device,
                                       lgrass_sparsify, phase1_device)

__all__ = [
    "BaselineResult", "baseline_sparsify", "default_budget",
    "OFFICIAL_CASE_SHAPES", "Graph", "feeder_like_graph", "from_reference",
    "official_case", "powergrid_like_graph", "random_connected_graph",
    "trivial_graph", "SparsifyResult", "lgrass_device", "lgrass_sparsify",
    "phase1_device",
]
