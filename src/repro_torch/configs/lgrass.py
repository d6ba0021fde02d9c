"""The paper's own workload: LGRASS graph sparsification cases.

A copy of `repro.configs.lgrass`. Each "shape" is a graph size; the
reference's dry-run lowers the distributed phase 1
(`repro_torch.core.distributed` in the port) over its production mesh
for each case.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphCase:
    name: str
    n_nodes: int
    n_edges: int


CASES = {
    "case1_4k": GraphCase("case1_4k", 4_096, 13_056),
    "case2_7k": GraphCase("case2_7k", 7_056, 22_344),
    "case3_16k": GraphCase("case3_16k", 16_129, 51_200),
    "rand_1m": GraphCase("rand_1m", 1_048_576, 3_145_728),
}
