"""Maximum spanning tree via Borůvka (the MST subroutine).

The port of `repro.core.mst`. Edges are compared by a precomputed rank
(position in the (eff desc, edge-id asc) total order), so the tree is
unique and Borůvka equals the numpy Kruskal oracle. Each round picks
every component's best inter-component edge with scatter-mins, hooks
components to their smallest chosen neighbour, breaks mutual 2-cycles
and contracts by pointer jumping. The reference's two while_loops are
host loops that sync once per round / jump on their conditions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.bfs import INF


def boruvka_mst(u: torch.Tensor, v: torch.Tensor, rank: torch.Tensor,
                n: int, edge_valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """(L,) bool mask of spanning-tree edges; rank 0 is the best edge.
    edge_valid: optional (L,) padding mask; padding edges are never
    candidates, and the termination test ignores them."""
    dev = u.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    comp = ids
    tree_mask = torch.zeros_like(u, dtype=torch.bool)
    if edge_valid is None:
        edge_valid = torch.ones_like(u, dtype=torch.bool)
    rank = rank.to(torch.int64)
    inf_e = torch.full_like(rank, INF)
    while bool(torch.any((comp[u] != comp[v]) & edge_valid)):
        cu, cv = comp[u], comp[v]
        inter = (cu != cv) & edge_valid
        key = torch.where(inter, rank, inf_e)
        best = torch.full((n,), INF, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, cu, key, "amin", include_self=True)
        best.scatter_reduce_(0, cv, key, "amin", include_self=True)
        chosen = inter & ((rank == best[cu]) | (rank == best[cv]))
        tree_mask = tree_mask | chosen
        # hook: each component points to the smallest neighbouring one
        ptr = ids.clone()
        ptr.scatter_reduce_(0, cu, torch.where(chosen, cv, inf_e), "amin",
                            include_self=True)
        ptr.scatter_reduce_(0, cv, torch.where(chosen, cu, inf_e), "amin",
                            include_self=True)
        ptr = torch.minimum(ptr, ids)
        # break mutual 2-cycles deterministically (smaller id wins)
        mutual = (ptr[ptr] == ids) & (ptr != ids)
        ptr = torch.where(mutual & (ids < ptr), ids, ptr)
        while bool(torch.any(ptr[ptr] != ptr)):
            ptr = ptr[ptr]
        comp = ptr[comp]
    return tree_mask


def kruskal_mst_numpy(u, v, rank, n):
    """Host Kruskal on the same total order — oracle / test reference."""
    order = np.argsort(rank, kind="stable")
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    mask = np.zeros(len(u), dtype=bool)
    cnt = 0
    for e in order:
        a, b = find(int(u[e])), find(int(v[e]))
        if a != b:
            parent[max(a, b)] = min(a, b)
            mask[e] = True
            cnt += 1
            if cnt == n - 1:
                break
    return mask
