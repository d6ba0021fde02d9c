"""The baseline program's semantics (IPCC reference, Algorithms 1 & 3).

A copy of `repro.core.baseline`, numpy only. It is the oracle the torch
pipeline's masks are held against where JAX is not installed.

This is the fidelity oracle: the original competition program marks edges
with the O(N^2 L) triple loop; we reproduce its *semantics* (greedy over
criticality-sorted off-tree edges, ball-pair edge marking, budget cut) at
O(L * ball) host cost — still super-linear, used only to validate that the
linear LGRASS pipeline produces the identical sparsifier.

Every float op mirrors the torch pipeline bit-exactly (see _host.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core import _host as H
from repro_torch.core.graph import Graph
from repro_torch.core.mst import kruskal_mst_numpy


@dataclasses.dataclass
class BaselineResult:
    edge_mask: np.ndarray          # (L,) bool — final sparsifier edges
    accepted: np.ndarray           # accepted off-tree edge ids, accept order
    tree_mask: np.ndarray          # (L,) bool
    root: int
    depth_graph: np.ndarray
    depth_tree: np.ndarray
    parent_tree: np.ndarray
    eff: np.ndarray
    rank_eff: np.ndarray
    crit: np.ndarray
    beta: np.ndarray
    edge_lca: np.ndarray
    crossing: np.ndarray
    order: np.ndarray              # off-tree edges, (crit desc, id asc)
    marked: np.ndarray             # final mark state (diagnostics)


def default_budget(n: int) -> int:
    return max(1, int(round(0.05 * n)))


def baseline_sparsify(g: Graph, budget: int | None = None) -> BaselineResult:
    n, L = g.n, g.m
    u = g.u.astype(np.int64)
    v = g.v.astype(np.int64)
    w = g.w.astype(np.float32)
    if budget is None:
        budget = default_budget(n)

    # EFF: BFS depth on the full graph, depth-scaled effective weights
    root = H.select_root_np(u, v, n)
    depth_g, _ = H.bfs_np(u, v, n, root)
    eff = H.effective_weights_np(u, v, w, depth_g)

    # MST: maximum spanning tree under the (eff desc, id asc) total order
    order_eff = H.desc_stable_order_np(eff)
    rank_eff = H.rank_from_order(order_eff)
    tree_mask = kruskal_mst_numpy(u, v, rank_eff, n)

    # Tree BFS (depths/parents used for LCA, beta, balls)
    depth_t, parent_t = H.bfs_np(u, v, n, root, edge_mask=tree_mask)
    up = H.build_lifting_np(parent_t, depth_t, n)

    # RES: root-path resistance sums -> criticality
    inv_w = H.node_parent_inv_w_np(u, v, w, tree_mask, parent_t, n)
    rd = H.root_path_sums_np(up, depth_t, inv_w, n)
    edge_lca = H.lca_np(up, depth_t, u, v)
    crit = H.criticality_np(u, v, w, rd, edge_lca)
    beta = np.maximum(
        np.minimum(depth_t[u], depth_t[v]) - depth_t[edge_lca], 1
    ).astype(np.int32)
    crossing = (~tree_mask) & (edge_lca != u) & (edge_lca != v)

    # SORT: off-tree edges by (criticality desc, id asc)
    offtree = ~tree_mask
    keys = np.where(offtree, crit, np.float32(-np.inf)).astype(np.float32)
    order = H.desc_stable_order_np(keys)[: int(offtree.sum())]

    # MARK (Algorithm 1 semantics): greedy with ball-pair edge marking
    adj = H.tree_adjacency(parent_t, n)
    marked = np.zeros(L, bool)
    accepted: List[int] = []
    out = np.zeros(L, bool)
    for e in order:
        e = int(e)
        if marked[e]:
            continue
        out[e] = True
        accepted.append(e)
        if len(accepted) == budget:
            break
        s1 = H.ball_np(adj, int(u[e]), int(beta[e]))
        s2 = H.ball_np(adj, int(v[e]), int(beta[e]))
        m1 = np.zeros(n, bool)
        m2 = np.zeros(n, bool)
        m1[list(s1)] = True
        m2[list(s2)] = True
        cov = offtree & (
            (m1[u] & m2[v]) | (m2[u] & m1[v])
        )
        marked |= cov

    return BaselineResult(
        edge_mask=tree_mask | out,
        accepted=np.array(accepted, dtype=np.int64),
        tree_mask=tree_mask,
        root=root,
        depth_graph=depth_g,
        depth_tree=depth_t,
        parent_tree=parent_t,
        eff=eff,
        rank_eff=rank_eff,
        crit=crit,
        beta=beta,
        edge_lca=edge_lca,
        crossing=crossing,
        order=order,
        marked=marked,
    )
