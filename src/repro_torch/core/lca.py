"""Batched LCA: binary lifting and the Euler-tour sparse table (§3.2).

The port of `repro.core.lca`. Binary lifting (`LiftingTables`, `lca`)
answers a query in O(log depth) gathers; the Euler tour plus sparse-table
range minimum (`EulerLCA`, `lca_euler`) in O(1) gathers. The pipeline
builds the tour in `bfs.root_tree_euler` (the "doubling" engine) or from
parent pointers in `build_euler` (the "levels" engine and the standalone
recovery); `tables_from_tour` is the one definition of the table layout.

The lifting table `up` and `depth` are int32, as in the reference: they
are the inputs of the tree-distance kernel. Query ids may be int32 or
int64; results are int64 unless stated (the tree distances are int32,
as in the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bfs import INF
from repro_torch.core.pow2 import log2_ceil


class LiftingTables(NamedTuple):
    up: torch.Tensor     # (LOG, n) int32 — 2^k-th ancestor (root loops)
    depth: torch.Tensor  # (n,) int32


def build_lifting(parent: torch.Tensor, depth: torch.Tensor, n: int,
                  levels: int | None = None) -> LiftingTables:
    """levels: optional depth bound with 2^levels > max(depth); the
    default ceil(log2(n+1)) is always safe."""
    log = levels if levels is not None else log2_ceil(n + 1)
    cur = torch.where(parent < 0,
                      torch.arange(n, dtype=parent.dtype,
                                   device=parent.device), parent)
    ups = []
    for _ in range(log):
        ups.append(cur)
        cur = cur[cur]
    return LiftingTables(up=torch.stack(ups).to(torch.int32),
                         depth=depth.to(torch.int32))


def kth_ancestor(t: LiftingTables, node: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """Ancestor `k` hops above `node` (clamped at the root)."""
    cur = node.to(torch.int64)
    for i in range(t.up.shape[0]):
        cur = torch.where(((k >> i) & 1) == 1, t.up[i][cur].to(torch.int64),
                          cur)
    return cur


def lca(t: LiftingTables, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LCA of query tensors a, b (same shape) by the lifting climb."""
    log = t.up.shape[0]
    da = t.depth[a].to(torch.int64)
    db = t.depth[b].to(torch.int64)
    a2 = kth_ancestor(t, a, torch.clamp(da - db, min=0))
    b2 = kth_ancestor(t, b, torch.clamp(db - da, min=0))
    for i in range(log):
        k = log - 1 - i
        ua = t.up[k][a2].to(torch.int64)
        ub = t.up[k][b2].to(torch.int64)
        jump = (a2 != b2) & (ua != ub)
        a2 = torch.where(jump, ua, a2)
        b2 = torch.where(jump, ub, b2)
    return torch.where(a2 == b2, a2, t.up[0][a2].to(torch.int64))


def tree_distance(t: LiftingTables, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    w = lca(t, a, b)
    d = t.depth.to(torch.int64)
    return d[a] + d[b] - 2 * d[w]


def tree_distance_with_lca(t: LiftingTables, a: torch.Tensor,
                           b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Distance when the LCA `w` is already known (saves the climb)."""
    d = t.depth.to(torch.int64)
    return d[a] + d[b] - 2 * d[w]


def subroot(t: LiftingTables, node: torch.Tensor) -> torch.Tensor:
    """Ancestor at depth 1 (the root-subtree id); the root maps to itself."""
    d = t.depth[node].to(torch.int64)
    return kth_ancestor(t, node, torch.clamp(d - 1, min=0))


def lca_with_shortcut(t: LiftingTables, root: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """LGRASS §3.2: if a, b sit in different root subtrees, LCA = root."""
    different = subroot(t, a) != subroot(t, b)
    return torch.where(different, root, lca(t, a, b))


class EulerLCA(NamedTuple):
    """Euler tour + sparse-table RMQ — O(1) gathers per LCA query."""

    tour: torch.Tensor   # (P,) — node at each tour position (P = 2n - 1)
    dseq: torch.Tensor   # (P,) — depth along the tour (INF past the end)
    first: torch.Tensor  # (n,) — first tour position of each node
    table: torch.Tensor  # (LOGP, P) — position of the depth minimum in
    #                      [i, i + 2^k) (clamped at the tour end)
    depth: torch.Tensor  # (n,) — node depths


def tables_from_tour(tour: torch.Tensor, T: torch.Tensor,
                     depth: torch.Tensor, n: int) -> EulerLCA:
    """EulerLCA tables from a materialised tour with positions 0..T real;
    any valid Euler tour of the (sub)tree gives the same LCA answers."""
    dev = tour.device
    P = 2 * n - 1
    piota = torch.arange(P, dtype=torch.int64, device=dev)
    real = piota <= T
    depth = depth.to(torch.int64)
    dseq = torch.where(real, depth[tour], INF)
    first = torch.full((n,), P - 1, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, tour[real], piota[real], "amin",
                          include_self=True)
    tabs = [piota]
    for k in range(1, log2_ceil(P) + 1 if P > 1 else 1):
        h = 1 << (k - 1)
        prev = tabs[-1]
        other = prev[torch.clamp(piota + h, max=P - 1)]
        tabs.append(torch.where(dseq[other] < dseq[prev], other, prev))
    return EulerLCA(tour=tour, dseq=dseq, first=first,
                    table=torch.stack(tabs), depth=depth)


def build_euler(parent: torch.Tensor, depth: torch.Tensor,
                root: torch.Tensor, n: int) -> EulerLCA:
    """The Euler-tour LCA tables of a rooted tree given by parent pointers
    (parent < 0 for the root and for unreachable nodes, which are not
    toured): the reference's `repro.core.lca.build_euler`.

    The tour is the node sequence of a DFS that orders children by
    ascending id, materialised without a sequential DFS: children sorted
    by (parent, id) with the u64 pair sort (invalid entries last), per-arc
    successor pointers (enter first child / next sibling / climb back;
    the up-arc of the root's last child ends the tour), pointer-doubling
    list ranking over the 2n arc slots, one scatter into the node
    sequence. JAX's dropped scatters become masked scatters; every kept
    target is distinct.
    """
    from repro_torch.core.sort import U32_MASK, radix_argsort_u64pair

    dev = parent.device
    P = 2 * n - 1
    parent = parent.to(torch.int64)
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    valid_c = parent >= 0

    # -- 1. successor pointers ------------------------------------------
    S = radix_argsort_u64pair(
        torch.where(valid_c, parent, torch.full_like(parent, U32_MASK)),
        nodes)
    Sv = valid_c[S]
    Sp = torch.where(Sv, parent[S], -1)
    is_first = Sv & ((nodes == 0) | (Sp != torch.roll(Sp, 1)))
    first_child = torch.full((n,), -1, dtype=torch.int64, device=dev)
    first_child[Sp[is_first]] = S[is_first]
    has_next = (nodes < n - 1) & Sv & (Sp == torch.roll(Sp, -1))
    next_sib = torch.full((n,), -1, dtype=torch.int64, device=dev)
    next_sib[S[has_next]] = torch.roll(S, -1)[has_next]

    # arc c (parent -> c) and n + c (c -> parent)
    arc_ids = torch.arange(2 * n, dtype=torch.int64, device=dev)
    succ_down = torch.where(first_child >= 0, first_child, n + nodes)
    at_end = (parent == root) & (next_sib < 0)
    succ_up = torch.where(
        next_sib >= 0, next_sib,
        torch.where(at_end, n + nodes, n + torch.clamp(parent, min=0)))
    arc_valid = torch.cat([valid_c, valid_c])
    succ = torch.where(arc_valid, torch.cat([succ_down, succ_up]), arc_ids)

    # -- 2. list ranking by pointer doubling ----------------------------
    d = (succ != arc_ids).to(torch.int64)
    nxt = succ
    for _ in range(log2_ceil(2 * n) + 1):
        d = d + d[nxt]
        nxt = nxt[nxt]
    fc_root = first_child[root]
    T = torch.where(fc_root >= 0, d[torch.clamp(fc_root, min=0)] + 1, 0)
    pos = T - 1 - d

    # -- 3. node sequence -----------------------------------------------
    heads = torch.cat([nodes, torch.clamp(parent, min=0)])
    tour = torch.zeros((P,), dtype=torch.int64, device=dev)
    tour[0] = root
    wpos = pos + 1
    keep = arc_valid & (wpos < P)
    tour[wpos[keep]] = heads[keep]

    # -- 4. depth sequence, first occurrences, sparse RMQ table ---------
    return tables_from_tour(tour, T, depth, n)


def lca_euler(e: EulerLCA, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LCA in O(1) gathers per query (any query shape)."""
    logp, P = e.table.shape
    fa, fb = e.first[a], e.first[b]
    lo = torch.minimum(fa, fb)
    hi = torch.maximum(fa, fb)
    span = hi - lo + 1
    k = torch.zeros_like(span)
    for j in range(1, logp):
        k = k + (span >= (1 << j)).to(span.dtype)
    flat = e.table.reshape(-1)
    i1 = flat[k * P + lo]
    i2 = flat[k * P + (hi + 1 - torch.bitwise_left_shift(
        torch.ones_like(k), k))]
    w = torch.where(e.dseq[i2] < e.dseq[i1], i2, i1)
    return e.tour[w]


def tree_distance_euler(e: EulerLCA, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """int32, wrapped as the reference's int32 sum wraps: a node off the
    root's component has depth INF, and a sum over two of them overflows
    (the lifting climb's `tree_dist_pairs` wraps the same way)."""
    w = lca_euler(e, a, b)
    return (e.depth[a] + e.depth[b] - 2 * e.depth[w]).to(torch.int32)
