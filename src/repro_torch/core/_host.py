"""Bit-exact numpy mirrors of the device subroutines.

A copy of `repro.core._host`. The numpy oracle (baseline.py) must agree
with the torch pipeline down to float tie-breaks, so every float
computation here uses the *same expression and summation order* as the
device code (float32 throughout, elementwise, no reassociation).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.pow2 import log2_ceil as _log2_ceil

INF_I32 = np.iinfo(np.int32).max


def bfs_np(u, v, n, root, edge_mask=None):
    """Mirror of bfs.bfs — smallest-id-parent, level synchronous."""
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    if edge_mask is not None:
        emask = np.concatenate([edge_mask, edge_mask])
    else:
        emask = np.ones_like(src, dtype=bool)
    depth = np.full(n, INF_I32, np.int32)
    parent = np.full(n, -1, np.int32)
    depth[root] = 0
    frontier = np.zeros(n, bool)
    frontier[root] = True
    level = 0
    while frontier.any():
        active = frontier[src] & emask
        cand = np.full(n, INF_I32, np.int64)
        np.minimum.at(cand, dst[active], src[active])
        newly = (cand != INF_I32) & (depth == INF_I32)
        parent[newly] = cand[newly]
        depth[newly] = level + 1
        frontier = newly
        level += 1
    return depth, parent


def select_root_np(u, v, n) -> int:
    deg = np.zeros(n, np.int64)
    np.add.at(deg, u, 1)
    np.add.at(deg, v, 1)
    return int(np.argmax(deg))


def effective_weights_np(u, v, w, depth) -> np.ndarray:
    # mirror of bfs.finite_depth: unreachable depths clamp to 0 so a
    # disconnected input cannot poison the weights with float32(2^31-1)
    d = np.where(depth == INF_I32, 0, depth).astype(np.float32)
    return (w.astype(np.float32) * (d[u] + d[v] + np.float32(1.0))).astype(
        np.float32
    )


def float32_sort_key_np(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32)
    sign = bits >> 31
    return np.where(sign == 1, ~bits, bits | np.uint32(0x80000000))


def desc_stable_order_np(keys_f32: np.ndarray) -> np.ndarray:
    """(key desc, index asc) order — mirrors sort.sort_f32_desc_stable."""
    k = float32_sort_key_np(keys_f32)
    return np.argsort(~k, kind="stable")


def rank_from_order(order: np.ndarray) -> np.ndarray:
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank


def build_lifting_np(parent, depth, n):
    """Mirror of lca.build_lifting: up (LOG, n)."""
    log = _log2_ceil(n + 1)
    up = np.zeros((log, n), np.int32)
    up[0] = np.where(parent < 0, np.arange(n, dtype=np.int32), parent)
    for k in range(1, log):
        up[k] = up[k - 1][up[k - 1]]
    return up


def kth_ancestor_np(up, node, k):
    log = up.shape[0]
    cur = np.asarray(node).copy()
    k = np.asarray(k)
    for i in range(log):
        bit = (k >> i) & 1
        cur = np.where(bit == 1, up[i][cur], cur)
    return cur


def lca_np(up, depth, a, b):
    log = up.shape[0]
    a = np.asarray(a)
    b = np.asarray(b)
    da, db = depth[a], depth[b]
    a2 = kth_ancestor_np(up, a, np.maximum(da - db, 0))
    b2 = kth_ancestor_np(up, b, np.maximum(db - da, 0))
    for i in range(log):
        k = log - 1 - i
        ua, ub = up[k][a2], up[k][b2]
        jump = (a2 != b2) & (ua != ub)
        a2 = np.where(jump, ua, a2)
        b2 = np.where(jump, ub, b2)
    return np.where(a2 == b2, a2, up[0][a2])


def tree_dist_np(up, depth, a, b):
    w = lca_np(up, depth, a, b)
    return depth[a] + depth[b] - 2 * depth[w]


def euler_tables_np(parent, depth):
    """Euler tour + sparse-table RMQ of a rooted tree in which every node
    is reachable (parent < 0 only at the root): (tour, first, table,
    log_of) for `tree_dist_euler_np`. Any tour answers every LCA alike:
    the depth minimum between two first occurrences is the unique LCA."""
    n = len(parent)
    kids = tree_children(parent, n)
    tour = np.empty(2 * n - 1, np.int64)
    pos, stack = 0, [(int(np.argmin(depth)), 0)]
    while stack:
        node, i = stack.pop()
        tour[pos] = node
        pos += 1
        if i < len(kids[node]):
            stack.append((node, i + 1))
            stack.append((kids[node][i], 0))
    first = np.full(n, len(tour), np.int64)
    np.minimum.at(first, tour, np.arange(len(tour)))
    dseq = np.asarray(depth, np.int64)[tour]
    tabs = [np.arange(len(tour))]
    while (1 << len(tabs)) <= len(tour):
        prev, h = tabs[-1], 1 << (len(tabs) - 1)
        other = prev[np.minimum(np.arange(len(tour)) + h, len(tour) - 1)]
        tabs.append(np.where(dseq[other] < dseq[prev], other, prev))
    log_of = np.zeros(len(tour) + 1, np.int64)
    log_of[2:] = np.floor(np.log2(np.arange(2, len(tour) + 1))).astype(
        np.int64)
    return tour, first, np.stack(tabs), log_of, dseq


def tree_dist_euler_np(tables, depth, a, b):
    """Tree hop distances by the Euler tables' O(1) LCA; equal to
    `tree_dist_np` on a tree in which every node is reachable."""
    tour, first, table, log_of, dseq = tables
    fa, fb = first[a], first[b]
    lo, hi = np.minimum(fa, fb), np.maximum(fa, fb)
    k = log_of[hi - lo + 1]
    i1, i2 = table[k, lo], table[k, hi + 1 - (1 << k)]
    w = tour[np.where(dseq[i2] < dseq[i1], i2, i1)]
    return depth[a] + depth[b] - 2 * depth[w]


def node_parent_inv_w_np(u, v, w, tree_mask, parent, n):
    inv = np.zeros(n, np.float32)
    for arr_c, arr_p in ((u, v), (v, u)):
        is_child = tree_mask & (parent[arr_c] == arr_p)
        inv[arr_c[is_child]] = (np.float32(1.0) / w[is_child]).astype(np.float32)
    return inv


def root_path_sums_np(up, depth, inv_w, n):
    """Mirror of resistance.root_path_sums (same add order, float32)."""
    log = up.shape[0]
    ws = np.zeros((log, n), np.float32)
    ups = np.zeros((log, n), np.int32)
    cur_up = up[0].copy()
    cur_ws = inv_w.astype(np.float32).copy()
    for k in range(log):
        ups[k] = cur_up
        ws[k] = cur_ws
        cur_ws = (cur_ws + cur_ws[cur_up]).astype(np.float32)
        cur_up = cur_up[cur_up]
    nodes = np.arange(n, dtype=np.int32)
    rd = np.zeros(n, np.float32)
    cur = nodes.copy()
    rem = depth.astype(np.int32).copy()
    for i in range(log):
        k = log - 1 - i
        take = ((rem >> k) & 1) == 1
        rd = (rd + np.where(take, ws[k][cur], np.float32(0.0))).astype(np.float32)
        cur = np.where(take, ups[k][cur], cur)
        rem = rem & ~(1 << k)
    return rd


def criticality_np(u, v, w, rd, edge_lca) -> np.ndarray:
    r = (rd[u] + rd[v] - np.float32(2.0) * rd[edge_lca]).astype(np.float32)
    return (w.astype(np.float32) * r).astype(np.float32)


def tree_children(parent, n):
    kids = [[] for _ in range(n)]
    for c in range(n):
        p = parent[c]
        if p >= 0:
            kids[p].append(c)
    return kids


def ball_np(adj, center: int, beta: int) -> set:
    """Nodes within tree hop distance <= beta of center (adj = tree lists)."""
    seen = {center}
    frontier = [center]
    for _ in range(beta):
        nxt = []
        for x in frontier:
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    nxt.append(y)
        frontier = nxt
        if not frontier:
            break
    return seen


def tree_adjacency(parent, n):
    adj = [[] for _ in range(n)]
    for c in range(n):
        p = parent[c]
        if p >= 0:
            adj[c].append(p)
            adj[p].append(c)
    return adj


def phase1_np(up, depth_t, su, sv, sbeta, gidx, active, k_cap):
    """Numpy oracle for phase-1 marking — mirrors every schedule.

    Inputs are the *sorted-slot* views (marking.GroupLayout order):
    su/sv/sbeta the edge endpoints and ball radii per sorted slot, gidx
    the dense group index, `active` the crossing-slot mask. Replays the
    per-group greedy sequentially: accept a slot iff no *stored* earlier
    same-group accept covers its ball pair (tree distances via the
    binary-lifting tables); store at most k_cap accepts per group; an
    accept past k_cap only raises the group's overflow flag.

    Returns (accept (L,) bool per sorted slot, overflow (L,) bool per
    dense group index) — the `Phase1Result` layout.
    """
    m = len(su)
    accept = np.zeros(m, bool)
    overflow = np.zeros(m, bool)
    stored: dict = {}
    for i in range(m):
        if not active[i]:
            continue
        g = int(gidx[i])
        lst = stored.setdefault(g, [])
        x, y, b = int(su[i]), int(sv[i]), int(sbeta[i])
        covered = False
        for (au, av, ab) in lst:
            dxu = int(tree_dist_np(up, depth_t, x, au))
            dxv = int(tree_dist_np(up, depth_t, x, av))
            dyu = int(tree_dist_np(up, depth_t, y, au))
            dyv = int(tree_dist_np(up, depth_t, y, av))
            if (dxu <= ab and dyv <= ab) or (dxv <= ab and dyu <= ab):
                covered = True
                break
        if covered:
            continue
        accept[i] = True
        if len(lst) >= k_cap:
            overflow[g] = True
        else:
            lst.append((x, y, b))
    return accept, overflow
