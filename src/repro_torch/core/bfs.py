"""BFS engines, root selection and effective weights (LGRASS §4.4, EFF).

The port of `repro.core.bfs`: both engines, selected by ``engine`` and
equal in output.

  * ``engine="levels"`` (`bfs_levels`) — one edge-parallel relaxation
    per BFS level, a host sync per level on the frontier;
  * ``engine="doubling"`` (`bfs_doubling`, the default) — Bellman–Ford
    relaxations plus pointer doubling, O(log n) rounds on chain-like
    inputs, a host sync per round on its fixpoint.

Every `jax.lax.while_loop` becomes a host loop that syncs once per round
on its condition; the loop bodies are the reference's edge-parallel
scatters and pointer doubling, on tensors of one device. Both engines,
`degrees`, `select_root` and `effective_weights` take the reference's
optional edge mask (the batched pipeline's padding).

Node ids, depths and parents are int64 tensors holding the reference's
int32 values; unreachable depths hold INF = INT32_MAX exactly as there.
The int64 width means the relaxation key dist·(n+1) + id of
`bfs_doubling` never overflows, so the port always runs it packed (the
reference unpacks above PACKED_KEY_MAX_N with identical results);
`packed_key_bound` and the two switch points are kept for parity.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.pow2 import log2_ceil

INF = 2 ** 31 - 1  # INT32_MAX, the reference's sentinel

BFS_ENGINES = ("doubling", "levels")


def packed_key_bound(n: int) -> int:
    """Largest packed relaxation key `bfs_doubling` can produce at `n`:
    dist·(n+1) + id with dist, id in [0, n], so (n+1)² − 1."""
    return (n + 1) * (n + 1) - 1


# Largest n for which the reference's packed key fits int32.
PACKED_KEY_MAX_N = math.isqrt(2 ** 31) - 1
# Largest n for which `root_tree_euler` packs an arc's (tail, head) pair
# into one u32 radix key (16 bits each); beyond it the u64 pair sort runs.
EULER_PACK_MAX_N = 0xFFFF


def finite_depth(depth: torch.Tensor) -> torch.Tensor:
    """Clamp unreachable (INF) BFS depths to 0."""
    return torch.where(depth == INF, torch.zeros_like(depth), depth)


def relax_key(ds: torch.Tensor, src: torch.Tensor, live: torch.Tensor,
              base: int) -> torch.Tensor:
    """`bfs_doubling`'s packed relaxation key ds·base + src of a live arc
    whose source is reached (INF otherwise), in int64: the product is
    formed on every arc, the INF depths' included, so it must fit int64
    at every n the port takes (`analysis.graph_audit` checks it)."""
    return torch.where(live & (ds < INF), ds * base + src, INF)


def euler_arc_key(tail: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """`root_tree_euler`'s (tail << 16) | head arc key, read as u32 by
    the radix sort: exact while tail, head <= EULER_PACK_MAX_N."""
    return (tail << 16) | head


def _full(n: int, value: int, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int64, device=device)


def _scatter_min(n: int, init: int, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """full(n, init).at[index].min(src) — deterministic for integers."""
    out = _full(n, init, index.device)
    return out.scatter_reduce_(0, index, src, "amin", include_self=True)


def _scatter_max(n: int, init: int, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    out = _full(n, init, index.device)
    return out.scatter_reduce_(0, index, src, "amax", include_self=True)


def _emask(src: torch.Tensor, edge_mask: Optional[torch.Tensor]):
    """The arc mask of an (L,) edge mask over src = cat([u, v])."""
    if edge_mask is None:
        return torch.ones_like(src, dtype=torch.bool)
    return torch.cat([edge_mask, edge_mask])


def bfs(u, v, n: int, root, edge_mask: Optional[torch.Tensor] = None,
        engine: str = "doubling"):
    """BFS over the undirected edge list from `root`: (depth, parent),
    INF / -1 for unreachable nodes. edge_mask: optional (L,) bool, True
    edges participate (the spanning tree, or the padding mask)."""
    if engine == "doubling":
        return bfs_doubling(u, v, n, root, edge_mask)
    if engine != "levels":
        raise ValueError(f"unknown BFS engine {engine!r}")
    return bfs_levels(u, v, n, root, edge_mask)


def bfs_levels(u: torch.Tensor, v: torch.Tensor, n: int, root: torch.Tensor,
               edge_mask: Optional[torch.Tensor] = None):
    """Level-synchronous BFS: one edge-parallel relaxation per level, the
    smallest active source id as each newly reached node's parent. The
    host loop syncs once per level, on whether the frontier is empty."""
    dev = u.device
    src = torch.cat([u, v])
    dst = torch.cat([v, u])
    emask = _emask(src, edge_mask)
    inf_src = torch.full_like(src, INF)
    depth = _full(n, INF, dev)
    depth[root] = 0
    parent = _full(n, -1, dev)
    frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
    frontier[root] = True
    level = 0
    while bool(frontier.any()):
        active = frontier[src] & emask
        cand = _scatter_min(n, INF, dst, torch.where(active, src, inf_src))
        newly = (cand != INF) & (depth == INF)
        parent = torch.where(newly, cand, parent)
        depth = torch.where(newly, level + 1, depth)
        frontier = newly
        level += 1
    return depth, parent


def bfs_doubling(u: torch.Tensor, v: torch.Tensor, n: int,
                 root: torch.Tensor,
                 edge_mask: Optional[torch.Tensor] = None):
    """Hop-doubling BFS: Bellman–Ford relaxations + pointer doubling.

    The reference's rounds (`repro.core.bfs.bfs_doubling`): one packed
    scatter-min relaxation that also yields the climb's re-anchor
    witness, two static monotone chains (smallest- / largest-id
    neighbour) pulled and squared, and a truncated re-anchored climb over
    the tentative-parent forest. The host loop runs to the relaxation
    fixpoint, where the tentative depths equal the BFS depths; the
    smallest-id parent then comes from one edge-parallel pass.
    """
    dev = u.device
    src = torch.cat([u, v])
    dst = torch.cat([v, u])
    emask = _emask(src, edge_mask)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    log = log2_ceil(n + 1)
    climb_len = max(2, (3 * log) // 5)
    base = n + 1
    kinf = INF

    inf_src = torch.full_like(src, INF)
    lo_nbr = _scatter_min(n, INF, dst, torch.where(emask, src, inf_src))
    hi_nbr = _scatter_max(n, -1, dst, torch.where(emask, src, -1))
    fallback = torch.where(lo_nbr != INF, lo_nbr, iota)
    pl = fallback
    ol = (pl != iota).to(torch.int64)
    pr = torch.where(hi_nbr >= 0, hi_nbr, iota)
    orr = (pr != iota).to(torch.int64)
    # depth 0 at the root, written on the device: `dist[root] = 0` reads
    # the 0-d root back and copies the 0 from the host
    dist = torch.where(iota == root, 0, _full(n, INF, dev))

    def pull(dist, p, o):
        dp = dist[p]
        c = torch.where(dp < INF, torch.clamp(dp + o, max=n), INF)
        return torch.minimum(dist, c)

    changed = True
    while changed:
        d_in = dist
        ds = dist[src]
        key = relax_key(ds, src, emask, base)
        kmin = _scatter_min(n, kinf, dst, key)
        has = kmin < kinf
        mnb = torch.where(has, kmin // base, INF)
        wit = torch.where(has, kmin % base, n)
        dist = torch.minimum(dist, torch.where(
            mnb < INF, torch.clamp(mnb + 1, max=n), INF))
        dist = pull(dist, pl, ol)
        dist = pull(dist, pr, orr)
        ol = torch.clamp(ol + ol[pl], max=n)
        pl = pl[pl]
        orr = torch.clamp(orr + orr[pr], max=n)
        pr = pr[pr]
        ptc = torch.where(wit < n, wit, fallback)
        ptc = torch.where(iota == root, root, ptc)
        jmp = ptc
        joff = (jmp != iota).to(torch.int64)
        for _ in range(climb_len):
            dist = pull(dist, jmp, joff)
            joff = torch.clamp(joff + joff[jmp], max=n)
            jmp = jmp[jmp]
        changed = bool(torch.any(dist != d_in))

    ds, dd = dist[src], dist[dst]
    prev = emask & (ds < INF) & (dd < INF) & (ds + 1 == dd)
    cand = _scatter_min(n, INF, dst, torch.where(prev, src, inf_src))
    parent = torch.where((dist > 0) & (dist < INF) & (cand < INF), cand, -1)
    return dist, parent


def root_tree_euler(u: torch.Tensor, v: torch.Tensor, n: int,
                    root: torch.Tensor, tree_mask: torch.Tensor,
                    with_euler: bool = True):
    """Root the spanning tree at `root` in O(log n) rounds — no BFS.

    Returns (depth, parent, euler), (depth, parent) equal to a BFS over
    the tree edges; `euler` is the `lca.EulerLCA` table set built from
    the same tour (or None). The reference's construction: arcs sorted by
    (tail, head) — one u32 radix key while ids fit 16 bits, the u64 pair
    sort beyond — Euler-circuit successor pointers with a terminator,
    pointer-doubling list ranking, then depth as a ±1 prefix sum over the
    ranked tour. JAX's dropped scatters (`mode="drop"`) become masked
    scatters; every kept target is distinct.
    """
    from repro_torch.core.lca import tables_from_tour
    from repro_torch.core.sort import (U32_MASK, radix_argsort_u32,
                                       radix_argsort_u64pair)

    dev = u.device
    L = u.shape[0]
    depth = torch.where(torch.arange(n, dtype=torch.int64, device=dev)
                        == root, 0, _full(n, INF, dev))
    parent = _full(n, -1, dev)
    P = 2 * n - 1
    if L == 0:
        euler = None
        if with_euler:
            tour0 = torch.zeros((P,), dtype=torch.int64, device=dev)
            tour0[0] = root
            euler = tables_from_tour(tour0, torch.zeros((), dtype=torch.int64,
                                                        device=dev), depth, n)
        return depth, parent, euler
    A = 2 * L
    aiota = torch.arange(A, dtype=torch.int64, device=dev)
    tail = torch.cat([u, v])
    head = torch.cat([v, u])
    valid = torch.cat([tree_mask, tree_mask])
    rev = torch.where(aiota < L, aiota + L, aiota - L)

    # -- 1. sorted out-arc blocks ---------------------------------------
    umax = torch.full_like(tail, U32_MASK)
    if n <= EULER_PACK_MAX_N:
        S = radix_argsort_u32(torch.where(valid, euler_arc_key(tail, head),
                                          umax))
    else:
        S = radix_argsort_u64pair(torch.where(valid, tail, umax), head)
    pos = torch.empty_like(S)
    pos[S] = aiota
    vS = valid[S]
    st = torch.where(vS, tail[S], -1)
    is_first = vS & ((aiota == 0) | (st != torch.roll(st, 1)))
    is_last = vS & ((aiota == A - 1) | (st != torch.roll(st, -1)))
    stc = torch.clamp(st, 0, n - 1)
    start_pos = _full(n, 0, dev)
    start_pos[stc[is_first]] = aiota[is_first]
    first_arc = _full(n, -1, dev)
    first_arc[stc[is_first]] = S[is_first]

    # -- 2. successor pointers + terminator -----------------------------
    succ_pos = torch.where(is_last, start_pos[stc],
                           torch.clamp(aiota + 1, max=A - 1))
    succ = torch.where(valid, S[succ_pos[pos[rev]]], aiota)
    s0 = first_arc[root]
    has_tour = s0 >= 0
    is_term = valid & (succ == s0) & has_tour
    term = torch.argmax(is_term.to(torch.int32))
    succ = torch.where(is_term, aiota, succ)

    # -- 3. list ranking by pointer doubling ----------------------------
    d = (succ != aiota).to(torch.int64)
    nxt = succ
    for _ in range(log2_ceil(A) + 1):
        d = d + d[nxt]
        nxt = nxt[nxt]
    in_tour = has_tour & valid & (nxt == term)
    T = torch.where(has_tour, d[torch.clamp(s0, min=0)] + 1, 0)
    rank = T - 1 - d

    # -- 4. depth prefix sum + parents ----------------------------------
    down = in_tour & (d > d[rev])
    seq = torch.zeros((A,), dtype=torch.int64, device=dev)
    seq[rank[in_tour]] = torch.where(down, 1, -1)[in_tour]
    csum = torch.cumsum(seq, dim=0)
    hd = head[down]
    parent[hd] = tail[down]
    depth[hd] = csum[torch.clamp(rank, 0, A - 1)][down]
    euler = None
    if with_euler:
        # arc of rank r contributes its head at tour position r + 1
        tour = torch.zeros((P,), dtype=torch.int64, device=dev)
        tour[0] = root
        wpos = torch.clamp(rank + 1, max=P)
        keep = in_tour & (wpos < P)
        tour[wpos[keep]] = head[keep]
        euler = tables_from_tour(tour, T, depth, n)
    return depth, parent, euler


def root_tree(u, v, n: int, root, tree_mask):
    """`root_tree_euler` without the LCA tables: (depth, parent) only."""
    depth, parent, _ = root_tree_euler(u, v, n, root, tree_mask,
                                       with_euler=False)
    return depth, parent


def degrees(u: torch.Tensor, v: torch.Tensor, n: int,
            edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Node degrees; padding edges (edge_valid False) add none."""
    one = torch.ones_like(u) if edge_valid is None else edge_valid.to(u.dtype)
    deg = torch.zeros((n,), dtype=u.dtype, device=u.device)
    deg.index_add_(0, u, one)
    deg.index_add_(0, v, one)
    return deg


def select_root(u, v, n: int,
                edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max-degree node, ties -> smallest id (torch.argmax returns the
    first maximum on CPU and CUDA). A 0-d int64 tensor. Padding edges
    add no degree, so a padded node can never win."""
    return torch.argmax(degrees(u, v, n, edge_valid))


def effective_weights(u, v, w, depth, n: int,
                      edge_valid: Optional[torch.Tensor] = None):
    """eff(e) = w(e) * (depth[u] + depth[v] + 1), unreachable depths
    clamped to 0 first (`finite_depth`); float32, elementwise, in the
    reference's order of operations. Padding slots are zeroed."""
    d = finite_depth(depth).to(torch.float32)
    eff = w * (d[u] + d[v] + 1.0)
    if edge_valid is not None:
        eff = torch.where(edge_valid, eff, torch.zeros_like(eff))
    return eff
