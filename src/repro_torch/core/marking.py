"""Edge marking — LGRASS §3.1 + §4.2, phase 1 (MARK).

The port of `repro.core.marking`. Crossing edges only interact within
their LCA group (Lemma 3.1/3.2), root-LCA edges further split by their
(subtree, subtree) pair; the greedy keeps a bounded (G, K) table of
accepted edges per group and decides cover analytically,
dist(x, u_j) <= beta_j, by batched tree distances. Three schedules, all
with the same decisions:

  * `phase1_chunked` (schedule "chunked", the default) processes the
    sorted slots in blocks of C. Per block, one batched distance query
    (`ball_pair_table`) builds the cover table of the block against (a)
    each slot's group buffer snapshot and (b) every other block slot.
    The reference then resolves the block's accept chain with a C-step
    `lax.scan`. Slots only depend on earlier slots of their own group, so
    the port finds the same decisions as the fixed point of one
    vectorised step `store <- F(store)` over the whole block: after r
    applications every slot that is at most the r-th of its group within
    the block is final. The iteration stops when nothing changes (one
    sync per step) and never runs more steps than the block's longest
    group run, which is read once for all blocks. All table updates land
    in one batched scatter per block.
  * `phase1_basic` (schedule "scan", parallel=False) — one step per
    crossing slot in sorted order (the paper's basic LGRASS).
  * `phase1_parallel` (schedule "scan", parallel=True) — rank lockstep:
    at step r every group decides its r-th slot; as many steps as the
    longest crossing group.

The scan engines are the reference's lax loops as host loops of torch
ops on the tensors' device, with the lifting climb's distances
(`_ball_pair_covered`), as there; each step writes one slot per group,
so no scatter of theirs has a duplicate index. They never go through
the MARK kernel. The chunked loop is the plain version of MARK:
`run_phase1` sends "chunked" through `kernels.ops.mark`, which on a CUDA
device launches the MARK kernel (`kernels/phase1.py`, `csrc/mark.cu`), a
chain launch and a card-wide tail launch with no host sync between them
that make the same decisions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lca import (EulerLCA, LiftingTables, lca, subroot,
                                  tree_distance_euler)
from repro_torch.core.pow2 import auto_chunk
from repro_torch.core.sort import (UMAX, block_view, radix_argsort_u64pair,
                                   sort_f32_desc_stable)
from repro_torch.kernels import ops

class GroupLayout(NamedTuple):
    perm: torch.Tensor         # (L,) edge ids sorted by (group, crit-rank)
    gidx: torch.Tensor         # (L,) dense group index per sorted slot
    group_start: torch.Tensor  # (L,) first sorted slot of each group
    active: torch.Tensor       # (L,) bool — sorted slot holds a crossing edge
    n_groups: torch.Tensor     # 0-d (incl. possibly one inactive tail)


def group_keys(t: LiftingTables, root, u, v, edge_lca, is_offtree
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's two-step partition key F(u, v) as a (hi, lo) u32 pair
    (held in int64):

        hi = 0, lo = lca                      if lca != root
        hi = s1 + 1, lo = s2                  if lca == root (crossing)
        (UMAX, UMAX)                          inactive (tree / non-crossing)

    where s1 >= s2 are the compact root-subtree indices of u, v.
    """
    n = t.depth.shape[0]
    crossing = is_offtree & (edge_lca != u) & (edge_lca != v)
    child_rank = torch.cumsum((t.depth == 1).to(torch.int64), dim=0) - 1
    sub_all = subroot(t, torch.arange(n, dtype=torch.int64,
                                      device=u.device))
    s_u = child_rank[sub_all[u]]
    s_v = child_rank[sub_all[v]]
    s1 = torch.maximum(s_u, s_v)
    s2 = torch.minimum(s_u, s_v)
    at_root = edge_lca == root
    hi = torch.where(at_root, s1 + 1, 0)
    lo = torch.where(at_root, s2, edge_lca)
    hi = torch.where(crossing, hi, UMAX)
    lo = torch.where(crossing, lo, UMAX)
    return hi, lo, crossing


def build_group_layout(crit, hi, lo, crossing,
                       edge_valid: Optional[torch.Tensor] = None
                       ) -> GroupLayout:
    """Sort edges by (group, criticality desc, id asc); derive group spans.

    One f32 sort (4 byte passes) then one u64-pair sort (8 passes), both
    stable. Non-crossing and tree edges share the inactive (UMAX, UMAX)
    tail group, where `active` is False; so do padding edges
    (edge_valid False), which leaves the real groups' indices unchanged.
    L == 0 gives empty fields and n_groups == 0.
    """
    if edge_valid is not None:
        crossing = crossing & edge_valid
    m = crit.shape[0]
    dev = crit.device
    if m == 0:
        zi = torch.zeros((0,), dtype=torch.int64, device=dev)
        return GroupLayout(perm=zi, gidx=zi, group_start=zi,
                           active=torch.zeros((0,), dtype=torch.bool,
                                              device=dev),
                           n_groups=torch.zeros((), dtype=torch.int64,
                                                device=dev))
    p1 = sort_f32_desc_stable(
        torch.where(crossing, crit, torch.full_like(crit, -torch.inf)))
    p2 = radix_argsort_u64pair(hi[p1], lo[p1])  # stable => keeps crit order
    perm = p1[p2]
    sh, sl = hi[perm], lo[perm]
    bnd = (sh != torch.roll(sh, 1)) | (sl != torch.roll(sl, 1))
    bnd[0] = True
    gidx = torch.cumsum(bnd.to(torch.int64), dim=0) - 1
    iota = torch.arange(m, dtype=torch.int64, device=dev)
    group_start = torch.full((m,), m, dtype=torch.int64, device=dev)
    group_start.scatter_reduce_(0, gidx, iota, "amin", include_self=True)
    return GroupLayout(perm=perm, gidx=gidx, group_start=group_start,
                       active=crossing[perm],
                       n_groups=gidx[-1] + 1)


def ball_pair_table(t: LiftingTables, xs, ys, cols_u, cols_v, cols_b,
                    use_tree_kernel: bool = False,
                    euler: Optional[EulerLCA] = None) -> torch.Tensor:
    """Ball-pair cover table for a block of edges vs a set of candidates.

    xs, ys: (C,) block edge endpoints. cols_*: candidate accepted edges
    (u, v, beta), (K,) shared across the block or (C, K) per row.
    Returns (C, K) bool — candidate j's ball pair covers block edge i:

        cover <=> (d(x,u_j) <= b_j and d(y,v_j) <= b_j) or swapped.

    The 4·C·K tree distances are one batched query: the tree-distance
    kernel under `use_tree_kernel`, else the Euler-tour O(1) LCA of
    `euler`, which is then required.
    """
    c = xs.shape[0]
    k = cols_u.shape[-1]
    if cols_u.dim() == 1:
        cols_u = cols_u[None, :].expand(c, k)
        cols_v = cols_v[None, :].expand(c, k)
        cols_b = cols_b[None, :].expand(c, k)
    qa = torch.stack([xs, ys, xs, ys])[:, :, None].expand(4, c, k)
    qb = torch.stack([cols_u, cols_v, cols_v, cols_u])
    if use_tree_kernel:
        d = ops.tree_dist_pairs(t.up, t.depth, qa.reshape(-1),
                                qb.reshape(-1)).reshape(4, c, k)
    else:
        if euler is None:
            raise ValueError("ball_pair_table needs `euler` unless "
                             "use_tree_kernel is set")
        d = tree_distance_euler(euler, qa, qb)
    return ((d[0] <= cols_b) & (d[1] <= cols_b)) | (
        (d[2] <= cols_b) & (d[3] <= cols_b))


def _ball_pair_covered(t: LiftingTables, x, y, row_u, row_v, row_b,
                       cnt) -> torch.Tensor:
    """Paired-ball cover test against a (…, K) accepted-edge table:

        covered <=> exists j < cnt:
            (d(x,u_j) <= b_j and d(y,v_j) <= b_j) or
            (d(x,v_j) <= b_j and d(y,u_j) <= b_j)

    with the lifting climb's distances (`lca`), int32 with the reference's
    wrap (two unreachable depths), all four in one batched query. `t`
    holds int64 tables (the climb then casts nothing)."""
    xb = x[..., None].expand(row_u.shape)
    yb = y[..., None].expand(row_u.shape)
    qa = torch.stack([xb, xb, yb, yb])
    qb = torch.stack([row_u, row_v, row_u, row_v])
    d = t.depth
    dist = (d[qa] + d[qb] - 2 * d[lca(t, qa, qb)]).to(torch.int32)
    dxu, dxv, dyu, dyv = dist
    pair = (((dxu <= row_b) & (dyv <= row_b))
            | ((dxv <= row_b) & (dyu <= row_b)))
    k = row_u.shape[-1]
    valid = torch.arange(k, dtype=torch.int64,
                         device=x.device) < cnt[..., None]
    return (pair & valid).any(dim=-1)


class Phase1Result(NamedTuple):
    accept: torch.Tensor          # (L,) bool — per *sorted slot*
    group_overflow: torch.Tensor  # (L,) bool — per dense group index


def _empty_phase1(dev) -> Phase1Result:
    """The L == 0 result (isolated-node graphs)."""
    empty = torch.zeros((0,), dtype=torch.bool, device=dev)
    return Phase1Result(accept=empty, group_overflow=empty)


def _scan_state(t: LiftingTables, rows: int, k_cap: int, dev):
    """The scan engines' int64 tables and their (rows, K) accepted-edge
    table: (t64, acc_u, acc_v, acc_b, cnt), beta -1 matching nothing."""
    t64 = LiftingTables(up=t.up.to(torch.int64), depth=t.depth.to(torch.int64))
    acc_u = torch.zeros((rows, k_cap), dtype=torch.int64, device=dev)
    acc_b = torch.full((rows, k_cap), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros((rows,), dtype=torch.int64, device=dev)
    return t64, acc_u, acc_u.clone(), acc_b, cnt


def phase1_edge_views(perm, gidx, accept_sorted, group_overflow, crossing):
    """Scatter phase-1's sorted-slot outputs back to edge-id order: the
    accept decision, the dense group index (-1 for anything that is not
    a crossing edge) and the initial dirty set (every crossing edge of an
    overflowed group)."""
    L = perm.shape[0]
    dev = perm.device
    accept_by_edge = torch.zeros((L,), dtype=torch.bool, device=dev)
    accept_by_edge[perm] = accept_sorted
    group_of_edge = torch.full((L,), -1, dtype=torch.int64, device=dev)
    group_of_edge[perm] = gidx
    group_of_edge = torch.where(crossing, group_of_edge, -1)
    dirty0 = torch.zeros((L,), dtype=torch.bool, device=dev)
    dirty0[perm] = group_overflow[gidx] & crossing[perm]
    return accept_by_edge, group_of_edge, dirty0


def phase1_chunked(t: LiftingTables, su, sv, sbeta, layout: GroupLayout,
                   k_cap: int = 32, chunk: int = 32,
                   use_tree_kernel: bool = False,
                   euler: Optional[EulerLCA] = None) -> Phase1Result:
    """Two-level chunked greedy over the sorted slots (see module doc).

    Crossing slots occupy a prefix of the sorted layout, so the host loop
    runs ceil(n_crossing / chunk) blocks, counted once.
    """
    m = su.shape[0]
    dev = su.device
    if m == 0:
        return _empty_phase1(dev)
    c = max(min(chunk, m), 1)
    act_all = layout.active
    x_pad = block_view(torch.where(act_all, su, 0), c, 0)
    y_pad = block_view(torch.where(act_all, sv, 0), c, 0)
    b_pad = block_view(sbeta.to(torch.int64), c, -1)
    g_pad = block_view(layout.gidx, c, 0)
    act_pad = block_view(act_all, c, False)
    n_blocks = g_pad.shape[0]
    # position of each slot within its group's run inside its block; the
    # fixed-point step count of a block is bounded by its longest run
    slot = torch.arange(n_blocks * c, dtype=torch.int64, device=dev)
    run_start = torch.maximum(layout.group_start[g_pad.reshape(-1)],
                              (slot // c) * c)
    run_pad = torch.where(act_pad.reshape(-1), slot - run_start,
                           -1).reshape(n_blocks, c)
    steps = (run_pad.max(dim=1).values + 1).tolist()  # the one sync

    kiota = torch.arange(k_cap, dtype=torch.int64, device=dev)
    ciota = torch.arange(c, dtype=torch.int64, device=dev)
    earlier = ciota[None, :] < ciota[:, None]
    acc_u = torch.zeros((m, k_cap), dtype=torch.int64, device=dev)
    acc_v = torch.zeros((m, k_cap), dtype=torch.int64, device=dev)
    acc_b = torch.full((m, k_cap), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros((m,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((m,), dtype=torch.bool, device=dev)
    out = torch.zeros((n_blocks, c), dtype=torch.bool, device=dev)

    for blk, n_steps in enumerate(steps):
        if n_steps == 0:  # past the crossing prefix: nothing to decide
            break
        g, act = g_pad[blk], act_pad[blk]
        x, y, b = x_pad[blk], y_pad[blk], b_pad[blk]
        cnt0 = cnt[g]
        pair_buf = ball_pair_table(t, x, y, acc_u[g], acc_v[g], acc_b[g],
                                   use_tree_kernel, euler)
        cov_buf = (pair_buf & (kiota[None, :] < cnt0[:, None])).any(dim=1)
        pair_blk = ball_pair_table(t, x, y, x, y, b, use_tree_kernel, euler)
        same_prior = (g[:, None] == g[None, :]) & earlier
        cover_f = (pair_blk & same_prior).to(torch.float32)
        prior_f = same_prior.to(torch.float32)
        cand = act & ~cov_buf
        room = k_cap - cnt0
        store = torch.zeros((c,), dtype=torch.bool, device=dev)
        for it in range(n_steps):
            sf = store.to(torch.float32)
            accept = cand & ((cover_f @ sf) == 0)
            new_store = accept & ((prior_f @ sf) < room)
            if it + 1 < n_steps and not bool((new_store != store).any()):
                break
            store = new_store
        cnt_at = cnt0 + (prior_f @ store.to(torch.float32)).to(torch.int64)
        rows = g[store]
        cols = torch.clamp(cnt_at, max=k_cap - 1)[store]
        acc_u[rows, cols] = x[store]
        acc_v[rows, cols] = y[store]
        acc_b[rows, cols] = b[store]
        cnt.index_add_(0, rows, torch.ones_like(rows))
        ovf[g[accept & ~store]] = True
        out[blk] = accept
    return Phase1Result(accept=out.reshape(-1)[:m], group_overflow=ovf)


def phase1_basic(t: LiftingTables, su, sv, sbeta, layout: GroupLayout,
                 k_cap: int = 32) -> Phase1Result:
    """Sequential greedy (basic LGRASS): one step per sorted slot, each
    deciding its slot against its group's stored accepts.

    The reference scans every slot; the inactive tail (tree, non-crossing
    and padding slots, which sort last) decides nothing and changes no
    state, so the host loop stops after the crossing prefix, counted
    once. Every index of a step is a 1-element tensor, so a step enqueues
    its ops without a sync.
    """
    m = su.shape[0]
    dev = su.device
    if m == 0:
        return _empty_phase1(dev)
    t64, acc_u, acc_v, acc_b, cnt = _scan_state(t, m, k_cap, dev)
    ovf = torch.zeros((m,), dtype=torch.bool, device=dev)
    out = torch.zeros((m,), dtype=torch.bool, device=dev)
    su, sv, sbeta = su.to(torch.int64), sv.to(torch.int64), \
        sbeta.to(torch.int64)
    for i in range(int(layout.active.sum())):
        g = layout.gidx[i:i + 1]
        act = layout.active[i:i + 1]
        x = torch.where(act, su[i:i + 1], 0)
        y = torch.where(act, sv[i:i + 1], 0)
        c = cnt[g]
        cov = _ball_pair_covered(t64, x, y, acc_u[g], acc_v[g], acc_b[g], c)
        accept = act & ~cov
        full = c >= k_cap
        ovf[g] = ovf[g] | (accept & full)
        slot = torch.clamp(c, max=k_cap - 1)
        store = accept & ~full
        acc_u[g, slot] = torch.where(store, x, acc_u[g, slot])
        acc_v[g, slot] = torch.where(store, y, acc_v[g, slot])
        acc_b[g, slot] = torch.where(store, sbeta[i:i + 1], acc_b[g, slot])
        cnt[g] = c + store.to(torch.int64)
        out[i:i + 1] = accept
    return Phase1Result(accept=out, group_overflow=ovf)


def phase1_parallel(t: LiftingTables, su, sv, sbeta, layout: GroupLayout,
                    k_cap: int = 32) -> Phase1Result:
    """Rank-lockstep greedy (parallel LGRASS): step r decides the r-th
    slot of every group at once.

    The trip count is the longest *active* group: the (UMAX, UMAX) tail
    group of inactive slots never fires. Active groups are the leading
    dense group ids (crossing slots sort first). Their lanes are held in
    order of group size, largest first, so that step r works on the
    prefix of lanes whose group has an r-th slot and nothing else; the
    sizes are read once. Each step writes one slot per live lane, so no
    scatter has a duplicate index.
    """
    m = su.shape[0]
    dev = su.device
    if m == 0:
        return _empty_phase1(dev)
    group_size = torch.bincount(layout.gidx, minlength=m)
    group_active = layout.active[torch.clamp(layout.group_start, max=m - 1)]
    live = ((torch.arange(m, dtype=torch.int64, device=dev)
             < layout.n_groups) & group_active)
    sizes, lane_group = torch.sort(torch.where(live, group_size, 0),
                                   descending=True, stable=True)
    sizes_h = sizes.tolist()  # the one sync
    n_lanes = sum(1 for z in sizes_h if z > 0)
    lane_group, gs = lane_group[:n_lanes], \
        layout.group_start[lane_group[:n_lanes]]
    t64, acc_u, acc_v, acc_b, cnt = _scan_state(t, n_lanes, k_cap, dev)
    ovf = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    out = torch.zeros((m,), dtype=torch.bool, device=dev)
    su, sv, sbeta = su.to(torch.int64), sv.to(torch.int64), \
        sbeta.to(torch.int64)
    rows = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    k = n_lanes
    for r in range(sizes_h[0] if n_lanes else 0):
        while sizes_h[k - 1] <= r:  # lanes whose group has no r-th slot
            k -= 1
        i = gs[:k] + r
        x, y = su[i], sv[i]
        c = cnt[:k]
        accept = ~_ball_pair_covered(t64, x, y, acc_u[:k], acc_v[:k],
                                     acc_b[:k], c)
        full = c >= k_cap
        ovf[:k] |= accept & full
        slot = torch.clamp(c, max=k_cap - 1)
        store = accept & ~full
        at = (rows[:k], slot)
        acc_u[at] = torch.where(store, x, acc_u[at])
        acc_v[at] = torch.where(store, y, acc_v[at])
        acc_b[at] = torch.where(store, sbeta[i], acc_b[at])
        cnt[:k] += store.to(torch.int64)
        out[i] = accept
    group_overflow = torch.zeros((m,), dtype=torch.bool, device=dev)
    group_overflow[lane_group] = ovf
    return Phase1Result(accept=out, group_overflow=group_overflow)


def run_phase1(t: LiftingTables, su, sv, sbeta, layout: GroupLayout,
               k_cap: int = 32, schedule: str = "chunked",
               parallel: bool = True, chunk: Optional[int] = None,
               use_tree_kernel: bool = False,
               euler: Optional[EulerLCA] = None) -> Phase1Result:
    """Schedule dispatcher. "chunked" goes through `ops.mark`: the MARK
    kernel on a CUDA device and `phase1_chunked` on the CPU (an automatic
    pow2 block size, `pow2.auto_chunk`, ~sqrt(L), unless `chunk` pins
    one), with the Euler tables' distances, or the lifting climb's when
    `euler` is None or under use_tree_kernel. "scan" runs
    `phase1_parallel` (parallel=True) or `phase1_basic` on the tensors'
    device, never the MARK kernel."""
    if schedule == "chunked":
        c = auto_chunk(int(su.shape[0])) if chunk is None else int(chunk)
        return Phase1Result(*ops.mark(t, su, sv, sbeta, layout, k_cap, c,
                                      None if use_tree_kernel else euler))
    if schedule != "scan":
        raise ValueError(f"unknown phase-1 schedule {schedule!r}")
    fn = phase1_parallel if parallel else phase1_basic
    return fn(t, su, sv, sbeta, layout, k_cap=k_cap)
