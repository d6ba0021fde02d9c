"""Recovery of non-crossing edges and their after-effects (Algorithm 6).

The port of `repro.core.recovery`: the device replay `_recover_scan` the
fused pipeline runs, the standalone `recover_device` and
`recover_device_batched` (which rebuild the Euler tables from the
lifting table, `_euler_from_lifting`), and the numpy oracle
`recover_host` behind `recovery="host"`.

Phase 1 resolved crossing edges per LCA group. This replay walks all
off-tree edges in global criticality order and decides each: a crossing
edge keeps its phase-1 decision unless it is *dirty* (its group
overflowed, an earlier decision of its group flipped, or an accepted
non-crossing edge covers it); every other edge is accepted iff no
accepted edge's ball pair covers it. The accepted set lives in a
(b_cap,) buffer and the greedy stops at `budget` accepts.

Edges go in blocks of `chunk`: one batched distance query builds the
cover table of the block against the buffer and against itself. The
reference then replays the block with a `chunk`-step scan. Each slot's
decision depends only on the decisions of earlier slots of the block,
so the port finds the same decisions as the fixed point of one
vectorised step `dec <- F(dec)`: after r applications the first r slots
are final, and the iteration stops as soon as nothing changes (one sync
per application). The host loop over blocks stops once the budget is
filled, where the reference's while_loop stops.

That loop is the plain version of REC: the pipeline and
`recover_device` go through `kernels.ops.recover`, which on a CUDA
device launches the REC kernel (`kernels/phase1.py`, `csrc/recover.cu`),
one thread-block cluster that makes the same decisions and whose
accepted count is the one value read back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import _host as H
from repro_torch.core.lca import LiftingTables, build_euler
from repro_torch.core.marking import ball_pair_table
from repro_torch.core.sort import block_view
from repro_torch.kernels import ops


def recover_host(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    tree_mask: np.ndarray,
    parent_t: np.ndarray,
    depth_t: np.ndarray,
    up: np.ndarray,
    beta: np.ndarray,
    crossing: np.ndarray,
    crit_order: np.ndarray,
    phase1_accept: np.ndarray,
    group_of_edge: np.ndarray,
    dirty0: np.ndarray,
    budget: int,
) -> np.ndarray:
    """Returns (L,) bool — final accepted off-tree edges (numpy, on the
    host; the reference's oracle replay, line for line).

    phase1_accept: (L,) bool, meaningful for crossing edges only.
    group_of_edge: (L,) int64 dense group index, -1 for non-crossing.
    dirty0: (L,) bool — initial dirty set (overflowed groups).
    up, depth_t: int32, as the reference's, whose distance sums wrap.

    The reference's cover test climbs the lifting table. Where every node
    is reachable the port skips the entries farther in depth from an
    endpoint than their radius (a distance is at least the depth
    difference) and answers the rest's distances from an Euler tour
    (`H.tree_dist_euler_np`: the LCA of a tree is unique), the four of an
    edge in one query: the same decisions for a fraction of the numpy
    work. Past the root's component the climb decides, as there.
    """
    L = len(u)
    offtree = ~tree_mask
    adj = H.tree_adjacency(parent_t, n)
    euler = (H.euler_tables_np(parent_t, depth_t)
             if n and (depth_t != H.INF_I32).all() else None)
    dirty = dirty0.copy()
    out = np.zeros(L, bool)

    # accepted set: preallocated at the budget bound
    cap = max(int(budget), 1)
    acc_u = np.zeros(cap, np.int64)
    acc_v = np.zeros(cap, np.int64)
    acc_b = np.zeros(cap, np.int64)

    def covered_by_any(e: int, count: int) -> bool:
        if count == 0:
            return False
        au, av, ab = acc_u[:count], acc_v[:count], acc_b[:count]
        x, y = int(u[e]), int(v[e])
        if euler is not None:
            # a distance is at least the depth difference: only entries
            # within it of both endpoints can cover (the kernels' skip)
            du, dv = depth_t[au], depth_t[av]
            near = (((np.abs(depth_t[x] - du) <= ab)
                     & (np.abs(depth_t[y] - dv) <= ab))
                    | ((np.abs(depth_t[x] - dv) <= ab)
                       & (np.abs(depth_t[y] - du) <= ab)))
            if not near.any():
                return False
            au, av, ab = au[near], av[near], ab[near]
            k = len(au)
            dxu, dxv, dyu, dyv = H.tree_dist_euler_np(
                euler, depth_t, np.repeat([x, x, y, y], k),
                np.concatenate([au, av, au, av])).reshape(4, k)
        else:
            dxu = H.tree_dist_np(up, depth_t, x, au)
            dxv = H.tree_dist_np(up, depth_t, x, av)
            dyu = H.tree_dist_np(up, depth_t, y, au)
            dyv = H.tree_dist_np(up, depth_t, y, av)
        pair = ((dxu <= ab) & (dyv <= ab)) | ((dxv <= ab) & (dyu <= ab))
        return bool(pair.any())

    count = 0
    for e in crit_order:
        e = int(e)
        if count == budget:
            break
        if crossing[e] and not dirty[e]:
            dec = bool(phase1_accept[e])
        else:
            dec = not covered_by_any(e, count)
        if crossing[e] and dec != bool(phase1_accept[e]):
            # flip: later same-group phase-1 decisions are stale
            dirty |= group_of_edge == group_of_edge[e]
        if dec:
            out[e] = True
            acc_u[count] = int(u[e])
            acc_v[count] = int(v[e])
            acc_b[count] = int(beta[e])
            count += 1
            if not crossing[e]:
                # Alg. 6 after-effects: dirty everything this edge covers
                s1 = H.ball_np(adj, int(u[e]), int(beta[e]))
                s2 = H.ball_np(adj, int(v[e]), int(beta[e]))
                m1 = np.zeros(n, bool)
                m2 = np.zeros(n, bool)
                m1[list(s1)] = True
                m2[list(s2)] = True
                cov = offtree & ((m1[u] & m2[v]) | (m2[u] & m1[v]))
                dirty |= cov
    return out


def _recover_scan(t: LiftingTables, u, v, beta, offtree, crossing, order,
                  phase1_accept, group_of_edge, dirty0, budget: int,
                  b_cap: int, use_tree_kernel: bool = False,
                  chunk: int = 32, euler=None):
    """Returns (accepted (L,) bool, n_accepted int).

    `order` is the full (L,) (crit desc, id asc) permutation with tree
    slots trailing; `budget` is clamped to `b_cap`, the buffer size.
    """
    L = u.shape[0]
    dev = u.device
    if L == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev), 0
    budget = min(int(budget), int(b_cap))
    c = max(min(chunk, L), 1)
    order_pad = block_view(order.to(torch.int64), c, 0)
    svalid_pad = block_view(torch.ones((L,), dtype=torch.bool, device=dev),
                            c, False)
    n_blocks = order_pad.shape[0]
    beta = beta.to(torch.int64)
    occ_iota = torch.arange(b_cap, dtype=torch.int64, device=dev)
    ciota = torch.arange(c, dtype=torch.int64, device=dev)
    earlier = ciota[None, :] < ciota[:, None]
    earlier_f = earlier.to(torch.float32)

    buf_u = torch.zeros((b_cap,), dtype=torch.int64, device=dev)
    buf_v = torch.zeros((b_cap,), dtype=torch.int64, device=dev)
    buf_b = torch.full((b_cap,), -1, dtype=torch.int64, device=dev)
    buf_nc = torch.zeros((b_cap,), dtype=torch.bool, device=dev)
    gflag = torch.zeros((L + 1,), dtype=torch.bool, device=dev)
    out = torch.zeros((L,), dtype=torch.bool, device=dev)
    cnt = 0
    blk = 0
    while blk < n_blocks and cnt < budget:
        eids = order_pad[blk]
        a0 = svalid_pad[blk] & offtree[eids]
        bx = torch.where(a0, u[eids], 0)
        by = torch.where(a0, v[eids], 0)
        bb = beta[eids]
        pair = ball_pair_table(t, bx, by, torch.cat([buf_u, bx]),
                               torch.cat([buf_v, by]),
                               torch.cat([buf_b, bb]), use_tree_kernel,
                               euler)
        pair_buf, pair_blk = pair[:, :b_cap], pair[:, b_cap:]
        occ = occ_iota < cnt
        cov_buf = (pair_buf & occ).any(dim=1)
        cr = crossing[eids]
        g = group_of_edge[eids]
        gsafe = torch.where(g < 0, L, g)
        p1a = phase1_accept[eids]
        dirty_base = (dirty0[eids] | gflag[gsafe]
                      | (pair_buf & occ & buf_nc).any(dim=1))
        cover_f = (pair_blk & earlier).to(torch.float32)
        cover_nc_f = (pair_blk & earlier & ~cr[None, :]).to(torch.float32)
        group_f = ((gsafe[:, None] == gsafe[None, :]) & earlier).to(
            torch.float32)

        dec = torch.zeros((c,), dtype=torch.bool, device=dev)
        flip = torch.zeros((c,), dtype=torch.bool, device=dev)
        while True:
            df, ff = dec.to(torch.float32), flip.to(torch.float32)
            active = a0 & ((earlier_f @ df) < budget - cnt)
            cov_any = cov_buf | ((cover_f @ df) > 0)
            dirty = (dirty_base | ((cover_nc_f @ df) > 0)
                     | ((group_f @ ff) > 0))
            new_dec = active & torch.where(cr & ~dirty, p1a, ~cov_any)
            new_flip = active & cr & (new_dec != p1a)
            changed = bool(((new_dec != dec) | (new_flip != flip)).any())
            dec, flip = new_dec, new_flip
            if not changed:
                break

        out[eids[dec]] = True
        gflag[gsafe[flip]] = True
        k = int(dec.sum())
        if k:
            slots = torch.arange(cnt, cnt + k, dtype=torch.int64,
                                 device=dev)
            buf_u[slots] = bx[dec]
            buf_v[slots] = by[dec]
            buf_b[slots] = bb[dec]
            buf_nc[slots] = ~cr[dec]
        cnt += k
        blk += 1
    return out, cnt


def _euler_from_lifting(up: torch.Tensor, depth_t: torch.Tensor):
    """The Euler-tour O(1)-LCA tables from the lifting table: parent is
    up[0] with its self-loops (the root, unreachable or padded nodes)
    mapped back to -1, and the root is the unique depth-0 node (`argmin`:
    padding carries INF depth, so the real root always wins)."""
    n = up.shape[-1]
    up0 = up[0].to(torch.int64)
    nodes = torch.arange(n, dtype=torch.int64, device=up.device)
    parent = torch.where(up0 == nodes, -1, up0)
    return build_euler(parent, depth_t, torch.argmin(depth_t), n)


def _rec_lane(up, depth_t, u, v, beta, tree_mask, crossing, order,
              phase1_accept, group_of_edge, dirty0, budget: int, b_cap: int,
              edge_valid, use_tree_kernel: bool, chunk: int,
              use_euler_lca: bool):
    """One graph's standalone replay through `ops.recover` (the REC kernel
    on a CUDA device): (accepted (L,) bool, n_accepted int)."""
    t = LiftingTables(up=up.to(torch.int32), depth=depth_t.to(torch.int32))
    euler = None
    if use_euler_lca and not use_tree_kernel:
        euler = _euler_from_lifting(up, depth_t)
    offtree = ~tree_mask if edge_valid is None else (~tree_mask) & edge_valid
    return ops.recover(t, u, v, beta, offtree, crossing, order,
                       phase1_accept, group_of_edge, dirty0, int(budget),
                       b_cap, chunk, euler)


def _on(dev, x):
    """x (a tensor or an array) on `dev`, integers as int64; None stays."""
    if x is None:
        return None
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if x.dtype != torch.bool and not x.is_floating_point():
        x = x.to(torch.int64)
    return x.to(dev)


def recover_device(up, depth_t, u, v, beta, tree_mask, crossing, order,
                   phase1_accept, group_of_edge, dirty0, budget, b_cap: int,
                   edge_valid=None, use_tree_kernel: bool = False,
                   chunk: int = 32, use_euler_lca: bool = True,
                   device=None):
    """The standalone recovery replay from one graph's phase-1 outputs.

    Arguments as `recover_host`'s, except that `order` is the full (L,)
    sort permutation (`phase1_views_np`'s) and the tree is given by the
    lifting table `up` and `depth_t`; tensors or numpy arrays. It runs on
    `device`: the CUDA device by default (raises without one), where it
    launches the REC kernel; "cpu" for the plain loop. use_euler_lca
    (default on) rebuilds the Euler tables from up[0]; otherwise, and
    under use_tree_kernel, the lifting climb decides. `budget` is clamped
    to b_cap. Returns (accepted (L,) bool tensor, n_accepted int).
    """
    from repro_torch.core.sparsify import resolve_device

    dev = resolve_device(device)
    args = [_on(dev, x) for x in (up, depth_t, u, v, beta, tree_mask,
                                  crossing, order, phase1_accept,
                                  group_of_edge, dirty0)]
    return _rec_lane(*args, budget, b_cap, _on(dev, edge_valid),
                     use_tree_kernel, chunk, use_euler_lca)


def recover_device_batched(up, depth_t, u, v, beta, tree_mask, crossing,
                           order, phase1_accept, group_of_edge, dirty0,
                           budget, b_cap: int, edge_valid=None,
                           use_tree_kernel: bool = False, chunk: int = 32,
                           use_euler_lca: bool = True, device=None):
    """`recover_device` over a leading batch axis: every argument carries
    a (B, ...) dimension and `budget` is (B,). The lanes run one after
    another, each with its own Euler tables and one REC launch. Returns
    ((B, L) bool tensor, (B,) int64 tensor)."""
    from repro_torch.core.sparsify import resolve_device

    dev = resolve_device(device)
    args = [_on(dev, x) for x in (up, depth_t, u, v, beta, tree_mask,
                                  crossing, order, phase1_accept,
                                  group_of_edge, dirty0)]
    edge_valid = (torch.ones_like(args[5]) if edge_valid is None
                  else _on(dev, edge_valid))
    budgets = np.broadcast_to(np.asarray(budget), (args[0].shape[0],))
    outs, counts = [], []
    for i in range(args[0].shape[0]):
        acc, n_acc = _rec_lane(*(x[i] for x in args), int(budgets[i]),
                               b_cap, edge_valid[i], use_tree_kernel, chunk,
                               use_euler_lca)
        outs.append(acc)
        counts.append(n_acc)
    return (torch.stack(outs),
            torch.tensor(counts, dtype=torch.int64, device=dev))
