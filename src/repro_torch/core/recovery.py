"""Recovery of non-crossing edges and their after-effects (Algorithm 6).

The port of `repro.core.recovery._recover_scan`, the device replay the
fused pipeline runs (the numpy `recover_host`, the standalone
`recover_device[_batched]` and `_euler_from_lifting` are still to port).

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

That loop is the plain version of REC: the pipeline goes through
`kernels.ops.recover`, which on a CUDA device launches the REC kernel
(`kernels/phase1.py`, `csrc/recover.cu`), one thread-block cluster that
makes the same decisions and whose accepted count is the one value read
back.
"""
from __future__ import annotations

import torch

from repro_torch.core.lca import LiftingTables
from repro_torch.core.marking import ball_pair_table
from repro_torch.core.sort import block_view


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
