"""Tree effective resistance and criticality (LGRASS §3.2, RES).

The port of the device half of `repro.core.resistance`:

    R_T(u, v) = rd[u] + rd[v] - 2 * rd[lca(u, v)]

with rd[x] the sum of 1/w on the root->x tree path, computed by weighted
binary lifting. Criticality of an off-tree edge is w(e) * R_T(u, v).

Every float32 operation is elementwise and keeps the reference's order:
`1 / w`, the doubling sums `ws + ws[up]` level by level, the high-bit to
low-bit climb, then `w * (rd[u] + rd[v] - 2 * rd[lca])`. One ulp in a
criticality value can reorder the sort and change the mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.lca import LiftingTables


class ResistanceTables(NamedTuple):
    rd: torch.Tensor  # (n,) float32 — root-path resistance sum


def node_parent_inv_w(u, v, w, tree_mask, parent, n: int) -> torch.Tensor:
    """inv_w[c] = 1/w of the tree edge (c, parent[c]); 0 for the root."""
    inv = torch.zeros((n,), dtype=torch.float32, device=u.device)
    recip = torch.ones_like(w) / w
    for child, other in ((u, v), (v, u)):
        is_child = tree_mask & (parent[child] == other)
        inv[child[is_child]] = recip[is_child]
    return inv


def root_path_sums(t: LiftingTables, inv_w: torch.Tensor) -> ResistanceTables:
    """rd[x] = sum of inv_w along root->x, via weighted binary lifting."""
    log, n = t.up.shape
    up_k = t.up[0].to(torch.int64)
    ws_k = inv_w
    ups, wsums = [], []
    for _ in range(log):
        ups.append(up_k)
        wsums.append(ws_k)
        ws_k = ws_k + ws_k[up_k]
        up_k = up_k[up_k]
    cur = torch.arange(n, dtype=torch.int64, device=inv_w.device)
    acc = torch.zeros((n,), dtype=torch.float32, device=inv_w.device)
    rem = t.depth.to(torch.int64)
    zero = torch.zeros_like(acc)
    for i in range(log):
        k = log - 1 - i
        take = ((rem >> k) & 1) == 1
        acc = acc + torch.where(take, wsums[k][cur], zero)
        cur = torch.where(take, ups[k][cur], cur)
        rem = rem & ~(1 << k)
    return ResistanceTables(rd=acc)


def edge_resistance(t: LiftingTables, r: ResistanceTables, u, v,
                    edge_lca) -> torch.Tensor:
    return r.rd[u] + r.rd[v] - 2.0 * r.rd[edge_lca]


def criticality(t: LiftingTables, r: ResistanceTables, u, v, w,
                edge_lca) -> torch.Tensor:
    """Spectral criticality w(e) * R_T(e) — the greedy's sort key."""
    return w * edge_resistance(t, r, u, v, edge_lca)
