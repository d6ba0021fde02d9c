"""Tree effective resistance and criticality (LGRASS §3.2, RES).

The port of the device half of `repro.core.resistance`:

    R_T(u, v) = rd[u] + rd[v] - 2 * rd[lca(u, v)]

with rd[x] the sum of 1/w on the root->x tree path, computed by weighted
binary lifting. Criticality of an off-tree edge is w(e) * R_T(u, v).

Every float32 operation is elementwise and keeps the reference's order:
`1 / w`, the doubling sums `ws + ws[up]` level by level, the high-bit to
low-bit climb, then `w * (rd[u] + rd[v] - 2 * rd[lca])`. One ulp in a
criticality value can reorder the sort and change the mask.

The numpy helpers at the end (dense Laplacian, pinv resistances,
Spearman, the probe calibration seam, pencil bounds) are the float64
oracle of the solver-free estimator's calibration checks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Dense ground truth (host / numpy, float64): the O(n^3) pseudoinverse
# oracle the solver-free estimator (core/spectral_probe.py) is calibrated
# against. Small n only. Copies of `repro.core.resistance`'s numpy helpers.
# ---------------------------------------------------------------------------


def dense_laplacian_np(n, u, v, w, mask=None) -> np.ndarray:
    """(n, n) float64 graph Laplacian of the (optionally masked) edges."""
    L = np.zeros((n, n), np.float64)
    if mask is None:
        mask = np.ones(len(u), bool)
    for x, y, ww, keep in zip(np.asarray(u), np.asarray(v),
                              np.asarray(w, np.float64), np.asarray(mask)):
        if not keep:
            continue
        x, y = int(x), int(y)
        L[x, x] += ww
        L[y, y] += ww
        L[x, y] -= ww
        L[y, x] -= ww
    return L


def dense_effective_resistance_np(L_dense: np.ndarray, u, v) -> np.ndarray:
    """Effective resistances R(u_i, v_i) via the Laplacian pseudoinverse:
    R(a, b) = (e_a - e_b)^T L^+ (e_a - e_b)."""
    P = np.linalg.pinv(L_dense, hermitian=True)
    u = np.asarray(u)
    v = np.asarray(v)
    return P[u, u] + P[v, v] - 2.0 * P[u, v]


def spearman_np(a, b) -> float:
    """Tie-aware Spearman rank correlation (ties get average ranks)."""
    def _ranks(x):
        x = np.asarray(x, np.float64)
        _, inv, cnt = np.unique(x, return_inverse=True, return_counts=True)
        start = np.cumsum(cnt) - cnt
        return (start + (cnt - 1) / 2.0)[inv]

    ra, rb = _ranks(a), _ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    if denom == 0.0:  # constant ranks on either side: define as perfect
        return 1.0
    return float((ra * rb).sum() / denom)


def probe_calibration_np(n, u, v, w, qu, qv, qw, r_hat,
                         mask=None) -> dict:
    """Score estimated resistances `r_hat` against the dense pinv on the
    (optionally masked) graph: Spearman of the raw resistances and of the
    criticality ordering (qw · R), plus relative-error quantiles."""
    L = dense_laplacian_np(n, u, v, w, mask=mask)
    r_dense = dense_effective_resistance_np(L, qu, qv)
    r_hat = np.asarray(r_hat, np.float64)
    qw = np.asarray(qw, np.float64)
    rel = np.abs(r_hat - r_dense) / np.maximum(r_dense, 1e-12)
    return dict(
        r_dense=r_dense,
        spearman_er=spearman_np(r_hat, r_dense),
        spearman_crit=spearman_np(qw * r_hat, qw * r_dense),
        med_rel_err=float(np.median(rel)) if len(rel) else 0.0,
        max_rel_err=float(rel.max()) if len(rel) else 0.0,
    )


def spectral_bounds_np(L_full: np.ndarray, L_sub: np.ndarray,
                       tol: float = 1e-9):
    """(lam_min, lam_max) of the pencil x^T L_sub x / x^T L_full x,
    restricted to range(L_full): for a subgraph sparsifier
    0 <= lam <= 1, and lam_min is how much of every quadratic form the
    sparsifier preserves."""
    d, U = np.linalg.eigh(L_full)
    keep = d > tol * max(float(d[-1]), 1.0)
    W = U[:, keep] / np.sqrt(d[keep])[None, :]
    M = W.T @ L_sub @ W
    lam = np.linalg.eigvalsh((M + M.T) / 2.0)
    return float(lam[0]), float(lam[-1])
