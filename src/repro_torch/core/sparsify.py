"""LGRASS end-to-end pipeline on PyTorch: the public sparsifier API.

    EFF  -> graph BFS + depth-scaled effective weights      (bfs.py)
    SORT -> 4-pass radix sort on IEEE-754 keys              (sort.py)
    MST  -> Borůvka maximum spanning tree                   (mst.py)
    LCA  -> Euler-tour rooting, binary lifting, O(1) LCA    (bfs.py, lca.py)
    RES  -> root-path resistance sums -> criticality        (resistance.py)
    MARK -> per-group greedy (phase 1): chain + tail launch (marking.py)
    REC  -> greedy replay in criticality order: one cluster (recovery.py)

The port of `repro.core.sparsify`'s single-graph device path:
`lgrass_sparsify(g)` runs `lgrass_device`, phase 1 followed by the
recovery replay, on one device, and only masks and scalar statistics
come back to the host. Its edge masks are bit-identical to
`repro.core.lgrass_sparsify` and to `baseline_sparsify`. Each stage runs
under a `torch.profiler.record_function` span of its name (EFF,
SORT_EFF, MST, ROOT_TREE, LCA, RES, LAYOUT, MARK, REC_ORDER, REC), which
costs nothing measurable when no profiler is active.

It runs on the CUDA device unless the caller passes `device="cpu"`;
without a CUDA device the default raises. Options of the reference that
are not ported yet (`recovery="host"`, `schedule="scan"`,
`bfs_engine="levels"`, `auto_lift_bound`) raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.baseline import default_budget
from repro_torch.core.bfs import (bfs, effective_weights, finite_depth,
                                  root_tree_euler, select_root)
from repro_torch.core.graph import Graph
from repro_torch.core.lca import (LiftingTables, build_lifting, lca_euler,
                                  lca_with_shortcut)
from repro_torch.core.marking import (build_group_layout, group_keys,
                                      phase1_edge_views, run_phase1)
from repro_torch.core.mst import boruvka_mst
from repro_torch.core.pow2 import next_pow2
from repro_torch.core.resistance import (criticality, node_parent_inv_w,
                                         root_path_sums)
from repro_torch.core.sort import sort_f32_desc_stable
from repro_torch.kernels import ops

# Device recovery holds accepted edges in a (b_cap,) buffer.
B_CAP_FLOOR = 8


def _bucket_b_cap(budgets) -> int:
    """Accept-buffer size covering every budget in `budgets`."""
    need = max([int(b) for b in budgets] + [1])
    return max(next_pow2(need), B_CAP_FLOOR)


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when None. Asking for CUDA without a
    CUDA device raises: nothing drops to the CPU unless asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the pipeline on the CPU")
    return dev


@dataclasses.dataclass
class SparsifyResult:
    edge_mask: np.ndarray       # (L,) bool — tree + accepted off-tree edges
    tree_mask: np.ndarray       # (L,) bool
    accepted_mask: np.ndarray   # (L,) bool — accepted off-tree edges
    n_accepted: int
    n_groups: int
    n_overflow_groups: int
    n_dirty: int


def _phase1_program(u, v, w, n: int, k_cap: int,
                    schedule: str = "chunked", p1_chunk=None,
                    use_tree_kernel: bool = False,
                    bfs_engine: str = "doubling"):
    """EFF→SORT→MST→LCA→RES→SORT→MARK (phase 1); returns (outputs,
    euler, layout): the outputs as a dict, the Euler tables (None under
    use_tree_kernel) and MARK's group layout.

    The Euler-tour O(1)-LCA tables are built once, from the tour
    `root_tree_euler` already ranks, and back the cover tests of MARK
    and REC; use_tree_kernel makes them climb the lifting table instead
    (the tree-distance kernel's climb) and skips the Euler build.
    """
    with record_function("EFF"):
        root = select_root(u, v, n)
        depth_g, _ = bfs(u, v, n, root, engine=bfs_engine)
        eff = effective_weights(u, v, w, depth_g, n)
    with record_function("SORT_EFF"):
        perm_eff = sort_f32_desc_stable(eff)
        rank_eff = torch.empty_like(perm_eff)
        rank_eff[perm_eff] = torch.arange(perm_eff.shape[0], device=u.device)
    with record_function("MST"):
        tree_mask = boruvka_mst(u, v, rank_eff, n)

    want_euler = not use_tree_kernel
    with record_function("ROOT_TREE"):
        depth_t, parent_t, euler = root_tree_euler(u, v, n, root, tree_mask,
                                                   with_euler=want_euler)
    with record_function("LCA"):
        t = build_lifting(parent_t, depth_t, n)
        if euler is not None:
            elca = lca_euler(euler, u, v)
        else:
            elca = lca_with_shortcut(t, root, u, v)
    with record_function("RES"):
        inv_w = node_parent_inv_w(u, v, w, tree_mask, parent_t, n)
        r = root_path_sums(t, inv_w)
        crit = criticality(t, r, u, v, w, elca)
        beta = torch.clamp(
            torch.minimum(depth_t[u], depth_t[v]) - depth_t[elca], min=1)

    with record_function("LAYOUT"):
        hi, lo, crossing = group_keys(t, root, u, v, elca, ~tree_mask)
        layout = build_group_layout(crit, hi, lo, crossing)
    with record_function("MARK"):
        su, sv, sbeta = u[layout.perm], v[layout.perm], beta[layout.perm]
        p1 = run_phase1(t, su, sv, sbeta, layout, k_cap=k_cap,
                        schedule=schedule, chunk=p1_chunk,
                        use_tree_kernel=use_tree_kernel, euler=euler)
    d = dict(
        tree_mask=tree_mask,
        parent_t=parent_t,
        depth_t=depth_t,
        up=t.up,
        beta=beta,
        crit=crit,
        crossing=crossing,
        perm=layout.perm,
        gidx=layout.gidx,
        accept_sorted=p1.accept,
        group_overflow=p1.group_overflow,
        n_groups=layout.n_groups,
    )
    return d, euler, layout


def phase1_device(u, v, w, n: int, k_cap: int = 32,
                  schedule: str = "chunked", p1_chunk: Optional[int] = None,
                  use_tree_kernel: bool = False,
                  bfs_engine: str = "doubling") -> dict:
    """Phase 1 on the tensors' device: everything the recovery tail
    needs, as a dict of tensors."""
    d, _, _ = _phase1_program(u, v, w, n, k_cap, schedule,
                              p1_chunk, use_tree_kernel, bfs_engine)
    return d


def _rec_inputs(d: dict, u, v) -> tuple:
    """REC's arguments before the budget, from phase 1's outputs: the
    lifting tables, the edges, phase 1's views by edge id and the
    (crit desc, id asc) order with tree edges trailing."""
    offtree = ~d["tree_mask"]
    accept_by_edge, group_of_edge, dirty0 = phase1_edge_views(
        d["perm"], d["gidx"], d["accept_sorted"], d["group_overflow"],
        d["crossing"])
    keys = torch.where(offtree, d["crit"],
                       torch.full_like(d["crit"], -torch.inf))
    return (LiftingTables(up=d["up"], depth=d["depth_t"]), u, v, d["beta"],
            offtree, d["crossing"], sort_f32_desc_stable(keys),
            accept_by_edge, group_of_edge, dirty0)


def _lgrass_program(u, v, w, budget: int, n: int, k_cap: int, b_cap: int,
                    use_tree_kernel: bool,
                    chunk: int = 32, schedule: str = "chunked",
                    p1_chunk=None, bfs_engine: str = "doubling") -> dict:
    """Phase 1 + the recovery replay on one device (Fig. 1b end to end)."""
    d, euler, _ = _phase1_program(u, v, w, n, k_cap, schedule,
                                  p1_chunk, use_tree_kernel, bfs_engine)
    with record_function("REC_ORDER"):
        rec = _rec_inputs(d, u, v)
    with record_function("REC"):
        accepted, n_accepted = ops.recover(*rec, budget, b_cap, chunk,
                                           euler)
    depth_fin = finite_depth(d["depth_t"])
    return dict(
        tree_mask=d["tree_mask"],
        accepted=accepted,
        n_accepted=n_accepted,
        n_groups=d["n_groups"],
        n_overflow_groups=d["group_overflow"].sum(),
        n_dirty=rec[-1].sum(),
        tree_depth_max=depth_fin.max(),
    )


def lgrass_device(u, v, w, budget: int, n: int, k_cap: int = 32,
                  b_cap: int = B_CAP_FLOOR, use_tree_kernel: bool = False,
                  chunk: int = 32, schedule: str = "chunked",
                  p1_chunk: Optional[int] = None,
                  bfs_engine: str = "doubling") -> dict:
    """The full program on the tensors' device: phase 1 fused with the
    recovery replay. Returns the final masks and scalar statistics."""
    return _lgrass_program(u, v, w, budget, n, k_cap, b_cap,
                           use_tree_kernel, chunk, schedule, p1_chunk,
                           bfs_engine)


def lgrass_sparsify(g: Graph, budget: Optional[int] = None, k_cap: int = 32,
                    auto_lift_bound: bool = False,
                    recovery: str = "device", b_cap: Optional[int] = None,
                    use_tree_kernel: bool = False, chunk: int = 32,
                    schedule: str = "chunked",
                    p1_chunk: Optional[int] = None,
                    bfs_engine: str = "doubling",
                    device=None) -> SparsifyResult:
    """Run LGRASS on a host graph; returns the sparsifier edge mask.

    device: where the pipeline runs — the CUDA device by default (raises
    without one), or any torch device the caller names ("cpu" for the
    plain versions of the kernels). Arguments as in
    `repro.core.lgrass_sparsify`, less `parallel` and `use_euler_lca`:
    the port always runs the reference's defaults for those. b_cap
    defaults to a pow2 bucket of the budget.
    """
    dev = resolve_device(device)
    if auto_lift_bound:
        raise NotImplementedError("auto_lift_bound is not ported yet")
    if recovery == "host":
        raise NotImplementedError("recovery='host' is not ported yet")
    if recovery != "device":
        raise ValueError(f"unknown recovery mode {recovery!r}")
    n, L = g.n, g.m
    budget = default_budget(n) if budget is None else int(budget)
    if b_cap is None:
        b_cap = _bucket_b_cap([budget])
    if b_cap < budget:
        raise ValueError(f"b_cap {b_cap} < budget {budget}")
    u = torch.as_tensor(np.asarray(g.u, np.int64), device=dev)
    v = torch.as_tensor(np.asarray(g.v, np.int64), device=dev)
    w = torch.as_tensor(np.asarray(g.w, np.float32), device=dev)
    d = lgrass_device(u, v, w, budget, n, k_cap, b_cap,
                      use_tree_kernel, chunk, schedule, p1_chunk, bfs_engine)
    tree_mask = d["tree_mask"].cpu().numpy()[:L]
    accepted = d["accepted"].cpu().numpy()[:L]
    return SparsifyResult(
        edge_mask=tree_mask | accepted,
        tree_mask=tree_mask,
        accepted_mask=accepted,
        n_accepted=int(d["n_accepted"]),
        n_groups=int(d["n_groups"]),
        n_overflow_groups=int(d["n_overflow_groups"]),
        n_dirty=int(d["n_dirty"]),
    )
