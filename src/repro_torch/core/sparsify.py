"""LGRASS end-to-end pipeline on PyTorch: the public sparsifier API.

    EFF  -> graph BFS + depth-scaled effective weights      (bfs.py)
    SORT -> 4-pass radix sort on IEEE-754 keys              (sort.py)
    MST  -> Borůvka maximum spanning tree                   (mst.py)
    LCA  -> tree rooting, binary lifting, O(1) LCA          (bfs.py, lca.py)
    RES  -> root-path resistance sums -> criticality        (resistance.py)
    MARK -> per-group greedy (phase 1): chain + tail launch (marking.py)
    REC  -> greedy replay in criticality order: one cluster (recovery.py)

The port of `repro.core.sparsify`. `lgrass_sparsify(g)` runs
`lgrass_device`, phase 1 followed by the recovery replay, on one device,
and only masks and scalar statistics come back to the host; with
`recovery="host"` phase 1 runs on the device and the replay is the numpy
oracle `recover_host`. Every engine of the reference is here, with its
options (`schedule`, `parallel`, `bfs_engine`, `use_euler_lca`,
`use_tree_kernel`, `auto_lift_bound`). The batched forms
(`phase1_device_batched`, `lgrass_device_batched`,
`lgrass_sparsify_batch`) run each lane of a padded `GraphBatch` through
the same program with its padding mask, one lane after another, and
stack the outputs as the reference's vmap does. Edge masks are
bit-identical to `repro.core`'s and to `baseline_sparsify`. Each stage
runs under a `torch.profiler.record_function` span of its name (EFF,
SORT_EFF, MST, ROOT_TREE, LCA, RES, LAYOUT, MARK, REC_ORDER, REC), which
costs nothing measurable when no profiler is active.

The entry points that take host graphs run on the CUDA device unless the
caller passes `device="cpu"`; without a CUDA device the default raises.
Those that take tensors run on the tensors' device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import _host as H
from repro_torch.core.baseline import default_budget
from repro_torch.core.bfs import (bfs, effective_weights, finite_depth,
                                  root_tree_euler, select_root)
from repro_torch.core.graph import Graph, GraphBatch
from repro_torch.core.lca import (LiftingTables, build_euler, build_lifting,
                                  lca_euler, lca_with_shortcut)
from repro_torch.core.marking import (build_group_layout, group_keys,
                                      phase1_edge_views, run_phase1)
from repro_torch.core.mst import boruvka_mst
from repro_torch.core.pow2 import log2_ceil, next_pow2
from repro_torch.core.recovery import recover_host
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


def _phase1_program(u, v, w, n: int, k_cap: int, parallel: bool = True,
                    lift_levels: Optional[int] = None, edge_valid=None,
                    schedule: str = "chunked", p1_chunk=None,
                    use_euler_lca: bool = True,
                    use_tree_kernel: bool = False,
                    bfs_engine: str = "doubling"):
    """EFF→SORT→MST→LCA→RES→SORT→MARK (phase 1), optionally
    padding-masked; returns (outputs, euler, layout): the outputs as a
    dict, the Euler tables (or None) and MARK's group layout.

    With edge_valid=None this is the single-graph program. With a padding
    mask (a `GraphBatch` lane) every stage is threaded so padding edges
    never enter the tree or a crossing group. bfs_engine "doubling" roots
    the tree by its Euler tour (`root_tree_euler`, which also gives the
    O(1)-LCA tables); "levels" runs a second level-synchronous BFS over
    the tree edges and builds the tables from its parents
    (`build_euler`). The tables are built when use_euler_lca and not
    use_tree_kernel; they back MARK (chunked schedule only) and REC,
    whose distances are otherwise the lifting climb's.
    """
    with record_function("EFF"):
        root = select_root(u, v, n, edge_valid)
        depth_g, _ = bfs(u, v, n, root, edge_mask=edge_valid,
                         engine=bfs_engine)
        eff = effective_weights(u, v, w, depth_g, n, edge_valid)
    with record_function("SORT_EFF"):
        perm_eff = sort_f32_desc_stable(eff, valid=edge_valid)
        rank_eff = torch.empty_like(perm_eff)
        rank_eff[perm_eff] = torch.arange(perm_eff.shape[0],
                                          dtype=torch.int64, device=u.device)
    with record_function("MST"):
        tree_mask = boruvka_mst(u, v, rank_eff, n, edge_valid)

    want_euler = use_euler_lca and not use_tree_kernel
    with record_function("ROOT_TREE"):
        if bfs_engine == "doubling":
            depth_t, parent_t, euler = root_tree_euler(
                u, v, n, root, tree_mask, with_euler=want_euler)
        else:
            depth_t, parent_t = bfs(u, v, n, root, edge_mask=tree_mask,
                                    engine=bfs_engine)
            euler = (build_euler(parent_t, depth_t, root, n)
                     if want_euler else None)
    with record_function("LCA"):
        t = build_lifting(parent_t, depth_t, n, levels=lift_levels)
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
        is_offtree = (~tree_mask if edge_valid is None
                      else ~tree_mask & edge_valid)
        hi, lo, crossing = group_keys(t, root, u, v, elca, is_offtree)
        layout = build_group_layout(crit, hi, lo, crossing, edge_valid)
    with record_function("MARK"):
        su, sv, sbeta = u[layout.perm], v[layout.perm], beta[layout.perm]
        p1 = run_phase1(t, su, sv, sbeta, layout, k_cap=k_cap,
                        schedule=schedule, parallel=parallel, chunk=p1_chunk,
                        use_tree_kernel=use_tree_kernel,
                        euler=euler if schedule == "chunked" else None)
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


def phase1_device(u, v, w, n: int, k_cap: int = 32, parallel: bool = True,
                  lift_levels: Optional[int] = None,
                  schedule: str = "chunked", p1_chunk: Optional[int] = None,
                  use_euler_lca: bool = True, use_tree_kernel: bool = False,
                  bfs_engine: str = "doubling") -> dict:
    """Phase 1 on the tensors' device: everything the recovery tail
    needs, as a dict of tensors."""
    d, _, _ = _phase1_program(u, v, w, n, k_cap, parallel, lift_levels,
                              None, schedule, p1_chunk, use_euler_lca,
                              use_tree_kernel, bfs_engine)
    return d


def _stack(lanes: list) -> dict:
    """Per-lane output dicts stacked along a leading (B,) axis."""
    return {k: torch.stack([d[k] for d in lanes]) for k in lanes[0]}


def phase1_device_batched(u, v, w, edge_valid, n: int, k_cap: int = 32,
                          parallel: bool = True,
                          lift_levels: Optional[int] = None,
                          schedule: str = "chunked",
                          p1_chunk: Optional[int] = None,
                          use_euler_lca: bool = True,
                          use_tree_kernel: bool = False,
                          bfs_engine: str = "doubling") -> dict:
    """`phase1_device` over a leading batch axis: (B, L_max) padded edge
    tensors, their (B, L_max) padding mask and the shared node pad
    n = n_max. Each lane runs the padded program (one MARK launch on a
    CUDA device); the outputs are stacked (B, ...), padding slots
    included."""
    return _stack([_phase1_program(
        u[i], v[i], w[i], n, k_cap, parallel, lift_levels, edge_valid[i],
        schedule, p1_chunk, use_euler_lca, use_tree_kernel, bfs_engine)[0]
        for i in range(u.shape[0])])


def _rec_inputs(d: dict, u, v, edge_valid=None) -> tuple:
    """REC's arguments before the budget, from phase 1's outputs: the
    lifting tables, the edges, phase 1's views by edge id and the
    (crit desc, id asc) order with tree and padding slots trailing."""
    offtree = ~d["tree_mask"]
    if edge_valid is not None:
        offtree = offtree & edge_valid
    accept_by_edge, group_of_edge, dirty0 = phase1_edge_views(
        d["perm"], d["gidx"], d["accept_sorted"], d["group_overflow"],
        d["crossing"])
    keys = torch.where(offtree, d["crit"],
                       torch.full_like(d["crit"], -torch.inf))
    return (LiftingTables(up=d["up"], depth=d["depth_t"]), u, v, d["beta"],
            offtree, d["crossing"], sort_f32_desc_stable(keys),
            accept_by_edge, group_of_edge, dirty0)


def _lgrass_program(u, v, w, budget: int, n: int, k_cap: int,
                    parallel: bool, lift_levels: Optional[int], b_cap: int,
                    edge_valid, use_tree_kernel: bool, chunk: int = 32,
                    schedule: str = "chunked", p1_chunk=None,
                    use_euler_lca: bool = True,
                    bfs_engine: str = "doubling") -> dict:
    """Phase 1 + the recovery replay on one device (Fig. 1b end to end)."""
    d, euler, _ = _phase1_program(u, v, w, n, k_cap, parallel, lift_levels,
                                  edge_valid, schedule, p1_chunk,
                                  use_euler_lca, use_tree_kernel, bfs_engine)
    with record_function("REC_ORDER"):
        rec = _rec_inputs(d, u, v, edge_valid)
    with record_function("REC"):
        accepted, n_accepted = ops.recover(*rec, budget, b_cap, chunk,
                                           euler)
    return dict(
        tree_mask=d["tree_mask"],
        accepted=accepted,
        n_accepted=torch.tensor(n_accepted, device=u.device),
        n_groups=d["n_groups"],
        n_overflow_groups=d["group_overflow"].sum(),
        n_dirty=rec[-1].sum(),
        tree_depth_max=finite_depth(d["depth_t"]).max(),
    )


def lgrass_device(u, v, w, budget: int, n: int, k_cap: int = 32,
                  parallel: bool = True, lift_levels: Optional[int] = None,
                  b_cap: int = B_CAP_FLOOR, use_tree_kernel: bool = False,
                  chunk: int = 32, schedule: str = "chunked",
                  p1_chunk: Optional[int] = None, use_euler_lca: bool = True,
                  bfs_engine: str = "doubling") -> dict:
    """The full program on the tensors' device: phase 1 fused with the
    recovery replay. Returns the final masks and scalar statistics."""
    return _lgrass_program(u, v, w, budget, n, k_cap, parallel, lift_levels,
                           b_cap, None, use_tree_kernel, chunk, schedule,
                           p1_chunk, use_euler_lca, bfs_engine)


def _lgrass_batched(u, v, w, edge_valid, budget, n: int, donate: bool,
                    **opts) -> dict:
    """The lane loop of the batched program; with `donate`, each lane's
    tree mask is written over its `edge_valid` row once the lane is done
    (later lanes read only their own rows), and the stacked `tree_mask`
    is `edge_valid` itself."""
    budgets = [int(b) for b in (budget.tolist() if torch.is_tensor(budget)
                                else budget)]
    lanes = []
    for i in range(u.shape[0]):
        d = _lgrass_program(u[i], v[i], w[i], budgets[i], n,
                            edge_valid=edge_valid[i], **opts)
        if donate:
            edge_valid[i].copy_(d.pop("tree_mask"))
        lanes.append(d)
    out = _stack(lanes)
    if donate:
        out["tree_mask"] = edge_valid
    return out


def lgrass_device_batched(u, v, w, edge_valid, budget, n: int,
                          k_cap: int = 32, parallel: bool = True,
                          lift_levels: Optional[int] = None,
                          b_cap: int = B_CAP_FLOOR,
                          use_tree_kernel: bool = False, chunk: int = 32,
                          schedule: str = "chunked",
                          p1_chunk: Optional[int] = None,
                          use_euler_lca: bool = True,
                          bfs_engine: str = "doubling") -> dict:
    """`lgrass_device` over a padded batch: (B, L_max) tensors, their
    padding mask, a (B,) budget vector (read on the host: REC takes its
    budget as a launch argument) and the node pad n = n_max. Each lane
    runs phase 1 and the replay (one MARK and one REC launch on a CUDA
    device); the outputs are stacked (B, ...)."""
    return _lgrass_batched(
        u, v, w, edge_valid, budget, n, False, k_cap=k_cap,
        parallel=parallel, lift_levels=lift_levels, b_cap=b_cap,
        use_tree_kernel=use_tree_kernel, chunk=chunk, schedule=schedule,
        p1_chunk=p1_chunk, use_euler_lca=use_euler_lca,
        bfs_engine=bfs_engine)


def lgrass_device_batched_donated(u, v, w, edge_valid, budget, n: int,
                                  k_cap: int = 32, parallel: bool = True,
                                  lift_levels: Optional[int] = None,
                                  b_cap: int = B_CAP_FLOOR,
                                  use_tree_kernel: bool = False,
                                  chunk: int = 32,
                                  schedule: str = "chunked",
                                  p1_chunk: Optional[int] = None,
                                  use_euler_lca: bool = True,
                                  bfs_engine: str = "doubling") -> dict:
    """`lgrass_device_batched` for callers that hand their inputs over
    (the serving plane's donated mode). The only same-shape, same-dtype
    input/output pair is edge_valid -> tree_mask, so each lane's tree
    mask is written into `edge_valid[i]` once lane i is done and the
    returned `tree_mask` is that storage: the call allocates no (B, L)
    output mask. Same outputs as the plain form, bit for bit."""
    return _lgrass_batched(
        u, v, w, edge_valid, budget, n, True, k_cap=k_cap,
        parallel=parallel, lift_levels=lift_levels, b_cap=b_cap,
        use_tree_kernel=use_tree_kernel, chunk=chunk, schedule=schedule,
        p1_chunk=p1_chunk, use_euler_lca=use_euler_lca,
        bfs_engine=bfs_engine)


_RESULT_STATS = ("n_accepted", "n_groups", "n_overflow_groups", "n_dirty")


def results_to_host(d: dict) -> dict:
    """The result fields of (batched) device outputs as numpy arrays, in
    one device-to-host copy: the four statistics as int64 and the two
    masks as bytes, packed on the device first."""
    stats = torch.stack([d[k].to(torch.int64) for k in _RESULT_STATS])
    masks = torch.stack([d["tree_mask"], d["accepted"]]).to(torch.uint8)
    flat = torch.cat([stats.reshape(-1).view(torch.uint8),
                      masks.reshape(-1)]).cpu().numpy()
    cut = stats.numel() * 8
    stats_h = flat[:cut].view(np.int64).reshape(stats.shape)
    masks_h = flat[cut:].view(bool).reshape(masks.shape)
    return dict(zip(_RESULT_STATS, stats_h), tree_mask=masks_h[0],
                accepted=masks_h[1])


def _result_from_host(h: dict, i: Optional[int], L: int) -> SparsifyResult:
    """One graph's `SparsifyResult` out of `results_to_host` arrays."""
    pick = (lambda x: x[i]) if i is not None else (lambda x: x)
    tree_mask = pick(h["tree_mask"])[:L]
    accepted = pick(h["accepted"])[:L]
    return SparsifyResult(
        edge_mask=tree_mask | accepted,
        tree_mask=tree_mask,
        accepted_mask=accepted,
        n_accepted=int(pick(h["n_accepted"])),
        n_groups=int(pick(h["n_groups"])),
        n_overflow_groups=int(pick(h["n_overflow_groups"])),
        n_dirty=int(pick(h["n_dirty"])),
    )


def _result_from_device(d: dict, i: Optional[int], L: int) -> SparsifyResult:
    """One graph's `SparsifyResult` out of (batched) device outputs."""
    return _result_from_host(results_to_host(d), i, L)


def _numpy(d: dict) -> dict:
    return {k: x.cpu().numpy() for k, x in d.items()}


def lgrass_sparsify(g: Graph, budget: Optional[int] = None, k_cap: int = 32,
                    parallel: bool = True, auto_lift_bound: bool = False,
                    recovery: str = "device", b_cap: Optional[int] = None,
                    use_tree_kernel: bool = False, chunk: int = 32,
                    schedule: str = "chunked",
                    p1_chunk: Optional[int] = None,
                    use_euler_lca: bool = True,
                    bfs_engine: str = "doubling",
                    device=None) -> SparsifyResult:
    """Run LGRASS on a host graph; returns the sparsifier edge mask.

    Arguments as `repro.core.lgrass_sparsify`'s, plus `device`: where the
    pipeline runs — the CUDA device by default (raises without one), or
    any torch device the caller names ("cpu" for the plain versions of
    the kernels). recovery "device" runs `lgrass_device`; "host" runs
    phase 1 on the device, reads it back once and replays Algorithm 6
    with the numpy oracle (`recover_host`). auto_lift_bound measures the
    graph BFS depth first and builds depth-bounded lifting tables, redone
    at full depth if the tree turns out deeper. b_cap defaults to a pow2
    bucket of the budget.
    """
    dev = resolve_device(device)
    if recovery not in ("device", "host"):
        raise ValueError(f"unknown recovery mode {recovery!r}")
    n, L = g.n, g.m
    budget = default_budget(n) if budget is None else int(budget)
    u = torch.as_tensor(np.asarray(g.u, np.int64), device=dev)
    v = torch.as_tensor(np.asarray(g.v, np.int64), device=dev)
    w = torch.as_tensor(np.asarray(g.w, np.float32), device=dev)

    lift_levels = None
    if auto_lift_bound:
        # estimate from the graph BFS depth ×4 (tree paths stretch); the
        # check after the run guarantees correctness regardless
        root = select_root(u, v, n)
        depth_g, _ = bfs(u, v, n, root, engine=bfs_engine)
        dmax = int(finite_depth(depth_g).max())
        safe = 1
        while (1 << safe) <= 4 * max(dmax, 1):
            safe += 1
        lift_levels = min(safe, log2_ceil(n + 1))
    opts = dict(k_cap=k_cap, parallel=parallel, schedule=schedule,
                p1_chunk=p1_chunk, use_euler_lca=use_euler_lca,
                use_tree_kernel=use_tree_kernel, bfs_engine=bfs_engine)

    if recovery == "device":
        if b_cap is None:
            b_cap = _bucket_b_cap([budget])
        if b_cap < budget:
            raise ValueError(f"b_cap {b_cap} < budget {budget}")
        opts.update(b_cap=b_cap, chunk=chunk)
        d = lgrass_device(u, v, w, budget, n, lift_levels=lift_levels,
                          **opts)
        if lift_levels is not None and \
                int(d["tree_depth_max"]) >= (1 << lift_levels):
            d = lgrass_device(u, v, w, budget, n, **opts)
        return _result_from_device(d, None, L)

    d = phase1_device(u, v, w, n, lift_levels=lift_levels, **opts)
    if lift_levels is not None and \
            int(d["depth_t"].max()) >= (1 << lift_levels):
        d = phase1_device(u, v, w, n, **opts)  # bound violated: redo
    return _recovery_tail(g, _numpy(d), budget)


def phase1_views_np(d: dict, L: int):
    """Numpy mirror of `marking.phase1_edge_views` + the global
    criticality order — the glue between MARK and a host-side replay.

    `d` holds one graph's phase-1 outputs as numpy arrays of padded
    length L_pad >= L (slicing to the leading L real slots is exact:
    padding edges were kept out of the tree and every crossing group).
    Returns (tree_mask, crossing, accept_by_edge, group_of_edge, dirty0,
    order) with `order` the full (L,) (crit desc, id asc) permutation,
    off-tree edges first.
    """
    L_pad = int(d["tree_mask"].shape[0])
    crossing_p = d["crossing"].astype(bool)
    perm = d["perm"].astype(np.int64)
    gidx = d["gidx"].astype(np.int64)

    accept_by_edge = np.zeros(L_pad, bool)
    accept_by_edge[perm] = d["accept_sorted"]
    group_of_edge = np.full(L_pad, -1, np.int64)
    group_of_edge[perm] = gidx
    group_of_edge[~crossing_p] = -1
    dirty0 = np.zeros(L_pad, bool)
    dirty0[perm] = d["group_overflow"].astype(bool)[gidx] & crossing_p[perm]

    tree_mask = d["tree_mask"].astype(bool)[:L]
    keys = np.where(~tree_mask, d["crit"][:L],
                    np.float32(-np.inf)).astype(np.float32)
    order = H.desc_stable_order_np(keys)
    return (tree_mask, crossing_p[:L], accept_by_edge[:L],
            group_of_edge[:L], dirty0[:L], order)


def _recovery_tail(g: Graph, d: dict, budget: int) -> SparsifyResult:
    """Host recovery from one graph's phase-1 outputs (numpy arrays). The
    tree tables go in as the reference's int32, whose distance sums wrap
    past the root's component."""
    n, L = g.n, g.m
    (tree_mask, crossing, accept_by_edge, group_of_edge, dirty0,
     order) = phase1_views_np(d, L)
    crit_order = order[: int((~tree_mask).sum())]
    accepted = recover_host(
        n=n,
        u=g.u.astype(np.int64),
        v=g.v.astype(np.int64),
        tree_mask=tree_mask,
        parent_t=d["parent_t"][:n].astype(np.int32),
        depth_t=d["depth_t"][:n].astype(np.int32),
        up=d["up"][:, :n].astype(np.int32),
        beta=d["beta"][:L].astype(np.int32),
        crossing=crossing,
        crit_order=crit_order,
        phase1_accept=accept_by_edge,
        group_of_edge=group_of_edge,
        dirty0=dirty0,
        budget=budget,
    )
    return SparsifyResult(
        edge_mask=tree_mask | accepted,
        tree_mask=tree_mask,
        accepted_mask=accepted,
        n_accepted=int(accepted.sum()),
        n_groups=int(d["n_groups"]),
        n_overflow_groups=int(d["group_overflow"].astype(bool).sum()),
        n_dirty=int(dirty0.sum()),
    )


def lgrass_sparsify_batch(graphs, budget=None, k_cap: int = 32,
                          parallel: bool = True, recovery: str = "device",
                          b_cap: Optional[int] = None,
                          use_tree_kernel: bool = False, chunk: int = 32,
                          schedule: str = "chunked",
                          p1_chunk: Optional[int] = None,
                          use_euler_lca: bool = True,
                          bfs_engine: str = "doubling",
                          device=None) -> list:
    """Run LGRASS on many graphs padded to one bucket; a list of
    `SparsifyResult`, one per graph, equal to per-graph
    `lgrass_sparsify` runs.

    graphs: a `GraphBatch`, or a sequence of `Graph`s (padded here).
    budget: None -> per-graph `default_budget(g.n)`; a scalar applies to
    every graph; a sequence gives one budget per graph (None entries
    fall back to that graph's default). recovery "device" runs
    `lgrass_device_batched` (b_cap the bucket of the largest budget);
    "host" runs `phase1_device_batched`, reads it back once, then the
    numpy replay per graph. device as for `lgrass_sparsify`.
    """
    dev = resolve_device(device)
    batch = (graphs if isinstance(graphs, GraphBatch)
             else GraphBatch.from_graphs(list(graphs)))
    if budget is None or np.ndim(budget) == 0:
        budget = [budget] * len(batch.graphs)
    elif len(budget) != len(batch.graphs):
        raise ValueError("one budget per graph required")
    budgets = [default_budget(g.n) if b is None else int(b)
               for g, b in zip(batch.graphs, budget)]
    u, v = (torch.as_tensor(x.astype(np.int64), device=dev)
            for x in (batch.u, batch.v))
    w = torch.as_tensor(batch.w, device=dev)
    valid = torch.as_tensor(batch.edge_valid, device=dev)
    opts = dict(k_cap=k_cap, parallel=parallel, schedule=schedule,
                p1_chunk=p1_chunk, use_euler_lca=use_euler_lca,
                use_tree_kernel=use_tree_kernel, bfs_engine=bfs_engine)

    if recovery == "device":
        if b_cap is None:
            b_cap = _bucket_b_cap(budgets)
        if b_cap < max(budgets):
            raise ValueError(f"b_cap {b_cap} < max budget {max(budgets)}")
        h = results_to_host(lgrass_device_batched(
            u, v, w, valid, budgets, batch.n_max, b_cap=b_cap, chunk=chunk,
            **opts))
        return [_result_from_host(h, i, g.m)
                for i, g in enumerate(batch.graphs)]
    if recovery != "host":
        raise ValueError(f"unknown recovery mode {recovery!r}")

    d = _numpy(phase1_device_batched(u, v, w, valid, batch.n_max, **opts))
    return [_recovery_tail(g, {k: x[i] for k, x in d.items()}, b)
            for i, (g, b) in enumerate(zip(batch.graphs, budgets))]
