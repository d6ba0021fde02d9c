"""Multi-device LGRASS: batch-axis sharding and the group-sharded phase 1.

The port of `repro.core.distributed`. A mesh here is an ordered tuple of
torch devices with axis names (`Mesh`); a shard is one entry of it, and
the host drives every shard from one process.

  * batch-axis sharding: `lgrass_device_batched` is embarrassingly
    parallel over its leading (graph) axis, so the serving plane
    (`SparsifyService(mesh=...)`) hands each mesh entry its contiguous
    slice of a chunk's rows (`shard_batch_leading`) and gathers the
    results in request order.
  * the group-sharded phase 1 (§4.2): `partition_groups` packs whole
    groups onto shards by greedy longest-processing-time (the paper's
    greedy scheduler, once up front since group sizes are known after
    the radix sort); `make_phase1_sharded` runs each shard's contiguous
    group block as one MARK call on the shard's device (the kernel on a
    CUDA device, the plain loop on the CPU) with the lifting climb's
    distances, as the reference's per-shard lockstep does. No exchange
    is needed inside phase 1: groups are independent (Lemma 3.1/3.2).

A mesh may name one device several times. That is the port's
counterpart of XLA's forced host device count: the CPU tests build 8
shards on `cpu`, and a single card can carry 4 shards of `cuda:0`. A
mesh that names a CUDA device the process cannot see raises; nothing
drops to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lca import LiftingTables
from repro_torch.core.marking import GroupLayout
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes, row-major: `devices` holds
    prod(axis_sizes) entries, repeats allowed."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("batch",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        sizes = (len(devs),) if self.axis_sizes is None \
            else tuple(int(s) for s in self.axis_sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"axis sizes {sizes} for axes {self.axis_names}")
        if not devs or int(np.prod(sizes)) != len(devs):
            raise ValueError(f"{len(devs)} devices for a mesh of {sizes}")
        for d in devs:
            if d.type == "cuda" and (not torch.cuda.is_available() or (
                    d.index or 0) >= torch.cuda.device_count()):
                raise RuntimeError(f"the mesh names {d}, which this process "
                                   "cannot see; pass device='cpu' for a CPU "
                                   "mesh")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def batch_mesh(n_devices: Optional[int] = None, axis: str = "batch",
               device=None) -> Mesh:
    """A 1-axis mesh for batch-axis sharding.

    device None: the distinct CUDA devices, `n_devices` of them (all by
    default); raises past `torch.cuda.device_count()` and without a card.
    device given ("cpu", "cuda:0"): `n_devices` shards (1 by default) all
    on that one device, the counterpart of XLA's forced host device count.
    """
    if device is not None:
        return Mesh((torch.device(device),) * int(n_devices or 1), (axis,))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a CPU mesh")
    n = count if n_devices is None else int(n_devices)
    if n > count:
        raise ValueError(f"batch_mesh({n}) but only {count} devices")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), (axis,))


def mesh_size(mesh: Mesh) -> int:
    """Total device count of `mesh` (the batch axis is sharded over ALL
    of its axes, so multi-axis meshes flatten into one factor)."""
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def shard_batch_leading(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """For each mesh entry, its contiguous slice of every tensor's leading
    axis on that entry's device: a list (one per entry) of tuples. A
    slice already on its device is a view, not a copy. The leading axis
    must divide by `mesh_size(mesh)`; the service pads the batch axis to
    guarantee that."""
    s = mesh_size(mesh)
    out = []
    for j, dev in enumerate(mesh.devices):
        part = []
        for t in tensors:
            rows, rem = divmod(t.shape[0], s)
            if rem:
                raise ValueError(f"leading axis {t.shape[0]} does not divide "
                                 f"by the mesh size {s}")
            part.append(t[j * rows:(j + 1) * rows].to(dev))
        out.append(tuple(part))
    return out


@dataclasses.dataclass
class ShardedGroupPlan:
    """Host-side plan mapping sorted slots onto shards (padded, contiguous)."""

    slot_edge: np.ndarray     # (S * Lloc,) int64 — edge id per padded slot (-1 pad)
    group_start: np.ndarray   # (S * Lloc,) int32 — local starts per shard lane
    group_size: np.ndarray    # (S * Lloc,) int32
    n_shards: int
    local_len: int
    load: np.ndarray          # (S,) int64 — slots per shard (diagnostics)


def partition_groups(perm: np.ndarray, gidx: np.ndarray, active: np.ndarray,
                     n_shards: int) -> ShardedGroupPlan:
    """Greedy LPT packing of whole groups onto shards.

    perm/gidx/active come from marking.build_group_layout (host copies).
    Groups never straddle shards, so shard-local greedy == global greedy
    per group (Lemma 3.1 independence).
    """
    m = len(perm)
    n_groups = int(gidx[-1]) + 1 if m else 0
    # group extents in sorted-slot space (active slots only)
    sizes = np.zeros(n_groups, np.int64)
    np.add.at(sizes, gidx[active], 1)
    starts = np.full(n_groups, m, np.int64)
    np.minimum.at(starts, gidx, np.arange(m))
    order = np.argsort(-sizes, kind="stable")  # LPT: big groups first
    load = np.zeros(n_shards, np.int64)
    assign = np.zeros(n_groups, np.int64)
    for gid in order:
        if sizes[gid] == 0:
            continue
        s = int(np.argmin(load))
        assign[gid] = s
        load[s] += sizes[gid]
    local_len = max(1, int(load.max()))
    slot_edge = np.full(n_shards * local_len, -1, np.int64)
    gstart = np.zeros(n_shards * local_len, np.int32)
    gsize = np.zeros(n_shards * local_len, np.int32)
    cursor = np.zeros(n_shards, np.int64)
    for gid in range(n_groups):
        size = int(sizes[gid])
        if size == 0:
            continue
        s = int(assign[gid])
        base = s * local_len + int(cursor[s])
        span = perm[starts[gid]: starts[gid] + size]
        slot_edge[base: base + size] = span
        gstart[base: base + size] = int(cursor[s])
        gsize[base: base + size] = size
        cursor[s] += size
    return ShardedGroupPlan(slot_edge=slot_edge, group_start=gstart,
                            group_size=gsize, n_shards=n_shards,
                            local_len=local_len, load=load)


def _local_layout(gstart, active) -> tuple:
    """One shard's block as a MARK group layout, with the layout's
    contract (`marking.build_group_layout`): its groups in plan order,
    then one inactive tail group over the padding slots; `group_start`
    indexed by dense group (the slot count past the last group). Returns
    (layout, head): head marks each group's first slot."""
    m = gstart.shape[0]
    iota = torch.arange(m, dtype=torch.int64, device=gstart.device)
    # each slot's group start: the plan's local start, or the tail's
    start = torch.where(active, gstart.to(torch.int64), active.sum())
    head = start == iota
    gidx = torch.cumsum(head.to(torch.int64), dim=0) - 1
    # each head's slot at its group's index; the other slots write the
    # spare last entry, so the shapes do not depend on the data
    group_start = torch.full((m + 1,), m, dtype=torch.int64,
                             device=gstart.device).scatter_(
        0, torch.where(head, gidx, m), iota)[:m]
    return GroupLayout(perm=iota, gidx=gidx, group_start=group_start,
                       active=active, n_groups=gidx[-1] + 1), head


def _local_phase1(up, depth, su, sv, sbeta, gstart, active, k_cap: int):
    """One shard's greedy: one MARK call on the shard's block with the
    lifting climb. Returns (accept per slot, overflow on each group's
    head slot), as the reference's `_local_lockstep`."""
    layout, head = _local_layout(gstart, active)
    accept, group_overflow = ops.mark(
        LiftingTables(up=up, depth=depth), su, sv, sbeta, layout, k_cap,
        32, None)
    return accept, head & active & group_overflow[layout.gidx]


def make_phase1_sharded(mesh: Mesh,
                        shard_axes: Optional[Tuple[str, ...]] = None,
                        k_cap: int = 32):
    """The phase 1 sharded over `shard_axes` of `mesh` (all of its axes
    by default, which is the only layout the port supports), as a
    callable.

    Inputs (global shapes): up (LOG, n), depth (n,), replicated;
    su/sv/sbeta/gstart/gsize/active (S*Lloc,) in plan order, split into
    S contiguous blocks. Shard j runs its block on `mesh.devices[j]`
    (one MARK launch on a CUDA device). Returns (accept, overflow) per
    slot on the first shard's device: overflow is set on the head slot
    of each group whose accepted-edge table overflowed. `gstart` is the
    plan's *local* start, so a head slot is one whose gstart equals its
    own index within its block; `gsize` is part of the contract and is
    implied by the layout.
    """
    n_shards = _n_shards(mesh, shard_axes)
    if n_shards != mesh_size(mesh):
        raise ValueError(f"shard over every axis of the mesh "
                         f"({mesh.axis_names}), got {shard_axes}")

    def fn(up, depth, su, sv, sbeta, gstart, gsize, active):
        del gsize
        parts = shard_batch_leading((su, sv, sbeta, gstart, active), mesh)
        outs = [_local_phase1(up.to(dev), depth.to(dev), *part, k_cap)
                for dev, part in zip(mesh.devices, parts)]
        home = mesh.devices[0]
        return tuple(torch.cat([o[i].to(home) for o in outs])
                     for i in range(2))

    return fn


def _n_shards(mesh: Mesh, shard_axes) -> int:
    axes = mesh.axis_names if shard_axes is None else shard_axes
    return int(np.prod([mesh.shape[a] for a in axes]))


def lgrass_phase1_distributed(g, mesh: Mesh, shard_axes=None,
                              k_cap: int = 32):
    """Host orchestration: phase 1 on the mesh's first device for the
    tables -> plan -> sharded greedy. Returns (accept_by_edge,
    overflow_dirty_by_edge, the phase-1 outputs as numpy arrays)."""
    from repro_torch.core.sparsify import phase1_device  # cycle-free

    dev = mesh.devices[0]
    n, L = g.n, g.m
    u = torch.as_tensor(np.asarray(g.u, np.int64), device=dev)
    v = torch.as_tensor(np.asarray(g.v, np.int64), device=dev)
    w = torch.as_tensor(np.asarray(g.w, np.float32), device=dev)
    d_dev = phase1_device(u, v, w, n, k_cap, True)
    d = {k: x.cpu().numpy() for k, x in d_dev.items()}

    perm = d["perm"].astype(np.int64)
    gidx = d["gidx"].astype(np.int64)
    active = d["crossing"].astype(bool)[perm]
    plan = partition_groups(perm, gidx, active, _n_shards(mesh, shard_axes))

    eid = np.where(plan.slot_edge >= 0, plan.slot_edge, 0)
    def put(x):
        return torch.as_tensor(x, device=dev)

    fn = make_phase1_sharded(mesh, shard_axes, k_cap)
    out, ovf = fn(d_dev["up"], d_dev["depth_t"], u[put(eid)], v[put(eid)],
                  d_dev["beta"][put(eid)], put(plan.group_start),
                  put(plan.group_size), put(plan.slot_edge >= 0))
    out, ovf = out.cpu().numpy(), ovf.cpu().numpy()
    accept_by_edge = np.zeros(L, bool)
    valid = plan.slot_edge >= 0
    accept_by_edge[plan.slot_edge[valid]] = out[valid]
    # overflow lane -> dirty every edge of that shard-local group
    dirty_by_edge = np.zeros(L, bool)
    for lane in np.where(ovf)[0]:
        size = int(plan.group_size[lane])  # head lane owns lane..lane+size-1
        ids = plan.slot_edge[lane: lane + size]
        dirty_by_edge[ids[ids >= 0]] = True
    return accept_by_edge, dirty_by_edge, d
