"""MARK and REC as kernels: the phase-1 greedy and the recovery replay.

The two greedy loops of the pipeline, each one wrapper call per
`lgrass_sparsify` call with no host sync inside (MARK enqueues two CUDA
kernels, REC one cluster). They compute the tree distances of their
cover tests themselves, with the engine of the call:
the Euler tour's O(1) LCA by default (`csrc/euler_lca.cuh`), or the
binary-lifting climb of the TPU kernel `tree_dist_pairs`
(`csrc/tree_dist.cuh`) under `use_tree_kernel=True`, where no Euler
table is built. So the (4, C, K) distance batches of the plain loops, and
their launches of the tree-distance kernel, are gone from the path.

  * `mark_cuda` launches `csrc/mark.cu` (two CUDA kernels: the chain, a
    block per group at a time with 32-slot chunks resolved by one warp
    on bitmasks until the group has stored k_cap entries; then the tail,
    one thread per slot over the whole card) and counts its calls in
    `mark_launches`; `mark_plain` is the plain version,
    `core.marking.phase1_chunked`;
  * `recover_cuda` launches `csrc/recover.cu` (one thread-block cluster,
    `rec_cluster_size`, walks the criticality order in 32-edge chunks)
    and counts its launches in `rec_launches`; it reads the accepted
    count back once, after the launch. `recover_plain` is the plain
    version, `core.recovery._recover_scan`.

`kernels/ops.py` picks between them by the tensor's device. Both kernels
make the plain versions' decisions exactly: every test is an integer
comparison of the same distances.
"""
from __future__ import annotations

import torch

from repro_torch.core.bfs import INF
from repro_torch.kernels import oplib

# CUDA launches of each kernel since the last reset (kernels/ops.py).
mark_launches = 0
rec_launches = 0

EULER, LIFTING = 0, 1  # the C entry points' engine ids
MARK_TAIL_THREADS = 256  # a block of MARK's tail launch (csrc/mark.cu)


def mark_plain(t, su, sv, sbeta, layout, k_cap, chunk, euler):
    """Plain version: `phase1_chunked`, (accept, group_overflow); euler
    None for the lifting climb."""
    from repro_torch.core.marking import phase1_chunked

    return tuple(phase1_chunked(t, su, sv, sbeta, layout, k_cap=k_cap,
                                chunk=chunk, use_tree_kernel=euler is None,
                                euler=euler))


def recover_plain(t, u, v, beta, offtree, crossing, order, phase1_accept,
                  group_of_edge, dirty0, budget, b_cap, chunk, euler):
    """Plain version: `_recover_scan`, (accepted, n_accepted); euler None
    for the lifting climb."""
    from repro_torch.core.recovery import _recover_scan

    return _recover_scan(t, u, v, beta, offtree, crossing, order,
                         phase1_accept, group_of_edge, dirty0, budget, b_cap,
                         euler is None, chunk, euler)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _engine(t, euler) -> tuple:
    """(engine id, (t0..t4), tlog, tn) for the C entry points: the Euler
    tables narrowed to int32 (first, table, dseq, tour, depth), or the
    lifting table and depth when `euler` is None."""
    if euler is None:
        up = _i32(t.up)
        return LIFTING, (up, _i32(t.depth), None, None, None), *up.shape
    logp, p = euler.table.shape
    return EULER, tuple(_i32(x) for x in (euler.first, euler.table,
                                          euler.dseq, euler.tour,
                                          euler.depth)), logp, p


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_cuda(dev, **tensors) -> None:
    for name, x in tensors.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}")
    oplib.check_launchable("rec", *tensors.values())


def _check_card(dev, **tensors) -> None:
    """As `_check_cuda` for an operator's caller: meta tensors pass."""
    for name, x in tensors.items():
        if x.device != dev or not oplib.on_card_route(x):
            raise ValueError(f"{name} must be on the CUDA device {dev}")


def _scratch(nbytes: int, dev):
    return torch.empty((nbytes,), dtype=torch.uint8, device=dev) \
        if nbytes else None


def mark_cuda(t, su, sv, sbeta, layout, k_cap: int, euler=None,
              depth_skip: bool = True):
    """Launch `csrc/mark.cu` on the current stream of the tensors' device,
    through its operator (`torch.ops.repro_torch.mark`; meta tensors get
    its fake). t: LiftingTables; su, sv, sbeta: (L,) sorted slots;
    layout: the GroupLayout; euler: the EulerLCA tables, or None for the
    lifting climb; depth_skip False turns off the cover test's
    depth-difference skip (`csrc/ball_pair.cuh`), which changes no
    decision. Returns (accept (L,) bool per sorted slot, group_overflow
    (L,) bool per dense group)."""
    dev = su.device
    _check_card(dev, su=su, sv=sv, sbeta=sbeta, up=t.up,
                group_start=layout.group_start, active=layout.active,
                n_groups=layout.n_groups)
    if k_cap < 1:
        raise ValueError(f"k_cap must be >= 1, got {k_cap}")
    m = su.shape[0]
    if m >= 2 ** 31 - 1:
        raise ValueError(f"{m} slots do not fit int32 indices")
    engine, tabs, _, _ = _engine(t, euler)
    return MARK_OP(engine, *tabs, _i32(su), _i32(sv), _i32(sbeta),
                   _i32(layout.group_start), _i32(layout.gidx),
                   layout.active.contiguous(),
                   layout.n_groups.to(torch.int64).contiguous(),
                   (t.depth != INF).all(), k_cap, depth_skip)


def _mark_launch(engine, t0, t1, t2, t3, t4, su, sv, sb, gstart, gidx,
                 active, n_groups, connected, k_cap, depth_skip):
    global mark_launches
    tabs = (t0, t1, t2, t3, t4)
    oplib.check_launchable("mark", su, sv, sb, gstart, gidx, active,
                           n_groups, connected, *tabs)
    dev, m = su.device, su.shape[0]
    accept = torch.empty((m,), dtype=torch.bool, device=dev)
    overflow = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return accept, overflow
    from repro_torch.kernels._build import library

    lib = library()
    tlog, tn = t0.shape if engine == LIFTING else t1.shape
    work = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        scratch = _scratch(lib.mark_scratch_bytes(m), dev)
        err = lib.mark_launch(
            engine, *map(_ptr, tabs), tlog, tn, su.data_ptr(), sv.data_ptr(),
            sb.data_ptr(), gstart.data_ptr(), gidx.data_ptr(),
            active.data_ptr(), n_groups.data_ptr(), connected.data_ptr(), m,
            k_cap, int(depth_skip), accept.data_ptr(), overflow.data_ptr(),
            work.data_ptr(), _ptr(scratch),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mark launch failed: CUDA error {err}")
    mark_launches += 1
    return accept, overflow


def _mark_fake(engine, t0, t1, t2, t3, t4, su, *args):
    m = su.shape[0]
    return (su.new_empty((m,), dtype=torch.bool),
            su.new_empty((m,), dtype=torch.bool))


MARK_OP = oplib.define(
    "mark(int engine, Tensor t0, Tensor t1, Tensor? t2, Tensor? t3, "
    "Tensor? t4, Tensor su, Tensor sv, Tensor sbeta, Tensor group_start, "
    "Tensor gidx, Tensor active, Tensor n_groups, Tensor connected, "
    "int k_cap, bool depth_skip) -> (Tensor, Tensor)", _mark_launch,
    _mark_fake)


def walk_order(offtree: torch.Tensor, order: torch.Tensor):
    """The off-tree edges of `order`, in its sequence, as an (L + 1,)
    int32 tensor whose first n_walk entries are meaningful, and n_walk as
    a 0-d int64 tensor: a stable compaction without a host sync."""
    m = order.shape[0]
    keep = offtree[order]
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, m)
    walk = torch.zeros((m + 1,), dtype=torch.int32, device=order.device)
    walk.scatter_(0, dest, order.to(torch.int32))
    return walk, keep.sum()


def group_offsets(crossing: torch.Tensor, group_of_edge: torch.Tensor):
    """(L,) int32: where each phase-1 group's list starts in REC's (L,)
    list scratch, the exclusive sum of the groups' crossing-edge counts
    (a group never accepts more edges than it has); without a sync."""
    m = crossing.shape[0]
    sizes = torch.zeros((m + 1,), dtype=torch.int32, device=crossing.device)
    sizes.scatter_add_(0, torch.where(crossing, group_of_edge, m),
                       torch.ones((m,), dtype=torch.int32,
                                  device=crossing.device))
    return (torch.cumsum(sizes[:m], 0, dtype=torch.int32) - sizes[:m])


def rec_cluster_size(lifting: bool = False) -> int:
    """The blocks of the one cluster REC launches as on the current CUDA
    device (16, else 8), for the lifting or the Euler engine. Raises when
    the card cannot place a cluster of at least 2."""
    from repro_torch.kernels._build import library

    size = library().rec_cluster_size(LIFTING if lifting else EULER)
    if size < 0:
        raise RuntimeError(f"rec cluster query failed: CUDA error {-size}")
    if size < 2:
        raise RuntimeError("the card cannot place REC's thread-block "
                           "cluster (8 or 16 blocks of 1024 threads)")
    return size


def rec_clock_count() -> int:
    """The length of the `clocks` sums `recover_cuda` can fill."""
    from repro_torch.kernels._build import library

    return library().rec_clock_count()


def recover_cuda(t, u, v, beta, offtree, crossing, order, phase1_accept,
                 group_of_edge, dirty0, budget: int, b_cap: int,
                 euler=None, depth_skip: bool = True, clocks=None):
    """Launch `csrc/recover.cu` on the current stream of the tensors'
    device; arguments as `_recover_scan`'s, euler None for the lifting
    climb, depth_skip as for `mark_cuda`. clocks: None, or an int64 CUDA
    tensor of `rec_clock_count()` sums to which the launch adds block 0's
    SM cycles per phase (staging, classification, tests, exchange and
    cluster barrier, resolution), its chunks, its pairs and its whole
    run. Returns (accepted (L,) bool, n_accepted int): the count is read
    back after the launch, the one sync of REC. Raises when the launch
    fails, as it does on a card that cannot place a cluster of 2."""
    global rec_launches
    dev = u.device
    _check_cuda(dev, u=u, v=v, beta=beta, offtree=offtree,
                crossing=crossing, order=order, phase1_accept=phase1_accept,
                group_of_edge=group_of_edge, dirty0=dirty0, up=t.up)
    m = u.shape[0]
    if m >= 2 ** 31 - 1:
        raise ValueError(f"{m} edges do not fit int32 indices")
    if m == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev), 0
    from repro_torch.kernels._build import library

    lib = library()
    budget = max(min(int(budget), int(b_cap)), 0)
    engine, tabs, tlog, tn = _engine(t, euler)
    if clocks is not None:
        _check_cuda(dev, clocks=clocks)
        if clocks.dtype != torch.int64 or \
                clocks.numel() != lib.rec_clock_count():
            raise ValueError("clocks must be rec_clock_count() int64 sums")
    walk, n_walk = walk_order(offtree, order)
    connected = (t.depth != INF).all()
    offsets = group_offsets(crossing, group_of_edge)
    ui, vi, bi, gi = _i32(u), _i32(v), _i32(beta), _i32(group_of_edge)
    flags = [x.contiguous() for x in (crossing, phase1_accept, dirty0)]
    out = torch.empty((m,), dtype=torch.bool, device=dev)
    gflag = torch.empty((m,), dtype=torch.uint8, device=dev)
    n_acc = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        scratch = _scratch(lib.rec_scratch_bytes(m, int(b_cap)), dev)
        err = lib.rec_launch(
            engine, *map(_ptr, tabs), tlog, tn, walk.data_ptr(),
            n_walk.data_ptr(), ui.data_ptr(), vi.data_ptr(), bi.data_ptr(),
            gi.data_ptr(), *(x.data_ptr() for x in flags),
            connected.data_ptr(), offsets.data_ptr(), m, budget, int(b_cap),
            int(depth_skip), gflag.data_ptr(), out.data_ptr(),
            n_acc.data_ptr(), _ptr(clocks), _ptr(scratch),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rec launch failed: CUDA error {err}")
    rec_launches += 1
    return out, int(n_acc.item())
