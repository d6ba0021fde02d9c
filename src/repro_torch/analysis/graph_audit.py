"""Run-time audit of the port's public device programs: host syncs and
wide dtypes, by source site, against a documented budget.

The port's twin of `repro.analysis.jaxpr_audit`, named for what it reads:
the port has no jaxprs. A jitted JAX program is one dispatch whose loops
are `while` primitives; the port's programs are host loops of torch ops,
and each loop that tests a device value syncs the host once a trip. So
the reference's `EXPECTED_WHILE` (how many loops) becomes a **sync
budget**: for each (program, BFS engine), the set of source sites
allowed to sync and a bound on each, in terms of the input (n, L, the
lanes, the graph's BFS eccentricity from the root and the spanning
tree's depth), with the reason the bound holds (`SITES`, `BUDGETS`).

`audit_program(name, fn, args, kwargs, budget)` runs the program under a
`TorchDispatchMode` that records, by the innermost `repro_torch` source
line that caused it (outside this package):

  * every host sync: `aten._local_scalar_dense` (`.item()`, `bool(t)`,
    `int(t)`, a 0-d tensor used as an index on the CPU), a copy to the
    CPU from another device, and the ops whose output shape depends on
    the data (`nonzero`, `masked_select`, `unique`, indexing or
    index-writing with a bool mask, `repeat_interleave` by a tensor),
    which sync on the card. `.tolist()`, `.numpy()` and `.cpu()` are
    recorded at the call (on a CPU run they read memory without an op);
  * every float64 or complex128 tensor an op produces: int64 is the
    port's key type, so the wide-dtype rule covers the wide floats only.

Budgets are per lane (a batched program's lanes run one after another)
and mark where a site syncs: `any` device, `cpu` only (a plain loop that
the card runs as a kernel: MARK's `phase1_chunked`, REC's
`_recover_scan`; syncing there on the card means the kernel was not
used) or `cuda` only (the REC launch reads its count back). A site
outside the budget, or past its bound, is a finding.

`standard_program_audits(n=64, L=128, B=2, b_cap=8)` runs `phase1_device`,
`phase1_device_batched`, `lgrass_device` and `lgrass_device_batched`
on both BFS engines, `recover_device`, `recover_device_batched` and the
spectral probe (single and batched) on a seeded random connected graph;
`audit_service(svc, ...)` runs every `SparsifyService.program_specs`
signature on seeded graphs of its bucket; `check_derived_constants()`
asserts the interval models' bounds equal `core/bfs.py`'s constants and
range-checks the port's own packs at the largest n it takes.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.ranges import (
    PORT_MAX_N,
    Interval,
    check_ranges,
    derive_euler_pack_max_n,
    derive_packed_key_max_n,
    packed_key_interval,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
_aten = torch.ops.aten

# ops whose output shape depends on the data: each syncs on the card
_DYNAMIC = {
    _aten.nonzero.default: "nonzero",
    _aten.masked_select.default: "masked_select",
    _aten._unique2.default: "unique",
    _aten.unique_dim.default: "unique",
    _aten.unique_consecutive.default: "unique",
    _aten.repeat_interleave.Tensor: "repeat_interleave",
}
_INDEX_OPS = (_aten.index.Tensor, _aten.index_put_.default,
              _aten.index_put.default, _aten._index_put_impl_.default)
_WIDE = (torch.float64, torch.complex128)
_HOST_READS = ("tolist", "numpy", "cpu")


_REL: Dict[str, Optional[str]] = {}


def _port_path(filename: str) -> Optional[str]:
    """'core/bfs.py' for a source file of the package outside this
    package (a code object's filename may be relative), else None."""
    if filename not in _REL:
        path = os.path.abspath(filename)
        _REL[filename] = (
            os.path.relpath(path, _PKG).replace(os.sep, "/")
            if path.startswith(_PKG + os.sep)
            and not path.startswith(_HERE + os.sep) else None)
    return _REL[filename]


def _site() -> str:
    """'core/bfs.py:109 (bfs_levels)': the innermost frame in the
    `repro_torch` package outside this package, or '<caller>'."""
    f = sys._getframe(2)
    while f is not None:
        rel = _port_path(f.f_code.co_filename)
        if rel is not None:
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<caller>"


def site_key(site: str) -> str:
    """'core/bfs.py:bfs_levels', the budget's key of a recorded site."""
    if site == "<caller>":
        return site
    path, rest = site.split(":", 1)
    return f"{path}:{rest.split('(')[1].rstrip(')')}"


def _bool_index(indices) -> bool:
    return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                           torch.uint8)
               for i in (indices or ()))


class SyncRecorder(TorchDispatchMode):
    """Counts host syncs and wide-dtype tensors by source site while it
    is active (see the module docstring). `host_reads`: whether a
    `.tolist()` / `.numpy()` / `.cpu()` of a CPU tensor counts (it does
    on a CPU run standing in for the card)."""

    def __init__(self, host_reads: bool = True):
        super().__init__()
        self.host_reads = host_reads
        self.syncs: Dict[str, int] = collections.Counter()
        self.kinds: Dict[str, set] = collections.defaultdict(set)
        self.wide: Dict[str, set] = collections.defaultdict(set)
        self._inside = 0
        self._saved: Dict[str, Callable] = {}

    def _record(self, kind: str, site: Optional[str] = None):
        site = site or _site()
        self.syncs[site] += 1
        self.kinds[site].add(kind)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._inside:
            kind = None
            if func is _aten._local_scalar_dense.default:
                kind = "scalar"
            elif func in _DYNAMIC:
                if func is not _aten.repeat_interleave.Tensor or \
                        kwargs.get("output_size") is None:
                    kind = _DYNAMIC[func]
            elif func in _INDEX_OPS and _bool_index(args[1]):
                kind = "bool-index"
            elif func in (_aten._to_copy.default, _aten.copy_.default):
                src = args[1] if func is _aten.copy_.default else args[0]
                dst = args[0] if func is _aten.copy_.default else out
                if isinstance(src, torch.Tensor) and src.device.type != \
                        "cpu" and dst.device.type == "cpu":
                    kind = "to-cpu"
            if kind is not None:
                self._record(kind)
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor) and o.dtype in _WIDE:
                self.wide[_site()].add(str(o.dtype).replace("torch.", ""))
        return out

    def _wrap(self, name: str):
        orig = getattr(torch.Tensor, name)
        rec = self

        def method(t, *a, **k):
            if rec._inside or not (rec.host_reads
                                   or t.device.type != "cpu"):
                return orig(t, *a, **k)
            rec._record(name, _site())
            rec._inside += 1
            try:
                return orig(t, *a, **k)
            finally:
                rec._inside -= 1

        self._saved[name] = orig
        setattr(torch.Tensor, name, method)

    def __enter__(self):
        for name in _HOST_READS:
            self._wrap(name)
        return super().__enter__()

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(torch.Tensor, name, orig)
        self._saved.clear()
        return super().__exit__(*exc)


# ---------------------------------------------------------------------
# the sync budget
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ctx:
    """What a bound may depend on: the node pad n, the edge pad L, the
    lanes, log = log2_ceil(n + 1), ecc = the most BFS levels below the
    root over the lanes' graphs, tdepth = the deepest spanning tree over
    the lanes, c_mark = MARK's plain block (`auto_chunk(L)`), c_rec =
    REC's plain block (32)."""
    n: int
    L: int
    lanes: int = 1
    ecc: int = 0
    tdepth: int = 0
    c_rec: int = 32

    @property
    def log(self) -> int:
        from repro_torch.core.pow2 import log2_ceil
        return log2_ceil(self.n + 1)

    @property
    def c_mark(self) -> int:
        from repro_torch.core.pow2 import auto_chunk
        return auto_chunk(self.L)


@dataclasses.dataclass(frozen=True)
class Allow:
    """A site's bound (syncs per lane, from a Ctx), the reason it holds,
    and where it may sync: 'any', 'cpu' (a plain loop the card runs as a
    kernel) or 'cuda' (the card's route only)."""
    bound: Callable[[Ctx], int]
    reason: str
    where: str = "any"


def _blocks(L: int, c: int) -> int:
    return -(-L // max(min(c, L), 1))


SITES: Dict[str, Allow] = {
    "core/bfs.py:bfs_doubling": Allow(
        lambda c: c.ecc + 2,
        "`dist[root] = 0` reads the 0-d root (1; a 0-d index syncs on "
        "the card too); the round "
        "loop tests its fixpoint once a round, and every round is a full "
        "Bellman-Ford relaxation, so after ecc rounds every depth is "
        "final and round ecc + 1 sees no change"),
    "core/bfs.py:bfs_levels": Allow(
        lambda c: 2 * 2 + (c.ecc + 2) + (c.tdepth + 2),
        "two BFS per lane (the graph, then the tree's edges): 2 root "
        "writes each, and one frontier test per level: levels 0..ecc "
        "non-empty, then one empty (ecc + 2; tdepth + 2 on the tree)"),
    "core/bfs.py:root_tree_euler": Allow(
        lambda c: 14,
        "no loop: 3 reads of a 0-d index (root, s0) and 11 masked "
        "gathers / scatters (is_first, in_tour, down) of data-dependent "
        "length"),
    "core/lca.py:tables_from_tour": Allow(
        lambda c: 2,
        "no loop: one masked scatter of the real tour positions"),
    "core/lca.py:build_euler": Allow(
        lambda c: 8,
        "no loop: reads of the 0-d root (tour[0], first_child[root]) and "
        "3 masked scatters of 2 masks each"),
    "core/mst.py:boruvka_mst": Allow(
        lambda c: (c.log + 1) * (c.log + 2),
        "one termination test per Borůvka round, and every component with "
        "a crossing edge merges each round, so the components halve: at "
        "most log + 1 tests; the pointer jumps after each round halve the "
        "hooking forest's depth (at most the component count): at most "
        "log + 1 tests a round"),
    "core/resistance.py:node_parent_inv_w": Allow(
        lambda c: 4,
        "no loop: two masked scatters (u-side, v-side children) of 2 "
        "masks each"),
    "core/marking.py:phase1_chunked": Allow(
        lambda c: 1 + _blocks(c.L, c.c_mark) * (c.c_mark + 6),
        "the plain MARK loop: one `.tolist()` of the blocks' step counts, "
        "then per block at most c_mark fixpoint tests (a block's steps "
        "are bounded by its longest run, at most its c_mark slots) and 6 "
        "masked writes of the accepted slots; the card runs MARK as one "
        "kernel", "cpu"),
    "core/recovery.py:_recover_scan": Allow(
        lambda c: _blocks(c.L, c.c_rec) * (c.c_rec + 1 + 7),
        "the plain REC loop: per block at most c_rec + 1 fixpoint tests "
        "(each trip fixes at least the first undecided position), the "
        "count `int(dec.sum())` and 6 masked writes; the card runs REC as "
        "one kernel", "cpu"),
    "core/sparsify.py:_lgrass_batched": Allow(
        lambda c: 1,
        "the (B,) budget vector read once per call (REC takes its budget "
        "as a launch argument); counted per lane, so an upper bound"),
    "kernels/phase1.py:recover_cuda": Allow(
        lambda c: 1,
        "the REC launch's accepted count read back, the one sync of REC",
        "cuda"),
    "core/sparsify.py:results_to_host": Allow(
        lambda c: 2,
        "the host-facing result decode: the masks and the statistics "
        "packed on the device, one copy (and on the CPU its `.numpy()`)"),
}

_PHASE1 = ("core/bfs.py:root_tree_euler", "core/lca.py:tables_from_tour",
           "core/mst.py:boruvka_mst", "core/resistance.py:node_parent_inv_w",
           "core/marking.py:phase1_chunked")
_LEVELS = ("core/bfs.py:bfs_levels", "core/lca.py:build_euler",
           "core/lca.py:tables_from_tour", "core/mst.py:boruvka_mst",
           "core/resistance.py:node_parent_inv_w",
           "core/marking.py:phase1_chunked")
_REC = ("core/recovery.py:_recover_scan", "kernels/phase1.py:recover_cuda")

# the documented budget per (program family, BFS engine)
BUDGETS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("phase1", "doubling"): ("core/bfs.py:bfs_doubling",) + _PHASE1,
    ("phase1", "levels"): _LEVELS,
    ("lgrass", "doubling"): ("core/bfs.py:bfs_doubling",) + _PHASE1 + _REC
    + ("core/sparsify.py:_lgrass_batched",),
    ("lgrass", "levels"): _LEVELS + _REC
    + ("core/sparsify.py:_lgrass_batched",),
    ("recover", "-"): ("core/lca.py:build_euler",
                       "core/lca.py:tables_from_tour") + _REC,
    ("probe", "-"): (),
    ("sparsify", "doubling"): ("core/bfs.py:bfs_doubling",) + _PHASE1
    + _REC + ("core/sparsify.py:results_to_host",),
}


# float64 the port makes on purpose, by site key, with the reason
WIDE_ALLOWED: Dict[str, str] = {
    "core/spectral_probe.py:_sqrt_rn":
        "the probes' W^{1/2} rounded to nearest on every device: the "
        "squares of the midpoints around a float32 sqrt are exact in "
        "float64 and decide the rounding; nothing wide leaves the "
        "function",
}


def budget_for(family: str, engine: str = "-") -> Dict[str, Allow]:
    return {k: SITES[k] for k in BUDGETS[(family, engine)]}


# ---------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------

@dataclasses.dataclass
class AuditReport:
    name: str
    device: str = "cpu"
    syncs: Dict[str, int] = dataclasses.field(default_factory=dict)
    kinds: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    bounds: Dict[str, int] = dataclasses.field(default_factory=dict)
    wide: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    findings: List[str] = dataclasses.field(default_factory=list)
    output: object = dataclasses.field(default=None, repr=False)

    @property
    def n_syncs(self) -> int:
        return sum(self.syncs.values())

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_key(self) -> Dict[str, int]:
        """Sync counts by budget key (file:function)."""
        out: Dict[str, int] = collections.Counter()
        for site, c in self.syncs.items():
            out[site_key(site)] += c
        return dict(out)

    def as_dict(self) -> dict:
        return dict(name=self.name, device=self.device,
                    n_syncs=self.n_syncs, syncs=dict(self.syncs),
                    kinds=dict(self.kinds), bounds=dict(self.bounds),
                    by_site=self.by_key(), wide=dict(self.wide),
                    findings=list(self.findings), ok=self.ok)


def audit_program(name: str, fn: Callable, args: Sequence = (),
                  kwargs: Optional[dict] = None,
                  budget: Optional[Dict[str, Allow]] = None,
                  ctx: Optional[Ctx] = None,
                  ctx_from: Optional[Callable] = None,
                  device: Optional[str] = None) -> AuditReport:
    """Run `fn(*args, **kwargs)` under a `SyncRecorder` and check it:
    no float64/complex128 tensor outside `WIDE_ALLOWED`, and, with a
    `budget` ({site key: Allow}), every sync at a budgeted site within
    its bound (per lane x ctx.lanes), no 'cpu' site syncing on the card
    and no 'cuda' site on the CPU. `ctx_from(output)` may supply the
    Ctx from the run's output (a bound on the tree depth). `device`
    ('cpu' or 'cuda') is where the program runs, by default its first
    tensor argument's. Returns the report; the output is
    `report.output`."""
    kwargs = kwargs or {}
    dev = device or next(
        (a.device.type for a in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(a, torch.Tensor)), "cpu")
    rep = AuditReport(name=name, device=dev)
    with SyncRecorder(host_reads=dev == "cpu") as rec:
        out = fn(*args, **kwargs)
    rep.output = out
    rep.syncs = dict(rec.syncs)
    rep.kinds = {s: sorted(k) for s, k in rec.kinds.items()}
    rep.wide = {s: sorted(d) for s, d in rec.wide.items()}
    for site, dts in sorted(rep.wide.items()):
        if site_key(site) not in WIDE_ALLOWED:
            rep.findings.append(f"wide dtype {', '.join(dts)} produced "
                                f"at {site}")
    if budget is None:
        return rep
    if ctx_from is not None:
        ctx = ctx_from(out)
    ctx = ctx or Ctx(n=0, L=0)
    for key, count in sorted(rep.by_key().items()):
        allow = budget.get(key)
        if allow is None:
            rep.findings.append(
                f"{count} sync(s) at {key}, a site outside the budget "
                f"({', '.join(s for s in rep.syncs if site_key(s) == key)})")
            continue
        bound = allow.bound(ctx) * ctx.lanes
        rep.bounds[key] = bound
        if count > bound:
            rep.findings.append(f"{count} syncs at {key} over its bound "
                                f"{bound}: {allow.reason}")
        if allow.where == "cpu" and dev != "cpu":
            rep.findings.append(f"{count} syncs on the card at {key}, a "
                                f"plain loop the card runs as a kernel")
        if allow.where == "cuda" and dev == "cpu":
            rep.findings.append(f"{count} syncs on the CPU at {key}, a "
                                f"site of the card's route")
    return rep


# ---------------------------------------------------------------------
# derived constants
# ---------------------------------------------------------------------

def check_derived_constants() -> List[str]:
    """Assert the runtime pack-switch constants equal the values the
    interval models derive independently; that the reference's int32
    packed-key witness range-checks clean at PACKED_KEY_MAX_N and flags
    one past it; and that the port's own packs (`bfs.relax_key`, always
    int64, and `bfs.euler_arc_key`, read as u32) are clean at the
    largest n the port takes and the Euler switch point, the Euler key
    flagging one past it."""
    from repro_torch.core import bfs

    findings: List[str] = []
    derived = derive_packed_key_max_n()
    if derived != bfs.PACKED_KEY_MAX_N:
        findings.append(
            f"bfs.PACKED_KEY_MAX_N={bfs.PACKED_KEY_MAX_N} != derived "
            f"int32-safe bound {derived}")
    if derive_euler_pack_max_n() != bfs.EULER_PACK_MAX_N:
        findings.append(
            f"bfs.EULER_PACK_MAX_N={bfs.EULER_PACK_MAX_N} != derived "
            f"u32 pack bound {derive_euler_pack_max_n()}")
    for n in (2, 1024, bfs.PACKED_KEY_MAX_N):
        model = packed_key_interval(n).hi
        if model != bfs.packed_key_bound(n):
            findings.append(
                f"packed_key_bound({n})={bfs.packed_key_bound(n)} "
                f"disagrees with interval model {model}")

    def i32(k=4):
        return torch.zeros((k,), dtype=torch.int32)

    def i64(k=4):
        return torch.zeros((k,), dtype=torch.int64)

    def witness(dist, ids, base):
        return dist * base + ids

    def run(n: int) -> List:
        return check_ranges(
            witness, [Interval.of(0, n), Interval.of(0, n),
                      Interval.const(n + 1)],
            i32(), i32(), torch.tensor(n + 1, dtype=torch.int32))

    if run(bfs.PACKED_KEY_MAX_N):
        findings.append(
            f"packed-key witness flags at n=PACKED_KEY_MAX_N="
            f"{bfs.PACKED_KEY_MAX_N} (bound too loose)")
    if not run(bfs.PACKED_KEY_MAX_N + 1):
        findings.append(
            "packed-key witness fails to flag at n=PACKED_KEY_MAX_N+1 "
            "(bound not tight: the switch is unverified)")

    n = PORT_MAX_N
    relax = check_ranges(
        lambda ds, src, live: bfs.relax_key(ds, src, live, n + 1),
        [Interval.of(0, n, sentinel=bfs.INF), Interval.of(0, n - 1),
         Interval.of(0, 1)], i64(), i64(), torch.ones((4,),
                                                      dtype=torch.bool))
    if relax:
        findings.append(f"bfs.relax_key flags at n={n}: "
                        + "; ".join(map(str, relax)))

    def euler(m: int) -> List:
        return check_ranges(bfs.euler_arc_key,
                            [Interval.of(0, m), Interval.of(0, m)],
                            i64(), i64(), out_dtypes=["uint32"])

    if euler(bfs.EULER_PACK_MAX_N):
        findings.append(f"bfs.euler_arc_key flags at n=EULER_PACK_MAX_N="
                        f"{bfs.EULER_PACK_MAX_N}")
    if not euler(bfs.EULER_PACK_MAX_N + 1):
        findings.append("bfs.euler_arc_key fails to flag past "
                        "EULER_PACK_MAX_N (the u64 pair-sort switch is "
                        "unverified)")
    return findings


# ---------------------------------------------------------------------
# standard program set + service audit
# ---------------------------------------------------------------------

def _ecc(u, v, n: int, valid, tree=None) -> Tuple[int, int]:
    """(the most BFS levels below `select_root`'s root (max degree, least
    id) over the valid edges, the same over the `tree` edges from that
    root), on the host: the audit's own reference, independent of the
    programs it audits."""
    u, v = u.tolist(), v.tolist()
    valid = [True] * len(u) if valid is None else valid.tolist()
    deg = [0] * n
    for a, b, ok in zip(u, v, valid):
        if ok:
            deg[a] += 1
            deg[b] += 1
    root = max(range(n), key=lambda i: (deg[i], -i))
    keep = valid if tree is None else [
        ok and t for ok, t in zip(valid, tree.tolist())]
    return (_levels(u, v, n, valid, root),
            0 if tree is None else _levels(u, v, n, keep, root))


def _levels(u, v, n: int, keep, root: int) -> int:
    adj = [[] for _ in range(n)]
    for a, b, ok in zip(u, v, keep):
        if ok:
            adj[a].append(b)
            adj[b].append(a)
    depth = {root: 0}
    frontier = [root]
    while frontier:
        nxt = []
        for x in frontier:
            for y in adj[x]:
                if y not in depth:
                    depth[y] = depth[x] + 1
                    nxt.append(y)
        frontier = nxt
    return max(depth.values())


def _lane_ctx(n: int, us, vs, valids, trees) -> Ctx:
    """Ctx over lanes (per lane: its u, v, edge mask or None, and the
    program's tree mask): the largest graph eccentricity and tree
    depth."""
    eccs = [_ecc(u, v, n, ok, t) for u, v, ok, t in zip(us, vs, valids,
                                                       trees)]
    return Ctx(n=n, L=int(us[0].shape[0]), lanes=len(us),
               ecc=max(e for e, _ in eccs), tdepth=max(t for _, t in eccs))


def audit_graphs(n: int, L: int, B: int, seed: int = 0, device="cpu"):
    """B seeded random connected graphs of n nodes and L edges (a
    spanning tree plus chords), as (u, v, w) int64/float32 tensors of
    shape (B, L) on `device`, and the (B, L) all-true edge mask."""
    from repro_torch.core.graph import random_connected_graph

    gs = [random_connected_graph(n, L - (n - 1), seed=seed + i)
          for i in range(B)]
    u = torch.stack([torch.as_tensor(g.u, dtype=torch.int64) for g in gs])
    v = torch.stack([torch.as_tensor(g.v, dtype=torch.int64) for g in gs])
    w = torch.stack([torch.as_tensor(g.w, dtype=torch.float32)
                     for g in gs])
    ev = torch.ones((B, L), dtype=torch.bool)
    return tuple(x.to(device) for x in (u, v, w, ev))


def standard_program_audits(n: int = 64, L: int = 128, B: int = 2,
                            b_cap: int = 8, device=None
                            ) -> List[AuditReport]:
    """Audit the public device programs at one signature on `device`
    (by default the CUDA device; `device="cpu"` asks for the CPU, where
    the plain loops stand in for the card's kernels).

    Covers both BFS engines for the fused and phase-1 programs, single
    and batched (`core/sparsify.py`), the standalone recovery units
    (`core/recovery.py`) and the spectral-probe estimator, each on
    seeded random connected graphs of n nodes and L edges."""
    from repro_torch.core import recovery as rec
    from repro_torch.core import sparsify as sp
    from repro_torch.core import spectral_probe as probe

    dev = sp.resolve_device(device)
    u, v, w, ev = audit_graphs(n, L, B, device=dev)
    budget = torch.full((B,), b_cap, dtype=torch.int32, device=dev)
    host = [x.cpu() for x in (u, v)]

    def ctx_of(out, lanes):
        trees = out["tree_mask"].reshape(-1, L).cpu()
        return _lane_ctx(n, [host[0][i] for i in lanes],
                         [host[1][i] for i in lanes], [None] * len(lanes),
                         list(trees))

    reports: List[AuditReport] = []
    for eng in ("doubling", "levels"):
        one = dict(n=n, bfs_engine=eng)
        for fam, fn, args, kw in (
                ("phase1", sp.phase1_device, (u[0], v[0], w[0]), one),
                ("phase1", sp.phase1_device_batched, (u, v, w, ev), one),
                ("lgrass", sp.lgrass_device, (u[0], v[0], w[0], b_cap),
                 dict(one, b_cap=b_cap)),
                ("lgrass", sp.lgrass_device_batched,
                 (u, v, w, ev, budget), dict(one, b_cap=b_cap))):
            lanes = list(range(B)) if args[0].dim() == 2 else [0]
            reports.append(audit_program(
                f"{fn.__name__}[{eng}]", fn, args, kw, budget_for(fam, eng),
                ctx_from=lambda out, lanes=lanes: ctx_of(out, lanes),
                device=dev.type))

    # the standalone replay from one graph's phase-1 outputs
    d = {k: x.cpu().numpy() for k, x in sp.phase1_device(
        u[0], v[0], w[0], n).items()}
    tree, crossing, accept, group, dirty0, order = sp.phase1_views_np(d, L)
    args1 = (d["up"], d["depth_t"], host[0][0].numpy(), host[1][0].numpy(),
             d["beta"], tree, crossing, order, accept, group, dirty0)
    ctx1 = Ctx(n=n, L=L)
    # numpy arguments, staged onto `device` by the programs themselves
    reports.append(audit_program(
        "recover_device", rec.recover_device, args1 + (b_cap, b_cap),
        dict(device=dev), budget_for("recover"), ctx1, device=dev.type))
    reports.append(audit_program(
        "recover_device_batched", rec.recover_device_batched,
        tuple(x[None] for x in args1) + ([b_cap], b_cap),
        dict(device=dev), budget_for("recover"), ctx1, device=dev.type))

    pk = dict(n_probes=8, n_iters=16, device=dev)
    reports.append(audit_program(
        "probe_edge_resistance", probe.probe_edge_resistance,
        (u[0], v[0], w[0], n), pk, budget_for("probe"), Ctx(n=n, L=L),
        device=dev.type))
    reports.append(audit_program(
        "probe_edge_resistance_batched",
        probe.probe_edge_resistance_batched, (u, v, w, ev, n), pk,
        budget_for("probe"), Ctx(n=n, L=L, lanes=B), device=dev.type))
    return reports


def audit_service(svc, sizes=None, batch_sizes=(1,), budgets=(),
                  seed: int = 0) -> List[AuditReport]:
    """Audit every dispatch signature of a `SparsifyService`: each
    `ProgramSpec` (`SparsifyService.program_specs`, exactly what
    `_dispatch` runs) on seeded graphs filling its bucket, against the
    fused program's budget for the spec's BFS engine."""
    reports = []
    for spec in svc.program_specs(sizes, batch_sizes=batch_sizes,
                                  budgets=budgets):
        kw = spec.static_kwargs
        n = kw["n"]
        (B, L), _ = spec.args[0]
        L_real = max(min(L, n * (n - 1) // 2), n - 1)
        u, v, w, ev = audit_graphs(n, L_real, B, seed=seed)
        pad = L - L_real
        if pad:
            u, v = (torch.cat([x, torch.zeros((B, pad), dtype=x.dtype)], 1)
                    for x in (u, v))
            w = torch.cat([w, torch.ones((B, pad))], 1)
            ev = torch.cat([ev, torch.zeros((B, pad), dtype=torch.bool)], 1)
        dev = svc.device
        args = tuple(x.to(dev) for x in (u, v, w, ev)) + (torch.full(
            (B,), spec.signature[3], dtype=torch.int32, device=dev),)

        def ctx_from(out, hu=u, hv=v, hev=ev, n=n):
            return _lane_ctx(n, list(hu), list(hv), list(hev),
                             list(out["tree_mask"].cpu()))

        reports.append(audit_program(
            spec.name, spec.fn, args, kw,
            budget_for("lgrass", kw["bfs_engine"]), ctx_from=ctx_from))
    return reports


def audit_sparsify(g, device=None, **opts) -> AuditReport:
    """`core.sparsify.lgrass_sparsify(g, device=device, **opts)`, the
    host-facing entry (its result decoded to numpy), against the
    'sparsify' budget; on the CUDA device unless `device` says
    otherwise."""
    from repro_torch.core import sparsify as sp

    dev = sp.resolve_device(device)
    u = torch.as_tensor(g.u, dtype=torch.int64)
    v = torch.as_tensor(g.v, dtype=torch.int64)

    def ctx_from(res):
        return _lane_ctx(g.n, [u], [v], [None],
                         [torch.as_tensor(res.tree_mask)])

    return audit_program(
        f"lgrass_sparsify(n={g.n},L={g.m})", sp.lgrass_sparsify, (g,),
        dict(opts, device=dev), budget_for("sparsify", "doubling"),
        ctx_from=ctx_from, device=dev.type)
