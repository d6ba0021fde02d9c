"""Batched sparsification serving: size-bucketed `GraphBatch` dispatch.

The port of `repro.serve.sparsify_service`. Many graphs per dispatch,
with the reference's traffic-facing policy kept exactly, since it is
host arithmetic:

  * **bucketing** — each request's pad targets (n, L) round up to powers
    of two with floors (`min_n_bucket`, `min_L_bucket`), so the number of
    distinct padded programs is logarithmic in the size range. The
    recovery accept buffer (`b_cap`) is bucketed off the bucket's default
    budget, so default-budget traffic shares one program per bucket.
  * **chunking** — a bucket is dispatched in chunks of at most
    `max_batch_size` graphs, each padded up to a power of two (a mesh
    multiple with a mesh) with trivial placeholder graphs whose results
    are dropped. Placeholder rows run the whole padded program, as the
    reference's vmapped rows do; `ServiceStats.batch_pad_overhead` counts
    them.
  * **schedule and BFS-engine policy** — resolved per bucket through one
    hook each (`_p1_chunk`, `_bfs_engine`), which `warmup` and the
    request path share.

The port has no JIT, so the serving modes mean this in torch:

  * **sync** — for each chunk: fill a host staging set (pinned when the
    service runs on a CUDA device), copy it to the device, run
    `lgrass_device_batched`, then drain the outputs to the host in one
    copy (`results_to_host`).
  * **async_dispatch** — run every chunk's program before draining any,
    then drain in request order. The pipeline syncs the host inside a
    lane (a BFS round, a Borůvka round, REC's accepted count), so a
    dispatch returns with most of its device work done and little can
    overlap; the mode keeps the reference's contract, not its gain.
  * **donate** — dispatch through `lgrass_device_batched_donated`, whose
    tree mask is written over its `edge_valid` input. The device inputs
    come from a pool of buffer sets per (B_pad, L_bucket), refilled from
    the pinned host staging set by `non_blocking` copies. A set is taken
    again only once a CUDA event recorded after its chunk's outputs were
    drained has completed (`event.query()`; the pool never blocks). On
    the CPU that fence is always passed. Steady traffic allocates no new
    set.
  * **warmup** — dispatches placeholder chunks through the same
    `_dispatch` funnel, so it builds the CUDA kernels and the donated
    buffer sets that traffic will use. A "compile" is a dispatch
    signature (n_bucket, L_bucket, B_pad, b_cap): `n_on_path_compiles`
    counts signatures first seen on the request path that warmup did not
    cover, with the reference's b_cap-widening policy (a request whose
    explicit budget exceeds `default_budget(n_bucket)` widens b_cap).
  * **mesh** — each chunk's rows are split over the mesh entries
    (`core.distributed.shard_batch_leading`); each shard runs on its
    device and the results are gathered in request order. The batch pad
    rounds up to a mesh multiple so every shard gets equal rows.

`recovery="host"` keeps the numpy oracle tail per chunk and refuses the
serving modes. Results come back in request order, bit-identical to
per-graph `lgrass_sparsify` under every mode. The service runs on the
CUDA device unless `device="cpu"` is passed; without a card the default
raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.baseline import default_budget
from repro_torch.core.distributed import mesh_size, shard_batch_leading
from repro_torch.core.graph import (PAD_ENDPOINT, PAD_WEIGHT, Graph,
                                    GraphBatch, trivial_graph)
from repro_torch.core.pow2 import auto_chunk, next_pow2
from repro_torch.core.sparsify import (SparsifyResult, _bucket_b_cap,
                                       _result_from_host,
                                       lgrass_device_batched,
                                       lgrass_device_batched_donated,
                                       lgrass_sparsify_batch, resolve_device,
                                       results_to_host)


def _placeholder_graph() -> Graph:
    """Smallest valid graph; pads the batch axis (results discarded).
    The (n=1, m=0) trivial graph fits every bucket."""
    return trivial_graph()


@dataclasses.dataclass
class ServiceStats:
    n_graphs: int = 0
    n_dispatches: int = 0
    n_padded_edge_slots: int = 0   # total L_bucket * B_pad over dispatches
    n_real_edge_slots: int = 0     # real edges of real (requested) graphs
    # the two distinct kinds of padding a dispatch carries:
    n_batch_pad_edge_slots: int = 0  # placeholder rows: L_bucket * n_fill
    n_shape_pad_edge_slots: int = 0  # real rows' tail: L_bucket*B_real - m
    bucket_counts: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict
    )
    n_warmup_dispatches: int = 0   # dispatches made off the request path
    warmup_seconds: float = 0.0
    # dispatch signatures (n_bucket, L_bucket, B_pad, b_cap) first seen on
    # the request path, i.e. programs warmup never ran; counted once per
    # signature (see the module docstring for the b_cap-widening policy)
    n_on_path_compiles: int = 0

    @property
    def padding_overhead(self) -> float:
        """Fraction of dispatched edge slots that were padding (both
        kinds: batch-axis placeholder rows AND real rows' shape tail)."""
        if self.n_padded_edge_slots == 0:
            return 0.0
        return (self.n_batch_pad_edge_slots + self.n_shape_pad_edge_slots
                ) / self.n_padded_edge_slots

    @property
    def batch_pad_overhead(self) -> float:
        """Fraction of dispatched edge slots burned on placeholder rows
        (the pow2 batch-axis fill). Tune with max_batch_size / warmup
        batch_sizes."""
        if self.n_padded_edge_slots == 0:
            return 0.0
        return self.n_batch_pad_edge_slots / self.n_padded_edge_slots

    @property
    def shape_pad_overhead(self) -> float:
        """Fraction of dispatched edge slots burned padding real graphs
        up to their (n_bucket, L_bucket) shape. Tune with the bucket
        floors."""
        if self.n_padded_edge_slots == 0:
            return 0.0
        return self.n_shape_pad_edge_slots / self.n_padded_edge_slots


# the padded (B_pad, L_bucket) arrays of one chunk: (dtype, fill value)
_STAGED = ((torch.int64, PAD_ENDPOINT),   # u
           (torch.int64, PAD_ENDPOINT),   # v
           (torch.float32, PAD_WEIGHT),   # w
           (torch.bool, False))           # edge_valid
_BUSY = "busy"  # fence of a set held by a dispatched, undrained chunk


class _StagingPool:
    """Per-(B_pad, L_bucket) buffer sets (u, v, w, edge_valid) on one
    device, reused across chunks.

    Each entry is [bufs, fence]. A set is free when its fence is None or
    a CUDA event that has completed (`query()`, never a wait); `_BUSY`
    marks a set that a dispatched chunk still holds. `acquire` takes a
    free set or, when every set is fenced, allocates one: the pool grows
    to the number of chunks of one shape in flight at once, and steady
    traffic allocates nothing. Host sets are pinned when `pin`, so that
    their copies to the card can be `non_blocking`.
    """

    def __init__(self, device, pin: bool = False):
        self.device = torch.device(device)
        self.pin = pin
        self._sets: Dict[Tuple[int, int], List[list]] = {}

    def acquire(self, B_pad: int, L_bucket: int) -> list:
        sets = self._sets.setdefault((B_pad, L_bucket), [])
        for entry in sets:
            fence = entry[1]
            if fence is None or (fence is not _BUSY and fence.query()):
                entry[1] = _BUSY
                return entry
        bufs = tuple(torch.empty((B_pad, L_bucket), dtype=dtype,
                                 device=self.device, pin_memory=self.pin)
                     for dtype, _ in _STAGED)
        entry = [bufs, _BUSY]
        sets.append(entry)
        return entry

    @property
    def n_buffer_sets(self) -> int:
        return sum(len(v) for v in self._sets.values())

    @staticmethod
    def fill(bufs, graphs: Sequence[Graph]):
        """Pad-fill (u, v, w, edge_valid) with the leading len(graphs)
        rows holding the real graphs and the tail rows left as
        all-padding placeholder rows."""
        for buf, (_, value) in zip(bufs, _STAGED):
            buf.fill_(value)
        u, v, w, ev = bufs
        for i, g in enumerate(graphs):
            m = g.m
            u[i, :m] = torch.from_numpy(np.asarray(g.u, np.int64))
            v[i, :m] = torch.from_numpy(np.asarray(g.v, np.int64))
            w[i, :m] = torch.from_numpy(np.asarray(g.w, np.float32))
            ev[i, :m] = True
        return bufs


def _fence(device):
    """A fence for work enqueued so far on `device`'s current stream: a
    recorded CUDA event, or None on the CPU (already done)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One dispatch signature of the service, in auditable form: the
    callable, the array arguments as (shape, dtype) pairs and the static
    kwargs, exactly what `_dispatch` would run for that signature."""
    name: str
    signature: Tuple[int, int, int, int]   # (n_bucket, L_bucket, B_pad, b_cap)
    fn: object                             # the batched program
    args: tuple                            # (shape, torch dtype) per array
    static_kwargs: dict


@dataclasses.dataclass
class _PendingChunk:
    """One dispatched chunk awaiting drain: the device outputs (one dict
    per shard) plus everything needed to scatter rows back into request
    order and to release its donated buffer set."""
    idxs: List[int]          # request indices of the real rows
    Ls: List[int]            # per-row true edge counts (result slicing)
    device: List[dict]       # output tensors, one dict per shard
    inputs: Optional[list] = None  # the donated set's pool entry


class SparsifyService:
    """Sparsify request batches with a bounded set of padded shapes.

    >>> svc = SparsifyService(async_dispatch=True, donate=True)
    >>> svc.warmup([(100, 300)])             # optional: off the path
    >>> results = svc.sparsify(list_of_graphs)   # request order preserved

    async_dispatch: run every chunk before draining any result. donate:
    dispatch through the donated program with pooled device inputs.
    mesh: split the rows of each chunk across the mesh (requires
    recovery="device", as do the other serving modes). device: where the
    service runs, the CUDA device by default (raises without one), or
    "cpu".
    """

    def __init__(
        self,
        k_cap: int = 32,
        parallel: bool = True,
        max_batch_size: int = 64,
        min_n_bucket: int = 16,
        min_L_bucket: int = 32,
        recovery: str = "device",
        schedule: str = "chunked",
        p1_chunk: Optional[int] = None,
        bfs_engine: str = "doubling",
        async_dispatch: bool = False,
        donate: bool = False,
        mesh=None,
        device=None,
    ):
        self.k_cap = k_cap
        self.parallel = parallel
        self.max_batch_size = max_batch_size
        self.min_n_bucket = min_n_bucket
        self.min_L_bucket = min_L_bucket
        self.recovery = recovery
        self.schedule = schedule
        self.p1_chunk = p1_chunk
        self.bfs_engine = bfs_engine
        self.async_dispatch = async_dispatch
        self.donate = donate
        self.mesh = mesh
        if recovery == "device":
            pass
        elif recovery == "host":
            if async_dispatch or donate or mesh is not None:
                raise ValueError(
                    "async_dispatch/donate/mesh require recovery='device' "
                    "(the host oracle tail blocks per chunk by design)"
                )
        else:
            raise ValueError(f"unknown recovery mode {recovery!r}")
        self.device = resolve_device(device)
        self.stats = ServiceStats()
        self._pool = _StagingPool("cpu", pin=self.device.type == "cuda")
        self._device_pool = _StagingPool(self.device)  # donated inputs
        self._warmed: Set[Tuple[int, int, int, int]] = set()
        self._seen: Set[Tuple[int, int, int, int]] = set()

    # ---------------------------------------------------------- policies

    def _p1_chunk(self, L_bucket: int) -> Optional[int]:
        """Per-bucket phase-1 block size: `auto_chunk` of the padded edge
        count under the chunked schedule, so every graph of a bucket
        shares one block size; an explicit `p1_chunk` pins all buckets."""
        if self.schedule != "chunked":
            return None
        if self.p1_chunk is not None:
            return self.p1_chunk
        return auto_chunk(L_bucket)

    def _bfs_engine(self, n_bucket: int) -> str:
        """Per-bucket BFS-engine policy, the one hook the request path and
        `warmup` resolve through (uniform by default)."""
        return self.bfs_engine

    def _bucket(self, n: int, L: int) -> Tuple[int, int]:
        """The bucketing policy, from raw sizes: the single source both
        the request path (`bucket_key`) and `warmup` resolve through."""
        return (
            max(next_pow2(int(n)), self.min_n_bucket),
            max(next_pow2(int(L)), self.min_L_bucket),
        )

    def bucket_key(self, g: Graph) -> Tuple[int, int]:
        """(n_bucket, L_bucket): pad targets rounded up to powers of two.
        An edgeless graph lands in the smallest bucket (next_pow2 floors
        at 1)."""
        return self._bucket(g.n, g.m)

    def _b_cap(self, n_bucket: int, budgets: Sequence[int]) -> int:
        """Accept-buffer bucket for a chunk, keyed off the bucket's own
        default budget; larger explicit budgets widen it (and land a new
        dispatch signature: see n_on_path_compiles)."""
        return _bucket_b_cap(list(budgets) + [default_budget(n_bucket)])

    def _program_kwargs(self, n_bucket: int, L_bucket: int,
                        b_cap: int) -> dict:
        """The static kwargs of the batched program for one dispatch
        signature: the single definition `_dispatch`, `warmup` and
        `program_specs` share."""
        return dict(
            n=n_bucket,
            k_cap=self.k_cap,
            parallel=self.parallel,
            lift_levels=None,
            b_cap=b_cap,
            use_tree_kernel=False,
            chunk=32,
            schedule=self.schedule,
            p1_chunk=self._p1_chunk(L_bucket),
            use_euler_lca=True,
            bfs_engine=self._bfs_engine(n_bucket),
        )

    @property
    def dispatch_fn(self):
        """The one callable every device chunk dispatches through for
        this service's mode (donated or plain)."""
        return (lgrass_device_batched_donated if self.donate
                else lgrass_device_batched)

    def compiled_signatures(self) -> List[Tuple[int, int, int, int]]:
        """Every dispatch signature (n_bucket, L_bucket, B_pad, b_cap)
        this service has run, warmed and request-path alike."""
        return sorted(self._warmed | self._seen)

    def program_specs(
        self,
        sizes: Optional[Iterable[Tuple[int, int]]] = None,
        batch_sizes: Sequence[int] = (1,),
        budgets: Sequence[int] = (),
    ) -> List[ProgramSpec]:
        """`ProgramSpec`s for a signature set, without dispatching:
        sizes=None gives the signatures already run; otherwise (n, L)
        pairs resolve through the same bucketing, b_cap and batch-pad
        policies `warmup` and the request path use."""
        if sizes is None:
            sigs = self.compiled_signatures()
        else:
            sigset = set()
            for (n, L) in sizes:
                n_bucket, L_bucket = self._bucket(n, L)
                b_cap = self._b_cap(n_bucket, list(budgets))
                for B in batch_sizes:
                    sigset.add((n_bucket, L_bucket, self._pad_batch(int(B)),
                                b_cap))
            sigs = sorted(sigset)
        mode = ("donated" if self.donate else
                "sharded" if self.mesh is not None else "plain")
        specs = []
        for sig in sigs:
            n_bucket, L_bucket, B_pad, b_cap = sig
            args = tuple(((B_pad, L_bucket), dtype)
                         for dtype, _ in _STAGED) + (((B_pad,), torch.int32),)
            specs.append(ProgramSpec(
                name=f"lgrass_device_batched[{mode}]"
                     f"(n={n_bucket},L={L_bucket},B={B_pad},b_cap={b_cap})",
                signature=sig,
                fn=self.dispatch_fn,
                args=args,
                static_kwargs=self._program_kwargs(n_bucket, L_bucket,
                                                   b_cap),
            ))
        return specs

    def _pad_batch(self, n_chunk: int) -> int:
        """Batch-axis pad target for a chunk of `n_chunk` graphs: the
        next power of two, rounded up to whole mesh multiples when
        sharding so every shard gets equal rows."""
        if self.mesh is not None:
            ms = mesh_size(self.mesh)
            return ms * next_pow2(-(-int(n_chunk) // ms))
        return next_pow2(int(n_chunk))

    # ---------------------------------------------------------- dispatch

    def _dispatch(
        self,
        graphs: Sequence[Graph],
        budgets: Sequence[int],
        n_bucket: int,
        L_bucket: int,
        B_pad: int,
        b_cap: int,
    ) -> Tuple[List[dict], Optional[list]]:
        """Run ONE padded chunk on the device: the single funnel for the
        request path and warmup. Returns (output dicts, one per shard;
        the donated set's pool entry or None), not yet drained."""
        host = self._pool.acquire(B_pad, L_bucket)
        self._pool.fill(host[0], graphs)
        bb = np.ones((B_pad,), np.int32)  # placeholder rows: budget 1
        bb[: len(budgets)] = np.asarray(budgets, np.int32)
        nb = self.device.type == "cuda"
        if self.donate:
            entry = self._device_pool.acquire(B_pad, L_bucket)
            arrs = tuple(d.copy_(h, non_blocking=nb)
                         for d, h in zip(entry[0], host[0]))
        else:
            entry = None
            arrs = tuple(torch.empty_like(h, device=self.device).copy_(
                h, non_blocking=nb) for h in host[0])
        # the staging set is free again once its copies have run
        host[1] = _fence(self.device)
        kwargs = self._program_kwargs(n_bucket, L_bucket, b_cap)
        if self.mesh is None:
            return [self.dispatch_fn(*arrs, bb, **kwargs)], entry
        parts = shard_batch_leading(arrs, self.mesh)
        rows = B_pad // len(parts)
        return [self.dispatch_fn(*part, bb[j * rows:(j + 1) * rows],
                                 **kwargs)
                for j, part in enumerate(parts)], entry

    def _drain(self, pending: _PendingChunk,
               results: List[Optional[SparsifyResult]]):
        """Copy one chunk's outputs to the host (one copy per shard),
        scatter its rows into `results` at their request indices
        (placeholder tail dropped), and fence its donated set."""
        hosts = [results_to_host(d) for d in pending.device]
        h = {k: np.concatenate([x[k] for x in hosts]) for k in hosts[0]}
        if pending.inputs is not None:
            pending.inputs[1] = _fence(self.device)
        for row, (i, L) in enumerate(zip(pending.idxs, pending.Ls)):
            results[i] = _result_from_host(h, row, L)

    # ---------------------------------------------------------- serving

    def sparsify(
        self,
        graphs: Sequence[Graph],
        budget: Optional[object] = None,
    ) -> List[SparsifyResult]:
        """Sparsify `graphs`, returning results in request order.

        budget: None (per-graph default), an int for all graphs, or a
        sequence with one budget per graph.
        """
        graphs = list(graphs)
        if budget is None or np.ndim(budget) == 0:
            budgets = [budget] * len(graphs)
        else:
            budgets = list(budget)
            if len(budgets) != len(graphs):
                raise ValueError("one budget per graph required")

        by_bucket: Dict[Tuple[int, int], List[int]] = {}
        for i, g in enumerate(graphs):
            by_bucket.setdefault(self.bucket_key(g), []).append(i)

        results: List[Optional[SparsifyResult]] = [None] * len(graphs)
        pending: List[_PendingChunk] = []
        for key in sorted(by_bucket):
            idxs = by_bucket[key]
            n_bucket, L_bucket = key
            self.stats.bucket_counts[key] = (
                self.stats.bucket_counts.get(key, 0) + len(idxs)
            )
            for lo in range(0, len(idxs), self.max_batch_size):
                chunk = idxs[lo: lo + self.max_batch_size]
                B_pad = self._pad_batch(len(chunk))
                # resolve None budgets once, so b_cap and the program agree
                resolved = [
                    default_budget(graphs[i].n) if budgets[i] is None
                    else int(budgets[i])
                    for i in chunk
                ]
                b_cap = self._b_cap(n_bucket, resolved)
                sig = (n_bucket, L_bucket, B_pad, b_cap)
                if sig not in self._warmed and sig not in self._seen:
                    self.stats.n_on_path_compiles += 1
                self._seen.add(sig)
                if self.recovery == "host":
                    self._sparsify_host_chunk(
                        graphs, chunk, resolved, n_bucket, L_bucket, B_pad,
                        b_cap, results)
                else:
                    outs, entry = self._dispatch(
                        [graphs[i] for i in chunk], resolved,
                        n_bucket, L_bucket, B_pad, b_cap)
                    item = _PendingChunk(
                        idxs=chunk, Ls=[graphs[i].m for i in chunk],
                        device=outs, inputs=entry)
                    if self.async_dispatch:
                        pending.append(item)   # drain after ALL dispatches
                    else:
                        self._drain(item, results)
                n_fill = B_pad - len(chunk)
                n_real = sum(graphs[i].m for i in chunk)
                self.stats.n_dispatches += 1
                self.stats.n_graphs += len(chunk)
                self.stats.n_padded_edge_slots += L_bucket * B_pad
                self.stats.n_real_edge_slots += n_real
                self.stats.n_batch_pad_edge_slots += L_bucket * n_fill
                self.stats.n_shape_pad_edge_slots += (
                    L_bucket * len(chunk) - n_real
                )
        for item in pending:
            self._drain(item, results)
        return results  # type: ignore[return-value]

    def _sparsify_host_chunk(self, graphs, chunk, resolved, n_bucket,
                             L_bucket, B_pad, b_cap, results):
        """The oracle tail (recovery='host'): a per-chunk blocking batch
        call through lgrass_sparsify_batch, kept for fidelity checks."""
        n_fill = B_pad - len(chunk)
        batch = GraphBatch.from_graphs(
            [graphs[i] for i in chunk] + [_placeholder_graph()] * n_fill,
            n_max=n_bucket,
            L_max=L_bucket,
        )
        out = lgrass_sparsify_batch(
            batch,
            budget=list(resolved) + [None] * n_fill,
            k_cap=self.k_cap, parallel=self.parallel,
            recovery=self.recovery,
            b_cap=b_cap,
            schedule=self.schedule,
            p1_chunk=self._p1_chunk(L_bucket),
            bfs_engine=self._bfs_engine(n_bucket),
            device=self.device,
        )
        for i, r in zip(chunk, out):  # placeholder tail dropped
            results[i] = r

    def warmup(
        self,
        sizes: Iterable[Tuple[int, int]],
        batch_sizes: Sequence[int] = (1,),
        budgets: Sequence[int] = (),
    ) -> int:
        """Run the bucket programs of anticipated request shapes off the
        request path.

        sizes: (n, L) pairs, each rounded to its bucket as `sparsify`
        would. batch_sizes: chunk sizes to warm (each padded as the
        request path pads). budgets: explicit request budgets whose wider
        b_cap to warm; without them a larger explicit budget counts as an
        on-path compile. Each signature runs once on placeholder graphs
        through the same `_dispatch` funnel as traffic (so the kernels are
        built and, with donate, the pool holds the signature's set), and
        is drained before the next. Returns the number of warmup
        dispatches; `stats.n_warmup_dispatches` / `stats.warmup_seconds`
        accumulate.
        """
        t0 = time.perf_counter()
        n_dispatched = 0
        for (n, L) in sizes:
            n_bucket, L_bucket = self._bucket(n, L)
            b_cap = self._b_cap(n_bucket, list(budgets))
            for B in batch_sizes:
                B_pad = self._pad_batch(int(B))
                sig = (n_bucket, L_bucket, B_pad, b_cap)
                if sig in self._warmed:
                    continue
                self._warmed.add(sig)
                out: List[Optional[SparsifyResult]] = [None] * B_pad
                if self.recovery == "host":
                    self._sparsify_host_chunk(
                        [_placeholder_graph()] * B_pad, list(range(B_pad)),
                        [1] * B_pad, n_bucket, L_bucket, B_pad, b_cap, out)
                else:
                    outs, entry = self._dispatch(
                        [_placeholder_graph()] * B_pad, [1] * B_pad,
                        n_bucket, L_bucket, B_pad, b_cap)
                    self._drain(_PendingChunk(
                        idxs=list(range(B_pad)), Ls=[0] * B_pad,
                        device=outs, inputs=entry), out)
                n_dispatched += 1
        self.stats.n_warmup_dispatches += n_dispatched
        self.stats.warmup_seconds += time.perf_counter() - t0
        return n_dispatched
