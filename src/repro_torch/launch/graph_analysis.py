"""Cost analysis of a torch program, in the role of the reference's
`src/repro/launch/hlo_analysis.py`.

The reference lowers a jitted program and reads its compiled HLO. The
port's programs are eager Python over torch ops, so
`analyze_program(fn, *args, static_kwargs=None)` runs `fn` once under a
`TorchDispatchMode` that sees every op as it is dispatched (the
backward's and a checkpoint's recomputation included), beside torch's
`FlopCounterMode`. Run on meta tensors, it costs nothing and allocates
nothing: that is how the dry-run (`launch/dryrun.py`) sizes a program
for the card, whose kernels answer meta tensors with their fakes
(`kernels/oplib.py`). Run on real tensors, it measures the same things
of a real run. The report keeps the reference's keys:

  * `flops`: `FlopCounterMode`'s total, torch's formulas for the dense
    ops and the port's for its flash operators (`kernels/flash_attention`),
    so a program counts the same on the card and on the CPU. That is the
    reference's convention: attention over the full square whatever
    its mask;
  * `flops_work`: `flops` with each attention operator counted as the
    work its kernels must do (`flash_attention.WORK_FLOPS`): the
    (query, key) pairs its mask leaves visible at contiguous positions,
    and the backward's recomputed S. `chip_smoke.py`'s kernel bounds
    count the same, and a roofline divides by it;
  * `mem_bytes`, `mem_bytes_upper`: the operands read and the results
    written, over every op that moves data (views, `empty` and the like
    move none; a gather reads its indices and the rows it returns, an
    indexed write its indices and values). They are equal: eager mode
    fuses nothing, so every op's operands and results pass through
    memory;
  * `mem_bytes_dots`: the same over the ops that have a FLOP formula;
  * `collective_bytes`, `collective_by_kind`, `collective_counts`: copies
    from one device to another (neither the CPU), by "source->destination";
  * `model_collective_bytes`, `model_collective_by_kind`,
    `model_collective_counts`: the mesh's 'model' collectives
    (`models.sharding.MODEL_COLLECTIVES`), by the kind each call names
    ("attn_out", "mlp_out", "moe_combine", "embed", "ce_*", "logits";
    ":bwd" for a gradient's), each as the bytes one entry sends in a
    ring: 2·(tp−1)/tp of the tensor for an all-reduce, (tp−1)/tp of the
    whole for an all-gather;
  * `data_collective_bytes`, `data_collective_by_kind`,
    `data_collective_counts`: FSDP's collectives over the batch axes
    (`models.sharding.DATA_COLLECTIVES`): each `data_allgather` of a
    leaf's blocks ("gather") as a ring all-gather, (n−1)/n of the
    gathered block per entry, and its backward (`data_reducescatter`,
    "gather:bwd") as the reduce-scatter of its gradient, (n−1)/n of the
    gradient;
  * `transfer_count`: copies from the host to a device, which feed host
    data to the program while it runs (by source line in
    `transfer_sites`);
  * `sync_count`: the host waiting for device values: a scalar read
    (`_local_scalar_dense`: `.item()`, `bool(t)`) or a copy to the host
    (`.tolist()`, `.cpu()`), both host syncs as `analysis/graph_audit.py`
    counts them, which holds each site to its budget. The reference's
    HLO has none: its programs loop on the device (by source line in
    `sync_sites`);
  * `output_alias`: each output that shares storage with an argument,
    `{output_index: [i], parameter: j, kind: "must-alias"}` over the
    flattened outputs and arguments: the port's donation contract (an
    argument's storage handed back as a result);
  * `entry`: the program's name;
  * `peak_bytes`: the high-water mark of the storage live on one device
    during the run, the arguments' included, by a tracker of storage
    lifetimes (the largest over devices). It does not depend on when
    Python's cyclic collector runs: the garbage of earlier work is
    collected first, the collector is off during the run, and
    `FlopCounterMode` counts without its module tracker, whose hooks
    would tie autograd graphs into reference cycles.

Python loops unroll in eager mode, so each trip's ops are counted where
they run: nothing needs the reference's trip-count scaling of while
bodies. The reference's `parse_collectives` and `parse_output_alias` read
HLO text and have no counterpart: the port has no program text.
"""
from __future__ import annotations

import collections
import gc
import os
import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels.flash_attention import WORK_FLOPS
from repro_torch.models.sharding import (DATA_ALLGATHER, DATA_COLLECTIVES,
                                         MODEL_ALLREDUCE, MODEL_COLLECTIVES)

_aten = torch.ops.aten
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)
# ops that read or write no tensor data
_NO_DATA = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.new_empty.default,
            _aten.new_empty_strided.default, _aten.detach.default,
            _aten.alias.default, _aten.lift_fresh.default,
            _aten._local_scalar_dense.default, _aten.set_.source_Storage,
            _aten.set_.source_Storage_storage_offset,
            _aten.resize_.default, _aten.sym_size.int,
            _aten.sym_stride.int, _aten.sym_numel.default}
_COPIES = (_aten._to_copy.default, _aten.copy_.default)
# reads that touch only the indexed rows of their first operand: the
# indices, and the result read and written once
_GATHERS = {_aten.index.Tensor, _aten.index_select.default,
            _aten.gather.default, _aten.embedding.default}
# in-place writes of indexed rows: the indices and the values, read, and
# the values' size written
_SCATTERS = {_aten.index_put_.default, _aten._index_put_impl_.default,
             _aten.index_copy_.default, _aten.index_add_.default,
             _aten.scatter_.src, _aten.scatter_.value,
             _aten.scatter_add_.default, _aten.scatter_reduce_.two}


def _site() -> str:
    """'core/bfs.py:109 (bfs_levels)': the innermost frame of the
    `repro_torch` package outside this module, or '<caller>'."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG + os.sep) and path != _HERE:
            rel = os.path.relpath(path, _PKG).replace(os.sep, "/")
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<caller>"


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _storage(x: torch.Tensor):
    try:
        return x.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class _Recorder(TorchDispatchMode):
    """Bytes, copies, syncs and live storage of the ops it sees."""

    def __init__(self):
        super().__init__()
        self.mem = 0
        self.mem_dots = 0
        self.coll = collections.Counter()
        self.coll_counts = collections.Counter()
        self.model_coll = collections.Counter()
        self.model_counts = collections.Counter()
        self.data_coll = collections.Counter()
        self.data_counts = collections.Counter()
        self.transfers = collections.Counter()
        self.syncs = collections.Counter()
        self.n_ops = 0
        # the kernels' work less what the FLOP formulas count
        self.work_delta = 0
        self.live = collections.Counter()
        self.peak = collections.Counter()
        self._refs: Dict[int, weakref.ref] = {}

    def track(self, x: torch.Tensor) -> None:
        """Count x's storage as live on its device until it is freed."""
        st = _storage(x)
        if st is None or st._cdata in self._refs:
            return
        dev, nbytes, key = str(x.device), st.nbytes(), st._cdata
        live, refs = self.live, self._refs

        def freed(_, dev=dev, nbytes=nbytes, key=key):
            live[dev] -= nbytes
            refs.pop(key, None)

        refs[key] = weakref.ref(st, freed)
        live[dev] += nbytes
        if live[dev] > self.peak[dev]:
            self.peak[dev] = live[dev]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        outs = _tensors(out)
        for o in outs:
            self.track(o)
        if func is _aten._local_scalar_dense.default:
            if args[0].device.type != "cpu":
                self.syncs[_site()] += 1
            return out
        if func in _NO_DATA or func.is_view:
            return out
        if func in MODEL_COLLECTIVES:
            tp, kind = args[1], args[3]
            share = (2 if func is MODEL_ALLREDUCE else 1) * (tp - 1) / tp
            self.model_coll[kind] += share * _nbytes(out)
            self.model_counts[kind] += 1
        if func in DATA_COLLECTIVES:
            n, kind = args[3], args[-1]
            whole = _nbytes(out) if func is DATA_ALLGATHER else _nbytes(
                args[0])
            self.data_coll[kind] += (n - 1) / n * whole
            self.data_counts[kind] += 1
        if func in WORK_FLOPS:
            counted, work = WORK_FLOPS[func](*args)
            self.work_delta += work - counted
        ins = _tensors((args, kwargs))
        if func in _GATHERS:
            moved = sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
        elif func in _SCATTERS:
            rest = _tensors((args[1:], kwargs))
            moved = sum(map(_nbytes, rest)) + _nbytes(rest[-1])
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.mem += moved
        if func._overloadpacket in flop_registry:
            self.mem_dots += moved
        if func in _COPIES:
            src = args[1] if func is _aten.copy_.default else args[0]
            dst = args[0] if func is _aten.copy_.default else out
            s, d = src.device, dst.device
            if s.type == "cpu" and d.type != "cpu":
                self.transfers[_site()] += 1
            elif s.type != "cpu" and d.type == "cpu":
                self.syncs[_site()] += 1
            elif s != d:
                kind = f"{s}->{d}"
                self.coll[kind] += _nbytes(src)
                self.coll_counts[kind] += 1
        return out


class _NoModuleTracker:
    """FlopCounterMode's module tracker, doing nothing: only the total
    ("Global") is read here, and the tracker's hooks on every module's
    inputs and outputs (`register_multi_grad_hook`) make reference cycles
    with the autograd graph, which keep saved activations alive until the
    cyclic collector runs (a traced dbrx-132b step peaked at 2,878 GiB
    with the collector off and 2,496 GiB with it on)."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def analyze_program(fn, *args, static_kwargs: Optional[dict] = None,
                    name: Optional[str] = None) -> Dict:
    """Run `fn(*args, **static_kwargs)` once and report its costs (the
    module docstring). The arguments' storages count as live from the
    start. The outputs are returned under "outputs"."""
    static_kwargs = static_kwargs or {}
    rec = _Recorder()
    arg_leaves = _tensors(args)
    for x in arg_leaves:
        rec.track(x)
    flops = FlopCounterMode(display=False)
    flops.mod_tracker = _NoModuleTracker()
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with flops, rec:
            out = fn(*args, **static_kwargs)
    finally:
        if collecting:
            gc.enable()
    arg_storage = {}
    for j, x in enumerate(arg_leaves):
        st = _storage(x)
        if st is not None:
            arg_storage.setdefault(st._cdata, j)
    aliases = []
    for i, o in enumerate(pytree.tree_leaves(out)):
        st = _storage(o) if isinstance(o, torch.Tensor) else None
        if st is not None and st._cdata in arg_storage:
            aliases.append(dict(output_index=[i],
                                parameter=arg_storage[st._cdata],
                                kind="must-alias"))
    return dict(
        flops=float(flops.get_total_flops()),
        flops_work=float(flops.get_total_flops() + rec.work_delta),
        mem_bytes=float(rec.mem),
        mem_bytes_upper=float(rec.mem),
        mem_bytes_dots=float(rec.mem_dots),
        collective_bytes=float(sum(rec.coll.values())),
        collective_by_kind=dict(rec.coll),
        collective_counts=dict(rec.coll_counts),
        model_collective_bytes=float(sum(rec.model_coll.values())),
        model_collective_by_kind=dict(rec.model_coll),
        model_collective_counts=dict(rec.model_counts),
        data_collective_bytes=float(sum(rec.data_coll.values())),
        data_collective_by_kind=dict(rec.data_coll),
        data_collective_counts=dict(rec.data_counts),
        transfer_count=sum(rec.transfers.values()),
        transfer_sites=dict(rec.transfers),
        sync_count=sum(rec.syncs.values()),
        sync_sites=dict(rec.syncs),
        output_alias=aliases,
        n_ops=rec.n_ops,
        entry=name or getattr(fn, "__qualname__", repr(fn)),
        peak_bytes=float(max(rec.peak.values(), default=0)),
        outputs=out,
    )
