"""The training step: loss -> gradients -> AdamW, with microbatch
gradient accumulation and optional gradient compression with error
feedback. The port of `repro.train.train_step`.

A train state is a dict over one model's parameters:

    {"params": {name: the model's own float32 leaf},
     "opt": {"mu": {name: float32}, "nu": {name: float32},
             "step": int32 scalar},
     ["err": {name: float32}]}          (with compression)

keyed by the port's parameter names (the reference's pytree paths); a
leaf is a tensor, or on a tensor-parallel mesh a `Placed` value (see
below), and its moments follow it. The step runs eagerly:
`torch.autograd.grad` of `LM.loss_fn`, then the AdamW arithmetic of
`optim/optimizer.py`, the parameters and moments updated in place under
`torch.no_grad()`, so the model sees the new weights.

Microbatches: each one's gradients (cast to `grad_sync_dtype` first,
where given) are summed into a float32 accumulator in order, then the
sum and the summed loss are divided by their number, as the reference's
scan does. Compression works on the reference's leaves: in the `scan`
layout the reference holds each layer weight as one leaf stacked over
the layers, and both top-k's k and int8's rows (the first axis) are
taken over that leaf, so the port stacks its per-layer gradients the
same way before compressing and splits the result after.

On a mesh (`models.sharding.use_mesh`, read when the step runs, as the
reference reads `current_mesh()`), each microbatch's rows are split over
the data shards of `launch.mesh.batch_axes_for`'s axes (contiguous
blocks, in mesh order; a shard runs on the first mesh entry at its
coordinates). Each shard runs `LM.loss_fn` and `torch.autograd.grad` on
its rows on its device: the model's own whole leaves where the shard is
on the model's device (shards that repeat a device share them), a copy
of them made per step elsewhere (`launch.mesh.copy_params`,
`call_with`). A shard's CE is its sum over the microbatch's token count
(Σ mask, at least 1, where there is a mask), so the shards' losses add
up to the whole microbatch's mean, as the reference's jitted step
computes it whatever the sharding, and so do their gradients. The
gradients are summed in float32 in mesh order (no atomics: two runs are
bit-equal); `grad_sync_dtype` rounds the sum, the microbatch's gradient,
as the reference's does, before it is added to the accumulator.

MoE on the mesh: dispatch and capacity are per sequence (the reference's
`_capacity` takes the row length, its ranks are vmapped over rows), so a
data shard routes, keeps and drops its rows' pairs exactly as the whole
batch does. Only the Switch aux loss couples the rows: its density and
frac are the whole microbatch's. So each shard runs its forward first,
handing out its MoE layers' router statistics (`LM.loss_fn(...,
moe_stats=)`); the statistics are summed on the model's device in mesh
order (a shard elsewhere sends its own there) and give the microbatch's
aux (`moe.aux_from_stats`); then each shard takes its gradient of its CE
plus its linear share of the aux, coef·E/(L·B·S)·Σ_l ⟨gsum_s,l, frac_l⟩
(frac has no gradient; it goes back to the shard's device). The shards'
shares add up to the aux and their gradients to its gradient. Every
shard's forward graph lives until the last forward ends. The loss
reported is the shards' CE summed plus the assembled aux.

Tensor parallelism: on a mesh with a 'model' axis, each data shard's
loss runs under its 'model' entries (`models.sharding.model_entries`,
set by `use_entries`), and the state is laid out as the reference's
(`make_train_state` under `use_mesh`, or the step itself first:
`lay_out_state`). Each leaf whose spec puts a dimension on 'model' is
placed (`models.sharding.place_model`): every entry holds its block of
the parameter, mu and nu on its device, as tensors of its own, and
computes on it; the replicated leaves (norms, router, frontend, whole
wk / wv) stay whole on the model's device, copied per step to a data
shard elsewhere. A block's gradient comes back on its entry's device;
the data shards' gradients of block m are summed in mesh order in
float32 into the accumulator tile of the first data shard's entry m,
which keeps it (with `grad_shard_specs`, each entry its block along the
batch axes of its block m: the tiles of `Tile`), and AdamW runs there,
once per tile, so the global norm counts each element once. The
updated parameter, mu and nu of the tile are then copied to every other
tensor that holds block m (an entry of another data shard on another
device), so the copies stay bit-equal. No whole sharded leaf is
held or copied in a step; `entry_bytes` gives what each entry holds.
MLA and SSM configs do not shard (`models.sharding.tp_family`): their
first entry of each data coordinate works, on whole leaves. Without a
mesh the step runs under the caller's entries, if any: the dry-run's
one traced entry, whose model holds that entry's blocks alone
(`models.sharding.entry_model`).

FSDP: `make_train_state(model, specs=param_specs(model))` under
`use_mesh` (or `lay_out_state(model, state, specs)`) lays the state out
by the reference's full specs (`models.sharding.place_model(...,
specs=)`): each entry holds its ('pod', 'data', 'model') block of every
parameter, mu and nu, as a tensor of its own, and no entry holds
another's. Each data shard's loss reads a layer's blocks through its
gathers (`models.sharding.fsdp_use`, under the shard's entries and
`use_shard`), so its gradients come back per block (`reads`,
`_fsdp_sources`); the data shards' gradients of a block are summed in
float32 in mesh order into the tile of the entry that holds it (one
tile per distinct block, `_tiles`: the ZeRO tiles of the same mesh, in
the same order, so the step is bit-equal to the ZeRO step), AdamW runs
on the blocks in place, and no block has another tensor to copy to
(`_replicas`), but across pods, whose blocks are replicas.

`grad_shard_specs` ({name: P}, `models.sharding.param_specs`' layout),
on a mesh, makes the accumulator ZeRO-sharded: each data shard keeps
only its block of each whole leaf's gradient sum, along the spec's
batch axes (the spec resolved on the mesh and on the port's per-layer
leaf), on its device; the microbatches accumulate into those blocks,
AdamW runs on the blocks (views of the parameters and moments, so the
update lands in the whole leaves: the parameters are gathered back in
place), and the global norm is taken over them. Compression, where
asked, runs on the gathered sum, on the reference's leaves, on the
model's device, before the update.
Without a mesh (or with one data shard) the step is the one-device step
above: one shard, the whole leaves, `loss_fn`'s own mean.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ft.elastic import resolve_spec_for_mesh
from repro_torch.launch.mesh import (call_with, canon_device, copy_params,
                                     data_shards)
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.models.sharding import (Placed, block_slices,
                                         current_entries, current_mesh,
                                         gather_sources, gather_targets,
                                         is_fsdp, keep_axes, lay_out_model,
                                         local_tensors, model_entries,
                                         named_leaves, place, placed_mesh,
                                         shards_over_model, use_entries,
                                         use_shard)
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizer import (OptConfig, adamw_update,
                                         init_opt_state)

_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def _zeros(x):
    """Zeros like a leaf, as `init_opt_state` makes them; a Placed leaf's
    block for block, shared by the same entries."""
    if isinstance(x, Placed):
        return x.map(_zeros)
    return torch.zeros_like(x, memory_format=torch.contiguous_format)


def make_train_state(model: LM,
                     generator: Optional[torch.Generator] = None,
                     specs: Optional[Dict] = None) -> Dict:
    """The train state over `model`'s parameters, which must be float32
    (`LM(..., param_dtype=torch.float32)`); sets requires_grad on them.
    The model is laid out for the active mesh first (`sharding.
    lay_out_model`): under `use_mesh` of a mesh whose 'model' axis
    `model`'s config shards over, it is placed on it, and the state's
    sharded leaves, mu and nu are Placed values, each entry's block on
    its device. With `specs` ({name: P}: `param_specs(model)` under
    `use_mesh`, the reference's `make_train_state_specs`), it is laid out
    by them instead: FSDP on the batch axes and the 'model' blocks, each
    entry its ('pod', 'data', 'model') block of every parameter, mu and
    nu. With `generator`, the weights are drawn anew from it first (the
    reference's `make_train_state(model, rng)`), whole, then cut."""
    params = dict(named_leaves(lay_out_model(model, specs)))
    if generator is not None:
        fresh = LM(model.cfg, generator=generator, device=model.device,
                   param_dtype=torch.float32)
        drawn = dict(fresh.named_parameters())
        del fresh
        load_train_state({"params": params},
                         {"params": {n: drawn.pop(n) for n in params}})
    for name, p in params.items():
        if p.dtype != torch.float32:
            raise ValueError(f"{name} is {p.dtype}: a train state needs "
                             f"float32 leaves (param_dtype=torch.float32)")
        for t in local_tensors(p):
            t.requires_grad_(True)
    opt = init_opt_state({n: p for n, p in params.items()
                          if not isinstance(p, Placed)})
    for part in ("mu", "nu"):
        opt[part] = {n: opt[part][n] if n in opt[part] else _zeros(p)
                     for n, p in params.items()}
    return dict(params=params, opt=opt)


def load_train_state(state: Dict, values: Dict) -> Dict:
    """Copy `values` (a tree of the state's shape: tensors, numpy arrays
    or Placed values, such as `models/convert.from_reference_train_state`'s,
    a restored checkpoint or `ft.elastic.remesh_state`'s) into the state's
    tensors, in place; a placed leaf takes each entry's block."""
    with torch.no_grad():
        def walk(dst, src):
            if isinstance(dst, dict):
                if set(dst) != set(src):
                    raise ValueError(f"keys differ: {sorted(set(dst) ^ set(src))}")
                for k in dst:
                    walk(dst[k], src[k])
            elif isinstance(dst, Placed):
                dst.load_(src)
            else:
                dst.copy_(src.full() if isinstance(src, Placed)
                          else torch.as_tensor(src))
        walk(state, values)
    return state


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int) -> List[Dict]:
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} of {name} not divisible by "
                             f"micro {k}")
    return [{name: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
             for name, x in batch.items()} for i in range(k)]


def _reference_leaves(names, layout: str) -> List[List[str]]:
    """The port's parameter names grouped into the reference's leaves:
    in the `scan` layout every `layers.<i>.<rest>` of one <rest>, in layer
    order (one stacked leaf); otherwise each name alone."""
    if layout != "scan":
        return [[n] for n in names]
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for n in names:
        m = _LAYER.match(n)
        key = m.group(2) if m else n
        groups.setdefault(("layers." + key) if m else key, []).append(
            (int(m.group(1)) if m else 0, n))
    return [[n for _, n in sorted(g)] for g in groups.values()]


def _compress(fn: Callable, grads: Dict, errs: Dict, groups) -> Tuple[Dict,
                                                                      Dict]:
    """fn(g, err) -> (sent, new err) over each reference leaf: a group's
    tensors stacked, compressed, split back."""
    sent, new_err = {}, {}
    for names in groups:
        if len(names) == 1:
            n = names[0]
            sent[n], new_err[n] = fn(grads[n], errs[n])
            continue
        s, e = fn(torch.stack([grads[n] for n in names]),
                  torch.stack([errs[n] for n in names]))
        for i, n in enumerate(names):
            sent[n], new_err[n] = s[i], e[i]
    return sent, new_err


@dataclasses.dataclass(frozen=True)
class Tile:
    """A block of a leaf's gradient sum that one mesh entry keeps: `part`
    names which of a data shard's tensors of the leaf it comes from (a
    placed leaf's one per 'model' entry, else 0), `sl` its slices there,
    `gsl` in the whole leaf; kept on `device`, by mesh entry `keep`;
    `whole` where it is all of its part."""

    part: int
    sl: Tuple[slice, ...]
    gsl: Tuple[slice, ...]
    device: torch.device
    keep: int
    whole: bool = False


def _within(outer: Tuple[slice, ...], inner: Tuple[slice, ...]
            ) -> Tuple[slice, ...]:
    """`inner` (slices of the block `outer`) as slices of the whole."""
    out = []
    for o, i in zip(outer, inner):
        start, stop, _ = i.indices(o.stop - o.start)
        out.append(slice(o.start + start, o.start + stop))
    return tuple(out)


def _shard_index(mesh, at: Dict[str, int]) -> int:
    """The mesh entry of a data shard's root (its first 'model' entry)."""
    if mesh is None:
        return 0
    return int(np.ravel_multi_index([at.get(a, 0) for a in mesh.axis_names],
                                    mesh.axis_sizes))


def _fsdp_sources(leaf: Placed, entries, root: int) -> List[int]:
    """The mesh entries whose blocks of an FSDP leaf a data shard's loss
    reads through its gathers (`sharding.fsdp_use`), in the order of the
    leaf's tiles: for each entry it gathers for (`gather_targets`: its
    'model' `entries`, or its root at mesh entry `root`), the blocks
    along the batch axes in mesh order; the blocks the leaf holds (all
    but on the dry-run's traced entry)."""
    return [i for j in gather_targets(leaf, entries, root)
            for i in gather_sources(leaf, j)[1]
            if leaf.shards[i] is not None]


def _tiles(params: Dict, specs: Optional[Dict], mesh, axes, shards,
           groups, root) -> Dict[str, List[Tile]]:
    """Per leaf, the tiles of its gradient sum (`Tile`). A whole leaf:
    without specs one tile on `root`; with them the
    blocks of the spec's batch axes, each on the first shard that holds
    it. A placed leaf: per 'model' entry m, its block, kept by the first
    data shard's entry m, or with specs that block's blocks along the
    batch axes, each kept by entry m of the first shard that holds it.
    An FSDP leaf (`sharding.is_fsdp`): each block it holds, kept by the
    entry that holds it, in the order above (per 'model' entry, the
    blocks along the batch axes), whatever the specs."""
    out = {}
    for n, p in params.items():
        if is_fsdp(p):
            full = (slice(None),) * len(p.shape)
            out[n] = [Tile(b, full, p.block(j),
                           canon_device(p.mesh.devices[j]), j, True)
                      for b, j in enumerate(_fsdp_sources(
                          p, groups[0], _shard_index(mesh, shards[0][0])))]
            continue
        zs = (None if specs is None else
              keep_axes(resolve_spec_for_mesh(specs[n], mesh), set(axes)))
        if not isinstance(p, Placed):
            full = (slice(None),) * p.dim()
            if zs is None:
                out[n] = [Tile(0, full, full, root,
                               _shard_index(mesh, shards[0][0]), True)]
                continue
            seen, tiles = set(), []
            for at, dev in shards:
                sl = block_slices(p.shape, zs, mesh.shape, at)
                key = tuple((x.start, x.stop) for x in sl)
                if key not in seen:
                    seen.add(key)
                    tiles.append(Tile(0, sl, sl, dev,
                                      _shard_index(mesh, at)))
            out[n] = _mark_whole(tiles)
            continue
        tiles = []
        for m in range(len(groups[0].coords)):
            seen = set()
            for (at, _), entries in zip(shards, groups):
                e = list(entries)[m]
                blk = p.block(e.index)
                shape = tuple(x.stop - x.start for x in blk)
                sl = ((slice(None),) * len(shape) if zs is None else
                      block_slices(shape, zs, mesh.shape, at))
                key = tuple(x.indices(k)[:2] for x, k in zip(sl, shape))
                if key in seen:
                    continue
                seen.add(key)
                tiles.append(Tile(m, sl, _within(blk, sl), e.device,
                                  e.index))
                if zs is None:
                    break
        out[n] = _mark_whole(tiles)
    return out


def _mark_whole(tiles: List[Tile]) -> List[Tile]:
    """`tiles` with `whole` set on each that is the only one of its part."""
    parts = [t.part for t in tiles]
    return [dataclasses.replace(t, whole=parts.count(t.part) == 1)
            for t in tiles]


def _replicas(leaf: Placed, keep: int) -> List[int]:
    """The mesh entries whose tensors hold the block of entry `keep` of a
    placed leaf, one per tensor, `keep` first."""
    key = leaf.block_key(keep)
    own = leaf.shards[keep]
    return [keep] + [j for j, t in leaf.distinct()
                     if t is not own and leaf.block_key(j) == key]


def lay_out_state(model: LM, state: Dict,
                  specs: Optional[Dict] = None) -> Dict:
    """`model` and its train `state` laid out, in place, for the active
    mesh (`use_mesh`): the model by `sharding.lay_out_model` (by `specs`
    where given, FSDP; a model laid out by specs keeps that layout;
    otherwise placed on a mesh whose 'model' axis the config shards
    over, whole leaves elsewhere), then, wherever the state's parameters
    are not the model's leaves (the model was laid out anew, here or by
    a serving step), the state's parameters become them and the moments
    and the error feedback follow, block for block. The step does this
    first; call it to lay a state out before a step (to measure what it
    holds, `entry_bytes`). Returns `state`."""
    leaves = named_leaves(lay_out_model(model, specs))
    if all(state["params"].get(n) is x for n, x in leaves):
        return state
    state["params"] = params = dict(leaves)
    trees = [state["opt"]["mu"], state["opt"]["nu"]] + (
        [state["err"]] if "err" in state else [])
    with torch.no_grad():
        for tree in trees:
            for n, x in tree.items():
                whole = x.full(model.device) if isinstance(x, Placed) else x
                p = params[n]
                tree[n] = (place(whole, p.mesh, p.spec, own=True)
                           if isinstance(p, Placed) else whole.to(p.device))
    return state


def _layout(model: LM, params: Dict, specs: Optional[Dict], rows: int):
    """(the batch axes, the data shards' (coordinates, device), each one's
    'model' entries, the tiles of every leaf's gradient sum) of a step of
    `rows` rows on the active mesh; raises where the model is not laid
    out for that mesh (`lay_out_state`)."""
    mesh = current_mesh()
    placed = placed_mesh(model)
    if mesh is not None and placed != mesh and (
            placed is not None or shards_over_model(mesh, model.cfg)):
        raise ValueError(
            f"{model.cfg.name}: its train state is laid out for "
            f"{'no mesh' if placed is None else placed.shape}, the step "
            f"runs on {mesh.shape}: lay it out first (lay_out_state)")
    axes, shards = (((), [({}, model.device)]) if mesh is None
                    else data_shards(mesh, rows))
    # without a mesh, the caller's entries (the dry-run's one entry)
    groups = ([current_entries()] if mesh is None else
              [model_entries(mesh, at, model.cfg) for at, _ in shards])
    return axes, shards, groups, _tiles(params, specs if mesh else None,
                                        mesh, axes, shards, groups,
                                        model.device)


def entry_bytes(model: LM, state: Dict, rows: int,
                grad_shard_specs: Optional[Dict] = None
                ) -> List[Dict[str, int]]:
    """Per mesh entry of the active mesh (one without a mesh), the bytes
    of the train state it holds in a step of `rows` rows: its blocks of
    the parameters, mu and nu (and, for the entry of the model's device,
    the replicated leaves), and of the float32 gradient accumulator the
    tiles it keeps."""
    mesh = current_mesh()
    n = 1 if mesh is None else len(mesh.devices)
    out = [dict(params=0, mu=0, nu=0, accumulator=0) for _ in range(n)]
    for part, tree in (("params", state["params"]),
                       ("mu", state["opt"]["mu"]),
                       ("nu", state["opt"]["nu"])):
        for x in tree.values():
            if isinstance(x, Placed):
                for j, t in enumerate(x.shards):
                    if t is not None:
                        out[j][part] += t.numel() * t.element_size()
            else:
                out[0][part] += x.numel() * x.element_size()
    tiles = _layout(model, state["params"], grad_shard_specs, rows)[3]
    for name, ts in tiles.items():
        leaf = state["params"][name]
        for t in ts:
            shape = (leaf.shards[t.keep][t.sl].shape
                     if isinstance(leaf, Placed) else leaf[t.sl].shape)
            out[t.keep]["accumulator"] += int(np.prod(shape)) * 4
    return out


def _denominator(mb: Dict, root) -> torch.Tensor:
    """The microbatch's CE denominator: max(Σ mask, 1), or its token
    count where it has no mask (float32, on `root`)."""
    mask = mb.get("mask")
    if mask is not None:
        return torch.clamp(torch.sum(mask.to(root, torch.float32)), min=1.0)
    return torch.tensor(float(mb["labels"].numel()), dtype=torch.float32,
                        device=root)


def make_train_step(model: LM, opt_cfg: OptConfig, micro_batches: int = 1,
                    compress: Optional[str] = None, topk_frac: float = 0.01,
                    grad_shard_specs: Optional[Dict] = None,
                    grad_sync_dtype: Optional[str] = None):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "lr",
    "grad_norm"}, and for an MoE config "aux", the whole batch's Switch
    aux loss (on a mesh the one assembled from the shards' statistics),
    float32 scalars on the model's device). `state` must be
    `make_train_state(model)`'s (with "err" from
    `compression.init_error_state` when `compress` is 'topk' or 'int8');
    it is laid out for the mesh the step runs on (`lay_out_state`),
    updated in place and returned. On a mesh (`use_mesh`) the batch is
    split over its data shards; `grad_shard_specs` ({name: P}) then
    shards the gradient accumulator (see the module docstring)."""
    if compress not in (None, "topk", "int8"):
        raise ValueError(f"compress must be None, 'topk' or 'int8', got "
                         f"{compress!r}")
    sync_dt = getattr(torch, grad_sync_dtype) if grad_sync_dtype else None

    def compress_grads(state: Dict, grads: Dict, root) -> Dict:
        fn = ((lambda g, e: comp.topk_compress(g, topk_frac, e))
              if compress == "topk" else comp.int8_roundtrip)
        errs = {n: e.full(root) if isinstance(e, Placed) else e
                for n, e in state["err"].items()}
        grads, new_err = _compress(fn, grads, errs,
                                   _reference_leaves(list(grads),
                                                     model.cfg.layout))
        load_train_state(state["err"], new_err)
        return grads

    def reads(params, names, entries, dev, copies, root):
        """Per leaf, the tensors a data shard's loss reads: an FSDP
        leaf's blocks that its gathers read (`_fsdp_sources`, the
        shard's root at mesh entry `root`), a placed leaf's blocks of its
        entries, a whole leaf itself where the shard is on the model's
        device, else its copy there (made once per step)."""
        whole = [n for n in names if not isinstance(params[n], Placed)]
        if dev != model.device and dev not in copies:
            copies[dev] = copy_params(((n, params[n]) for n in whole), dev,
                                      requires_grad=True)
        own = copies.get(dev) if dev != model.device else None
        return [[params[n].shards[i] for i in _fsdp_sources(
                    params[n], entries, root)] if is_fsdp(params[n])
                else [params[n].shards[e.index] for e in entries]
                if isinstance(params[n], Placed)
                else [params[n] if own is None else own[n]]
                for n in names]

    def shard_loss(rows, dev, den, copies, stats, entries, root):
        """(loss, loss_fn's metrics) of one data shard's rows on its
        device, under its 'model' `entries` (its root at mesh entry
        `root`); `stats` (a list, or None) collects its MoE
        statistics."""
        with use_entries(entries), use_shard(root):
            if dev == model.device:
                return model.loss_fn(rows, den, stats)
            return call_with(model, copies[dev], "loss_fn", rows, den, stats)

    def grads_of(loss, use):
        flat = [t for ts in use for t in ts]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss does not read (hymba's ssm_norm) has zero grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        out, i = [], 0
        for ts in use:
            out.append(grads[i:i + len(ts)])
            i += len(ts)
        return out

    def shard_grads(params, names, mb, shards, per, den, copies, root,
                    auxes, groups, roots):
        """Per data shard in mesh order, (loss on `root`, grads: per leaf
        the list of its `reads`' gradients); an MoE config appends the
        microbatch's aux (on `root`) to `auxes`. On more than one shard
        it runs every shard's forward first, then assembles that aux
        (the module docstring), which a shard's loss then leaves out."""
        moe_mesh = model.cfg.is_moe and len(shards) > 1
        fwd = []
        for j, (_, dev) in enumerate(shards):
            stats = [] if moe_mesh else None
            use = reads(params, names, groups[j] or (), dev, copies,
                        roots[j])
            loss, metrics = shard_loss(
                {k: x[j * per:(j + 1) * per].to(dev) for k, x in mb.items()},
                dev, None if den is None else den.to(dev), copies, stats,
                groups[j], roots[j])
            if not moe_mesh:       # one shard's graph alive at a time
                if model.cfg.is_moe:
                    auxes.append(metrics["aux"].detach().to(root))
                yield loss.detach().to(root), grads_of(loss, use)
                continue
            fwd.append((loss, use, dev, stats))
        if not moe_mesh:
            return
        tot = [(g.detach().to(root), c.to(root)) for g, c in fwd[0][3]]
        for *_, stats in fwd[1:]:
            tot = [(g0 + g.detach().to(root), c0 + c.to(root))
                   for (g0, c0), (g, c) in zip(tot, stats)]
        tokens = mb["labels"].numel()
        cfg, n_layers = model.cfg, model.cfg.n_layers
        auxes.append(moe.aux_from_stats(cfg, tot, tokens, n_layers))
        for loss, use, dev, stats in fwd:
            share = moe.aux_from_stats(
                cfg, [(g, c.to(dev)) for (g, _), (_, c) in zip(stats, tot)],
                tokens, n_layers)
            yield loss.detach().to(root), grads_of(loss + share, use)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        lay_out_state(model, state)
        params = state["params"]
        names = list(params)
        root = model.device
        mbs = (_split_microbatches(batch, micro_batches)
               if micro_batches > 1 else [batch])
        rows = next(iter(mbs[0].values())).shape[0]
        _, shards, groups, tiles = _layout(model, params, grad_shard_specs,
                                           rows)
        mesh = current_mesh()
        roots = [_shard_index(mesh, at) for at, _ in shards]
        per = rows // len(shards)
        moe_mesh = model.cfg.is_moe and len(shards) > 1
        acc, lsum, copies, auxes = None, None, {}, []
        for mb in mbs:
            # one shard takes loss_fn's own mean, the one-device step's
            den = _denominator(mb, root) if len(shards) > 1 else None
            part, mloss = None, None
            for loss, grads in shard_grads(params, names, mb, shards, per,
                                           den, copies, root, auxes,
                                           groups, roots):
                mloss = loss if mloss is None else mloss + loss
                if part is None:
                    part = [[g[t.part][t.sl].to(t.device, torch.float32,
                                                copy=not t.whole)
                             for t in tiles[n]]
                            for n, g in zip(names, grads)]
                else:
                    for ts, n, g in zip(part, names, grads):
                        for a, t in zip(ts, tiles[n]):
                            a.add_(g[t.part][t.sl].to(t.device))
                del grads
            if moe_mesh:           # the shards' losses are their CE
                mloss = mloss + auxes[-1]
            lsum = mloss if lsum is None else lsum + mloss
            if micro_batches == 1:
                acc = part
                continue
            if acc is None:
                acc = [[torch.zeros_like(t) for t in ts] for ts in part]
            for a_ts, ts in zip(acc, part):
                for a, t in zip(a_ts, ts):
                    a.add_(t.to(sync_dt) if sync_dt is not None else t)
            del part
        aux = sum(auxes[1:], auxes[0]) if auxes else None
        if micro_batches > 1:
            acc = [[a / micro_batches for a in ts] for ts in acc]
            lsum = lsum / micro_batches
            aux = None if aux is None else aux / micro_batches
        acc = dict(zip(names, acc))

        if compress:    # on the reference's whole leaves, on the root
            full = {}
            for n, p in params.items():
                if len(tiles[n]) == 1 and not isinstance(p, Placed):
                    full[n] = acc[n][0].to(root)
                    continue
                full[n] = torch.empty(p.shape, dtype=torch.float32,
                                      device=root)
                for a, t in zip(acc[n], tiles[n]):
                    full[n][t.gsl] = a.to(root)
            full = compress_grads(state, full, root)
            acc = {n: [full[n][t.gsl].to(t.device) for t in tiles[n]]
                   for n in names}

        # AdamW over the tiles, on their keepers: views of the leaves,
        # their moments and the gradient sums; then each updated block of
        # a placed leaf is copied to the other tensors that hold it
        opt = state["opt"]
        p_b, g_b, mu_b, nu_b = {}, {}, {}, {}
        with torch.no_grad():
            for n in names:
                leaf = params[n]
                for b, t in enumerate(tiles[n]):
                    key = n if len(tiles[n]) == 1 else f"{n}#{b}"
                    src = (leaf, opt["mu"][n], opt["nu"][n])
                    if isinstance(leaf, Placed):
                        src = tuple(x.shards[t.keep] for x in src)
                    p_b[key], mu_b[key], nu_b[key] = (x[t.sl] for x in src)
                    g_b[key] = acc[n][b].to(p_b[key].device)
        _, _, om = adamw_update(p_b, g_b, dict(mu=mu_b, nu=nu_b,
                                               step=opt["step"]), opt_cfg)
        with torch.no_grad():
            for n in names:
                if not isinstance(params[n], Placed):
                    continue
                trees = (params[n], opt["mu"][n], opt["nu"][n])
                for t in tiles[n]:
                    for j in _replicas(params[n], t.keep)[1:]:
                        for x in trees:
                            x.shards[j][t.sl].copy_(x.shards[t.keep][t.sl])
        metrics = dict(loss=lsum, **om)
        if aux is not None:
            metrics["aux"] = aux
        return state, metrics

    return train_step
