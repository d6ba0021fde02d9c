"""The training step: loss -> gradients -> AdamW, with microbatch
gradient accumulation and optional gradient compression with error
feedback. The port of `repro.train.train_step`.

A train state is a dict over one model's parameters:

    {"params": {name: the model's own float32 Parameter},
     "opt": {"mu": {name: float32}, "nu": {name: float32},
             "step": int32 scalar},
     ["err": {name: float32}]}          (with compression)

keyed by the port's parameter names (the reference's pytree paths). The
step runs eagerly: `torch.autograd.grad` of `LM.loss_fn`, then the AdamW
arithmetic of `optim/optimizer.py`, the parameters and moments updated in
place under `torch.no_grad()`, so the model sees the new weights.

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
its rows on its device: the model's own parameters where the shard is on
the model's device (shards that repeat a device share them), a copy of
them through `torch.func.functional_call` elsewhere. A shard's CE is its
sum over the microbatch's token count (Σ mask, at least 1, where there is
a mask), so the shards' losses add up to the whole microbatch's mean, as
the reference's jitted step computes it whatever the sharding, and so do
their gradients. The gradients are summed in float32 in mesh order (no
atomics: two runs are bit-equal); `grad_sync_dtype` rounds the sum, the
microbatch's gradient, as the reference's does, before it is added to the
accumulator.

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

`grad_shard_specs` ({name: P}, `models.sharding.param_specs`' layout),
on a mesh, makes the accumulator ZeRO-sharded: each data shard keeps
only its block of each leaf's gradient sum, along the spec's batch axes
(the spec resolved on the mesh and on the port's per-layer leaf), on its
device; the microbatches accumulate into those blocks, AdamW runs on the
blocks (views of the parameters and moments, so the update lands in the
whole leaves: the parameters are gathered back in place), and the
global norm is taken over them. Compression, where asked, runs on the
gathered sum, on the reference's leaves, before the update.
Without a mesh (or with one data shard) the step is the one-device step
above: one shard, the whole leaves, `loss_fn`'s own mean.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.ft.elastic import resolve_spec_for_mesh
from repro_torch.launch.mesh import batch_axes_for
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.models.sharding import (Placed, block_slices,
                                         current_mesh, keep_axes)
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizer import (OptConfig, adamw_update,
                                         init_opt_state)

_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def make_train_state(model: LM,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """The train state over `model`'s parameters, which must be float32
    (`LM(..., param_dtype=torch.float32)`); sets requires_grad on them.
    With `generator`, the weights are drawn anew from it first (the
    reference's `make_train_state(model, rng)`)."""
    if generator is not None:
        fresh = LM(model.cfg, generator=generator, device=model.device,
                   param_dtype=torch.float32)
        drawn = dict(fresh.named_parameters())
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(drawn[name])
        del fresh, drawn
    params = dict(model.named_parameters())
    for name, p in params.items():
        if p.dtype != torch.float32:
            raise ValueError(f"{name} is {p.dtype}: a train state needs "
                             f"float32 leaves (param_dtype=torch.float32)")
        p.requires_grad_(True)
    return dict(params=params, opt=init_opt_state(params))


def load_train_state(state: Dict, values: Dict) -> Dict:
    """Copy `values` (a tree of the state's shape: tensors, numpy arrays
    or Placed values, such as `models/convert.from_reference_train_state`'s,
    a restored checkpoint or `ft.elastic.remesh_state`'s) into the state's
    tensors, in place."""
    with torch.no_grad():
        def walk(dst, src):
            if isinstance(dst, dict):
                if set(dst) != set(src):
                    raise ValueError(f"keys differ: {sorted(set(dst) ^ set(src))}")
                for k in dst:
                    walk(dst[k], src[k])
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


class _LossOf(nn.Module):
    """`model.loss_fn` as a module call, for `functional_call` with a copy
    of the parameters on another device."""

    def __init__(self, model: LM):
        super().__init__()
        self.model = model

    def forward(self, batch, denominator, moe_stats=None):
        return self.model.loss_fn(batch, denominator, moe_stats)


def _canon(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _data_shards(mesh, rows: int) -> Tuple[Tuple[str, ...], List]:
    """The batch axes of `rows` on `mesh` and, per data shard in mesh
    order, its coordinates on them and its device (the first mesh entry
    there)."""
    axes = batch_axes_for(rows, mesh)
    axes = () if axes is None else ((axes,) if isinstance(axes, str)
                                    else tuple(axes))
    sizes = [mesh.shape[a] for a in axes]
    shards = []
    for k in range(int(np.prod(sizes, dtype=np.int64))):
        at = dict(zip(axes, (int(c) for c in np.unravel_index(k, sizes))))
        j = np.ravel_multi_index([at.get(a, 0) for a in mesh.axis_names],
                                 mesh.axis_sizes)
        shards.append((at, _canon(mesh.devices[int(j)])))
    return axes, shards


def _grad_blocks(params: Dict, specs: Optional[Dict], mesh, axes,
                 shards, root) -> Dict[str, List]:
    """Per leaf, the (slices, device) of each block of its gradient sum
    that the data shards keep: without specs the whole leaf on `root`;
    with them the blocks of the spec's batch axes, each on the first
    shard that holds it."""
    if specs is None:
        return {n: [((slice(None),) * p.dim(), root)]
                for n, p in params.items()}
    out = {}
    for n, p in params.items():
        zs = keep_axes(resolve_spec_for_mesh(specs[n], mesh), set(axes))
        seen, blocks = set(), []
        for at, dev in shards:
            sl = block_slices(p.shape, zs, mesh.shape, at)
            key = tuple((x.start, x.stop) for x in sl)
            if key not in seen:
                seen.add(key)
                blocks.append((sl, dev))
        out[n] = blocks
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
    it is updated in place and returned. On a mesh (`use_mesh`) the batch
    is split over its data shards; `grad_shard_specs` ({name: P}) then
    shards the gradient accumulator (see the module docstring)."""
    if compress not in (None, "topk", "int8"):
        raise ValueError(f"compress must be None, 'topk' or 'int8', got "
                         f"{compress!r}")
    sync_dt = getattr(torch, grad_sync_dtype) if grad_sync_dtype else None
    loss_of = _LossOf(model)

    def compress_grads(state: Dict, grads: Dict) -> Dict:
        fn = ((lambda g, e: comp.topk_compress(g, topk_frac, e))
              if compress == "topk" else comp.int8_roundtrip)
        grads, new_err = _compress(fn, grads, state["err"],
                                   _reference_leaves(list(grads),
                                                     model.cfg.layout))
        with torch.no_grad():
            for n, e in new_err.items():
                state["err"][n].copy_(e)
        return grads

    def shard_loss(names, leaves, rows, dev, den, copies, stats):
        """(loss, loss_fn's metrics, the leaves it reads) of one data
        shard's rows on its device; `stats` (a list, or None) collects its
        MoE statistics."""
        if dev == model.device:
            return (*model.loss_fn(rows, den, stats), leaves)
        if dev not in copies:
            copies[dev] = [p.detach().to(dev).requires_grad_(True)
                           for p in leaves]
        use = copies[dev]
        loss, metrics = torch.func.functional_call(
            loss_of, {"model." + n: t for n, t in zip(names, use)},
            (rows, den, stats))
        return loss, metrics, use

    def grads_of(loss, use):
        grads = torch.autograd.grad(loss, use, allow_unused=True)
        # a leaf the loss does not read (hymba's ssm_norm) has zero grad
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(use, grads)]

    def shard_grads(names, leaves, mb, shards, per, den, copies, root,
                    auxes):
        """Per data shard in mesh order, (loss on `root`, grads); an MoE
        config appends the microbatch's aux (on `root`) to `auxes`. On
        more than one shard it runs every shard's forward first, then
        assembles that aux (the module docstring), which a shard's loss
        then leaves out."""
        moe_mesh = model.cfg.is_moe and len(shards) > 1
        fwd = []
        for j, (_, dev) in enumerate(shards):
            stats = [] if moe_mesh else None
            loss, metrics, use = shard_loss(
                names, leaves,
                {k: x[j * per:(j + 1) * per].to(dev) for k, x in mb.items()},
                dev, None if den is None else den.to(dev), copies, stats)
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
        mesh = current_mesh()
        params = state["params"]
        names = list(params)
        leaves = [params[n] for n in names]
        root = model.device
        mbs = (_split_microbatches(batch, micro_batches)
               if micro_batches > 1 else [batch])
        rows = next(iter(mbs[0].values())).shape[0]
        axes, shards = (((), [({}, root)]) if mesh is None
                        else _data_shards(mesh, rows))
        blocks = _grad_blocks(params, grad_shard_specs if mesh else None,
                              mesh, axes, shards, root)
        per = rows // len(shards)
        moe_mesh = model.cfg.is_moe and len(shards) > 1
        acc, lsum, copies, auxes = None, None, {}, []
        for mb in mbs:
            # one shard takes loss_fn's own mean, the one-device step's
            den = _denominator(mb, root) if len(shards) > 1 else None
            part, mloss = None, None
            for loss, grads in shard_grads(names, leaves, mb, shards, per,
                                           den, copies, root, auxes):
                mloss = loss if mloss is None else mloss + loss
                if part is None:
                    part = [[g[sl].to(bdev, torch.float32,
                                      copy=len(blocks[n]) > 1)
                             for sl, bdev in blocks[n]]
                            for n, g in zip(names, grads)]
                else:
                    for tiles, n, g in zip(part, names, grads):
                        for t, (sl, bdev) in zip(tiles, blocks[n]):
                            t.add_(g[sl].to(bdev))
                del grads
            if moe_mesh:           # the shards' losses are their CE
                mloss = mloss + auxes[-1]
            lsum = mloss if lsum is None else lsum + mloss
            if micro_batches == 1:
                acc = part
                continue
            if acc is None:
                acc = [[torch.zeros_like(t) for t in tiles]
                       for tiles in part]
            for a_tiles, tiles in zip(acc, part):
                for a, t in zip(a_tiles, tiles):
                    a.add_(t.to(sync_dt) if sync_dt is not None else t)
            del part
        aux = sum(auxes[1:], auxes[0]) if auxes else None
        if micro_batches > 1:
            acc = [[a / micro_batches for a in tiles] for tiles in acc]
            lsum = lsum / micro_batches
            aux = None if aux is None else aux / micro_batches
        acc = dict(zip(names, acc))

        if compress:
            full = {}
            for n, p in params.items():
                if len(blocks[n]) == 1:
                    full[n] = acc[n][0].to(root)
                    continue
                full[n] = torch.empty(p.shape, dtype=torch.float32,
                                      device=root)
                for t, (sl, _) in zip(acc[n], blocks[n]):
                    full[n][sl] = t.to(root)
            full = compress_grads(state, full)
            acc = {n: [full[n][sl] for sl, _ in blocks[n]] for n in names}

        # AdamW over the blocks: views of the leaves, their moments and
        # (moved to the leaf's device) the gradient sums
        opt = state["opt"]
        p_b, g_b, mu_b, nu_b = {}, {}, {}, {}
        with torch.no_grad():
            for n in names:
                for b, (sl, _) in enumerate(blocks[n]):
                    key = n if len(blocks[n]) == 1 else f"{n}#{b}"
                    p_b[key] = params[n][sl]
                    mu_b[key] = opt["mu"][n][sl]
                    nu_b[key] = opt["nu"][n][sl]
                    g_b[key] = acc[n][b].to(root)
        _, _, om = adamw_update(p_b, g_b, dict(mu=mu_b, nu=nu_b,
                                               step=opt["step"]), opt_cfg)
        metrics = dict(loss=lsum, **om)
        if aux is not None:
            metrics["aux"] = aux
        return state, metrics

    return train_step
