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

`grad_shard_specs` (ZeRO-sharded accumulation) waits for the port's
sharding (`models/sharding.py`).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.model import LM
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
    """Copy `values` (a tree of the state's shape: tensors or numpy
    arrays, such as `models/convert.from_reference_train_state`'s or a
    restored checkpoint) into the state's tensors, in place."""
    with torch.no_grad():
        def walk(dst, src):
            if isinstance(dst, dict):
                if set(dst) != set(src):
                    raise ValueError(f"keys differ: {sorted(set(dst) ^ set(src))}")
                for k in dst:
                    walk(dst[k], src[k])
            else:
                dst.copy_(torch.as_tensor(src))
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


def make_train_step(model: LM, opt_cfg: OptConfig, micro_batches: int = 1,
                    compress: Optional[str] = None, topk_frac: float = 0.01,
                    grad_sync_dtype: Optional[str] = None):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "lr",
    "grad_norm"}, float32 scalars on the model's device). `state` must be
    `make_train_state(model)`'s (with "err" from
    `compression.init_error_state` when `compress` is 'topk' or 'int8');
    it is updated in place and returned."""
    if compress not in (None, "topk", "int8"):
        raise ValueError(f"compress must be None, 'topk' or 'int8', got "
                         f"{compress!r}")
    sync_dt = getattr(torch, grad_sync_dtype) if grad_sync_dtype else None

    def grads_of(leaves: List[torch.Tensor], batch) -> Tuple[torch.Tensor,
                                                             List]:
        loss, _ = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not read (hymba's ssm_norm) has zero grad
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        names = list(params)
        leaves = [params[n] for n in names]
        if micro_batches > 1:
            gacc = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split_microbatches(batch, micro_batches):
                loss, grads = grads_of(leaves, mb)
                for a, g in zip(gacc, grads):
                    a.add_(g.to(sync_dt) if sync_dt is not None else g)
                lsum = lsum + loss
                del grads
            grads = [a / micro_batches for a in gacc]
            loss = lsum / micro_batches
        else:
            loss, grads = grads_of(leaves, batch)
        grads = dict(zip(names, grads))

        if compress:
            fn = ((lambda g, e: comp.topk_compress(g, topk_frac, e))
                  if compress == "topk" else comp.int8_roundtrip)
            grads, new_err = _compress(fn, grads, state["err"],
                                       _reference_leaves(names,
                                                         model.cfg.layout))
            with torch.no_grad():
                for n, e in new_err.items():
                    state["err"][n].copy_(e)

        _, _, om = adamw_update(params, grads, state["opt"], opt_cfg)
        return state, dict(loss=loss, **om)

    return train_step
