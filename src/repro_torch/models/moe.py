"""Mixture-of-Experts FFN of the port, with capacity-bounded index dispatch.

The port of `repro.models.moe`, function for function:

  * router: logits x · router in the activation dtype, then float32;
    padded experts (`real_n_experts`) at −1e9; softmax; the top k gates
    per token, renormalised (a 1e-9 floor). The top k are the first k of
    a stable descending sort, so equal gates keep the lower expert first
    on every device, as `jax.lax.top_k` does (`torch.topk` promises no
    order among ties);
  * dispatch: each (token, choice) pair's rank within its expert, per
    sequence, from ONE `core.sort.bucket_ranks` call over all rows with
    keys row·E + expert (the rank entry of `csrc/radix_hist.cu` on the
    card, kernel table row 1, where B·E ≤ 256; `bucket_ranks` takes its
    argsort path above that).
    Pairs at or past the capacity C = `capacity(S, k, E, cf)` are dropped;
  * compute: the kept tokens gathered into (B, E, C, d), the experts'
    three products as batched matmuls, SwiGLU or GELU (tanh), each slot
    scaled by its gate;
  * combine: each token's k contributions gathered from their (expert,
    slot) pairs (a dropped pair gives zero) and summed from zero in the
    activation dtype in ascending expert order, the order in which the
    reference's scatter-add visits the flattened (e, c) slots. No atomics,
    so a bf16 result is the same from run to run on the card.

The Switch-style load-balance loss is computed only where the caller asks
for it (`with_aux`): serving never reads it, and skipping it changes no
output. With `stats`, the layer hands out its router statistics in the
loss's place: `gsum`, the (E,) float32 sum of the gates over the rows
and positions it saw (it keeps its gradient), and `count`, the (E,)
float32 top-k counts (no gradient). The loss couples every row of the
batch through them (`aux_from_stats`); dispatch and capacity are per
sequence, so a data shard of the rows routes, keeps and drops exactly
as the whole batch does, and only these two sums cross the shards. A
model holds each layer's weights as an `MoE` module, whose call is
`moe_ffn`, so a caller can hook a layer's inputs.

Tensor parallelism on 'model' (`entries`): the experts split over the
entries (each its block of E / tp, its wi, wg, wo, which a placed
model's entry holds: `Entry.take` reads a view of it). The layer routes
once per data shard, on the shard's root device: the router, softmax,
top k, the dispatch ranks (one rank call), capacity and the slot tables,
and the aux or the statistics from that one routing. Each entry then
gathers the tokens of its experts' slots, runs its experts, and adds the
kept pairs of its own experts in ascending expert order, in float32;
the entries' partials are summed in float32 in mesh order and rounded
once (`sharding.model_sum`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sort import bucket_ranks
from repro_torch.models import sharding as sh
from repro_torch.models.layers import init_normal


def init_moe(cfg: ArchConfig, dtype: torch.dtype,
             generator: Optional[torch.Generator],
             device=None) -> Dict[str, torch.Tensor]:
    """router (d, E) and the experts wi, wg (E, d, f) with std d^-0.5, wo
    (E, f, d) with std f^-0.5 (wg for SwiGLU only)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(shape, std):
        return init_normal(shape, std, dtype, generator, device)

    p = {"router": w((d, e), d ** -0.5), "wi": w((e, d, f), d ** -0.5)}
    if cfg.act == "swiglu":
        p["wg"] = w((e, d, f), d ** -0.5)
    p["wo"] = w((e, f, d), f ** -0.5)
    return p


def capacity(t: int, k: int, e: int, cf: float) -> int:
    """Slots per expert for t tokens: the reference's `_capacity`."""
    c = int(t * k * cf / e) + 1
    return max(4, (c + 3) // 4 * 4)


def route(params: Dict, cfg: ArchConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (all gates (B, S, E) float32, the top k's
    renormalised gates (B, S, k) float32, their experts (B, S, k) int64)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.einsum("bsd,de->bse", x,
                          params["router"].to(x.dtype)).to(torch.float32)
    if cfg.real_n_experts and cfg.real_n_experts < e:
        pad = torch.arange(e, device=x.device) >= cfg.real_n_experts
        logits = logits.masked_fill(pad, -1e9)
    gates_all = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return gates_all, vals, idx


def dispatch_ranks(expert_idx: torch.Tensor, e: int) -> torch.Tensor:
    """(B, S, k) experts -> (B, S·k) int32: each pair's stable rank among
    its row's pairs with the same expert (the reference vmaps
    `bucket_ranks` over rows), from one rank call over all rows with keys
    row·E + expert."""
    b = expert_idx.shape[0]
    flat_e = expert_idx.reshape(b, -1)
    rows = torch.arange(b, device=flat_e.device)[:, None] * e
    return bucket_ranks((flat_e + rows).reshape(-1), b * e).reshape(b, -1)


def router_stats(gates_all: torch.Tensor, expert_idx: torch.Tensor,
                 e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, E) gates, (B, S, k) experts -> (gsum (E,) float32 with its
    gradient, count (E,) float32 top-k counts, exact, with none)."""
    gsum = gates_all.sum(dim=(0, 1))
    flat = expert_idx.reshape(-1)
    count = torch.zeros((e,), dtype=torch.float32,
                        device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=flat.device))
    return gsum, count


def aux_from_stats(cfg: ArchConfig, stats, tokens: int,
                   n_layers: int) -> torch.Tensor:
    """The load-balance loss of a whole batch of `tokens` = B·S positions
    from its MoE layers' (gsum, count), summed over the data shards: per
    layer coef·E·Σ_e density·frac with density = gsum / (B·S) and frac =
    count / (B·S·k), summed over the layers in order, over `n_layers`,
    as `LM.run_layers` averages the layers' losses."""
    e, k = cfg.n_experts, cfg.moe_top_k
    aux = None
    for gsum, count in stats:
        a = cfg.router_aux_coef * e * torch.sum(
            (gsum / tokens) * (count / (tokens * k)))
        aux = a if aux is None else aux + a
    return aux / max(n_layers, 1)


def _experts(wi, wg, wo, act, xe, gates, dt):
    """The experts' products on their slots: xe (B, E, C, d), gates
    (B, E, C) -> (B, E, C, d), each slot scaled by its gate."""
    h = torch.einsum("becd,edf->becf", xe, wi.to(dt))
    if act == "swiglu":
        g = torch.einsum("becd,edf->becf", xe, wg.to(dt))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("becf,efd->becd", h, wo.to(dt))
    return ye * gates[..., None].to(dt)


def _combine(ye: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
             x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each token's k contributions, summed from zero in `dtype` in the
    order of `slot` (B, S, k): rows of ye (B, n, d), where the spare row
    n (a zero row) stands for a dropped pair."""
    b, n, d = ye.shape
    ye_flat = torch.cat([ye, ye.new_zeros((b, 1, d))], dim=1)
    y = torch.zeros(x.shape, dtype=dtype, device=x.device)
    for j in range(slot.shape[-1]):
        y = y + ye_flat[rows, slot[..., j]]
    return y


def moe_ffn(params: Dict, cfg: ArchConfig, x: torch.Tensor,
            with_aux: bool = True, stats: bool = False,
            entries: Optional[sh.Entries] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, the load-balance loss as
    a float32 scalar, or None without `with_aux`). With `stats`, the
    second item is the layer's `router_stats` (gsum, count) instead of
    the loss. With `entries`, the experts split over them (the module
    docstring)."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = x.device
    gates_all, gate_vals, expert_idx = route(params, cfg, x)

    aux = None
    if stats:
        aux = router_stats(gates_all, expert_idx, e)
    elif with_aux:   # Switch-style
        # adds of one constant: the same sum in any order, and no sync
        density = gates_all.mean(dim=(0, 1))
        frac = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
            0, expert_idx.reshape(-1), torch.full(
                (b * s * k,), 1.0 / (b * s * k), dtype=torch.float32,
                device=dev))
        aux = cfg.router_aux_coef * e * torch.sum(density * frac)

    cap = capacity(s, k, e, cfg.capacity_factor)
    pos = dispatch_ranks(expert_idx, e).to(torch.int64)     # (B, S*k)
    flat_e = expert_idx.reshape(b, s * k)
    # a pair's flat (e, c) slot; a dropped pair's is the spare column E·C,
    # written by many pairs and cut off: the kept slots are written once
    dump = e * cap
    slot = torch.where(pos < cap, flat_e * cap + pos, dump)
    token_ids = torch.arange(s, device=dev).repeat_interleave(k).expand(
        b, s * k)
    tok_of_slot = torch.full((b, dump + 1), s, dtype=torch.int64,
                             device=dev).scatter_(1, slot, token_ids)
    gate_of_slot = torch.zeros((b, dump + 1), dtype=torch.float32,
                               device=dev).scatter_(
        1, slot, gate_vals.reshape(b, s * k))
    tok_of_slot, gate_of_slot = tok_of_slot[:, :dump], gate_of_slot[:, :dump]

    rows = torch.arange(b, device=dev)[:, None]
    # the ordered combine visits each token's pairs in ascending expert
    # order; a dropped pair's slot E·C reads a zero row
    by_expert = torch.argsort(expert_idx, dim=-1)            # (B, S, k)
    slot = torch.gather(slot.reshape(b, s, k), 2, by_expert)
    wg = params["wg"] if cfg.act == "swiglu" else None
    # unsharded: one part, every expert; else each entry's experts
    parts = [(slice(0, e), x, lambda w: w)] if entries is None else [
        (ent.block(e), xj, lambda w, ent=ent: ent.take(w, 0, ent.block(e), e))
        for ent, xj in zip(entries, sh.model_copy(x, entries, "moe_in"))]
    ys = []
    for ex, xj, take in parts:
        n_e, here = ex.stop - ex.start, xj.device
        cols = slice(ex.start * cap, ex.stop * cap)
        # empty slots read row S, a zero row
        xpad = torch.cat([xj, xj.new_zeros((b, 1, d))], dim=1)
        xe = xpad[rows.to(here), tok_of_slot[:, cols].to(here)]
        ye = _experts(take(params["wi"]), None if wg is None else take(wg),
                      take(params["wo"]), cfg.act,
                      xe.reshape(b, n_e, cap, d),
                      gate_of_slot[:, cols].reshape(b, n_e, cap).to(here), dt)
        # the pairs of these experts: their slots within the block; the
        # others (and dropped pairs) read its zero row
        local = slot.to(here) - cols.start
        local = torch.where((local >= 0) & (local < n_e * cap), local,
                            n_e * cap)
        # an entry's partial in float32, so that model_sum rounds once
        ys.append(_combine(ye.reshape(b, n_e * cap, d), local,
                           rows.to(here), xj,
                           dt if entries is None else torch.float32))
    return (ys[0] if entries is None
            else sh.model_sum(ys, entries, "moe_combine", dt)), aux


class MoE(nn.ParameterDict):
    """An MoE layer's weights (`init_moe`; no gradient unless a train
    state sets one) as a module whose call is `moe_ffn(self, cfg, x,
    with_aux, stats, entries)` (or of `params` in its place)."""

    __call__ = nn.Module.__call__   # a ParameterDict refuses calls

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__({k: nn.Parameter(t, requires_grad=False)
                          for k, t in tensors.items()})

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                with_aux: bool = True, stats: bool = False,
                entries: Optional[sh.Entries] = None,
                params: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`moe_ffn` on the layer's weights, or on `params` (the same
        weights as a data shard reads them: gathered FSDP leaves)."""
        return moe_ffn(self if params is None else params, cfg, x, with_aux,
                       stats, entries)
