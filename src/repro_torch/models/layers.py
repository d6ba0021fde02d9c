"""Shared layers of the port: norms, RoPE, MLPs, embeddings.

The port of `repro.models.layers`, function for function, on torch
tensors: each takes its weights as arguments, in the reference's layouts
(`wi` (d, f), `wo` (f, d), tables (vocab, d)), and casts them to the
activation's dtype at use as the reference does (a no-op for the port's
own parameters, which `models/model.py` keeps in that dtype already).
The reference's `ParamSet` becomes the `nn.Module` parameters of
`models/model.py`; `init_normal` draws its distributions.
`cross_entropy` is training's loss, `LM.loss_fn`'s.

Under tensor parallelism on 'model' (`models/sharding.Entries`), each
entry reads its blocks through `Entry.take` (of a placed model, views of
the blocks it holds; of whole leaves, the parts cut). `mlp`
runs each entry on its block of d_ff columns (wi, wg) and rows (wo) and
sums the partials (`sharding.model_sum`; below float32 each partial is
float32, `sharding.partial_product`, so the sum rounds once); the
embedding lookup writes each entry's vocab block's tokens and zeros
elsewhere, summed;
`lm_logit_blocks` gives each entry's block of the logits, and
`cross_entropy_parallel` the CE over those blocks: the logsumexp's max
and Σ exp reduced over the entries, the gold logit from the entry that
owns the label.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as sh


def init_normal(shape, std: float, dtype: torch.dtype,
                generator: Optional[torch.Generator],
                device=None) -> torch.Tensor:
    """N(0, std²) drawn in float32 on the generator's device, then cast:
    the reference's `layers.normal`, with torch's bits. Without a
    generator the tensor is left empty on `device`, for a state dict to
    fill."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return x.normal_(0.0, std, generator=generator).to(dtype)


# ------------------------- norms -------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, the result cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dt)


# ------------------------- RoPE -------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) — rotate pairs (d, d + D/2) in float32.
    positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)               # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------- MLP -------------------------
def init_mlp(d_model: int, d_ff: int, act: str, dtype: torch.dtype,
             generator: Optional[torch.Generator],
             device=None) -> Dict[str, torch.Tensor]:
    """wi (and wg for SwiGLU) with std d^-0.5, wo with std d_ff^-0.5."""
    w = {"wi": init_normal((d_model, d_ff), d_model ** -0.5, dtype,
                           generator, device)}
    if act == "swiglu":
        w["wg"] = init_normal((d_model, d_ff), d_model ** -0.5, dtype,
                              generator, device)
    w["wo"] = init_normal((d_ff, d_model), d_ff ** -0.5, dtype, generator,
                          device)
    return w


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        act: str, entries: Optional[sh.Entries] = None,
        d_ff: int = 0) -> torch.Tensor:
    """SwiGLU (silu(x wg) * x wi) or GELU (tanh approximation, which is
    `jax.nn.gelu`'s default), then wo. With `entries`, each entry on its
    block of the `d_ff` columns, the partials summed."""
    wg = params["wg"] if act == "swiglu" else None
    if entries is None:
        return _mlp(params["wi"], wg, params["wo"], x, act)
    parts = []
    for e, xe in zip(entries, sh.model_copy(x, entries, "mlp_in",
                                            wide=True)):
        sl = e.block(d_ff)
        parts.append(_mlp(e.take(params["wi"], 1, sl, d_ff),
                          None if wg is None else e.take(wg, 1, sl, d_ff),
                          e.take(params["wo"], 0, sl, d_ff), xe, act,
                          partial=True, dt=x.dtype))
    return sh.model_sum(parts, entries, "mlp_out", x.dtype)


def _in_product(x, w, dt):
    """x · w (d, f) in `dt`; x may be a float32 carrier of a `dt` value
    (`sharding.column_product`)."""
    if x.dtype != dt:
        return sh.column_product(x, w.to(dt))
    return torch.einsum("...d,df->...f", x, w.to(dt))


def _mlp(wi, wg, wo, x, act, partial=False, dt=None):
    dt = x.dtype if dt is None else dt
    h = _in_product(x, wi, dt)
    if act == "swiglu":
        g = _in_product(x, wg, dt)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    if partial and dt != torch.float32:
        return sh.partial_product(h, wo)
    return torch.einsum("...f,fd->...d", h, wo.to(dt))


# ------------------------- embeddings -------------------------
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype, entries: Optional[sh.Entries] = None,
                 vocab: int = 0) -> torch.Tensor:
    """The rows of `tokens`. With `entries`, each entry writes the tokens
    of its block of the `vocab` rows and zeros elsewhere, summed."""
    if entries is None:
        return table.to(dtype)[tokens]
    parts = []
    for e in entries:
        sl = e.block(vocab)
        local = tokens.to(e.device) - sl.start
        mine = (local >= 0) & (local < sl.stop - sl.start)
        rows = e.take(table, 0, sl, vocab).to(dtype)
        if rows.shape[0] == 0:
            parts.append(torch.zeros(tokens.shape + (table.shape[1],),
                                     dtype=dtype, device=e.device))
            continue
        got = rows[local.clamp(0, rows.shape[0] - 1)]
        parts.append(torch.where(mine[..., None], got, got.new_zeros(())))
    return sh.model_sum(parts, entries, "embed")


def lm_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x · tableᵀ: table is the embedding when tied, else the lm head."""
    return torch.einsum("...d,vd->...v", x, table.to(x.dtype))


def lm_logit_blocks(table: torch.Tensor, x: torch.Tensor,
                    entries: sh.Entries, vocab: int) -> List[torch.Tensor]:
    """Each entry's block of the `vocab` logits, on its device (x · the
    block's rows, with a float32 gradient of x in training,
    `sharding.column_product`)."""
    out = []
    for e, xe in zip(entries, sh.model_copy(x, entries, "logits_in",
                                            wide=True)):
        rows = e.take(table, 0, e.block(vocab), vocab)
        out.append(lm_logits(rows, xe) if xe.dtype == x.dtype else
                   sh.column_product(xe, rows.to(x.dtype).t()))
    return out


def act_dtype(dtype_name: str) -> torch.dtype:
    """The activation dtype of a config's `dtype` field."""
    return torch.bfloat16 if dtype_name == "bfloat16" else torch.float32


def rms_scale(dim: int, device=None) -> torch.Tensor:
    """A norm scale at its init value: ones in float32."""
    return torch.ones((dim,), dtype=torch.float32, device=device)


def _vocab_pad(logits: torch.Tensor, cols: slice,
               real_vocab: int) -> torch.Tensor:
    """float32 logits of the columns `cols` with -1e9 added (not set) on
    those past `real_vocab` (0: none)."""
    logits = logits.to(torch.float32)
    if real_vocab and real_vocab < cols.stop:
        # + 0 leaves the real columns as they are
        pad = torch.zeros((cols.stop - cols.start,), dtype=torch.float32,
                          device=logits.device)
        pad[max(real_vocab - cols.start, 0):] = -1e9
        logits = logits + pad
    return logits


def _mean_nll(nll: torch.Tensor, mask: Optional[torch.Tensor],
              denominator: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        mask = mask.to(device=nll.device, dtype=torch.float32)
        total = torch.sum(nll * mask)
        return total / (torch.clamp(torch.sum(mask), min=1.0)
                        if denominator is None else denominator)
    return torch.mean(nll) if denominator is None else (torch.sum(nll)
                                                        / denominator)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  real_vocab: int = 0,
                  denominator: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Mean CE in float32, the reference's `cross_entropy`: padded vocab
    columns (past `real_vocab`) get -1e9 added (not set), then logsumexp
    minus the gold logit (a gather); with `mask`, the masked mean over
    max(Σ mask, 1). With `denominator`, the (masked) sum over it instead:
    a data shard's part of the whole batch's mean."""
    logits = _vocab_pad(logits, slice(0, logits.shape[-1]), real_vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return _mean_nll(logz - gold, mask, denominator)


def cross_entropy_parallel(blocks: List[torch.Tensor], labels: torch.Tensor,
                           entries: sh.Entries, vocab: int,
                           mask: Optional[torch.Tensor] = None,
                           real_vocab: int = 0,
                           denominator: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`cross_entropy` over the entries' blocks of the `vocab` logits
    (`lm_logit_blocks`): -1e9 on the padded columns wherever they fall,
    the logsumexp's max and Σ exp(l − max) reduced over the entries, and
    the gold logit from the entry whose block holds the label (zeros
    from the others), summed. On the first entry's device."""
    padded, maxes = [], []
    for e, lg in zip(entries, blocks):
        lg = _vocab_pad(lg, e.block(vocab), real_vocab)
        padded.append(lg)
        maxes.append(lg.amax(-1) if lg.shape[-1] else torch.full(
            lg.shape[:-1], -torch.inf, device=lg.device))
    top = sh.model_max(maxes, entries, "ce_max")
    sums, golds = [], []
    for e, lg in zip(entries, padded):
        sl = e.block(vocab)
        sums.append(torch.exp(lg - top.to(lg.device)[..., None]).sum(-1))
        local = labels.to(device=lg.device, dtype=torch.int64) - sl.start
        mine = (local >= 0) & (local < sl.stop - sl.start)
        if lg.shape[-1] == 0:
            golds.append(torch.zeros(lg.shape[:-1], device=lg.device))
            continue
        got = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])
        golds.append(torch.where(mine, got[..., 0], got.new_zeros(())))
    logz = top + torch.log(sh.model_sum(sums, entries, "ce_sumexp"))
    nll = logz - sh.model_sum(golds, entries, "ce_gold")
    return _mean_nll(nll, mask, denominator)
