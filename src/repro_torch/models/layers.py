"""Shared layers of the port: norms, RoPE, MLPs, embeddings.

The port of `repro.models.layers`, function for function, on torch
tensors: each takes its weights as arguments, in the reference's layouts
(`wi` (d, f), `wo` (f, d), tables (vocab, d)), and casts them to the
activation's dtype at use as the reference does (a no-op for the port's
own parameters, which `models/model.py` keeps in that dtype already).
The reference's `ParamSet` becomes the `nn.Module` parameters of
`models/model.py`; `init_normal` draws its distributions.
`cross_entropy` is training's loss, `LM.loss_fn`'s.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


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
        act: str) -> torch.Tensor:
    """SwiGLU (silu(x wg) * x wi) or GELU (tanh approximation, which is
    `jax.nn.gelu`'s default), then wo."""
    dt = x.dtype
    h = torch.einsum("...d,df->...f", x, params["wi"].to(dt))
    if act == "swiglu":
        g = torch.einsum("...d,df->...f", x, params["wg"].to(dt))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("...f,fd->...d", h, params["wo"].to(dt))


# ------------------------- embeddings -------------------------
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return table.to(dtype)[tokens]


def lm_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x · tableᵀ: table is the embedding when tied, else the lm head."""
    return torch.einsum("...d,vd->...v", x, table.to(x.dtype))


def act_dtype(dtype_name: str) -> torch.dtype:
    """The activation dtype of a config's `dtype` field."""
    return torch.bfloat16 if dtype_name == "bfloat16" else torch.float32


def rms_scale(dim: int, device=None) -> torch.Tensor:
    """A norm scale at its init value: ones in float32."""
    return torch.ones((dim,), dtype=torch.float32, device=device)


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
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    if real_vocab and real_vocab < v:
        # + 0 leaves the real columns as they are
        pad = torch.zeros((v,), dtype=torch.float32, device=logits.device)
        pad[real_vocab:] = -1e9
        logits = logits + pad
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        total = torch.sum(nll * mask)
        return total / (torch.clamp(torch.sum(mask), min=1.0)
                        if denominator is None else denominator)
    return torch.mean(nll) if denominator is None else (torch.sum(nll)
                                                        / denominator)
