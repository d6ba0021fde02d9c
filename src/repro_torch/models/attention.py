"""GQA attention of the port: RoPE, causal / bidirectional / sliding
window masks, and the KV cache (full, or a ring of `window` slots).

The port of the GQA half of `repro.models.attention`. Layouts follow the
reference: wq (d, H, hd), wk and wv (d, Kv, hd), wo (H, hd, d);
activations (B, S, H, hd).

Caches
------
GQA full:    {k, v: (B, S_max, Kv, hd), pos: (S_max,) abs positions (-1 empty)}
GQA window:  the same arrays with S_max = window, written mod window (ring).

Full-sequence attention (`gqa_attention`, train and prefill) goes through
`kernels/ops.flash_attention`: on a CUDA tensor the hand-written kernel
of `csrc/flash_attention.cu`, on a CPU tensor its plain version. Both
compute the function of the reference's `_masked_softmax_attend` (its
`use_flash=False` path) and of its Pallas kernel (`use_flash=True`); the
port has one engine per device, as its sorts and its spmv have. Decode
(`gqa_decode`) is plain torch against every cache slot with a validity
mask, as in the reference, which runs no kernel there.

The caches are updated in place (`gqa_fill_cache`, `gqa_decode`): the
reference's functional updates would copy the whole cache every step.
MLA and the banded sliding-window path (`_banded_swa`) wait for their
slices of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, init_normal

NEG_INF = -1e9


def init_gqa(cfg: ArchConfig, dtype: torch.dtype,
             generator: Optional[torch.Generator],
             device=None) -> Dict[str, torch.Tensor]:
    """wq, wk, wv (std d^-0.5) and wo (std (H·hd)^-0.5), unfused: the
    reference's default (no `fused_qkv`). Empty on `device` without a
    generator."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    std = d ** -0.5
    return dict(
        wq=init_normal((d, h, hd), std, dtype, generator, device),
        wk=init_normal((d, kv, hd), std, dtype, generator, device),
        wv=init_normal((d, kv, hd), std, dtype, generator, device),
        wo=init_normal((h, hd, d), (h * hd) ** -0.5, dtype, generator,
                       device),
    )


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _qkv(params, x):
    return tuple(_proj(x, params[w]) for w in ("wq", "wk", "wv"))


def _out(params, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(out.dtype))


def gqa_attention(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Self-attention over full sequences (train / prefill). x: (B, S, d);
    positions: (B, S), the same row for every sequence (0..S-1)."""
    q, k, v = _qkv(params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pos = positions[0].to(torch.int32)
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               qpos=pos, kpos=pos)
    return _out(params, out)


def init_gqa_cache(cfg: ArchConfig, batch: int, max_len: int,
                   window: Optional[int], dtype: torch.dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    slots = min(window, max_len) if window else max_len
    hd = cfg.resolved_head_dim
    return dict(
        k=torch.zeros((batch, slots, cfg.n_kv_heads, hd), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, slots, cfg.n_kv_heads, hd), dtype=dtype,
                      device=device),
        pos=torch.full((slots,), -1, dtype=torch.int32, device=device),
    )


def gqa_fill_cache(params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: Dict,
                   window: Optional[int]) -> Dict:
    """Prefill: write K/V of a full prompt into the cache (the last
    `slots` positions of a ring), in place."""
    k = apply_rope(_proj(x, params["wk"]), positions, cfg.rope_theta)
    v = _proj(x, params["wv"])
    slots = cache["k"].shape[1]
    s = k.shape[1]
    if window:
        take = min(s, slots)
        pos = positions[0, -take:]
        idx = (pos % slots).long()
        cache["k"][:, idx] = k[:, -take:]
        cache["v"][:, idx] = v[:, -take:]
        cache["pos"][idx] = pos.to(torch.int32)
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:s] = positions[0].to(torch.int32)
    return cache


def gqa_decode(params: Dict, cfg: ArchConfig, x: torch.Tensor, pos: int,
               cache: Dict, window: Optional[int]
               ) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence. x: (B, 1, d); pos: its absolute position.
    Writes the token's K/V into the cache in place, then attends over
    every slot with the mask (slot filled) ∧ (pos' <= pos) [∧ window].
    Without a window, a position past the cache's end raises ValueError
    (the reference clamps the write and overwrites the last slot)."""
    slots = cache["k"].shape[1]
    if not window and not 0 <= pos < slots:
        raise ValueError(f"decode at position {pos} is past the end of a "
                         f"cache of max_len {slots}")
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(params, x)
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % slots if window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = pos
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]

    b, _, h, _ = q.shape
    n_kv = cfg.n_kv_heads
    g = h // n_kv
    # fp32 scores of the cache's dtype values (preferred_element_type=f32)
    qg = q.reshape(b, 1, n_kv, g, hd).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          kc.to(torch.float32)) * (hd ** -0.5)
    valid = (pc >= 0) & (pc <= pos)
    if window is not None:
        valid = valid & (pc > pos - window)
    scores = torch.where(valid, scores, torch.full((), NEG_INF,
                                                   device=scores.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(vc.dtype), vc)
    y = _out(params, out.reshape(b, 1, h, hd))
    return y, cache
