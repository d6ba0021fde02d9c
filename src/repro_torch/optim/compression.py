"""Gradient compression with error feedback: the port of
`repro.optim.compression`.

Two schemes, each re-injecting its compression error next step:

  * top-k sparsification: keep the entries of g + err whose |value| is at
    least the k-th largest (k = max(1, ⌊n·frac⌋)), so ties at the
    threshold are all kept, as the reference's `>=` keeps them;
  * int8 row-wise quantisation: absmax per row of the leaf's first axis
    over 127 (at least 1e-12), values rounded half to even and clipped to
    ±127.

`compressed_psum` is the int8 all-reduce across the shards of one mesh
axis: one shared absmax scale, int8 values, an int32 sum, dequantised
once.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.models.sharding import Placed


def topk_compress(g: torch.Tensor, frac: float, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top `frac` of entries (by |value|) of g + err; the rest
    feeds err. Returns (sent in g's dtype, new err in float32)."""
    acc = g.to(torch.float32) + err
    flat = acc.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    sent = torch.where(torch.abs(acc) >= thresh, acc,
                       torch.zeros((), dtype=acc.dtype, device=acc.device))
    return sent.to(g.dtype), acc - sent


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise absmax int8. Returns (q (rows, cols) int8, scale (rows, 1))."""
    g32 = g.to(torch.float32)
    flat = g32.reshape(g32.shape[0], -1) if g32.dim() > 1 else g32[None, :]
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def int8_roundtrip(g: torch.Tensor, err: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g + err through int8 and back. Returns (sent in g's dtype, new err)."""
    acc = g.to(torch.float32) + err
    q, s = int8_quantize(acc)
    deq = int8_dequantize(q, s, acc.shape)
    return deq.to(g.dtype), acc - deq


def compressed_psum(contributions: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """The int8-compressed sum of the shards' `contributions` along one
    mesh axis, given in mesh order: the scale is the max over the shards
    of each one's absmax, over 127 (at least 1e-12 / 127); each shard's
    values are rounded half to even to int8 steps of it and clipped to
    ±127; the int32 sum (taken on the first shard's device, in mesh
    order) times the scale. Returns the float32 result once per shard,
    on that shard's device."""
    root = contributions[0].device
    g32 = [c.to(device=root, dtype=torch.float32) for c in contributions]
    gmax = torch.stack([torch.amax(torch.abs(g)) for g in g32]).amax()
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    qsum = torch.zeros(g32[0].shape, dtype=torch.int32, device=root)
    for g in g32:
        qsum += torch.clamp(torch.round(g / scale), -127, 127).to(
            torch.int32)
    out = qsum.to(torch.float32) * scale
    return [out.to(c.device) for c in contributions]


def init_error_state(params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Zero float32 error feedback for each parameter (a placed leaf's
    block for block)."""
    def zeros(p):
        if isinstance(p, Placed):
            return p.map(zeros)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {k: zeros(p) for k, p in params.items()}
