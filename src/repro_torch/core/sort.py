"""Linear-time radix sort in PyTorch (LGRASS §3.3).

The port of `repro.core.sort`. Criticality keys are float32, so they are
mapped to u32 by the IEEE-754 order-preserving bit trick and sorted with
4 byte passes (an 8-pass variant sorts (hi, lo) u32 pairs).

Each pass is one stable counting-sort step: the digit of every element,
its stable rank within its digit bucket and the 256-bin histogram from
`kernels.ops.bucket_rank_hist` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors), the exclusive scan of the histogram, and
one scatter to the stable output position. That is the default engine on
every device.

u32 values are carried as int64 tensors holding the value (masked with
0xFFFFFFFF): PyTorch's uint32 lacks shifts, `~`, comparisons and scatter
on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

U32_MASK = 0xFFFFFFFF
UMAX = U32_MASK


def float32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map float32 -> u32 (held in int64).

    For x >= 0 this flips only the sign bit; for x < 0 all bits flip, so
    unsigned comparison == float comparison for any finite input.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & U32_MASK
    sign = bits >> 31
    return torch.where(sign == 1, ~bits & U32_MASK, bits | 0x80000000)


def _counting_pass(keys: torch.Tensor, perm: torch.Tensor,
                   shift: int) -> torch.Tensor:
    """One stable byte pass: reorder `perm` by byte `shift` of keys[perm]."""
    digits = ((keys[perm] >> shift) & 0xFF).to(torch.int32)
    rank, hist = ops.bucket_rank_hist(digits)
    hist = hist.to(torch.int64)
    offsets = torch.cumsum(hist, dim=0) - hist  # exclusive
    pos = offsets[digits.to(torch.int64)] + rank.to(torch.int64)
    out = torch.empty_like(perm)
    out[pos] = perm
    return out


def radix_argsort_u32(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of u32 keys (int64 tensor), (L,) int64,
    in 4 byte passes."""
    perm = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    for shift in (0, 8, 16, 24):
        perm = _counting_pass(keys, perm, shift)
    return perm


def radix_argsort_u64pair(hi: torch.Tensor,
                          lo: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of (hi, lo) u32 pairs — the paper's
    8-pass INT64 sort."""
    perm = torch.arange(hi.shape[0], dtype=torch.int64, device=hi.device)
    for shift in (0, 8, 16, 24):
        perm = _counting_pass(lo, perm, shift)
    for shift in (0, 8, 16, 24):
        perm = _counting_pass(hi, perm, shift)
    return perm


def sort_f32_desc_stable(keys: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Permutation sorting float32 keys descending; ties keep input order.

    This is the edge-criticality sort: (criticality desc, edge-id asc).
    valid: optional (L,) bool mask; invalid slots get key -inf, so they
    sort after every valid slot with a finite key.
    """
    if valid is not None:
        keys = torch.where(valid, keys, torch.full_like(keys, -torch.inf))
    k = float32_sort_key(keys)
    return radix_argsort_u32(~k & U32_MASK)  # not of monotone => desc


def bucket_ranks(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Stable rank of each element within its bucket (keys in
    [0, n_buckets)), (L,) int64: the position in the stable order minus
    the bucket's first position."""
    keys = keys.to(torch.int64)
    order = radix_argsort_u32(keys)
    counts = torch.bincount(keys, minlength=n_buckets)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(keys.shape[0], device=keys.device) \
        - starts[keys[order]]
    return rank


def block_view(x: torch.Tensor, chunk: int, fill) -> torch.Tensor:
    """Pad a (L,) tensor to a chunk multiple and reshape to
    (n_blocks, chunk); the ragged tail holds `fill`. L == 0 gives
    (0, chunk)."""
    m = x.shape[0]
    n_blocks = -(-m // chunk)
    pad = torch.full((n_blocks * chunk - m,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]).reshape(n_blocks, chunk)
