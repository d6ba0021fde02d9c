"""Linear-time radix sort in PyTorch (LGRASS §3.3).

The port of `repro.core.sort`. Criticality keys are float32, so they are
mapped to u32 by the IEEE-754 order-preserving bit trick and sorted with
4 byte passes (an 8-pass variant sorts (hi, lo) u32 pairs).

Both argsorts are `kernels.ops.radix_argsort_u32` / `_u64pair` on every
device: on a CUDA tensor the onesweep kernels of `csrc/radix_hist.cu`
(one histogram launch and one launch per byte, in one host call); on a
CPU tensor their plain version, stable counting passes of the per-byte
rank and histogram (`kernels/radix_hist.radix_argsort_plain`).

u32 values are carried as int64 tensors holding the value (masked with
0xFFFFFFFF): PyTorch's uint32 lacks shifts, `~`, comparisons and scatter
on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, radix_hist

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


def radix_argsort_u32(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of u32 keys (int64 tensor), (L,) int64,
    in 4 byte passes."""
    return ops.radix_argsort_u32(keys)


def radix_argsort_u64pair(hi: torch.Tensor,
                          lo: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of (hi, lo) u32 pairs — the paper's
    8-pass INT64 sort."""
    return ops.radix_argsort_u64pair(hi, lo)


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
    [0, n_buckets)), (L,) int32: the count of equal keys before it.

    Up to 256 buckets this is the rank output of one
    `ops.bucket_rank_hist` call (the rank entry of `csrc/radix_hist.cu`
    on a CUDA tensor, `bucket_rank_hist_plain` on a CPU one), as the
    reference's `_digit_ranks_and_hist` is the jnp twin of the Pallas
    kernel; above 256, the position in a stable radix argsort minus the
    bucket's first position."""
    if n_buckets <= radix_hist.NB:
        return ops.bucket_rank_hist(keys.to(torch.int32).contiguous())[0]
    keys = keys.to(torch.int64)
    order = radix_argsort_u32(keys)
    # each bucket's count, shape-static (bincount's length is the data's)
    counts = torch.zeros((n_buckets,), dtype=torch.int64,
                         device=keys.device).scatter_add_(
        0, keys, torch.ones_like(keys))
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(keys.shape[0], dtype=torch.int64,
                               device=keys.device) \
        - starts[keys[order]]
    return rank.to(torch.int32)


def block_view(x: torch.Tensor, chunk: int, fill) -> torch.Tensor:
    """Pad a (L,) tensor to a chunk multiple and reshape to
    (n_blocks, chunk); the ragged tail holds `fill`. L == 0 gives
    (0, chunk)."""
    m = x.shape[0]
    n_blocks = -(-m // chunk)
    pad = torch.full((n_blocks * chunk - m,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]).reshape(n_blocks, chunk)


def stable_group_sort(group_ids: torch.Tensor,
                      rank_perm: torch.Tensor) -> torch.Tensor:
    """Edges already permuted by criticality rank (`rank_perm`); stable-sort
    that order by u32 `group_ids` so groups are contiguous and
    criticality-ordered within each group. Returns the composed
    permutation (one radix argsort)."""
    g = group_ids[rank_perm].to(torch.int64) & U32_MASK
    return rank_perm[radix_argsort_u32(g)]
