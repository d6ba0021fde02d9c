"""Plain PyTorch oracles of the port's kernels, under the names of
`repro.kernels.ref`. Each is the plain version kept beside its kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bitmap_intersect import \
    bitmap_intersect_any_plain as bitmap_intersect_any_ref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.radix_hist import \
    bucket_rank_hist_plain as bucket_rank_hist_ref
from repro_torch.kernels.spmv import \
    laplacian_spmv_plain as laplacian_spmv_ref
from repro_torch.kernels.tree_dist import \
    tree_dist_pairs_plain as tree_dist_pairs_ref


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q/k/v: (BH, S, d); qpos/kpos: (S,) with -1 = padding — the
    reference oracle's layout, one head per leading index."""
    return flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                 qpos, kpos, causal, window)[:, :, 0]


__all__ = ["bitmap_intersect_any_ref", "bucket_rank_hist_ref",
           "flash_attention_ref", "laplacian_spmv_ref",
           "tree_dist_pairs_ref"]
