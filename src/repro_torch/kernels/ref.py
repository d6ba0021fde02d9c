"""Plain PyTorch oracles of the port's kernels, under the names of
`repro.kernels.ref`. Each is the plain version kept beside its kernel."""
from __future__ import annotations

from repro_torch.kernels.bitmap_intersect import \
    bitmap_intersect_any_plain as bitmap_intersect_any_ref
from repro_torch.kernels.radix_hist import \
    bucket_rank_hist_plain as bucket_rank_hist_ref
from repro_torch.kernels.spmv import \
    laplacian_spmv_plain as laplacian_spmv_ref
from repro_torch.kernels.tree_dist import \
    tree_dist_pairs_plain as tree_dist_pairs_ref

__all__ = ["bitmap_intersect_any_ref", "bucket_rank_hist_ref",
           "laplacian_spmv_ref", "tree_dist_pairs_ref"]
