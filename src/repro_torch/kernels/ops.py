"""Public wrappers of the port's kernels: the path follows the tensor.

A CUDA tensor goes to the hand-written kernel, and a failed build or
launch raises; a CPU tensor goes to the kernel's plain PyTorch version.
Nothing else decides the path: not whether a card is present, and there
is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bitmap_intersect, radix_hist, spmv, tree_dist

# counter name -> (module, attribute holding its CUDA launches)
_COUNTERS = {
    "radix_hist": (radix_hist, "launches"),
    "tree_dist": (tree_dist, "launches"),
    "laplacian_spmv": (spmv, "launches"),
    "arc_sum": (spmv, "arc_sum_launches"),
    "bitmap_intersect": (bitmap_intersect, "launches"),
}


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"no kernel path for device {x.device}")


def bucket_rank_hist(digits: torch.Tensor):
    """digits: (M,) int32 in [0, 256). Returns (rank_in_bucket (M,)
    int32, hist (256,) int32)."""
    if _route(digits) == "cuda":
        return radix_hist.bucket_rank_hist_cuda(digits)
    return radix_hist.bucket_rank_hist_plain(digits)


def tree_dist_pairs(up: torch.Tensor, depth: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """up: (LOG, n) int32 lifting table; depth: (n,) int32; a, b: (M,)
    node ids. Returns (M,) int32 tree hop distances."""
    if _route(up) == "cuda":
        return tree_dist.tree_dist_pairs_cuda(
            up.contiguous(), depth.to(torch.int32).contiguous(),
            a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous())
    return tree_dist.tree_dist_pairs_plain(up, depth, a, b)


def laplacian_operator(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       n: int, csr: Optional[spmv.ArcCSR] = None
                       ) -> spmv.LaplacianOperator:
    """L of the edge list (u, v, w) on n nodes, prepared once: a callable
    y = L x for (n, P) float32 x, with `.lift(val)` (Bᵀ val) and
    `.degree()`. On a CUDA device each product is one kernel launch on
    `csr`, the edge list's arc CSR (`core.spectral_probe.build_arc_csr`),
    which is then required; on the CPU `csr` is not used."""
    if _route(w) == "cuda":
        if csr is None:
            raise ValueError("a CUDA Laplacian operator needs the edge "
                             "list's arc CSR")
        return spmv.LaplacianOperator(u, v, w, n, csr)
    return spmv.LaplacianOperator(u, v, w, n, None)


def laplacian_spmv_edges(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                         x: torch.Tensor,
                         csr: Optional[spmv.ArcCSR] = None) -> torch.Tensor:
    """y = L x for one (n, P) float32 block x; w == 0.0 marks padding or
    masked slots, which contribute nothing. `csr` as in
    `laplacian_operator`."""
    return laplacian_operator(u, v, w, x.shape[0], csr)(x)


def bitmap_intersect_any(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """m1, m2: (L, W) int32 bit patterns of uint32 bitmaps. Returns (L,)
    bool: whether each row's AND is nonzero."""
    if _route(m1) == "cuda":
        return bitmap_intersect.bitmap_intersect_any_cuda(
            m1.contiguous(), m2.contiguous())
    return bitmap_intersect.bitmap_intersect_any_plain(m1, m2)


def launch_counts() -> dict:
    """CUDA launches of each kernel since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
