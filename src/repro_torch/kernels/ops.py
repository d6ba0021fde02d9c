"""Public wrappers of the port's kernels: the path follows the tensor.

A CUDA tensor goes to the hand-written kernel, and a failed build or
launch raises; a CPU tensor goes to the kernel's plain PyTorch version.
Nothing else decides the path: not whether a card is present, and there
is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import radix_hist, tree_dist

_KERNELS = {"radix_hist": radix_hist, "tree_dist": tree_dist}


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


def launch_counts() -> dict:
    """CUDA launches of each kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
