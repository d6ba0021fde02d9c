"""Public wrappers of the port's kernels: the path follows the tensor.

A CUDA tensor goes to the hand-written kernel, and a failed build or
launch raises; a CPU tensor goes to the kernel's plain PyTorch version.
Nothing else decides the path: not whether a card is present, and there
is no fallback from one to the other. A meta tensor takes the card's
route: the kernels registered as operators (`kernels/oplib.py`: the
flash forward and backward, the rank entry, the radix argsort and MARK)
answer it with their fakes, which is how the dry-run traces the card's
program without one; the others raise at their launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bitmap_intersect
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import phase1, radix_hist, spmv, tree_dist

# counter name -> (module, attribute holding its CUDA launches: a count, or
# a dict of counts by route that sum to the kernel's)
_COUNTERS = {
    "radix_hist": (radix_hist, "launches"),
    "tree_dist": (tree_dist, "launches"),
    "mark": (phase1, "mark_launches"),
    "rec": (phase1, "rec_launches"),
    "laplacian_spmv": (spmv, "launches"),
    "arc_sum": (spmv, "arc_sum_launches"),
    "bitmap_intersect": (bitmap_intersect, "launches"),
    "flash_attention": (fa, "launches"),
    "flash_attention_bwd": (fa, "bwd_launches"),
}


def _route(x: torch.Tensor) -> str:
    if x.device.type == "meta":
        return "cuda"
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"no kernel path for device {x.device}")


def bucket_rank_hist(digits: torch.Tensor):
    """digits: (M,) int32 in [0, 256). Returns (rank_in_bucket (M,)
    int32, hist (256,) int32)."""
    if _route(digits) == "cuda":
        return radix_hist.bucket_rank_hist_cuda(digits)
    return radix_hist.bucket_rank_hist_plain(digits)


def radix_argsort_u32(keys: torch.Tensor) -> torch.Tensor:
    """keys: (M,) int64 holding u32 values. Returns the stable ascending
    argsort, (M,) int64."""
    if _route(keys) == "cuda":
        return radix_hist.radix_argsort_cuda(
            keys.to(torch.int64).contiguous())
    return radix_hist.radix_argsort_plain(keys)


def radix_argsort_u64pair(hi: torch.Tensor, lo: torch.Tensor
                          ) -> torch.Tensor:
    """hi, lo: (M,) int64 holding u32 values. Returns the stable ascending
    argsort of the (hi, lo) pairs, (M,) int64."""
    if _route(lo) == "cuda":
        return radix_hist.radix_argsort_cuda(
            lo.to(torch.int64).contiguous(),
            hi.to(torch.int64).contiguous())
    return radix_hist.radix_argsort_plain(lo, hi)


def tree_dist_pairs(up: torch.Tensor, depth: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """up: (LOG, n) int32 lifting table; depth: (n,) int32; a, b: (M,)
    node ids. Returns (M,) int32 tree hop distances."""
    if _route(up) == "cuda":
        return tree_dist.tree_dist_pairs_cuda(
            up.contiguous(), depth.to(torch.int32).contiguous(),
            a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous())
    return tree_dist.tree_dist_pairs_plain(up, depth, a, b)


def mark(t, su, sv, sbeta, layout, k_cap: int, chunk: int, euler=None):
    """Phase 1 (MARK) over the sorted slots: t the LiftingTables, su, sv,
    sbeta (L,) the sorted endpoints and radii, layout the GroupLayout;
    distances by the Euler tables `euler`, or by the lifting climb when
    it is None. Returns (accept (L,) bool per sorted slot,
    group_overflow (L,) bool per dense group). `chunk` is the plain
    loop's block size; the kernel's decisions do not depend on it."""
    if _route(su) == "cuda":
        return phase1.mark_cuda(t, su, sv, sbeta, layout, k_cap, euler)
    return phase1.mark_plain(t, su, sv, sbeta, layout, k_cap, chunk, euler)


def recover(t, u, v, beta, offtree, crossing, order, phase1_accept,
            group_of_edge, dirty0, budget: int, b_cap: int, chunk: int = 32,
            euler=None):
    """The recovery replay (REC) over all edges in `order`; arguments as
    `core.recovery._recover_scan`'s, with the engine as for `mark`.
    Returns (accepted (L,) bool, n_accepted int). `chunk` is the plain
    loop's block size."""
    if _route(u) == "cuda":
        return phase1.recover_cuda(t, u, v, beta, offtree, crossing, order,
                                   phase1_accept, group_of_edge, dirty0,
                                   budget, b_cap, euler)
    return phase1.recover_plain(t, u, v, beta, offtree, crossing, order,
                                phase1_accept, group_of_edge, dirty0, budget,
                                b_cap, chunk, euler)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, Kv, d), query head h reading kv
    head h // (H / Kv). qpos (Sq,) / kpos (Sk,) default to 0..S-1; -1
    marks padding. Returns (B, Sq, H, d) in q's dtype. On a CUDA tensor
    the output carries the kernel's gradient (`fa.FlashAttention`); on a
    CPU tensor autograd differentiates the plain version."""
    if qpos is None:
        qpos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    if kpos is None:
        kpos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    if _route(q) == "cuda":
        return fa.FlashAttention.apply(q, k, v, qpos, kpos, causal, window)
    return fa.flash_attention_plain(q, k, v, qpos, kpos, causal, window)


def _total(count) -> int:
    return sum(count.values()) if isinstance(count, dict) else count


def launch_counts() -> dict:
    """CUDA launches of each kernel since the last reset."""
    return {name: _total(getattr(mod, attr))
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        count = getattr(mod, attr)
        setattr(mod, attr, dict.fromkeys(count, 0)
                if isinstance(count, dict) else 0)
