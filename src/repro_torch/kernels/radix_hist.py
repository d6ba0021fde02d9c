"""Per-byte stable rank and 256-bin histogram (one counting-sort pass).

The port of `repro.kernels.radix_hist.bucket_rank_hist`. For a stream of
int32 digits in [0, 256) it returns, for each element, its stable rank
among the elements with the same digit, and the 256-bin histogram. Four
passes of it, composed with an exclusive scan of the histogram and one
scatter (`core/sort.py`), give a stable LSD argsort of u32 keys.

Two executions of the one function live here:

  * `bucket_rank_hist_cuda` launches the hand-written Hopper kernel in
    `csrc/radix_hist.cu` (tile counts, in-kernel scan across tiles,
    warp-match stable ranking) and counts its launches in `launches`;
  * `bucket_rank_hist_plain` is the plain PyTorch version: the chunked
    one-hot scan of `repro.kernels.ref.bucket_rank_hist_ref`, a running
    per-bucket carry from chunk to chunk.

`kernels/ops.py` picks between them by the tensor's device. Unlike the
Pallas kernel there is no padding contract: any M works, M = 0 included.
"""
from __future__ import annotations

import torch

NB = 256
# CUDA launches of the kernel since the last reset (kernels/ops.py).
launches = 0


def bucket_rank_hist_plain(digits: torch.Tensor, chunk: int = 1024):
    """Plain version: (rank (M,) int32, hist (256,) int32) from a chunked
    one-hot scan; any device, used for CPU tensors and as the check."""
    m = digits.shape[0]
    dev = digits.device
    rank = torch.empty((m,), dtype=torch.int32, device=dev)
    carry = torch.zeros((NB,), dtype=torch.int64, device=dev)
    buckets = torch.arange(NB, device=dev)
    for s in range(0, m, chunk):
        ck = digits[s:s + chunk].to(torch.int64)
        onehot = (ck[:, None] == buckets[None, :]).to(torch.int64)
        within = torch.cumsum(onehot, dim=0) - onehot
        rank[s:s + chunk] = (carry[ck] + (within * onehot).sum(dim=1)).to(
            torch.int32)
        carry += onehot.sum(dim=0)
    return rank, carry.to(torch.int32)


def bucket_rank_hist_cuda(digits: torch.Tensor):
    """Launch `csrc/radix_hist.cu` on the current stream of the digits'
    device. digits: contiguous (M,) int32 CUDA tensor in [0, 256)."""
    global launches
    if digits.device.type != "cuda":
        raise ValueError("bucket_rank_hist_cuda needs a CUDA tensor")
    if digits.dtype != torch.int32 or digits.dim() != 1:
        raise ValueError(f"digits must be (M,) int32, got {digits.dtype} "
                         f"{tuple(digits.shape)}")
    if not digits.is_contiguous():
        raise ValueError("digits must be contiguous")
    from repro_torch.kernels._build import library

    lib = library()
    m = digits.shape[0]
    tile = lib.radix_hist_tile_elems()
    n_tiles = -(-m // tile)
    dev = digits.device
    rank = torch.empty((m,), dtype=torch.int32, device=dev)
    hist = torch.empty((NB,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(n_tiles, 1), NB), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.radix_hist_launch(
            digits.data_ptr(), m, rank.data_ptr(), hist.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"radix_hist launch failed: CUDA error {err}")
    launches += 1
    return rank, hist
