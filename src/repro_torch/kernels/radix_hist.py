"""Stable radix argsort of u32 keys, and the per-byte rank and histogram.

The port of `repro.kernels.radix_hist.bucket_rank_hist` and of the
argsort built from four passes of it (`repro.kernels.ops.radix_argsort_u32`).
Keys are u32 values carried in int64 tensors (`core/sort.py`).

Two executions of each function live here:

  * `radix_argsort_cuda` launches the hand-written Hopper kernels in
    `csrc/radix_hist.cu` (onesweep: one histogram launch, then one pass
    per byte with a decoupled look-back), all in one C call, and
    `bucket_rank_hist_cuda` the same histogram launch plus one pass in
    rank mode; each counts its calls in `launches`. Both go through
    operators (`kernels/oplib.py`): `radix_argsort` and
    `bucket_rank_hist`, whose fakes give a meta tensor the outputs'
    shapes;
  * `radix_argsort_plain` composes stable counting passes of
    `bucket_rank_hist_plain`, the chunked one-hot scan of
    `repro.kernels.ref.bucket_rank_hist_ref` with a running per-bucket
    carry from chunk to chunk.

`kernels/ops.py` picks between them by the tensor's device. Unlike the
Pallas kernel there is no padding contract: any M works, M = 0 included.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import oplib

NB = 256
# a count holds 30 bits in the kernel's look-back words
MAX_M = 1 << 30
# wrapper calls that launched the CUDA kernels since the last reset
# (kernels/ops.py); one per argsort and one per rank call
launches = 0


def bucket_rank_hist_plain(digits: torch.Tensor, chunk: int = 1024):
    """Plain version: (rank (M,) int32, hist (256,) int32) from a chunked
    one-hot scan; any device, used for CPU tensors and as the check."""
    m = digits.shape[0]
    dev = digits.device
    rank = torch.empty((m,), dtype=torch.int32, device=dev)
    carry = torch.zeros((NB,), dtype=torch.int64, device=dev)
    buckets = torch.arange(NB, dtype=torch.int64, device=dev)
    for s in range(0, m, chunk):
        ck = digits[s:s + chunk].to(torch.int64)
        onehot = (ck[:, None] == buckets[None, :]).to(torch.int64)
        within = torch.cumsum(onehot, dim=0) - onehot
        rank[s:s + chunk] = (carry[ck] + (within * onehot).sum(dim=1)).to(
            torch.int32)
        carry += onehot.sum(dim=0)
    return rank, carry.to(torch.int32)


def _counting_pass(keys: torch.Tensor, perm: torch.Tensor,
                   shift: int) -> torch.Tensor:
    """One stable byte pass: reorder `perm` by byte `shift` of keys[perm]."""
    digits = ((keys[perm] >> shift) & 0xFF).to(torch.int32)
    rank, hist = bucket_rank_hist_plain(digits)
    hist = hist.to(torch.int64)
    offsets = torch.cumsum(hist, dim=0) - hist  # exclusive
    pos = offsets[digits.to(torch.int64)] + rank.to(torch.int64)
    out = torch.empty_like(perm)
    out[pos] = perm
    return out


def radix_argsort_plain(keys: torch.Tensor,
                        hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: stable ascending argsort, (M,) int64, of the u32
    keys (int64 tensor) in 4 byte passes, or, given `hi`, of the
    (hi, keys) pairs in 8 (keys' bytes first)."""
    perm = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    for word in (keys,) if hi is None else (keys, hi):
        for shift in (0, 8, 16, 24):
            perm = _counting_pass(word, perm, shift)
    return perm


def _on(dev: torch.device):
    """A context that makes `dev` the runtime's current device, where the
    C side launches; nothing to enter when it already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _check_1d(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not oplib.on_card_route(x):
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype != dtype or x.dim() != 1:
        raise ValueError(f"{what} must be (M,) {dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.shape[0] >= MAX_M:
        raise ValueError(f"{what}: M = {x.shape[0]} is not below 2^30")


def radix_argsort_cuda(keys: torch.Tensor,
                       hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`csrc/radix_hist.cu`'s argsort on the current stream, through its
    operator (`torch.ops.repro_torch.radix_argsort`): one C call (a
    memset, the histogram launch, 4 or 8 pass launches) and one scratch
    buffer. keys (and hi): contiguous (M,) int64 CUDA tensors holding u32
    values; only the low 32 bits are read. A meta tensor gets the
    operator's fake."""
    _check_1d(keys, torch.int64, "radix_argsort_cuda keys")
    if hi is not None:
        _check_1d(hi, torch.int64, "radix_argsort_cuda hi")
        if hi.shape != keys.shape or hi.device != keys.device:
            raise ValueError("hi and keys must match in shape and device")
    return ARGSORT_OP(keys, hi)


def _argsort_launch(keys: torch.Tensor,
                    hi: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    oplib.check_launchable("radix_argsort", keys, hi)
    m, dev = keys.shape[0], keys.device
    perm = torch.empty((m,), dtype=torch.int64, device=dev)
    if m == 0:
        return perm
    from repro_torch.kernels._build import library

    lib = library()
    n_passes = 4 if hi is None else 8
    scratch = torch.empty((lib.radix_scratch_bytes(m, n_passes),),
                          dtype=torch.uint8, device=dev)
    with _on(dev):
        err = lib.radix_argsort_launch(
            keys.data_ptr(), None if hi is None else hi.data_ptr(), m,
            n_passes, perm.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"radix argsort launch failed: CUDA error {err}")
    launches += 1
    return perm


def _argsort_fake(keys: torch.Tensor,
                  hi: Optional[torch.Tensor]) -> torch.Tensor:
    return keys.new_empty((keys.shape[0],), dtype=torch.int64)


def bucket_rank_hist_cuda(digits: torch.Tensor):
    """The rank entry on the current stream, through its operator
    (`torch.ops.repro_torch.bucket_rank_hist`): the histogram launch and
    one pass in rank mode. digits: contiguous (M,) int32 CUDA tensor in
    [0, 256). Returns (rank (M,) int32, hist (256,) int32); hist is a view
    of the call's scratch buffer. A meta tensor gets the operator's
    fake."""
    _check_1d(digits, torch.int32, "bucket_rank_hist_cuda digits")
    return RANK_OP(digits)


def _rank_launch(digits: torch.Tensor):
    global launches
    oplib.check_launchable("bucket_rank_hist", digits)
    m, dev = digits.shape[0], digits.device
    rank = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return rank, torch.zeros((NB,), dtype=torch.int32, device=dev)
    from repro_torch.kernels._build import library

    lib = library()
    scratch = torch.empty((lib.radix_scratch_bytes(m, 1) // 4,),
                          dtype=torch.int32, device=dev)
    with _on(dev):
        err = lib.radix_rank_launch(
            digits.data_ptr(), m, rank.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"radix rank launch failed: CUDA error {err}")
    launches += 1
    return rank, scratch[:NB]


def _rank_fake(digits: torch.Tensor):
    return (digits.new_empty((digits.shape[0],)),
            digits.new_empty((NB,)))


ARGSORT_OP = oplib.define("radix_argsort(Tensor keys, Tensor? hi) -> Tensor",
                          _argsort_launch, _argsort_fake)
RANK_OP = oplib.define(
    "bucket_rank_hist(Tensor digits) -> (Tensor, Tensor)", _rank_launch,
    _rank_fake)
