"""Per-row bitmap intersection test (LGRASS Alg. 5's "M_{lca,u} ∩
M_{lca,v} is not empty").

The port of `repro.kernels.bitmap_intersect.bitmap_intersect_any`: for
two (L, W) bitmaps of 32-bit words, out[r] = any_k (m1[r, k] & m2[r, k])
≠ 0, an (L,) bool. The words are carried as int32 bit patterns (a uint32
array viewed as int32: `np.ndarray.view(np.int32)`); only AND ≠ 0 is
asked, so the sign of the view does not matter.

  * `bitmap_intersect_any_cuda` launches the hand-written Hopper kernel
    in `csrc/bitmap_intersect.cu` (a thread per row for W < 32, else a
    warp per row with 16-byte loads where the rows allow) and counts its
    launches in `launches`;
  * `bitmap_intersect_any_plain` is the plain PyTorch version, the
    formula of `repro.kernels.ref.bitmap_intersect_any_ref`.

`kernels/ops.py` picks between them by the tensor's device. There is no
padding contract: any L works, L = 0 included (no launch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import oplib
# CUDA launches of the kernel since the last reset (kernels/ops.py).
launches = 0


def bitmap_intersect_any_plain(m1: torch.Tensor,
                               m2: torch.Tensor) -> torch.Tensor:
    """Plain version: (L,) bool, any nonzero word of m1 & m2 per row."""
    return (m1 & m2).ne(0).any(dim=1)


def bitmap_intersect_any_cuda(m1: torch.Tensor,
                              m2: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/bitmap_intersect.cu` on the current stream of the
    tensors' device. m1, m2: contiguous (L, W) int32 on one CUDA device."""
    global launches
    dev = m1.device
    for name, x in (("m1", m1), ("m2", m2)):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}")
        if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (L, W) int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if m1.shape != m2.shape:
        raise ValueError(f"shapes differ: {tuple(m1.shape)} vs "
                         f"{tuple(m2.shape)}")
    oplib.check_launchable("bitmap_intersect", m1, m2)
    l, w = m1.shape
    out = torch.empty((l,), dtype=torch.bool, device=dev)
    if l == 0:
        return out
    from repro_torch.kernels._build import library

    lib = library()
    vec4 = w % 4 == 0 and m1.data_ptr() % 16 == 0 and m2.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        err = lib.bitmap_intersect_launch(
            m1.data_ptr(), m2.data_ptr(), l, w, int(vec4), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitmap_intersect launch failed: CUDA error {err}")
    launches += 1
    return out
