"""Laplacian spmv y = L x over an edge list, as an ordered CSR row sum.

The port of `repro.kernels.spmv.laplacian_spmv`, the inner loop of the
solver-free quality tier (`core/spectral_probe.py`): for an edge list
(u, v, w) and an (n, P) float32 block x,

    y = L x = Σ_e w_e (e_u − e_v)(e_u − e_v)ᵀ x.

Two executions of the one function live here:

  * the hand-written Hopper kernels in `csrc/spmv.cu` run on a CSR of
    arcs built once per graph (`ArcCSR`, built by
    `core.spectral_probe.build_arc_csr`): `spmv_csr_cuda` sums
    each (node, column) over the node's arcs in order, one thread each,
    and `arc_sum_cuda` does the same for a per-edge value (the probe
    lift Bᵀ s and the weighted degree). Their launches are counted in
    `launches` and `arc_sum_launches`;
  * `laplacian_spmv_plain` and `arc_sum_plain` are the plain PyTorch
    versions: the reference's formula, two `index_add_` scatters.

The arcs of node a are its u-arcs in edge order, then its v-arcs in edge
order: a stable sort of [u; v] by tail. That is the order in which the
two scatters of the plain version add to row a, and each arc's term
equals the scatter's term exactly, so on the CPU's sequential
`index_add_` the kernels' sums are equal bit for bit. (`index_add_` on
CUDA adds with float atomics, in no fixed order.)

`kernels/ops.py` picks between the two by the tensor's device; any n, m
and P work, m = 0 and isolated nodes included (they give exact zeros).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# CUDA launches of the spmv kernel and of the arc-sum kernel since the
# last reset (kernels/ops.py).
launches = 0
arc_sum_launches = 0


def laplacian_spmv_plain(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain version: c = w ⊙ (x[u] − x[v]), then +c at u and −c at v."""
    c = w.to(x.dtype)[:, None] * (x[u] - x[v])
    return torch.zeros_like(x).index_add_(0, u, c).index_add_(0, v, -c)


def arc_sum_plain(u: torch.Tensor, v: torch.Tensor, val: torch.Tensor,
                  n: int, negate_v: bool) -> torch.Tensor:
    """Plain version of the per-edge scatter: val[e] added at u[e], and
    at v[e] subtracted (`negate_v`, the lift Bᵀ val) or added (the
    degree). val: (m,) or (m, P); returns (n,) or (n, P)."""
    out = torch.zeros((n,) + tuple(val.shape[1:]), dtype=val.dtype,
                      device=val.device)
    return out.index_add_(0, u, val).index_add_(0, v,
                                                -val if negate_v else val)


class ArcCSR(NamedTuple):
    """The 2m arcs of an edge list, stably sorted by tail."""
    rowptr: torch.Tensor  # (n + 1,) int32 — node a's arcs: [rowptr[a], rowptr[a+1])
    arc: torch.Tensor     # (2m,) int32 — arc index: e for u-arcs, m + e for v-arcs
    other: torch.Tensor   # (2m,) int32 — the arc's head
    w_arc: torch.Tensor   # (2m,) float32 — the edge's weight
    n: int
    m: int


def _check_block(csr: ArcCSR, x: torch.Tensor, rows: int, name: str):
    dev = csr.rowptr.device
    if dev.type != "cuda" or x.device != dev:
        raise ValueError(f"{name} must be on the CSR's CUDA device {dev}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, P) float32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spmv_csr_cuda(csr: ArcCSR, x: torch.Tensor) -> torch.Tensor:
    """Launch the spmv kernel of `csrc/spmv.cu` on the current stream.
    x: contiguous (n, P) float32 on the CSR's CUDA device."""
    global launches
    _check_block(csr, x, csr.n, "x")
    from repro_torch.kernels._build import library

    lib = library()
    p = x.shape[1]
    y = torch.empty_like(x)
    dev = x.device
    with torch.cuda.device(dev):
        err = lib.spmv_csr_launch(
            csr.rowptr.data_ptr(), csr.other.data_ptr(),
            csr.w_arc.data_ptr(), x.data_ptr(), csr.n, p, y.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_csr launch failed: CUDA error {err}")
    launches += 1
    return y


def arc_sum_cuda(csr: ArcCSR, val: torch.Tensor,
                 negate_v: bool) -> torch.Tensor:
    """Launch the arc-sum kernel of `csrc/spmv.cu` on the current stream:
    the CSR-ordered counterpart of `arc_sum_plain`. val: contiguous (m,)
    or (m, P) float32 on the CSR's CUDA device."""
    global arc_sum_launches
    block = val[:, None] if val.dim() == 1 else val
    _check_block(csr, block, csr.m, "val")
    from repro_torch.kernels._build import library

    lib = library()
    p = block.shape[1]
    y = torch.empty((csr.n, p), dtype=torch.float32, device=val.device)
    dev = val.device
    with torch.cuda.device(dev):
        err = lib.arc_sum_launch(
            csr.rowptr.data_ptr(), csr.arc.data_ptr(), csr.m,
            block.data_ptr(), csr.n, p, int(negate_v), y.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"arc_sum launch failed: CUDA error {err}")
    arc_sum_launches += 1
    return y[:, 0] if val.dim() == 1 else y


class LaplacianOperator:
    """L of one edge list, prepared once for many products.

    Given the edge list's arc CSR, every product, lift and degree is one
    launch of a `csrc/spmv.cu` kernel; with `csr=None`, each is its plain
    version. `kernels/ops.laplacian_operator` decides by the tensors'
    device."""

    def __init__(self, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 n: int, csr: Optional[ArcCSR]):
        self.u, self.v = u.to(torch.int64), v.to(torch.int64)
        self.w = w.to(torch.float32)
        self.n = int(n)
        self.csr = csr

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = L x for x: (n, P) float32."""
        if self.csr is None:
            return laplacian_spmv_plain(self.u, self.v, self.w, x)
        return spmv_csr_cuda(self.csr, x.contiguous())

    def lift(self, val: torch.Tensor) -> torch.Tensor:
        """Bᵀ val: val[e] added at u[e], subtracted at v[e]; (m, P) in,
        (n, P) out."""
        if self.csr is None:
            return arc_sum_plain(self.u, self.v, val, self.n, True)
        return arc_sum_cuda(self.csr, val.contiguous(), True)

    def degree(self) -> torch.Tensor:
        """(n,) float32 weighted degrees."""
        if self.csr is None:
            return arc_sum_plain(self.u, self.v, self.w, self.n, False)
        return arc_sum_cuda(self.csr, self.w.contiguous(), False)
