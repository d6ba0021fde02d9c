"""Tree hop distances of query pairs by a binary-lifting climb.

The port of `repro.kernels.tree_dist.tree_dist_pairs`: for M pairs
(a, b) and a (LOG, n) int32 lifting table, depth[a] + depth[b] −
2·depth[lca(a, b)]. It is the distance engine of every cover table
(`core/marking.ball_pair_table`) under `use_tree_kernel=True`.

  * `tree_dist_pairs_cuda` launches the hand-written Hopper kernel in
    `csrc/tree_dist.cu` (one thread per pair, plain gathers from the
    L2-resident table) and counts its launches in `launches`;
  * `tree_dist_pairs_plain` is the plain PyTorch version: the pipeline's
    own `lca.tree_distance`, as `repro.kernels.ref.tree_dist_pairs_ref`
    makes it.

`kernels/ops.py` picks between them by the tensor's device; any M works.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import oplib
# CUDA launches of the kernel since the last reset (kernels/ops.py).
launches = 0


def tree_dist_pairs_plain(up: torch.Tensor, depth: torch.Tensor,
                          a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: `lca.tree_distance` on the same tables, (M,) int32."""
    from repro_torch.core.lca import LiftingTables, tree_distance

    return tree_distance(LiftingTables(up=up, depth=depth), a.long(),
                         b.long()).to(torch.int32)


def tree_dist_pairs_cuda(up: torch.Tensor, depth: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/tree_dist.cu` on the current stream of the tensors'
    device. up: (LOG, n), depth: (n,), a, b: (M,), all contiguous int32
    on one CUDA device; node ids must lie in [0, n)."""
    global launches
    dev = up.device
    for name, x in (("up", up), ("depth", depth), ("a", a), ("b", b)):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}")
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    log, n = up.shape
    if depth.shape != (n,) or a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"bad shapes up{tuple(up.shape)} "
                         f"depth{tuple(depth.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    oplib.check_launchable("tree_dist", up, depth, a, b)
    from repro_torch.kernels._build import library

    lib = library()
    m = a.shape[0]
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tree_dist_launch(
            up.data_ptr(), depth.data_ptr(), log, n, a.data_ptr(),
            b.data_ptr(), m, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_dist launch failed: CUDA error {err}")
    launches += 1
    return out
