"""Meshes for training: the port of `repro.launch.mesh`'s host half.

`make_host_mesh` is a 1-D 'data' mesh over the visible CUDA devices, or
`n` shards of one named device (a card carries 4 shards of `cuda:0`, the
CPU tests 8 of `cpu`), as `core.distributed.batch_mesh` builds them.
`batch_axes_for` picks the mesh axes a global batch is split over.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.distributed import Mesh, batch_mesh


def make_host_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """A ('data',) mesh: the distinct CUDA devices (all by default; raises
    without a card), or `n` shards of `device` where one is given."""
    return batch_mesh(n, axis="data", device=device)


def batch_axes_for(global_batch: int, mesh: Mesh):
    """The largest prefix of ('pod', 'data') on `mesh` whose product
    divides the batch: None, one axis name, or a tuple of them."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    chosen = []
    prod = 1
    for a in axes:
        if global_batch % (prod * mesh.shape[a]) == 0:
            chosen.append(a)
            prod *= mesh.shape[a]
        else:
            break
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]
