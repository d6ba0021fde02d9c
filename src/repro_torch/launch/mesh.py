"""Meshes: the port of `repro.launch.mesh`.

`make_host_mesh` is a 1-D 'data' mesh over the visible CUDA devices, or
`n` shards of one named device (a card carries 4 shards of `cuda:0`, the
CPU tests 8 of `cpu`), as `core.distributed.batch_mesh` builds them.
`batch_axes_for` picks the mesh axes a global batch is split over, and
`data_shards` the data shards of its rows (coordinates and device). A
shard on another device than the model's runs a method of the model on
a copy of its parameters there (`copy_params`, `call_with`).

`make_production_mesh` is the reference's production cell laid over
H100s: (16, 16) on ('data', 'model'), 256 cards ("h100x256"), or
(2, 16, 16) on ('pod', 'data', 'model'), 512 cards ("h100x512"), with
`TP_SIZE` = 16 on 'model', so `ArchConfig.padded_for_mesh(TP_SIZE)` and
the `% 16` rules of `launch/specs.py` pad and shard cell for cell as the
reference's do. It sizes and never runs: every entry is the meta device
(`Mesh` allows repeats), for the dry-run (`launch/dryrun.py`), which
traces one entry's program on meta tensors. Entries are row-major, and
a node holds `NODE_SIZE` consecutive ones: an axis whose entries lie in
one node is costed at the NVLink rate, any other at the rate across
nodes (`axis_bandwidth`).

The hardware constants are an NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
limit, from NVIDIA's data sheet, except `HBM_BYTES`, the `total_memory`
that the card reports (`torch.cuda.get_device_properties(0)`, read on
an NVIDIA H100 80GB HBM3 with a 700.00 W limit by `chip_smoke.py`).
Importing this module loads no kernel: `chip_smoke.py` reads the rates
here before it imports the rest of the package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TP_SIZE = 16  # 'model' axis extent on both production meshes
NODE_SIZE = 8  # cards of one node, joined by NVLink

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, data sheet
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s per direction, within a node of 8
CROSS_NODE_BW = 50e9          # B/s per card per direction, across nodes
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3, 700.00 W limit (chip_smoke.py's dryrun phase prints it)
HBM_BYTES = 85_017_493_504
DEVICE_NAME = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0

PRODUCTION_MESHES = {False: ("h100x256", (16, 16), ("data", "model")),
                     True: ("h100x512", (2, 16, 16),
                            ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production cell as a sizing-only mesh: 256 (or, multi_pod,
    512) entries, each the meta device. It sizes and never runs."""
    from repro_torch.core.distributed import Mesh

    _, shape, axes = PRODUCTION_MESHES[multi_pod]
    return Mesh((torch.device("meta"),) * int(np.prod(shape)), axes, shape)


def mesh_name(multi_pod: bool) -> str:
    return PRODUCTION_MESHES[multi_pod][0]


def make_host_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """A ('data',) mesh: the distinct CUDA devices (all by default; raises
    without a card), or `n` shards of `device` where one is given."""
    from repro_torch.core.distributed import batch_mesh

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


def canon_device(dev) -> torch.device:
    """`dev` with a CUDA device's index filled in (the current one)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def data_shards(mesh: Mesh, rows: int
                ) -> Tuple[Tuple[str, ...], List[Tuple[Dict[str, int],
                                                       torch.device]]]:
    """The batch axes of `rows` rows on `mesh` (`batch_axes_for`) and, per
    data shard in mesh order, its coordinates on them and its device (the
    first mesh entry there): one shard at {} where no axis divides."""
    axes = batch_axes_for(rows, mesh)
    axes = () if axes is None else ((axes,) if isinstance(axes, str)
                                    else tuple(axes))
    sizes = [mesh.shape[a] for a in axes]
    shards = []
    for k in range(int(np.prod(sizes, dtype=np.int64))):
        at = dict(zip(axes, (int(c) for c in np.unravel_index(k, sizes))))
        j = np.ravel_multi_index([at.get(a, 0) for a in mesh.axis_names],
                                 mesh.axis_sizes)
        shards.append((at, canon_device(mesh.devices[int(j)])))
    return axes, shards


def copy_params(named, dev, requires_grad: bool = False
                ) -> Dict[str, torch.Tensor]:
    """{name: a copy of the tensor on `dev`} of (name, tensor) pairs, such
    as a model's `named_parameters()`, detached, requiring grad or not."""
    return {n: p.detach().to(dev).requires_grad_(requires_grad)
            for n, p in named}


class _Method(torch.nn.Module):
    """A method of `module` as a module call, for `functional_call`."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, name: str, *args):
        return getattr(self.module, name)(*args)


def call_with(module: torch.nn.Module, params: Dict[str, torch.Tensor],
              name: str, *args):
    """`module.<name>(*args)` with `params` ({parameter name: tensor}, a
    `copy_params`) in place of its parameters
    (`torch.func.functional_call`)."""
    return torch.func.functional_call(
        _Method(module), {"module." + n: t for n, t in params.items()},
        (name, *args))


def axis_bandwidth(mesh: Mesh, axes: Sequence[str]) -> float:
    """B/s per card for traffic along `axes`: NVLink where the entries
    that differ only on those axes lie in one node, else the rate
    across nodes."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    strides, step = {}, 1
    for a in reversed(mesh.axis_names):
        strides[a] = step
        step *= sizes[a]
    span = 1 + sum((sizes[a] - 1) * strides[a] for a in axes)
    return NVLINK_BW if span <= NODE_SIZE else CROSS_NODE_BW
