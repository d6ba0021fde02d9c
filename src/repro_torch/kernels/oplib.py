"""The kernels of the model and phase-1 paths as torch operators.

Each one is an operator of the `repro_torch` library
(`torch.ops.repro_torch.<name>`) with two implementations:

  * CUDA: the wrapper's ctypes launch (`kernels/_build.py`), which a
    real CUDA tensor reaches: it launches the kernel or raises;
  * the fake (`torch.library.register_fake`, which is also the Meta
    kernel): the kernel's outputs, in shape, dtype and stride, and
    nothing else allocated. A meta tensor reaches it (the dry-run,
    `launch/dryrun.py`), and so does a tensor of a `FakeTensorMode`.

A CPU tensor never reaches a kernel's operator: `kernels/ops.py` hands
it to the kernel's plain version, so autograd on the CPU is unchanged.
The mesh's 'model' reductions (`models/sharding.py`) are operators of
the same library with a CPU implementation too: they are collectives,
not kernels, and one function on every device. No fake
stands in for a kernel that failed: the CUDA implementation raises.

The operators are defined with `torch.library.Library`'s `define` and
`impl` rather than `torch.library.custom_op`, which adds Python work to
every call; the decode path calls the rank entry once per MoE layer per
token. `check_launchable` guards each ctypes launch: a fake or meta
tensor there raises, since its `data_ptr()` is not device memory.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cuda_impl: Callable, fake_impl: Callable,
           cpu_impl: Optional[Callable] = None):
    """Define the operator `schema` ("name(args) -> outs"), its CUDA
    implementation and its fake (and, for an operator that is not a
    kernel, such as the mesh's 'model' reductions, its CPU one); returns
    its default overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda_impl, "CUDA")
    if cpu_impl is not None:
        LIB.impl(name, cpu_impl, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_impl, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def on_card_route(x: torch.Tensor) -> bool:
    """Whether x takes a kernel's card route: a CUDA tensor (the kernel)
    or a meta one (its operator's fake)."""
    return x.device.type in ("cuda", "meta")


def check_launchable(what: str, *tensors) -> None:
    """Raise unless every tensor given (None skipped) is a real CUDA
    tensor: a fake or meta tensor must never reach a ctypes launch."""
    from torch._subclasses.fake_tensor import FakeTensor

    for x in tensors:
        if x is None:
            continue
        if isinstance(x, FakeTensor) or x.is_meta:
            raise RuntimeError(f"{what}: a fake or meta tensor reached the "
                               f"kernel launch; it has no device memory")
        if x.device.type != "cuda":
            raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
