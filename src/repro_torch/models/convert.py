"""Carry the JAX package's LM weights across to the port.

`reference_state_dict(cfg, params)` turns the params pytree of
`repro.models.model.LM.init` (nested dicts of arrays; numpy arrays, or
anything `np.asarray` reads) into the state dict of
`repro_torch.models.model.LM`:

  * the `scan` layout's stacked layers (a leading layer axis on every
    leaf) are unstacked into `layers.<i>.*`; the `unroll` layout's list
    is taken as it is;
  * each leaf is stored in the dtype the reference reads it in
    (`leaf_dtype`). The reference keeps float32 params and casts each
    where it is used: matmul weights (MoE's router and its (E, d, f) /
    (E, f, d) experts, the audio frontend's `frontend.proj` among them),
    the embedding and the SSM's conv_w,
    conv_b and D to the activation dtype (`.astype(dt)`), which the port
    does once here, computing the same thing at half the memory in bf16
    (7.6 GB rather than 15.3 GB for phi3-mini-3.8b); the norm scales
    (`*norm`), A_log and dt_bias to float32, so they stay float32 (in
    bf16 a rounded A_log or dt_bias would change softplus and exp);
  * fused weights (`wqkv`, `wig`, from the reference's `fused_qkv`
    optimisation) are refused: the port has the unfused layout only.

`from_reference(cfg, params, device)` builds the port's `LM` from them.
The tests use this, not the port's own init, for parity with the
reference: the port's init draws the same distributions from a
`torch.Generator`, whose bits differ from `jax.random`'s.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import act_dtype
from repro_torch.models.model import LM

FUSED = ("wqkv", "wig")
# leaves the reference reads in float32 besides the norm scales
FP32_LEAVES = ("A_log", "dt_bias")


def leaf_dtype(name: str, act: torch.dtype) -> torch.dtype:
    """The dtype the reference reads the leaf `name` in: float32 for the
    norm scales (`*norm`) and FP32_LEAVES, else `act`."""
    leaf = name.rsplit(".", 1)[-1]
    return torch.float32 if (leaf.endswith("norm")
                             or leaf in FP32_LEAVES) else act


def _leaves(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{key}" if prefix else key)
    else:
        yield prefix, tree


def _layers(cfg: ArchConfig, layers: Any) -> Iterator[Tuple[int, Any]]:
    if isinstance(layers, dict):  # scan: every leaf has a layer axis
        for i in range(cfg.n_layers):
            yield i, {name: np.asarray(x)[i]
                      for name, x in _leaves(layers, "")}
    else:                         # unroll: a list of layer trees
        for i, tree in enumerate(layers):
            yield i, dict(_leaves(tree, ""))


def reference_state_dict(cfg: ArchConfig,
                         params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict of the reference's params (see above)."""
    dt = act_dtype(cfg.dtype)

    def tensor(name: str, x) -> torch.Tensor:
        if name.rsplit(".", 1)[-1] in FUSED:
            raise ValueError(f"{name}: fused weights are not ported; build "
                             f"the reference without 'fused_qkv'")
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(leaf_dtype(name, dt))

    flat = {name: x for name, x in _leaves(
        {k: v for k, v in params.items() if k != "layers"}, "")}
    for i, layer in _layers(cfg, params["layers"]):
        flat.update({f"layers.{i}.{name}": x for name, x in layer.items()})
    return {name: tensor(name, x) for name, x in flat.items()}


def from_reference(cfg: ArchConfig, params: Dict[str, Any],
                   device="cpu") -> LM:
    """The port's LM on `device` holding the reference's weights."""
    model = LM(cfg, device=device)
    model.load_state_dict(reference_state_dict(cfg, params), strict=True)
    return model
