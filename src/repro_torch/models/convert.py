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

`from_reference(cfg, params, device)` builds the port's `LM` from them,
on the card unless `device` names another; with `mesh=` (a mesh whose
'model' axis the config shards over), placed on that mesh
(`models/sharding.place_model`): built on the meta device and filled
block by block, so no device ever holds a whole sharded leaf.
`from_reference_train_state(cfg, state)` carries a train state across:
the reference's {"params", "opt": {"mu", "nu", "step"}, ["err"]} (as
numpy arrays: a restored checkpoint, or `jax.device_get` of a live
state) becomes the port's (`train/train_step.make_train_state`), every
leaf float32, keyed by the port's parameter names, from either layout;
`train_step.load_train_state` copies it into a train state, a placed
one block by block.
The tests use this, not the port's own init, for parity with the
reference: the port's init draws the same distributions from a
`torch.Generator`, whose bits differ from `jax.random`'s.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsify import resolve_device
from repro_torch.models.layers import act_dtype
from repro_torch.models import sharding as sh
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


def float32_leaves(cfg: ArchConfig,
                    params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Each leaf of a params-shaped tree as a float32 tensor under the
    port's name, layers unstacked (scan) or taken from the list (unroll);
    fused weights refused."""
    flat = {name: x for name, x in _leaves(
        {k: v for k, v in params.items() if k != "layers"}, "")}
    for i, layer in _layers(cfg, params["layers"]):
        flat.update({f"layers.{i}.{name}": x for name, x in layer.items()})
    for name in flat:
        if name.rsplit(".", 1)[-1] in FUSED:
            raise ValueError(f"{name}: fused weights are not ported; build "
                             f"the reference without 'fused_qkv'")
    return {name: torch.from_numpy(np.array(x, dtype=np.float32))
            for name, x in flat.items()}


def reference_state_dict(cfg: ArchConfig,
                         params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict of the reference's params (see above)."""
    dt = act_dtype(cfg.dtype)
    return {name: t.to(leaf_dtype(name, dt))
            for name, t in float32_leaves(cfg, params).items()}


def from_reference_train_state(cfg: ArchConfig,
                               state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state of the reference's: {"params": {name: float32
    tensor}, "opt": {"mu": ..., "nu": ..., "step": int32 scalar}} and, where
    the reference's has it (compression's error feedback), "err", each
    params-shaped tree keyed by the port's parameter names (the
    reference's pytree paths). CPU tensors; `train_step.load_train_state`
    copies them into a model's train state."""
    opt = state["opt"]
    out = {"params": float32_leaves(cfg, state["params"]),
           "opt": {"mu": float32_leaves(cfg, opt["mu"]),
                   "nu": float32_leaves(cfg, opt["nu"]),
                   "step": torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32)}}
    if "err" in state:
        out["err"] = float32_leaves(cfg, state["err"])
    return out


def from_reference(cfg: ArchConfig, params: Dict[str, Any],
                   device=None, mesh=None) -> LM:
    """The port's LM on `device` holding the reference's weights: the
    card unless another device is asked for (`core.sparsify.
    resolve_device`), which raises without one. With `mesh`, where the
    config shards over its 'model' axis, the LM placed on it
    (`sharding.place_model`; `device` is then the mesh's)."""
    if sh.shards_over_model(mesh, cfg):
        return sh.place_model(LM(cfg, device="meta"), mesh,
                              values=reference_state_dict(cfg, params))
    model = LM(cfg, device=resolve_device(device))
    model.load_state_dict(reference_state_dict(cfg, params), strict=True)
    return model
