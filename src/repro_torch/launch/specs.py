"""Shape and sharding stand-ins for the dry-run: the port of
`repro.launch.specs`.

Each function gives, for every leaf of a model input or state, a
`LeafSpec`: the global shape, the dtype, the `P` on the mesh (resolved by
`ft.elastic.resolve_spec_for_mesh`, the batch axes by
`launch.mesh.batch_axes_for`, as the reference's are) and the block one
mesh entry holds (`models.sharding.block_slices` at the first entry, the
largest block). Nothing is allocated: shapes come from a model on the
meta device. The port's leaves are per layer where the reference's `scan`
layout stacks them, so a stacked leaf of the reference is here one leaf
per layer, with the leading `stack` entry of its spec dropped.

The port's mesh step does not hold this layout (it keeps whole leaves on
each data shard): the dry-run (`launch/dryrun.py`) sums the first
entry's blocks into each record's `reference_layout_bytes_per_device`,
beside the peak that it traces for the port's own step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.distributed import Mesh
from repro_torch.ft.elastic import resolve_spec_for_mesh
from repro_torch.launch.mesh import batch_axes_for
from repro_torch.models import sharding as sh
from repro_torch.models.model import LM
from repro_torch.models.sharding import P


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: P
    block: Tuple[int, ...]  # the first mesh entry's block of the leaf

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.dtype.itemsize


def leaf(shape, dtype: torch.dtype, mesh: Mesh, p) -> LeafSpec:
    """The LeafSpec of a leaf of `shape` laid out by `p` on `mesh`."""
    p = resolve_spec_for_mesh(P(*p), mesh)
    first = dict.fromkeys(mesh.axis_names, 0)
    block = tuple(s.stop - s.start for s in sh.block_slices(
        tuple(shape), p, mesh.shape, first))
    return LeafSpec(tuple(shape), dtype, p, block)


def _meta_model(model: LM) -> LM:
    return model if model.device.type == "meta" else LM(model.cfg,
                                                        device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> Dict:
    """One global batch (train / prefill)."""
    b, s = shape.global_batch, shape.seq_len
    ba = batch_axes_for(b, mesh)
    if cfg.is_encoder:
        return dict(
            features=leaf((b, s, cfg.feat_dim), torch.float32, mesh,
                          (ba, None, None)),
            labels=leaf((b, s), torch.int32, mesh, (ba, None)),
            mask=leaf((b, s), torch.bool, mesh, (ba, None)),
        )
    return dict(
        tokens=leaf((b, s), torch.int32, mesh, (ba, None)),
        labels=leaf((b, s), torch.int32, mesh, (ba, None)),
    )


def _param_tree(model: LM, mesh: Mesh, dtype: Optional[torch.dtype],
                fix) -> Tuple[Dict, Dict]:
    with sh.use_mesh(mesh):
        specs = sh.param_specs(model)
    leaves, ps = {}, {}
    for name, p in model.named_parameters():
        spec = fix(resolve_spec_for_mesh(specs[name], mesh))
        leaves[name] = leaf(p.shape, dtype or p.dtype, mesh, spec)
        ps[name] = leaves[name].spec
    return leaves, ps


def state_specs(model: LM, mesh: Mesh) -> Tuple[Any, Any]:
    """(LeafSpec tree, P tree) of the train state
    (`train.train_step.make_train_state`): float32 parameters, their
    moments with the same specs, and the step."""
    params, ps = _param_tree(_meta_model(model), mesh, torch.float32,
                             lambda p: p)
    step = leaf((), torch.int32, mesh, ())
    return (dict(params=params, opt=dict(mu=params, nu=params, step=step)),
            dict(params=ps, opt=dict(mu=ps, nu=ps, step=P())))


def params_specs(model: LM, mesh: Mesh,
                 fsdp: bool = True) -> Tuple[Any, Any]:
    """(LeafSpec tree, P tree) of the model's parameters. fsdp=False
    (serving): the 'data' (FSDP) axis dropped from every spec, so the
    weights stay resident (the reference's 'serve_params_resident')."""
    def fix(p: P) -> P:
        if fsdp:
            return p
        return sh.keep_axes(p, set(mesh.axis_names) - {"data"})

    return _param_tree(_meta_model(model), mesh, None, fix)


def _cache_leaf_spec(cfg: ArchConfig, key: str, ndim: int, batch_axes,
                     slots: int) -> P:
    """The reference's rule for one per-layer cache leaf."""
    kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % 16 == 0
    ssm_ok = cfg.has_ssm and cfg.ssm_nheads % 16 == 0
    # KV heads that cannot shard 16 ways: shard the cache's sequence on
    # 'model' instead (sequence-parallel decode)
    seq_shard = (not kv_ok) and slots >= 4096 and slots % 16 == 0
    if key in ("k", "v"):
        return P(batch_axes, "model" if seq_shard else None,
                 "model" if kv_ok else None, None)
    if key in ("ckv", "krope"):
        mla_seq = slots >= 4096 and slots % 16 == 0
        return P(batch_axes, "model" if mla_seq else None, None)
    if key == "pos":
        if seq_shard or (cfg.attn_type == "mla" and slots >= 4096
                         and slots % 16 == 0):
            return P("model")
        return P(None)
    if key == "state":
        return P(batch_axes, "model" if ssm_ok else None, None, None)
    if key == "conv":
        return P(batch_axes, None, None)
    return P(*([None] * ndim))


def _slots(key: str, shape) -> int:
    if key in ("k", "v"):
        return shape[-3]
    if key in ("ckv", "krope"):
        return shape[-2]
    if key == "pos":
        return shape[-1]
    return 0


def cache_specs(model: LM, shape: ShapeConfig, mesh: Mesh) -> Any:
    """LeafSpecs of `model.init_caches(global_batch, seq_len)`: one dict
    per layer, as the port's caches are."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    ba = batch_axes_for(b, mesh)
    caches = _meta_model(model).init_caches(b, s)

    def walk(key: str, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(key, x) for x in node]
        return leaf(node.shape, node.dtype, mesh, _cache_leaf_spec(
            cfg, key, node.dim(), ba, _slots(key, node.shape)))

    return walk("", caches)


def decode_token_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh):
    """(the (B, 1) int32 tokens, the int32 position) of a decode step."""
    b = shape.global_batch
    ba = batch_axes_for(b, mesh)
    return (leaf((b, 1), torch.int32, mesh, (ba, None)),
            leaf((), torch.int32, mesh, ()))
