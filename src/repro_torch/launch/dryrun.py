"""The dry-run: the port of `repro.launch.dryrun`.

For every (architecture × input shape × production mesh) cell, and the
four LGRASS cases, it sizes the port's program for H100s without a card
and without allocating: the model lives on the meta device, and one
mesh entry's step is traced by `launch.graph_analysis.analyze_program`.
Every kernel of the path takes its card route through its operator,
whose fake answers the meta tensors (`kernels/oplib.py`), so what is
counted is the card's program. Each record holds:

  * the per-device FLOPs, bytes and peak live bytes of the traced step,
    and whether that peak fits the card's memory (`fits`). A train cell's
    trace holds entry 0's blocks of the state in the reference's layout
    (`state_layout` "fsdp entry blocks": `place_model(..., specs=
    param_specs)`, FSDP on 'data' and the 'model' blocks where the
    config shards), the layout a port step given that spec tree holds
    on every entry, with its parameters, mu and nu bytes
    (`state_bytes_per_device`) beside the reference's
    (`reference_layout_state_bytes_per_device`); a serving cell's holds
    entry 0's 'model' blocks ("entry blocks", `place_model`), or whole
    leaves where the config does not shard, so `fits` is the port's
    own;
  * the bytes the port's mesh moves between devices per step
    (`collective_bytes_per_device`; see below);
  * the three roofline terms on the H100 data sheet's rates
    (`launch/mesh.py`), the compute term over the kernels' work
    (`flops_work_per_device`: attention over its visible pairs), the
    dominant one, and the model's FLOPs against what the working devices
    compute (`flops_per_device`, the reference's convention);
  * the bytes one device would hold in the reference's layout, from
    `launch/specs.py` (`reference_layout_bytes_per_device`), beside the
    traced peak of the port's own.

On the production meshes the port's programs are tensor parallel on
'model' for the GQA families (dense, MoE, the encoder;
`models.sharding.tp_family`): each ('data', 'model') entry computes on
its blocks of heads, kv heads where they shard, MLP columns, experts and
vocab (`models/sharding.py`). So the dry-run traces one working entry,
'model' coordinate 0 (the largest blocks), at its sizes: the model
placed for that entry alone (`sharding.entry_model`, `place_model`'s
one-entry case, whose blocks are those entry 0 of a real mesh holds),
run under `sharding.traced_entry(TP_SIZE, "meta")`, on its data shard's
rows of each microbatch (the batch split over
`launch.mesh.batch_axes_for`'s axes), AdamW over its blocks. Every
entry works (`devices_with_work` = the mesh's chips). The MLA and SSM
families keep whole heads: only the first entry of each data
coordinate works, and its whole step is traced (a train cell's on its
'data' blocks of the leaves, FSDP's).

The collective term per step has three parts. Along 'model', the traced
entry's reductions (`sharding.model_sum` and its kin, forward and
backward, remat's recompute included), each the bytes it sends in a ring
(`launch/graph_analysis.py`), at `axis_bandwidth(mesh, ('model',))`, by
kind in `collectives` ("model:<kind>"). Along 'data', a train cell's
FSDP collectives: each layer's gather of its weights' blocks before use
("data:gather", the recompute's again) and its backward, the
reduce-scatter of their gradients ("data:gather:bwd"), each (n−1)/n of
the gathered block, at `axis_bandwidth(mesh, ('data',))`. Along the
data axes, the rest of the mesh step's exchange: the whole leaves'
(norms) float32 gradients go to the first data shard's entry, which
keeps their sum, once per microbatch ("grads->root", with an FSDP
block's gradient from a data shard of another pod, whose blocks are
replicas), once per step AdamW's updated parameter, mu and nu of an
FSDP block go to its replica in each other pod ("state->replicas", 0
on one pod), and the whole leaves are copied to each other shard
("params->shards"); those bytes, which the keeping entry receives or
sends, at the rate of the link that the data axes span. Serving cells
have no data exchange: each data shard serves its own rows.
`reference_layout_bytes_per_device` is what the reference's layout
would hold (FSDP on 'data' as well as 'model', from `launch/specs.py`):
the blocks of the train state and the batch, or of the parameters, the
caches and the batch. An LGRASS cell traces one
shard of `core.distributed.make_phase1_sharded` (one MARK call on its
block); its collective term is the home entry's copies of the tables
and the blocks to the other shards and of their results back.

Artifacts land in `build/dryrun/<arch>_<shape>_<mesh>.json` at the root
of the checkout.

Usage:
    python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
    python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k
    python -m repro_torch.launch.dryrun --shape train_4k --force   # every arch
    python -m repro_torch.launch.dryrun --lgrass
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.launch import mesh as M

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "build", "dryrun")

# the bytes of a float32 gradient or parameter element
_F32 = 4
# the mesh axes of FSDP's blocks: AXIS_RULES' 'embed'
_FSDP_AXES = ("data",)
# the accept table's width of an LGRASS cell, the reference's default
K_CAP = 32


def n_active_params(cfg) -> int:
    """Params touched per token (MoE: top-k of experts), excl. embeddings."""
    total = cfg.n_params()
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body = total - emb
    if cfg.is_moe:
        nmat = 3 if cfg.act == "swiglu" else 2
        expert = cfg.n_layers * cfg.n_experts * nmat * cfg.d_model * cfg.d_ff
        body = body - expert + expert * cfg.moe_top_k / cfg.n_experts
    return int(body)


def model_flops(cfg, shape) -> float:
    na = n_active_params(cfg)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * na * tokens
    if shape.kind == "prefill":
        return 2.0 * na * tokens
    return 2.0 * na * shape.global_batch  # decode: one token per sequence


def _axes(mesh, rows: int):
    """(the batch axes of `rows` rows on `mesh` as a tuple, the data
    shards they make)."""
    ba = M.batch_axes_for(rows, mesh)
    axes = () if ba is None else ((ba,) if isinstance(ba, str) else ba)
    return tuple(axes), int(np.prod([mesh.shape[a] for a in axes],
                                    dtype=np.int64))


def _device_record() -> dict:
    return dict(name=M.DEVICE_NAME, power_limit_w=M.POWER_LIMIT_W,
                hbm_bytes=M.HBM_BYTES,
                rates="data sheet (launch/mesh.py); not measured")


def _roofline(flops: float, bytes_: float, t_coll: float):
    t_compute = flops / M.PEAK_FLOPS_BF16
    t_memory = bytes_ / M.HBM_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return dict(t_compute_s=t_compute, t_memory_s=t_memory,
                t_collective_s=t_coll, dominant=dominant,
                roofline_fraction=(max(t_compute, 1e-30)
                                   / max(t_compute, t_memory, t_coll,
                                         1e-30)))


def _save(rec: dict, outdir: str, path: str) -> dict:
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def kernel_refusal(cfg, kind: str) -> Optional[str]:
    """Why the card's program of a `kind` cell cannot run `cfg`, or None:
    a flash head dim that no kernel takes (training, prefill and encode
    run the flash kernel; decode attention is plain torch)."""
    from repro_torch.kernels import flash_attention as fa

    if not cfg.has_attention or kind == "decode":
        return None
    d = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
         if cfg.attn_type == "mla" else cfg.resolved_head_dim)
    if d in fa.HEAD_DIMS:
        return None
    return (f"head dim {d} of the config padded for the mesh: no flash "
            f"kernel takes it (kernels/flash_attention.HEAD_DIMS "
            f"{fa.HEAD_DIMS})")


def _meta_batch(cfg, rows: int, seq: int) -> dict:
    meta = torch.device("meta")
    if cfg.is_encoder:
        return dict(features=torch.empty((rows, seq, cfg.feat_dim),
                                         device=meta),
                    labels=torch.empty((rows, seq), dtype=torch.int32,
                                       device=meta),
                    mask=torch.empty((rows, seq), dtype=torch.bool,
                                     device=meta))
    return dict(tokens=torch.empty((rows, seq), dtype=torch.int32,
                                   device=meta),
                labels=torch.empty((rows, seq), dtype=torch.int32,
                                   device=meta))


def _meta_model(cfg, tp: int, mesh=None, **kw):
    """The model on the meta device, with the one entry to drive where
    `cfg` shards over 'model' (else None): placed for entry 0 of `tp`
    alone (`entry_model`), or with `mesh` (a production mesh) laid out
    for entry 0 in the reference's layout (FSDP on 'data')."""
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import LM

    model = LM(cfg, device="meta", **kw)
    entry = (None if tp == 1 or not sh.tp_family(cfg)
             else sh.traced_entry(tp, "meta"))
    if mesh is not None:
        return sh.entry_model(model, tp, mesh), entry
    if entry is None:
        return model, None
    return sh.entry_model(model, tp), entry


def _entry_elements(model) -> tuple:
    """(elements of every leaf the traced entry holds, of its placed
    blocks alone)."""
    from repro_torch.models.sharding import Placed, named_leaves

    total = blocks = 0
    for _, leaf in named_leaves(model):
        n = leaf.shards[0].numel() if isinstance(leaf, Placed) else \
            leaf.numel()
        total += n
        blocks += n if isinstance(leaf, Placed) else 0
    return total, blocks


def _state_bytes(state) -> int:
    """The bytes of the parameters, mu and nu that a traced train state
    holds (mesh entry 0's blocks and the whole leaves)."""
    from repro_torch.models.sharding import Placed

    total = 0
    for tree in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for x in tree.values():
            t = x.shards[0] if isinstance(x, Placed) else x
            total += t.numel() * t.element_size()
    return total


def _trace_train(cfg, local_rows: int, seq: int, micro: int, tp: int = 1,
                 mesh=None):
    """(the analysis of mesh entry 0's train step, (elements of its
    leaves, of its placed blocks), the bytes of its parameters, mu and
    nu), the model laid out for entry 0 of `mesh` in the reference's
    layout (`_meta_model`)."""
    from repro_torch.launch.graph_analysis import analyze_program
    from repro_torch.models.sharding import use_entries
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import (make_train_state,
                                              make_train_step)

    model, entry = _meta_model(cfg, tp, mesh, param_dtype=torch.float32)
    state = make_train_state(model)
    held = _state_bytes(state)
    step = make_train_step(model, OptConfig(), micro_batches=micro)
    batch = _meta_batch(cfg, local_rows * micro, seq)
    with use_entries(entry):
        return (analyze_program(step, state, batch, name="train_step"),
                _entry_elements(model), held)


def _trace_serve(cfg, kind: str, local_rows: int, seq: int, tp: int = 1):
    from repro_torch.launch.graph_analysis import analyze_program
    from repro_torch.models.sharding import named_leaves, use_entries
    from repro_torch.serve.serve_step import (make_decode_step,
                                              make_prefill_step)

    model, entry = _meta_model(cfg, tp)
    params = dict(named_leaves(model))
    meta = torch.device("meta")
    with torch.no_grad(), use_entries(entry):
        if kind == "prefill" and cfg.is_encoder:
            feats = _meta_batch(cfg, local_rows, seq)["features"]
            return analyze_program(lambda p, f: model.encode(f), params,
                                   feats, name="encode")
        caches = model.init_caches(local_rows, seq)
        if kind == "prefill":
            tokens = torch.empty((local_rows, seq), dtype=torch.int32,
                                 device=meta)
            prefill = make_prefill_step(model)
            return analyze_program(lambda p, t, c: prefill(t, c), params,
                                   tokens, caches, name="prefill_step")
        tok = torch.empty((local_rows, 1), dtype=torch.int32, device=meta)
        decode = make_decode_step(model)
        return analyze_program(lambda p, t, c: decode(t, seq - 1, c),
                               params, tok, caches, name="decode_step")


def _block_bytes(tree) -> int:
    """The bytes of the first mesh entry's blocks of a LeafSpec tree."""
    from repro_torch.launch.specs import LeafSpec

    leaves = [x for x in torch.utils._pytree.tree_leaves(tree)
              if isinstance(x, LeafSpec)]
    return sum(int(np.prod(x.block, dtype=np.int64)) * x.dtype.itemsize
               for x in leaves)


def reference_state_bytes(cfg, mesh) -> int:
    """One device's bytes of the parameters, mu and nu in the reference's
    layout (`launch/specs.py`'s train state less its step counter)."""
    from repro_torch.launch import specs as S
    from repro_torch.models.model import LM

    state = S.state_specs(LM(cfg, device="meta"), mesh)[0]
    return _block_bytes({k: v for k, v in state.items() if k != "opt"}) + \
        _block_bytes({k: v for k, v in state["opt"].items()
                      if k in ("mu", "nu")})


def reference_layout_bytes(cfg, shape, mesh) -> int:
    """One device's bytes in the reference's layout, from `launch/specs.py`:
    the train state and the batch of a train cell; the parameters (FSDP
    on 'data', as the reference serves), the caches and the batch of a
    serving cell."""
    from repro_torch.launch import specs as S
    from repro_torch.models.model import LM

    model = LM(cfg, device="meta")
    if shape.kind == "train":
        return (_block_bytes(S.state_specs(model, mesh)[0])
                + _block_bytes(S.batch_specs(cfg, shape, mesh)))
    params = _block_bytes(S.params_specs(model, mesh)[0])
    if shape.kind == "prefill" and cfg.is_encoder:
        return params + _block_bytes(S.batch_specs(cfg, shape, mesh))
    caches = _block_bytes(S.cache_specs(model, shape, mesh))
    if shape.kind == "prefill":
        return params + caches + _block_bytes(
            S.batch_specs(cfg, shape, mesh)["tokens"])
    return params + caches + _block_bytes(
        S.decode_token_specs(cfg, shape, mesh))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: str, force: bool = False,
             micro_batches: Optional[int] = None) -> Optional[Dict]:
    """One (arch × shape × mesh) cell, the reference's paper-faithful
    baseline. micro_batches: a train cell's microbatches (default 8)."""
    from repro_torch.configs import SHAPES, cell_skip_reason, get_arch

    mesh_name = M.mesh_name(multi_pod)
    tag = f"{arch}_{shape_name}_{mesh_name}"
    path = os.path.join(outdir, f"{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg0 = get_arch(arch)
    shape = SHAPES[shape_name]
    if micro_batches is None:
        # 8 microbatches: per-device microbatch 2 (single-pod) / 1
        # (multi-pod), as the reference's default
        micro_batches = 8 if shape.kind == "train" else 1
    skip = cell_skip_reason(cfg0, shape)
    if skip:
        rec = dict(cell=tag, arch=arch, shape=shape_name, mesh=mesh_name,
                   skipped=skip)
        print(f"[dryrun] {tag}: SKIP ({skip})")
        return _save(rec, outdir, path)

    t0 = time.time()
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    chips = len(mesh.devices)
    cfg = cfg0.padded_for_mesh(M.TP_SIZE)
    rows = shape.global_batch // (micro_batches if shape.kind == "train"
                                  else 1)
    axes, n_data = _axes(mesh, rows)
    local = rows // n_data
    from repro_torch.models.sharding import tp_family

    tp = mesh.shape.get("model", 1) if tp_family(cfg) else 1
    refusal = kernel_refusal(cfg, shape.kind)
    if refusal:
        rec = dict(cell=tag, arch=arch, shape=shape_name, mesh=mesh_name,
                   kind=shape.kind, chips=chips, cannot_run=refusal)
        print(f"[dryrun] {tag}: CANNOT RUN ({refusal})")
        return _save(rec, outdir, path)
    state_bytes = ref_state_bytes = None
    if shape.kind == "train":
        hlo, (n_params, n_blocks), state_bytes = _trace_train(
            cfg, local, shape.seq_len, micro_batches, tp, mesh)
        ref_state_bytes = reference_state_bytes(cfg, mesh)
        others, whole = n_data - 1, n_params - n_blocks
        # the FSDP blocks' replicas: one per pod where the batch spans it
        pods = max(1, n_data // int(np.prod([mesh.shape[a] for a in
                                             _FSDP_AXES])))
        exchange = {"grads->root": float((others * whole + (pods - 1)
                                          * n_blocks) * _F32
                                         * micro_batches),
                    "state->replicas": float((pods - 1) * 3 * n_blocks
                                             * _F32),
                    "params->shards": float(others * whole * _F32)}
        counts = {"grads->root": others * micro_batches,
                  "state->replicas": pods - 1, "params->shards": others}
    else:
        hlo = _trace_serve(cfg, shape.kind, local, shape.seq_len, tp)
        exchange, counts = {}, {}

    flops = float(hlo["flops"])
    work = float(hlo["flops_work"])
    bytes_ = float(hlo["mem_bytes"])
    data_bytes = float(sum(exchange.values())) + hlo["collective_bytes"]
    model_bytes = hlo["model_collective_bytes"]
    gather_bytes = hlo["data_collective_bytes"]
    coll_bytes = data_bytes + model_bytes + gather_bytes
    t_coll = ((data_bytes / (M.axis_bandwidth(mesh, axes) if axes
                             else M.NVLINK_BW) if data_bytes else 0.0)
              + (model_bytes / M.axis_bandwidth(mesh, ("model",))
                 if model_bytes else 0.0)
              + (gather_bytes / M.axis_bandwidth(mesh, _FSDP_AXES)
                 if gather_bytes else 0.0))
    peak = float(hlo["peak_bytes"])
    mf = model_flops(cfg, shape)
    rec = dict(
        cell=tag, arch=arch, shape=shape_name, mesh=mesh_name,
        kind=shape.kind, chips=chips,
        micro_batches=micro_batches, batch_axes=list(axes),
        local_rows=local, model_entries=tp,
        devices_with_work=n_data * tp,
        device=_device_record(),
        trace_s=round(time.time() - t0, 1),
        flops_per_device=flops,
        flops_work_per_device=work,
        bytes_per_device=bytes_,
        bytes_upper_per_device=float(hlo["mem_bytes_upper"]),
        bytes_dots_per_device=float(hlo["mem_bytes_dots"]),
        collective_bytes_per_device=coll_bytes,
        model_collective_bytes_per_device=model_bytes,
        fsdp_collective_bytes_per_device=gather_bytes,
        collectives={**exchange, **hlo["collective_by_kind"],
                     **{f"model:{k}": v for k, v in
                        hlo["model_collective_by_kind"].items()},
                     **{f"data:{k}": v for k, v in
                        hlo["data_collective_by_kind"].items()},
                     **{f"n_{k}": v for k, v in counts.items()},
                     **{f"n_{k}": v for k, v in
                        hlo["collective_counts"].items()},
                     **{f"n_model:{k}": v for k, v in
                        hlo["model_collective_counts"].items()},
                     **{f"n_data:{k}": v for k, v in
                        hlo["data_collective_counts"].items()}},
        memory=dict(peak_bytes=peak, hbm_bytes=M.HBM_BYTES,
                    host_syncs=hlo["sync_count"],
                    transfers=hlo["transfer_count"]),
        peak_bytes_per_device=peak,
        fits=peak <= M.HBM_BYTES,
        state_layout=("fsdp entry blocks" if shape.kind == "train" else
                      "entry blocks" if tp > 1 else "whole leaves"),
        state_bytes_per_device=state_bytes,
        reference_layout_state_bytes_per_device=ref_state_bytes,
        reference_layout_bytes_per_device=reference_layout_bytes(
            cfg, shape, mesh),
        model_flops_global=mf,
        useful_flop_ratio=mf / (flops * n_data * tp) if flops else 0.0,
        **_roofline(work, bytes_, t_coll),
    )
    print(f"[dryrun] {tag}: ok in {rec['trace_s']}s | "
          f"flops/dev={flops:.3e} bytes/dev={bytes_:.3e} "
          f"coll/dev={coll_bytes:.3e} dominant={rec['dominant']} "
          f"peak={peak / 2**30:.2f}GiB fits={rec['fits']}")
    return _save(rec, outdir, path)


def run_lgrass_cell(case_name: str, multi_pod: bool, outdir: str,
                    force: bool = False) -> Optional[Dict]:
    """The paper's own workload: one shard of the group-sharded phase 1
    (`core.distributed.make_phase1_sharded`, sharded over every mesh
    axis) at the case's (LOG, n) tables, LOG = ⌈log2(n + 1)⌉, and its
    ⌈L / shards⌉ slots, with `K_CAP`."""
    from repro_torch.configs.lgrass import CASES
    from repro_torch.core.distributed import _local_phase1
    from repro_torch.launch.graph_analysis import analyze_program

    mesh_name = M.mesh_name(multi_pod)
    tag = f"lgrass_{case_name}_{mesh_name}"
    path = os.path.join(outdir, f"{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    t0 = time.time()
    case = CASES[case_name]
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    n_shards = len(mesh.devices)
    n, L = case.n_nodes, case.n_edges
    log = max(1, (n + 1).bit_length())
    lloc = (L + n_shards - 1) // n_shards
    meta = torch.device("meta")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=meta)

    args = (i32(log, n), i32(n), i32(lloc), i32(lloc), i32(lloc),
            i32(lloc), torch.empty((lloc,), dtype=torch.bool, device=meta))
    hlo = analyze_program(lambda *a: _local_phase1(*a, K_CAP), *args,
                          name="phase1_shard")
    # the home entry: the replicated tables and each block to the other
    # shards, (accept, overflow) of each back
    others = n_shards - 1
    exchange = {"tables->shards": float(others * (log * n + n) * 4),
                "blocks->shards": float(others * lloc * (4 * 4 + 1)),
                "results->home": float(others * lloc * 2)}
    flops = float(hlo["flops"])
    bytes_ = float(hlo["mem_bytes"])
    coll_bytes = float(sum(exchange.values()))
    peak = float(hlo["peak_bytes"])
    rec = dict(
        cell=tag, arch="lgrass", shape=case_name, mesh=mesh_name,
        kind="sparsify", chips=n_shards, k_cap=K_CAP, lift_levels=log,
        local_slots=lloc, devices_with_work=n_shards,
        device=_device_record(),
        trace_s=round(time.time() - t0, 1),
        flops_per_device=flops, flops_work_per_device=flops,
        bytes_per_device=bytes_,
        collective_bytes_per_device=coll_bytes,
        collectives={**exchange, **{f"n_{k}": others for k in exchange}},
        memory=dict(peak_bytes=peak, hbm_bytes=M.HBM_BYTES,
                    host_syncs=hlo["sync_count"],
                    transfers=hlo["transfer_count"]),
        peak_bytes_per_device=peak,
        fits=peak <= M.HBM_BYTES,
        **_roofline(flops, bytes_,
                    coll_bytes / M.axis_bandwidth(mesh, mesh.axis_names)),
    )
    print(f"[dryrun] {tag}: ok in {rec['trace_s']}s "
          f"bytes/dev={bytes_:.3e} coll/dev={coll_bytes:.3e} "
          f"dominant={rec['dominant']}")
    return _save(rec, outdir, path)


def summary_line(rec: dict) -> str:
    """One markdown table row of a record: cell, peak GiB, fits, the
    reference layout's GiB, the dominant term and its time, the working
    devices."""
    if "skipped" in rec or "cannot_run" in rec:
        why = (f"skipped: {rec['skipped']}" if "skipped" in rec
               else f"cannot run: {rec['cannot_run']}")
        return f"| {rec['cell']} | {why} ||||||"
    t = max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"])
    ref = rec.get("reference_layout_bytes_per_device")
    return (f"| {rec['cell']} | {rec['peak_bytes_per_device'] / 2**30:.2f} "
            f"| {'yes' if rec['fits'] else 'no'} "
            f"| {'-' if ref is None else f'{ref / 2**30:.2f}'} "
            f"| {rec['dominant']} | {t:.4g} "
            f"| {rec['devices_with_work']} of {rec['chips']} |")


def _run_one(arch: str, shape: str, multi_pod: bool, outdir: str,
             force: bool):
    """(record, None) or (None, the failure) of one cell."""
    try:
        if arch == "lgrass":
            return run_lgrass_cell(shape, multi_pod, outdir, force), None
        return run_cell(arch, shape, multi_pod, outdir, force), None
    except Exception as e:
        print(f"[dryrun] {arch}_{shape}_{M.mesh_name(multi_pod)}: "
              f"FAIL {e!r}")
        traceback.print_exc()
        return None, (arch, shape, multi_pod, repr(e))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lgrass", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, SHAPES
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.lgrass or args.all:
        from repro_torch.configs.lgrass import CASES
        for c in CASES:
            for mp in meshes:
                cells.append(("lgrass", c, mp))
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                for mp in meshes:
                    cells.append((a, s, mp))
    elif args.arch or args.shape:
        shapes = [args.shape] if args.shape else list(SHAPES)
        archs = [args.arch] if args.arch else list(ARCHS)
        for a in archs:
            for s in shapes:
                for mp in meshes:
                    cells.append((a, s, mp))

    results = [_run_one(a, s, mp, args.out, args.force)
               for a, s, mp in cells]
    failures = [r[1] for r in results if r[1] is not None]
    rows = [summary_line(r[0]) for r in results if r[0] is not None]
    print("| cell | peak GiB / device | fits "
          "| reference layout GiB | dominant | its time s "
          "| devices with work |")
    print("|---|---|---|---|---|---|---|")
    for row in rows:
        print(row)
    print(f"[dryrun] done; {len(failures)} failures")
    if failures:
        for f in failures:
            print("  FAIL:", f)
        sys.exit(1)


if __name__ == "__main__":
    main()
