"""Serving steps of the port: batched prefill and single-token greedy
decode with persistent caches (KV, MLA's latent, the SSM's state).

The port of `repro.serve.serve_step`. The model holds its weights (an
`nn.Module`), so the steps take no `params`; a position is a Python int.
On a CUDA model every prefill runs the flash-attention kernel once per
attention layer (GQA or MLA; none for an SSM layer), and every prefill
and decode step the radix rank kernel once per MoE layer (its dispatch
ranks); `kernels/ops.py` counts the launches. Decode attention is plain
torch. An encoder has no steps (`LM.encode` is its entry).

On a mesh (`models.sharding.use_mesh`, read when a step runs), the rows
split over the data shards (`launch.mesh.data_shards`), each run under
its 'model' entries (`models.sharding.model_entries`: tensor parallel
for the GQA families) on its device. The steps lay the model out for the
mesh first (`models.sharding.lay_out_model`, as the train step does):
placed on it where the config shards over its 'model' axis (a model
placed on another mesh is laid out anew), so each entry reads the blocks
it holds and no sharded leaf is copied; gathered into whole leaves on
any other mesh, or without one. A model laid out FSDP
(`sharding.place_model(..., specs=)`) keeps that layout: each data shard
(`use_shard`) gathers a layer's blocks as it runs the layer, as the
reference's partitioned decode does. A shard on another device than the
model's runs on a copy of the whole leaves (every leaf of an unplaced
model, the replicated ones of a placed one) made per call
(`launch.mesh.call_with`), so it reads the model's current weights. The
caches are then one per data shard (`init_caches`, a list in mesh
order), and the logits and tokens come back on the model's device, the
shards' rows in order.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.launch.mesh import call_with, copy_params, data_shards
from repro_torch.models.model import LM
from repro_torch.models.sharding import (current_mesh, lay_out_model,
                                         model_entries, use_entries,
                                         use_shard)


def _plan(model: LM, rows: int):
    """Per data shard of the active mesh: (its device, its 'model'
    entries, its rows' slice, its root's mesh entry); the model laid out
    for the mesh first (`lay_out_model`)."""
    mesh = current_mesh()
    lay_out_model(model)
    _, shards = data_shards(mesh, rows)
    per = rows // len(shards)
    return [(dev, model_entries(mesh, at, model.cfg),
             slice(j * per, (j + 1) * per),
             int(np.ravel_multi_index([at.get(a, 0) for a in mesh.axis_names],
                                      mesh.axis_sizes)))
            for j, (at, dev) in enumerate(shards)]


def _on_shards(model: LM, name: str, x: torch.Tensor, caches, *args):
    """`model.<name>(x[rows], *args, caches[j])` per data shard j: the
    shards' logits concatenated on the model's device, and their new
    caches. A shard on another device runs on a copy of the whole
    leaves made for this call, so it reads the model's current
    weights."""
    outs, new, copies = [], [], {}
    for j, (dev, entries, rows, root) in enumerate(_plan(model,
                                                         x.shape[0])):
        call = (x[rows].to(dev), *args, caches[j])
        with use_entries(entries), use_shard(root):
            if dev == model.device:
                out = getattr(model, name)(*call)
            else:
                if dev not in copies:
                    copies[dev] = copy_params(model.named_parameters(), dev)
                out = call_with(model, copies[dev], name, *call)
        outs.append(out[0].to(model.device))
        new.append(out[1])
    return torch.cat(outs), new


def init_caches(model: LM, batch: int, max_len: int) -> List[Any]:
    """The caches of `batch` rows: the model's (`LM.init_caches`), or on a
    mesh one per data shard, each built under its entries on its
    device."""
    if current_mesh() is None:
        return lay_out_model(model).init_caches(batch, max_len)
    out = []
    for dev, entries, rows, _ in _plan(model, batch):
        with use_entries(entries):
            out.append(model.init_caches(rows.stop - rows.start, max_len,
                                         device=dev))
    return out


def make_prefill_step(model: LM):
    def prefill_step(tokens: torch.Tensor, caches: List[Any]):
        if current_mesh() is None:
            return lay_out_model(model).prefill(tokens, caches)
        return _on_shards(model, "prefill", tokens, caches)
    return prefill_step


def make_decode_step(model: LM):
    def decode_step(tok: torch.Tensor, pos: int, caches: List[Any]):
        if current_mesh() is None:
            logits, caches = lay_out_model(model).decode_step(tok, pos,
                                                              caches)
        else:
            logits, caches = _on_shards(model, "decode_step", tok, caches,
                                        pos)
        # greedy next token (sampling handled by the server loop)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, caches
    return decode_step


@torch.inference_mode()
def generate(model: LM, prompt: torch.Tensor, max_new: int,
             max_len: int) -> torch.Tensor:
    """Greedy generation: prefill the (B, S) prompt, then max_new - 1
    decode steps. Returns the (B, max_new) int32 tokens on the model's
    device."""
    prompt = prompt.to(device=model.device, dtype=torch.int32)
    b, s = prompt.shape
    caches = init_caches(model, b, max_len)
    decode = make_decode_step(model)
    logits, caches = make_prefill_step(model)(prompt, caches)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    outs = [tok]
    for i in range(max_new - 1):
        tok, _, caches = decode(tok, s + i, caches)
        outs.append(tok)
    return torch.cat(outs, dim=1)
