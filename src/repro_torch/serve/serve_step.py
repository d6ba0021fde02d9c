"""Serving steps of the port: batched prefill and single-token greedy
decode with persistent caches (KV, MLA's latent, the SSM's state).

The port of `repro.serve.serve_step`. The model holds its weights (an
`nn.Module`), so the steps take no `params`; a position is a Python int.
On a CUDA model every prefill runs the flash-attention kernel once per
attention layer (GQA or MLA; none for an SSM layer; `kernels/ops.py`
counts the launches); decode is plain torch.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.models.model import LM


def make_prefill_step(model: LM):
    def prefill_step(tokens: torch.Tensor, caches: List[Any]):
        return model.prefill(tokens, caches)
    return prefill_step


def make_decode_step(model: LM):
    def decode_step(tok: torch.Tensor, pos: int, caches: List[Any]):
        logits, caches = model.decode_step(tok, pos, caches)
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
    caches = model.init_caches(b, max_len)
    decode = make_decode_step(model)
    logits, caches = make_prefill_step(model)(prompt, caches)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    outs = [tok]
    for i in range(max_new - 1):
        tok, _, caches = decode(tok, s + i, caches)
        outs.append(tok)
    return torch.cat(outs, dim=1)
