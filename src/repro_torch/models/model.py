"""Model assembly of the port: the decoder LMs as an `nn.Module`.

The port of `repro.models.model.LM` for the families this package
serves: decoders with GQA attention (any head ratio, RoPE, optional
sliding window) and a SwiGLU or GELU MLP (phi3, starcoder2, internlm2,
chameleon); MLA attention with an MLP (minicpm3); the Mamba2/SSD layer
alone (mamba2); and the hybrid block of parallel GQA and SSM heads with
per-layer sliding windows (hymba). Its surface:

    LM(cfg, generator=g)            weights drawn from g, on the card
    LM(cfg, generator=g, device=d)  weights drawn from g, placed on d
    LM(cfg, device=d)               empty weights on d, for
                                    `load_state_dict` (`models/convert.py`)
    forward(tokens)                 -> logits (B, S, V), the full sequence
    init_caches(batch, max_len)     -> caches (one dict per layer)
    prefill(tokens, caches)         -> (last logits (B, V), caches)
    decode_step(tok, pos, caches)   -> (logits (B, V), caches)

Parameter names are the reference's pytree paths ("embedding",
"layers.3.attn.wq", "layers.3.attn.kv_b", "layers.3.ssm.A_log", ...), and
shapes its layouts. A layer's cache is the reference's too: {"attn": ...}
and / or {"ssm": ...}. Matmul weights, the embedding and the SSM's conv_b
and D are kept in the activation dtype; what the reference reads in
float32 (norm scales, A_log, dt_bias) stays float32. The reference's
`scan` and `unroll` layouts are both a `ModuleList` of layers; what the
layout still decides is the reference's window rule (`scan` gives every
layer `cfg.sliding_window`; hymba, the one config with a window, is
`unroll`). Training's loss waits for the training slice. MoE and the
encoder with its audio frontend raise NotImplementedError.

The model lives on the CUDA device unless `device` asks for another
(`core.sparsify.resolve_device`): without a card the default raises, and
nothing drops to the CPU unless asked. A model with neither a generator
nor a device raises too, since its weights would be left empty.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsify import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (act_dtype, embed_tokens, init_mlp,
                                       init_normal, lm_logits, mlp, rms_scale,
                                       rmsnorm)

# where the families not ported yet wait
_LATER = "ROADMAP.md Queue 1, \"The rest of the LM stack\""


def unsupported_reason(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build `cfg` yet, or None."""
    if cfg.is_encoder or cfg.frontend == "audio":
        return f"{cfg.name}: the encoder and its audio frontend"
    if cfg.is_moe:
        return f"{cfg.name}: MoE layers"
    return None


def layer_window(cfg: ArchConfig, idx: int) -> Optional[int]:
    """The reference's `_layer_window`: no window on global layers."""
    if cfg.sliding_window is None:
        return None
    return None if idx in cfg.global_layers else cfg.sliding_window


def _params(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class Block(nn.Module):
    """One pre-norm layer, the reference's `_block`: x + mixer(norm x),
    then + mlp(norm x) where d_ff > 0. The mixer is attention (GQA or
    MLA), the SSM, or both in parallel on one normed input, averaged
    (hybrid)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        dev = generator.device if generator is not None else device
        if cfg.has_attention:
            self.attn_norm = _param(rms_scale(cfg.d_model, dev))
            init = attn.init_mla if cfg.attn_type == "mla" else attn.init_gqa
            self.attn = _params(init(cfg, dtype, generator, dev))
        if cfg.has_ssm:
            # built for the hybrid too, which normalises with attn_norm
            self.ssm_norm = _param(rms_scale(cfg.d_model, dev))
            self.ssm = _params(ssm.init_ssm(cfg, dtype, generator, dev))
        self.has_mlp = cfg.d_ff > 0
        if self.has_mlp:
            self.mlp_norm = _param(rms_scale(cfg.d_model, dev))
            self.mlp = _params(init_mlp(cfg.d_model, cfg.d_ff, cfg.act,
                                        dtype, generator, dev))

    def _attention(self, cfg, h_in, positions, window, mode, cache, pos):
        if cfg.attn_type == "mla":
            if mode == "decode":
                return attn.mla_decode(self.attn, cfg, h_in, pos,
                                       cache["attn"])[0]
            y = attn.mla_attention(self.attn, cfg, h_in, positions,
                                   causal=True)
            if mode == "prefill":
                attn.mla_fill_cache(self.attn, cfg, h_in, positions,
                                    cache["attn"])
            return y
        if mode == "decode":
            return attn.gqa_decode(self.attn, cfg, h_in, pos, cache["attn"],
                                   window)[0]
        y = attn.gqa_attention(self.attn, cfg, h_in, positions, causal=True,
                               window=window)
        if mode == "prefill":
            attn.gqa_fill_cache(self.attn, cfg, h_in, positions,
                                cache["attn"], window)
        return y

    def _ssm(self, cfg, h_in, mode, cache):
        if mode == "decode":
            return ssm.ssm_decode(self.ssm, cfg, h_in, cache["ssm"])[0]
        if mode == "prefill":
            y, state = ssm.ssm_forward(self.ssm, cfg, h_in, return_state=True)
            ssm.ssm_fill_cache(cache["ssm"], state)
            return y
        return ssm.ssm_forward(self.ssm, cfg, h_in)

    def run(self, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
            window: Optional[int], mode: str, cache: Optional[Dict] = None,
            pos: Optional[int] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
        """mode: 'train' (full sequence), 'prefill' (also fills `cache`,
        in place) or 'decode' (one token at `pos` against `cache`)."""
        args = (positions, window, mode, cache, pos)
        if cfg.has_attention and cfg.has_ssm:   # hybrid: parallel heads
            h_in = rmsnorm(x, self.attn_norm, cfg.norm_eps)
            a = self._attention(cfg, h_in, *args)
            s = self._ssm(cfg, h_in, mode, cache)
            x = x + 0.5 * (a + s)
        elif cfg.has_attention:
            h_in = rmsnorm(x, self.attn_norm, cfg.norm_eps)
            x = x + self._attention(cfg, h_in, *args)
        else:                                    # pure SSM
            h_in = rmsnorm(x, self.ssm_norm, cfg.norm_eps)
            x = x + self._ssm(cfg, h_in, mode, cache)
        if self.has_mlp:
            x = x + mlp(self.mlp, rmsnorm(x, self.mlp_norm, cfg.norm_eps),
                        cfg.act)
        return x, cache


class LM(nn.Module):
    """A decoder LM (see the module docstring)."""

    def __init__(self, cfg: ArchConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        why = unsupported_reason(cfg)
        if why is not None:
            raise NotImplementedError(f"{why} is not ported yet; it waits "
                                      f"for {_LATER}")
        if generator is None and device is None:
            raise ValueError("LM needs a generator to draw its weights, or "
                             "an explicit device to leave them empty on "
                             "for load_state_dict")
        target = resolve_device(device)
        self.cfg = cfg
        self.dtype = act_dtype(cfg.dtype)
        dev = generator.device if generator is not None else target
        v, d = cfg.vocab_size, cfg.d_model
        self.embedding = _param(init_normal((v, d), 0.02, self.dtype,
                                            generator, dev))
        if not cfg.tie_embeddings:
            self.lm_head = _param(init_normal((v, d), d ** -0.5, self.dtype,
                                              generator, dev))
        self.final_norm = _param(rms_scale(d, dev))
        self.layers = nn.ModuleList([Block(cfg, self.dtype, generator, dev)
                                     for _ in range(cfg.n_layers)])
        # the reference's scan layout gives every layer the config's window
        self.windows = [cfg.sliding_window if cfg.layout == "scan"
                        else layer_window(cfg, i)
                        for i in range(cfg.n_layers)]
        self.to(target)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    # ---------- serve ----------
    def init_caches(self, batch: int, max_len: int) -> List[Dict[str, Any]]:
        """Each layer's family's cache: GQA's full or ring cache (by
        `layer_window`), MLA's latent cache, the SSM's state and conv
        window."""
        cfg, dt, dev = self.cfg, self.dtype, self.device

        def one(i: int) -> Dict[str, Any]:
            c: Dict[str, Any] = {}
            if cfg.has_attention:
                c["attn"] = (attn.init_mla_cache(cfg, batch, max_len, dt, dev)
                             if cfg.attn_type == "mla" else
                             attn.init_gqa_cache(cfg, batch, max_len,
                                                 layer_window(cfg, i), dt,
                                                 dev))
            if cfg.has_ssm:
                c["ssm"] = ssm.init_ssm_cache(cfg, batch, dt, dev)
            return c

        return [one(i) for i in range(cfg.n_layers)]

    def prefill(self, tokens: torch.Tensor, caches: List[Dict]
                ) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, S) int. Returns the logits of the last position
        (B, V) and the caches filled with positions 0..S-1."""
        x, positions = self._embed_inputs(tokens)
        new_caches = []
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x, cache = blk.run(self.cfg, x, positions, window, "prefill",
                               cache)
            new_caches.append(cache)
        x = rmsnorm(x[:, -1:, :], self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0, :], new_caches

    def decode_step(self, tok: torch.Tensor, pos: int, caches: List[Dict]
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """tok: (B, 1) int; pos: its absolute position (a Python int)."""
        x = embed_tokens(self.embedding, tok, self.dtype)
        new_caches = []
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x, cache = blk.run(self.cfg, x, None, window, "decode", cache,
                               pos)
            new_caches.append(cache)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0, :], new_caches

    # ---------- full sequence ----------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, V) of every position: the layers of the
        reference's `_run_layers_train`, then the final norm and head."""
        x, positions = self._embed_inputs(tokens)
        for blk, window in zip(self.layers, self.windows):
            x, _ = blk.run(self.cfg, x, positions, window, "train")
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)

    # ---------- internals ----------
    def _embed_inputs(self, tokens: torch.Tensor):
        x = embed_tokens(self.embedding, tokens, self.dtype)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        return x, positions

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        table = (self.embedding if self.cfg.tie_embeddings
                 else self.lm_head)
        return lm_logits(table, x)
