"""Model assembly of the port: the LMs of every family as an `nn.Module`.

The port of `repro.models.model.LM`: decoders with GQA attention (any
head ratio, RoPE, optional sliding window) and a SwiGLU or GELU MLP
(phi3, starcoder2, internlm2, chameleon) or an MoE FFN (granite-moe,
dbrx; `models/moe.py`); MLA attention with an MLP (minicpm3); the
Mamba2/SSD layer alone (mamba2); the hybrid block of parallel GQA and SSM
heads with per-layer sliding windows (hymba); and the encoder with its
audio frontend (hubert: bidirectional attention, a linear projection of
frame features). Its surface:

    LM(cfg, generator=g)            weights drawn from g, on the card
    LM(cfg, generator=g, device=d)  weights drawn from g, placed on d
    LM(cfg, device=d)               empty weights on d, for
                                    `load_state_dict` (`models/convert.py`)
    LM(cfg, ..., param_dtype=torch.float32)
                                    float32 leaves, for training
    forward(tokens)                 -> logits (B, S, V), the full sequence
    init_caches(batch, max_len)     -> caches (one dict per layer)
    prefill(tokens, caches)         -> (last logits (B, V), caches)
    decode_step(tok, pos, caches)   -> (logits (B, V), caches)
    run_layers(x, positions)        -> (x, the MoE aux loss), the layers
    encode(features)                -> logits (B, T, V)     [encoder]
    loss_fn(batch)                  -> (loss, metrics)      [train]

The four decoder entries raise ValueError on an encoder, whose config
has no decode step (`supports_decode`); `encode` raises on a decoder.

Parameter names are the reference's pytree paths ("embedding",
"layers.3.attn.wq", "layers.3.mlp.router", "layers.3.ssm.A_log",
"frontend.proj", ...), and shapes its layouts. A layer's cache is the
reference's too: {"attn": ...} and / or {"ssm": ...}. Matmul weights,
the embedding and the SSM's conv_b and D are kept in the activation
dtype; what the reference reads in float32 (norm scales, A_log,
dt_bias) stays float32. The reference's `scan` and `unroll` layouts are
both a `ModuleList` of layers; what the layout still decides is the
reference's window rule (`scan` gives every layer `cfg.sliding_window`;
hymba, the one config with a window, is `unroll`). `run_layers` is the
reference's `_run_layers_train`: it returns the MoE aux loss (the mean
over layers of each MoE layer's loss) and, where `cfg.remat` is set and
autograd records, wraps each layer in `torch.utils.checkpoint`
(non-reentrant) as the reference wraps its layer body in
`jax.checkpoint`: the backward runs the layer's forward again, its flash
and rank kernels included. `loss_fn` is the reference's: CE + aux for a
decoder, the masked CE over `labels` and `mask` for the encoder.

The model lives on the CUDA device unless `device` asks for another
(`core.sparsify.resolve_device`): without a card the default raises, and
nothing drops to the CPU unless asked. A model with neither a generator
nor a device raises too, since its weights would be left empty.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsify import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm
from repro_torch.models.layers import (act_dtype, cross_entropy,
                                       embed_tokens, init_mlp, init_normal,
                                       lm_logits, mlp, rms_scale, rmsnorm)


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
    MLA; bidirectional in an encoder), the SSM, or both in parallel on
    one normed input, averaged (hybrid); the MLP is dense or MoE."""

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
        self.causal = not cfg.is_encoder
        self.has_mlp = cfg.d_ff > 0
        if self.has_mlp:
            self.mlp_norm = _param(rms_scale(cfg.d_model, dev))
            self.mlp = (moe.MoE(moe.init_moe(cfg, dtype, generator, dev))
                        if cfg.is_moe else
                        _params(init_mlp(cfg.d_model, cfg.d_ff, cfg.act,
                                         dtype, generator, dev)))

    def _attention(self, cfg, h_in, positions, window, mode, cache, pos):
        if cfg.attn_type == "mla":
            if mode == "decode":
                return attn.mla_decode(self.attn, cfg, h_in, pos,
                                       cache["attn"])[0]
            y = attn.mla_attention(self.attn, cfg, h_in, positions,
                                   causal=self.causal)
            if mode == "prefill":
                attn.mla_fill_cache(self.attn, cfg, h_in, positions,
                                    cache["attn"])
            return y
        if mode == "decode":
            return attn.gqa_decode(self.attn, cfg, h_in, pos, cache["attn"],
                                   window)[0]
        y = attn.gqa_attention(self.attn, cfg, h_in, positions,
                               causal=self.causal, window=window)
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
            pos: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], Optional[torch.Tensor]]:
        """mode: 'train' (full sequence), 'prefill' (also fills `cache`,
        in place) or 'decode' (one token at `pos` against `cache`).
        Returns (x, cache, the MoE layer's aux loss in 'train' mode, else
        None)."""
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
        aux = None
        if self.has_mlp:
            h_in = rmsnorm(x, self.mlp_norm, cfg.norm_eps)
            if cfg.is_moe:
                y, aux = self.mlp(cfg, h_in, with_aux=mode == "train")
            else:
                y = mlp(self.mlp, h_in, cfg.act)
            x = x + y
        return x, cache, aux


class LM(nn.Module):
    """An LM of any family (see the module docstring)."""

    def __init__(self, cfg: ArchConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if generator is None and device is None:
            raise ValueError("LM needs a generator to draw its weights, or "
                             "an explicit device to leave them empty on "
                             "for load_state_dict")
        target = resolve_device(device)
        self.cfg = cfg
        self.dtype = act_dtype(cfg.dtype)
        # the dtype of the leaves that are not float32 by nature
        pdt = self.dtype if param_dtype is None else param_dtype
        dev = generator.device if generator is not None else target
        v, d = cfg.vocab_size, cfg.d_model
        self.embedding = _param(init_normal((v, d), 0.02, pdt, generator,
                                            dev))
        if not cfg.tie_embeddings:
            self.lm_head = _param(init_normal((v, d), d ** -0.5, pdt,
                                              generator, dev))
        self.final_norm = _param(rms_scale(d, dev))
        if cfg.frontend == "audio":
            self.frontend = _params({"proj": init_normal(
                (cfg.feat_dim, d), cfg.feat_dim ** -0.5, pdt, generator,
                dev)})
        self.layers = nn.ModuleList([Block(cfg, pdt, generator, dev)
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
        self._decoder("init_caches")
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
        self._decoder("prefill")
        x, positions = self._embed_inputs(tokens)
        new_caches = []
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x, cache, _ = blk.run(self.cfg, x, positions, window,
                                  "prefill", cache)
            new_caches.append(cache)
        x = rmsnorm(x[:, -1:, :], self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0, :], new_caches

    def decode_step(self, tok: torch.Tensor, pos: int, caches: List[Dict]
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """tok: (B, 1) int; pos: its absolute position (a Python int)."""
        self._decoder("decode_step")
        x = embed_tokens(self.embedding, tok, self.dtype)
        new_caches = []
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x, cache, _ = blk.run(self.cfg, x, None, window, "decode",
                                  cache, pos)
            new_caches.append(cache)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0, :], new_caches

    # ---------- full sequence ----------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, V) of every position: the layers of the
        reference's `_run_layers_train`, then the final norm and head."""
        self._decoder("forward")
        x, positions = self._embed_inputs(tokens)
        x, _ = self.run_layers(x, positions)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)

    def run_layers(self, x: torch.Tensor, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layers in 'train' mode, the reference's `_run_layers_train`:
        (x, the MoE aux loss summed over layers over n_layers; 0 without
        MoE layers). With `cfg.remat`, while autograd records, each layer
        is a non-reentrant `torch.utils.checkpoint`: its activations are
        recomputed in the backward."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk, window in zip(self.layers, self.windows):
            if remat:
                x, a = checkpoint(self._train_layer, blk, x, positions,
                                  window, use_reentrant=False)
            else:
                x, a = self._train_layer(blk, x, positions, window)
            if a is not None:
                aux = aux + a
        return x, aux / max(self.cfg.n_layers, 1)

    def _train_layer(self, blk: Block, x: torch.Tensor,
                     positions: torch.Tensor, window: Optional[int]):
        x, _, a = blk.run(self.cfg, x, positions, window, "train")
        return x, a

    # ---------- train ----------
    def loss_fn(self, batch: Dict[str, torch.Tensor],
                denominator: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's `loss_fn`. A decoder's batch holds `tokens` and
        `labels` (B, S) and may hold a `mask`: (CE + aux, {loss, ce,
        aux}). The encoder's holds `features` (B, T, feat_dim), `labels`
        and `mask`: (the masked CE over the real vocab, {loss}). With
        `denominator` (a float32 scalar), the CE is the (masked) sum over
        it: a data shard's part of a whole batch's mean, whose token count
        (or Σ mask, at least 1) `denominator` is."""
        cfg = self.cfg
        if cfg.is_encoder:
            logits = self.encode(batch["features"])
            loss = cross_entropy(logits, batch["labels"], batch["mask"],
                                 cfg.real_vocab_size, denominator)
            return loss, {"loss": loss}
        x, positions = self._embed_inputs(batch["tokens"])
        x, aux = self.run_layers(x, positions)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        ce = cross_entropy(self._logits(x), batch["labels"],
                           batch.get("mask"), cfg.real_vocab_size,
                           denominator)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    # ---------- encoder ----------
    def encode(self, features: torch.Tensor) -> torch.Tensor:
        """features: (B, T, feat_dim) frame features -> logits (B, T, V):
        the reference's `encode`. The features are cast to the activation
        dtype and projected by `frontend.proj`; positions 0..T-1; the
        layers (bidirectional attention) as in `forward`."""
        if not self.cfg.is_encoder:
            raise ValueError(f"{self.cfg.name} is a decoder: encode is the "
                             f"encoder's entry")
        feats = features.to(self.dtype)
        x = torch.einsum("btf,fd->btd", feats,
                         self.frontend["proj"].to(self.dtype))
        b, t, _ = x.shape
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device).expand(b, t)
        x, _ = self.run_layers(x, positions)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)

    # ---------- internals ----------
    def _decoder(self, entry: str) -> None:
        if self.cfg.is_encoder:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no "
                             f"{entry} (use encode)")

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
