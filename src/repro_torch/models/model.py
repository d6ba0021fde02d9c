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
    run_layers(x, positions, moe_stats=list)
                                    -> (x, 0); each MoE layer's router
                                       statistics appended to the list
    encode(features)                -> logits (B, T, V)     [encoder]
    loss_fn(batch)                  -> (loss, metrics)      [train]
    loss_fn(batch, den, moe_stats=list)
                                    -> (CE, metrics), the statistics
                                       collected             [train]

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

A data shard of a batch cannot compute the batch's aux loss from its own
rows: the loss couples every row through the router's statistics. With a
`moe_stats` list, the layers hand out each MoE layer's (gsum, count)
(`moe.router_stats`) in layer order instead of their losses, and the
trainer assembles the whole batch's aux from every shard's statistics
(`moe.aux_from_stats`, `train/train_step.py`). Under remat the
statistics are outputs of the checkpointed layer, so the backward's
gradient of gsum flows through the layer's recomputed forward.

Tensor parallelism on 'model': under `models.sharding.use_entries`
(the train and serving steps set it per data shard), the entry points
drive those mesh entries: the embedding lookup, each layer's attention
(`attention.head_block`), dense MLP and MoE experts, and the logits run
per entry on its blocks of the leaves, and their partial sums meet in
`sharding.model_sum`; the norms, the router and the frontend run once,
on the shard's root device. The CE is vocab-parallel
(`layers.cross_entropy_parallel`); the logits that `forward`,
`prefill`, `decode_step` and `encode` return are the entries' vocab
blocks concatenated in order. `init_caches` gives a GQA layer one cache
per entry (`{"attn": [...]}`), of the kv heads it holds. The train
and serving steps place the model on their mesh
(`sharding.place_model`): each sharded leaf (`sharding.model_dim`) is
then a `Placed` value, each entry's block on its device, read by
`Entry.take` as a view; `named_leaves` lists the leaves, as
`named_parameters` no longer yields the placed ones. A placed model runs
under its mesh's entries only (its entry points raise without them); a
model placed for one entry alone (`sharding.entry_model`) runs the same
code under that one entry (`sharding.traced_entry`): the dry-run's
trace. The MLA and SSM families do not shard. A model laid out FSDP
(`sharding.place_model(..., specs=)`) reads its leaves gathered over the
batch axes: each layer's inside its remat region (`Block.run`, for the
entries or the data shard at mesh entry `shard`, which the entry points
take from `sharding.current_shard` and hand down, so that the recompute
gathers again), the embedding, head and frontend at their use.

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
from repro_torch.models import sharding as sh
from repro_torch.models.layers import (act_dtype, cross_entropy,
                                       cross_entropy_parallel, embed_tokens,
                                       init_mlp, init_normal, lm_logit_blocks,
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

    def _attention(self, p, cfg, h_in, positions, window, mode, cache, pos,
                   entries=None):
        if cfg.attn_type == "mla":
            if mode == "decode":
                return attn.mla_decode(p, cfg, h_in, pos, cache["attn"])[0]
            y = attn.mla_attention(p, cfg, h_in, positions,
                                   causal=self.causal)
            if mode == "prefill":
                attn.mla_fill_cache(p, cfg, h_in, positions, cache["attn"])
            return y
        if entries is None:
            if mode == "decode":
                return attn.gqa_decode(p, cfg, h_in, pos, cache["attn"],
                                       window)[0]
            y = attn.gqa_attention(p, cfg, h_in, positions,
                                   causal=self.causal, window=window)
            if mode == "prefill":
                attn.gqa_fill_cache(p, cfg, h_in, positions, cache["attn"],
                                    window)
            return y
        parts = []
        # the training products' input gradients stay float32 per entry
        hs = sh.model_copy(h_in, entries, "attn_in", wide=mode == "train")
        for j, (e, h) in enumerate(zip(entries, hs)):
            blk = attn.head_block(cfg, e)
            c = None if cache is None else cache["attn"][j]
            if mode == "decode":
                parts.append(attn.gqa_decode(p, cfg, h, pos, c, window,
                                             blk)[0])
                continue
            at = positions.to(e.device)
            parts.append(attn.gqa_attention(p, cfg, h, at,
                                            causal=self.causal,
                                            window=window, blk=blk,
                                            act=h_in.dtype))
            if mode == "prefill":
                attn.gqa_fill_cache(p, cfg, h, at, c, window, blk)
        return sh.model_sum(parts, entries, "attn_out", h_in.dtype)

    def _ssm(self, p, cfg, h_in, mode, cache):
        if mode == "decode":
            return ssm.ssm_decode(p, cfg, h_in, cache["ssm"])[0]
        if mode == "prefill":
            y, state = ssm.ssm_forward(p, cfg, h_in, return_state=True)
            ssm.ssm_fill_cache(cache["ssm"], state)
            return y
        return ssm.ssm_forward(p, cfg, h_in)

    def run(self, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
            window: Optional[int], mode: str, cache: Optional[Dict] = None,
            pos: Optional[int] = None, stats: bool = False,
            entries: Optional[sh.Entries] = None,
            shard: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], Optional[torch.Tensor]]:
        """mode: 'train' (full sequence), 'prefill' (also fills `cache`,
        in place) or 'decode' (one token at `pos` against `cache`).
        Returns (x, cache, the MoE layer's aux loss in 'train' mode, else
        None; with `stats`, its router statistics in the loss's place).
        With `entries`, the attention and the MLP or experts run per mesh
        entry on its blocks (the module docstring). The layer's FSDP
        leaves are gathered first, for `entries` or the data shard at
        mesh entry `shard` (`sharding.fsdp_layer`), in x's dtype."""
        args = (positions, window, mode, cache, pos)
        dt = x.dtype

        def use(params):
            return sh.fsdp_layer(params, dt, entries, shard)

        if cfg.has_attention and cfg.has_ssm:   # hybrid: parallel heads
            h_in = rmsnorm(x, self.attn_norm, cfg.norm_eps)
            a = self._attention(use(self.attn), cfg, h_in, *args)
            s = self._ssm(use(self.ssm), cfg, h_in, mode, cache)
            x = x + 0.5 * (a + s)
        elif cfg.has_attention:
            h_in = rmsnorm(x, self.attn_norm, cfg.norm_eps)
            x = x + self._attention(use(self.attn), cfg, h_in, *args,
                                    entries)
        else:                                    # pure SSM
            h_in = rmsnorm(x, self.ssm_norm, cfg.norm_eps)
            x = x + self._ssm(use(self.ssm), cfg, h_in, mode, cache)
        aux = None
        if self.has_mlp:
            h_in = rmsnorm(x, self.mlp_norm, cfg.norm_eps)
            p = use(self.mlp)
            if cfg.is_moe:
                y, aux = self.mlp(cfg, h_in, with_aux=mode == "train",
                                  stats=stats, entries=entries,
                                  params=None if p is self.mlp else p)
            else:
                y = mlp(p, h_in, cfg.act, entries, cfg.d_ff)
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
        """The device of the replicated leaves: a placed model's root."""
        return self.final_norm.device

    # ---------- serve ----------
    def init_caches(self, batch: int, max_len: int,
                    device=None) -> List[Dict[str, Any]]:
        """Each layer's family's cache, on `device` (the model's by
        default): GQA's full or ring cache (by `layer_window`), MLA's
        latent cache, the SSM's state and conv window. Under
        `use_entries`, a GQA layer's is a list of one cache per entry, on
        its device, of the kv heads it holds."""
        self._decoder("init_caches")
        cfg, dt = self.cfg, self.dtype
        dev = self.device if device is None else device
        entries = self._entries()

        def gqa(i: int, e=None):
            return attn.init_gqa_cache(
                cfg, batch, max_len, layer_window(cfg, i), dt,
                dev if e is None else e.device,
                None if e is None else attn.head_block(cfg, e))

        def one(i: int) -> Dict[str, Any]:
            c: Dict[str, Any] = {}
            if cfg.has_attention:
                c["attn"] = (attn.init_mla_cache(cfg, batch, max_len, dt, dev)
                             if cfg.attn_type == "mla" else
                             gqa(i) if entries is None else
                             [gqa(i, e) for e in entries])
            if cfg.has_ssm:
                c["ssm"] = ssm.init_ssm_cache(cfg, batch, dt, dev)
            return c

        return [one(i) for i in range(cfg.n_layers)]

    def prefill(self, tokens: torch.Tensor, caches: List[Dict]
                ) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, S) int. Returns the logits of the last position
        (B, V) and the caches filled with positions 0..S-1."""
        self._decoder("prefill")
        entries, shard = self._entries(), sh.current_shard()
        x, positions = self._embed_inputs(tokens, entries, shard)
        new_caches = []
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x, cache, _ = blk.run(self.cfg, x, positions, window,
                                  "prefill", cache, entries=entries,
                                  shard=shard)
            new_caches.append(cache)
        x = rmsnorm(x[:, -1:, :], self.final_norm, self.cfg.norm_eps)
        return self._logits(x, entries, shard)[:, 0, :], new_caches

    def decode_step(self, tok: torch.Tensor, pos: int, caches: List[Dict]
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """tok: (B, 1) int; pos: its absolute position (a Python int)."""
        self._decoder("decode_step")
        entries, shard = self._entries(), sh.current_shard()
        x = embed_tokens(self._leaf(self.embedding, entries, shard), tok,
                         self.dtype, entries, self.cfg.vocab_size)
        new_caches = []
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x, cache, _ = blk.run(self.cfg, x, None, window, "decode",
                                  cache, pos, entries=entries, shard=shard)
            new_caches.append(cache)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x, entries, shard)[:, 0, :], new_caches

    # ---------- full sequence ----------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, V) of every position: the layers of the
        reference's `_run_layers_train`, then the final norm and head."""
        self._decoder("forward")
        entries, shard = self._entries(), sh.current_shard()
        x, positions = self._embed_inputs(tokens, entries, shard)
        x, _ = self.run_layers(x, positions, entries=entries, shard=shard)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x, entries, shard)

    def run_layers(self, x: torch.Tensor, positions: torch.Tensor,
                   moe_stats: Optional[List] = None,
                   entries: Optional[sh.Entries] = None,
                   shard: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layers in 'train' mode, the reference's `_run_layers_train`:
        (x, the MoE aux loss summed over layers over n_layers; 0 without
        MoE layers). With `cfg.remat`, while autograd records, each layer
        is a non-reentrant `torch.utils.checkpoint`: its activations are
        recomputed in the backward. With a `moe_stats` list, each MoE
        layer's (gsum, count) is appended to it in layer order, and the
        aux returned is 0. `entries` (passed, not read from the context,
        so that the recompute sees them too) shard each layer. The
        recompute stops early, once it has the last tensor the backward
        saved: where one process drives a layer's entries one after
        another, it then recomputes the last products of every entry
        but the last, which an entry on a device of its own (and the
        dry-run's one traced entry) skips. (A float32 partial product,
        bf16's, saves its inputs once it has run, so every recompute
        runs it.) Each layer gathers its FSDP leaves inside its
        checkpoint (`Block.run`, for `entries` or the data shard at mesh
        entry `shard`), so the gathered weights are not saved across
        layers and the recompute gathers them again."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        stats = moe_stats is not None
        for blk, window in zip(self.layers, self.windows):
            if remat:
                x, a = checkpoint(self._train_layer, blk, x, positions,
                                  window, stats, entries, shard,
                                  use_reentrant=False)
            else:
                x, a = self._train_layer(blk, x, positions, window, stats,
                                         entries, shard)
            if a is None:
                continue
            if stats:
                moe_stats.append(a)
            else:
                aux = aux + a
        return x, aux / max(self.cfg.n_layers, 1)

    def _train_layer(self, blk: Block, x: torch.Tensor,
                     positions: torch.Tensor, window: Optional[int],
                     stats: bool = False,
                     entries: Optional[sh.Entries] = None,
                     shard: Optional[int] = None):
        x, _, a = blk.run(self.cfg, x, positions, window, "train",
                          stats=stats, entries=entries, shard=shard)
        return x, a

    # ---------- train ----------
    def loss_fn(self, batch: Dict[str, torch.Tensor],
                denominator: Optional[torch.Tensor] = None,
                moe_stats: Optional[List] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's `loss_fn`. A decoder's batch holds `tokens` and
        `labels` (B, S) and may hold a `mask`: (CE + aux, {loss, ce,
        aux}). The encoder's holds `features` (B, T, feat_dim), `labels`
        and `mask`: (the masked CE over the real vocab, {loss}). With
        `denominator` (a float32 scalar), the CE is the (masked) sum over
        it: a data shard's part of a whole batch's mean, whose token count
        (or Σ mask, at least 1) `denominator` is. With a `moe_stats` list
        (see `run_layers`), the MoE layers' statistics are appended to it
        and the loss is the CE alone: the caller assembles the aux. Under
        `use_entries` the CE is vocab-parallel over the entries' blocks."""
        cfg = self.cfg
        entries, shard = self._entries(), sh.current_shard()
        if cfg.is_encoder:
            x = self._encoded(batch["features"], entries, shard)
            loss = self._cross_entropy(x, batch["labels"], batch["mask"],
                                       denominator, entries, shard)
            return loss, {"loss": loss}
        x, positions = self._embed_inputs(batch["tokens"], entries, shard)
        x, aux = self.run_layers(x, positions, moe_stats, entries, shard)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        ce = self._cross_entropy(x, batch["labels"], batch.get("mask"),
                                 denominator, entries, shard)
        loss = ce if moe_stats is not None else ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    # ---------- encoder ----------
    def encode(self, features: torch.Tensor) -> torch.Tensor:
        """features: (B, T, feat_dim) frame features -> logits (B, T, V):
        the reference's `encode`. The features are cast to the activation
        dtype and projected by `frontend.proj`; positions 0..T-1; the
        layers (bidirectional attention) as in `forward`."""
        entries, shard = self._entries(), sh.current_shard()
        return self._logits(self._encoded(features, entries, shard),
                            entries, shard)

    def _encoded(self, features: torch.Tensor,
                 entries: Optional[sh.Entries],
                 shard: Optional[int] = None) -> torch.Tensor:
        """The encoder's normed hidden states, before the head."""
        if not self.cfg.is_encoder:
            raise ValueError(f"{self.cfg.name} is a decoder: encode is the "
                             f"encoder's entry")
        feats = features.to(self.dtype)
        proj = self._leaf(self.frontend["proj"], entries, shard)
        x = torch.einsum("btf,fd->btd", feats, proj.to(self.dtype))
        b, t, _ = x.shape
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device).expand(b, t)
        x, _ = self.run_layers(x, positions, entries=entries, shard=shard)
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    # ---------- internals ----------
    def _decoder(self, entry: str) -> None:
        if self.cfg.is_encoder:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no "
                             f"{entry} (use encode)")

    def _entries(self) -> Optional[sh.Entries]:
        """The 'model' entries to drive (`sharding.use_entries`), checked
        against the config."""
        entries = sh.current_entries()
        if entries is None and sh.shards_over_model(sh.placed_mesh(self),
                                                    self.cfg):
            raise ValueError(f"{self.cfg.name} is placed on a mesh "
                             f"(sharding.place_model): run it under that "
                             f"mesh's steps")
        if entries is not None:
            if not sh.tp_family(self.cfg):
                raise ValueError(f"{self.cfg.name}: its MLA or SSM layers "
                                 f"do not shard over 'model'")
            sh.check_tp(self.cfg, entries.tp)
        return entries

    def _leaf(self, w, entries: Optional[sh.Entries],
              shard: Optional[int]):
        """A leaf as the data shard reads it (`sharding.fsdp_use`: an FSDP
        leaf gathered in the activation dtype)."""
        return sh.fsdp_use(w, dtype=self.dtype, entries=entries, shard=shard)

    def _embed_inputs(self, tokens: torch.Tensor,
                      entries: Optional[sh.Entries] = None,
                      shard: Optional[int] = None):
        x = embed_tokens(self._leaf(self.embedding, entries, shard), tokens,
                         self.dtype, entries, self.cfg.vocab_size)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        return x, positions

    def _table(self, entries: Optional[sh.Entries] = None,
               shard: Optional[int] = None):
        """The head's table (the embedding when tied), as the data shard
        reads it."""
        return self._leaf(self.embedding if self.cfg.tie_embeddings
                          else self.lm_head, entries, shard)

    def _logits(self, x: torch.Tensor,
                entries: Optional[sh.Entries] = None,
                shard: Optional[int] = None) -> torch.Tensor:
        if entries is None:
            return lm_logits(self._table(None, shard), x)
        v = self.cfg.vocab_size
        return sh.model_gather(lm_logit_blocks(self._table(entries), x,
                                               entries, v),
                               entries, v, "logits")

    def _cross_entropy(self, x, labels, mask, denominator, entries,
                       shard=None):
        cfg = self.cfg
        if entries is None:
            return cross_entropy(lm_logits(self._table(None, shard), x),
                                 labels, mask, cfg.real_vocab_size,
                                 denominator)
        v = cfg.vocab_size
        return cross_entropy_parallel(
            lm_logit_blocks(self._table(entries), x, entries, v), labels,
            entries, v, mask, cfg.real_vocab_size, denominator)
