"""Attention of the port: GQA (RoPE, causal / bidirectional / sliding
window masks, a KV cache that is full or a ring of `window` slots) and
MLA (multi-head latent attention: a compressed latent cache and the
absorbed-matrix decode).

The port of `repro.models.attention`. Layouts follow the reference: GQA
wq (d, H, hd), wk and wv (d, Kv, hd), wo (H, hd, d); MLA q_a (d, r_q),
q_b (r_q, H, dn + dr), kv_a (d, r_kv + dr), kv_b (r_kv, H, dn + dv), wo
(H, dv, d); activations (B, S, H, hd).

Caches
------
GQA full:    {k, v: (B, S_max, Kv, hd), pos: (S_max,) abs positions (-1 empty)}
GQA window:  the same arrays with S_max = window, written mod window (ring).
MLA:         {ckv: (B, S_max, r_kv), krope: (B, S_max, dr), pos: (S_max,)}

Full-sequence attention (`gqa_attention`, train and prefill) goes through
`kernels/ops.flash_attention`: on a CUDA tensor the hand-written kernel
of `csrc/flash_attention.cu`, on a CPU tensor its plain version. Both
compute the function of the reference's `_masked_softmax_attend` (its
`use_flash=False` path) and of its Pallas kernel (`use_flash=True`); the
port has one engine per device, as its sorts and its spmv have. The
kernel also computes the reference's banded sliding-window path
(`_banded_swa`), the same function. MLA's prefill (`mla_attention`) goes
through the same kernel: it takes one head dim for q, k and v, so v is
zero-padded from dv to dn + dr and the output's first dv columns kept (a
zero column of v gives a zero column of the output and changes no
other); the kernel's scale d**-0.5 is the reference's (dn + dr)**-0.5.
Decode (`gqa_decode`, `mla_decode`) is plain torch against every cache
slot with a validity mask, as in the reference, which runs no kernel
there.

The caches are updated in place (`*_fill_cache`, `*_decode`): the
reference's functional updates would copy the whole cache every step.

Tensor parallelism on 'model': `gqa_attention`, `gqa_fill_cache` and
`gqa_decode` take a `HeadBlock` (`head_block(cfg, entry)`), and then
compute one mesh entry's part: its block of q heads [a, a + h) (wq,
and wo's rows), its kv heads (wk, wv and the cache hold the entry's
block of them where they shard, `sharding.kv_shards`, else all of
them, as the reference replicates them), and the output projection's
partial sum, which the caller adds over the entries. The q heads
[a, a + h) read kv heads a // g … (a + h − 1) // g, g = H / Kv: where g
divides h, h / g whole kv heads; where h divides g, one kv head with a
group of h (granite padded for 16-way TP: 32 / 8 heads, 2 q heads an
entry); otherwise the kv heads are repeated to the q heads before the
flash call (`HeadBlock.rep`). The weights are read through
`Entry.take`: of a placed model (`sharding.place_model`) a view of the
block the entry holds (wq, wo and, where kv heads shard, wk and wv),
of a whole leaf (wk and wv where they do not) the part cut and moved to
the entry's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as sh
from repro_torch.models.layers import (apply_rope, init_normal, rms_scale,
                                       rmsnorm)

NEG_INF = -1e9


def init_gqa(cfg: ArchConfig, dtype: torch.dtype,
             generator: Optional[torch.Generator],
             device=None) -> Dict[str, torch.Tensor]:
    """wq, wk, wv (std d^-0.5) and wo (std (H·hd)^-0.5), unfused: the
    reference's default (no `fused_qkv`). Empty on `device` without a
    generator."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    std = d ** -0.5
    return dict(
        wq=init_normal((d, h, hd), std, dtype, generator, device),
        wk=init_normal((d, kv, hd), std, dtype, generator, device),
        wv=init_normal((d, kv, hd), std, dtype, generator, device),
        wo=init_normal((h, hd, d), (h * hd) ** -0.5, dtype, generator,
                       device),
    )


@dataclasses.dataclass(frozen=True)
class HeadBlock:
    """One mesh entry's heads: `q` its q heads, `kv` the kv heads its
    weights and cache hold (its block, or all), `need` the kv heads its
    q heads read (global indices), and `rep` (or None) each q head's kv
    head within `need` where the kv heads must be repeated to the q
    heads (neither h nor g divides the other)."""

    entry: sh.Entry
    q: slice
    kv: slice
    need: slice
    rep: Optional[Tuple[int, ...]]


def head_block(cfg: ArchConfig, entry: sh.Entry) -> HeadBlock:
    """`entry`'s heads under `cfg` (see the module docstring)."""
    n_h, n_kv = cfg.n_heads, cfg.n_kv_heads
    g = n_h // n_kv
    q = entry.block(n_h)
    a, h = q.start, q.stop - q.start
    kv = entry.block(n_kv) if sh.kv_shards(cfg) else slice(0, n_kv)
    first, last = a // g, (a + h - 1) // g
    need = slice(first, last + 1)
    rep = None
    if h % g and g % h:
        rep = tuple((a + i) // g - first for i in range(h))
    return HeadBlock(entry, q, kv, need, rep)


def _proj(x: torch.Tensor, w: torch.Tensor,
          act: Optional[torch.dtype] = None) -> torch.Tensor:
    """x · w; where x is a float32 carrier of an `act` value (a column-
    parallel entry's input in training, `sharding.model_copy(...,
    wide=True)`), in `act` with a float32 gradient of x
    (`sharding.column_product`)."""
    if act is not None and x.dtype != act:
        return sh.column_product(x, w.to(act))
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _weights(params: Dict, cfg: ArchConfig, blk: Optional[HeadBlock],
             kv: str = "need") -> Dict[str, torch.Tensor]:
    """wq, wk, wv, wo whole, or the block's: q heads of wq and wo, and of
    wk and wv the kv heads `kv` names ('need' or 'kv'), each read by
    `Entry.take` (a view of the entry's own block of a placed leaf)."""
    if blk is None:
        return params
    e, n_h, n_kv = blk.entry, cfg.n_heads, cfg.n_kv_heads
    kvs = getattr(blk, kv)
    return dict(wq=e.take(params["wq"], 1, blk.q, n_h),
                wk=e.take(params["wk"], 1, kvs, n_kv),
                wv=e.take(params["wv"], 1, kvs, n_kv),
                wo=e.take(params["wo"], 0, blk.q, n_h))


def _qkv(params, x, act=None):
    return tuple(_proj(x, params[w], act) for w in ("wq", "wk", "wv"))


def _out(params, out: torch.Tensor,
         blk: Optional[HeadBlock] = None) -> torch.Tensor:
    """The output projection; a block's is its partial
    (`sharding.partial_product`: float32 below float32)."""
    if blk is None or out.dtype == torch.float32:
        return torch.einsum("bshk,hkd->bsd", out,
                            params["wo"].to(out.dtype))
    b, s, h, k = out.shape
    return sh.partial_product(out.reshape(b, s, h * k),
                              params["wo"].reshape(h * k, -1))


def _repeat(blk: Optional[HeadBlock], k: torch.Tensor) -> torch.Tensor:
    """k (B, S, n, hd) over the block's needed kv heads, repeated to its q
    heads where `rep` asks."""
    if blk is None or blk.rep is None:
        return k
    return k[:, :, list(blk.rep)]


def gqa_attention(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  blk: Optional[HeadBlock] = None,
                  act: Optional[torch.dtype] = None) -> torch.Tensor:
    """Self-attention over full sequences (train / prefill). x: (B, S, d);
    positions: (B, S), the same row for every sequence (0..S-1). With
    `blk`, the entry's heads and its partial output (to be summed over
    the entries); with `act`, x may be a float32 carrier of an `act`
    value (`_proj`)."""
    w = _weights(params, cfg, blk)
    q, k, v = _qkv(w, x, act)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pos = positions[0].to(torch.int32)
    out = kops.flash_attention(q, _repeat(blk, k), _repeat(blk, v),
                               causal=causal, window=window, qpos=pos,
                               kpos=pos)
    return _out(w, out, blk)


def init_gqa_cache(cfg: ArchConfig, batch: int, max_len: int,
                   window: Optional[int], dtype: torch.dtype,
                   device=None,
                   blk: Optional[HeadBlock] = None) -> Dict[str, torch.Tensor]:
    """The cache of all kv heads, or of the ones `blk` holds."""
    slots = min(window, max_len) if window else max_len
    hd = cfg.resolved_head_dim
    n_kv = cfg.n_kv_heads if blk is None else blk.kv.stop - blk.kv.start
    return dict(
        k=torch.zeros((batch, slots, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, slots, n_kv, hd), dtype=dtype, device=device),
        pos=torch.full((slots,), -1, dtype=torch.int32, device=device),
    )


def gqa_fill_cache(params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: Dict,
                   window: Optional[int],
                   blk: Optional[HeadBlock] = None) -> Dict:
    """Prefill: write K/V of a full prompt into the cache (the last
    `slots` positions of a ring), in place; with `blk`, the kv heads the
    entry's cache holds."""
    w = _weights(params, cfg, blk, "kv")
    k = apply_rope(_proj(x, w["wk"]), positions, cfg.rope_theta)
    v = _proj(x, w["wv"])
    slots = cache["k"].shape[1]
    s = k.shape[1]
    if window:
        take = min(s, slots)
        pos = positions[0, -take:]
        idx = (pos % slots).long()
        cache["k"][:, idx] = k[:, -take:]
        cache["v"][:, idx] = v[:, -take:]
        cache["pos"][idx] = pos.to(torch.int32)
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:s] = positions[0].to(torch.int32)
    return cache


def gqa_decode(params: Dict, cfg: ArchConfig, x: torch.Tensor, pos: int,
               cache: Dict, window: Optional[int],
               blk: Optional[HeadBlock] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence. x: (B, 1, d); pos: its absolute position.
    Writes the token's K/V into the cache in place, then attends over
    every slot with the mask (slot filled) ∧ (pos' <= pos) [∧ window].
    Without a window, a position past the cache's end raises ValueError
    (the reference clamps the write and overwrites the last slot). With
    `blk`, the entry's heads against its cache, and its partial
    output."""
    slots = cache["k"].shape[1]
    if not window and not 0 <= pos < slots:
        raise ValueError(f"decode at position {pos} is past the end of a "
                         f"cache of max_len {slots}")
    hd = cfg.resolved_head_dim
    w = _weights(params, cfg, blk, "kv")
    q, k, v = _qkv(w, x)
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % slots if window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = pos
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    if blk is not None:        # the kv heads the block's q heads read
        lo = blk.need.start - blk.kv.start
        kc = _repeat(blk, kc[:, :, lo:lo + blk.need.stop - blk.need.start])
        vc = _repeat(blk, vc[:, :, lo:lo + blk.need.stop - blk.need.start])

    b, _, h, _ = q.shape
    n_kv = kc.shape[2]
    g = h // n_kv
    # fp32 scores of the cache's dtype values (preferred_element_type=f32)
    qg = q.reshape(b, 1, n_kv, g, hd).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          kc.to(torch.float32)) * (hd ** -0.5)
    valid = (pc >= 0) & (pc <= pos)
    if window is not None:
        valid = valid & (pc > pos - window)
    scores = torch.where(valid, scores, torch.full((), NEG_INF,
                                                   device=scores.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(vc.dtype), vc)
    y = _out(w, out.reshape(b, 1, h, hd), blk)
    return y, cache


# ======================= MLA =======================
def init_mla(cfg: ArchConfig, dtype: torch.dtype,
             generator: Optional[torch.Generator],
             device=None) -> Dict[str, torch.Tensor]:
    """q_a, q_b, kv_a, kv_b and wo with the reference's stds (each
    fan-in^-0.5), the two latent norms float32 ones. Empty on `device`
    without a generator."""
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def w(shape, std):
        return init_normal(shape, std, dtype, generator, device)

    return dict(
        q_a=w((d, rq), d ** -0.5),
        q_a_norm=rms_scale(rq, device),
        q_b=w((rq, h, dn + dr), rq ** -0.5),
        kv_a=w((d, rkv + dr), d ** -0.5),
        kv_a_norm=rms_scale(rkv, device),
        kv_b=w((rkv, h, dn + dv), rkv ** -0.5),
        wo=w((h, dv, d), (h * dv) ** -0.5),
    )


def _mla_qkv_latent(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor):
    """q's low-rank projection, RMSNorm and q_b, RoPE on its last dr
    columns; kv_a split into the RMS-normed latent and the roped shared
    key. Returns q_nope (B, S, H, dn), q_rope (B, S, H, dr), ckv
    (B, S, r_kv), k_rope (B, S, dr)."""
    dt = x.dtype
    dn, rkv = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = torch.einsum("bsd,dr->bsr", x, params["q_a"].to(dt))
    cq = rmsnorm(cq, params["q_a_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhe->bshe", cq, params["q_b"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = torch.einsum("bsd,dr->bsr", x, params["kv_a"].to(dt))
    ckv = rmsnorm(ckv_full[..., :rkv], params["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., rkv:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_attend(q, k, v, scale, qpos, kpos, causal, dt):
    """The reference's plain formula: q, k (B, S, H, e), v (B, T, H, dv);
    fp32 scores, softmax, P·V in `dt`."""
    scores = torch.einsum("bshe,bthe->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        visible = kpos[:, None, :] <= qpos[:, :, None]
        scores = torch.where(visible[:, None], scores,
                             torch.full((), NEG_INF, device=scores.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthe->bshe", p.to(dt), v)


def _mla_qkv(params: Dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """Per-head q = [q_nope, q_rope], k = [k_nope, k_rope broadcast over
    heads] (B, S, H, dn + dr) and v (B, S, H, dv)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(params, cfg, x, positions)
    kv = torch.einsum("bsr,rhe->bshe", ckv, params["kv_b"].to(x.dtype))
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v


def mla_attention(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """MLA over full sequences (train / prefill) through the flash kernel
    (`kernels/ops.flash_attention`), v zero-padded to the qk head dim on
    every device (see the module docstring). x: (B, S, d); positions:
    (B, S), the same row for every sequence."""
    dv = cfg.v_head_dim
    q, k, v = _mla_qkv(params, cfg, x, positions)
    e = q.shape[-1]
    if dv > e:
        raise ValueError(f"v_head_dim {dv} above the qk head dim {e}: the "
                         f"kernel takes one head dim for q, k and v")
    v = torch.nn.functional.pad(v, (0, e - dv))
    pos = positions[0].to(torch.int32)
    out = kops.flash_attention(q, k, v, causal=causal, qpos=pos,
                               kpos=pos)[..., :dv]
    return torch.einsum("bshe,hed->bsd", out, params["wo"].to(x.dtype))


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return dict(
        ckv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
        krope=torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                          dtype=dtype, device=device),
        pos=torch.full((max_len,), -1, dtype=torch.int32, device=device),
    )


def mla_fill_cache(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: Dict) -> Dict:
    """Prefill: write the prompt's latent and rope key into the cache, in
    place."""
    _, _, ckv, k_rope = _mla_qkv_latent(params, cfg, x, positions)
    s = ckv.shape[1]
    cache["ckv"][:, :s] = ckv
    cache["krope"][:, :s] = k_rope
    cache["pos"][:s] = positions[0].to(torch.int32)
    return cache


def mla_decode(params: Dict, cfg: ArchConfig, x: torch.Tensor, pos: int,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matrix decode of one token per sequence (x: (B, 1, d)):
    the scores live in latent space, the per-head key and value
    expansions fold into q and the output projection. Writes the token's
    latent into the cache in place; a position past the cache's end
    raises ValueError (the reference clamps the write)."""
    slots = cache["ckv"].shape[1]
    if not 0 <= pos < slots:
        raise ValueError(f"decode at position {pos} is past the end of a "
                         f"cache of max_len {slots}")
    dt = x.dtype
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(params, cfg, x, posb)
    cache["ckv"][:, pos] = ckv[:, 0]
    cache["krope"][:, pos] = k_rope[:, 0]
    cache["pos"][pos] = pos
    c, r, pc = cache["ckv"], cache["krope"], cache["pos"]
    kv_b = params["kv_b"].to(dt)
    # absorb k_nope's expansion into q: q_lat = q_nope W_k^T per head
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, kv_b[..., :dn])
    # fp32 scores of the cache's dtype values (preferred_element_type=f32)
    c32 = c.to(torch.float32)
    scores = torch.einsum("bshr,btr->bhst", q_lat.to(torch.float32), c32)
    scores = scores + torch.einsum("bshe,bte->bhst",
                                   q_rope.to(torch.float32),
                                   r.to(torch.float32))
    scores = scores * ((dn + dr) ** -0.5)
    valid = (pc >= 0) & (pc <= pos)
    scores = torch.where(valid, scores, torch.full((), NEG_INF,
                                                   device=scores.device))
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", p.to(dt), c)
    out = torch.einsum("bshr,rhe->bshe", o_lat, kv_b[..., dn:])
    y = torch.einsum("bshe,hed->bsd", out, params["wo"].to(dt))
    return y, cache
