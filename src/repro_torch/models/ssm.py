"""Mamba2 / SSD layer of the port (arXiv:2405.21060): chunked train and
prefill, O(1) recurrent decode.

The port of `repro.models.ssm`, function for function, on torch tensors.
The SSD (state-space duality) form splits the sequence into chunks of Q:
inside a chunk the recurrence is a masked, attention-like product
(quadratic in Q); across chunks a small recurrence carries the (H, P, N)
state, a torch loop over S / Q steps with no host sync inside. The
reference has no Pallas kernel here and neither has the port: the SSD is
plain torch on every device.

The dtypes follow the reference step by step, since in bfloat16 they are
part of the function: dt and a are float32 (softplus of dtr + dt_bias,
-exp(A_log)); the C·B product and its weights w are float32, w cast to
x's dtype before the intra-chunk product; exp(cs_last - cs)·dt and
exp(cs) are cast to x's dtype before they scale x and the inter-chunk
term; the inter-chunk state is carried in x's dtype; the causal conv sums
in x's dtype tap by tap. Layouts: in_proj (d, 2·di + 2·G·N + H), conv_w
(K, conv_dim), out_proj (di, d).

Decode keeps the state (B, H, P, N) and a rolling conv window of the
last K - 1 inputs; the cache is updated in place:

    SSM:  {state: (B, H, P, N), conv: (B, K - 1, conv_dim)}
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_normal, rms_scale, rmsnorm


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h, p = cfg.ssm_nheads, cfg.ssm_headdim
    conv_dim = di + 2 * g * n
    d_in_proj = 2 * di + 2 * g * n + h
    return di, g, n, h, p, conv_dim, d_in_proj


def a_log_init(h: int) -> np.ndarray:
    """log(linspace(1, e, h)) rounded once to float32: A in [-e, -1]. The
    reference computes the same in float32 steps, which lands within an
    ulp of it."""
    return np.log(np.linspace(1.0, math.e, h)).astype(np.float32)


def init_ssm(cfg: ArchConfig, dtype: torch.dtype,
             generator: Optional[torch.Generator],
             device=None) -> Dict[str, torch.Tensor]:
    """in_proj (std d^-0.5), conv_w (std 0.1) and out_proj (std di^-0.5)
    drawn, or left empty without a generator; conv_b zeros, D ones (both
    in `dtype`, which the reference casts them to at use), and A_log,
    dt_bias (-2) and the norm scale in float32, as the reference reads
    them."""
    d = cfg.d_model
    di, g, n, h, p, conv_dim, d_in_proj = _dims(cfg)
    return dict(
        in_proj=init_normal((d, d_in_proj), d ** -0.5, dtype, generator,
                            device),
        conv_w=init_normal((cfg.ssm_conv, conv_dim), 0.1, dtype, generator,
                           device),
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=device),
        A_log=torch.as_tensor(a_log_init(h), device=device),
        D=torch.ones((h,), dtype=dtype, device=device),
        dt_bias=torch.full((h,), -2.0, dtype=torch.float32, device=device),
        norm=rms_scale(di, device),
        out_proj=init_normal((di, d), di ** -0.5, dtype, generator, device),
    )


def _split_in_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, _, _, _, _, conv_dim, _ = _dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di: di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width K over (B, S, C), then SiLU. carry:
    (B, K - 1, C), the previous inputs. Returns (out, new carry)."""
    k = conv_w.shape[0]
    s = xbc.shape[1]
    if carry is None:
        pad = torch.zeros(xbc.shape[:1] + (k - 1,) + xbc.shape[2:],
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = carry.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + full[:, i: i + s] * conv_w[i].to(xbc.dtype)
    out = out + conv_b.to(xbc.dtype)
    new_carry = full[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_carry


def _ssd_chunked(xh: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor, chunk: int):
    """SSD over chunks. xh: (B, S, H, P); bm, cm: (B, S, G, N); dt:
    (B, S, H) float32; a: (H,) negative float32. Returns y (B, S, H, P)
    and the final state (B, H, P, N), both in xh's dtype."""
    b, s, h, p = xh.shape
    q = chunk
    s_orig = s
    if s % q != 0:
        # pad to a chunk multiple with dt = 0 steps: their decay is
        # exp(0) = 1 and their update carries dt = 0, so the final state
        # is unaffected
        pad = q - s % q
        xh, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, bm, cm))
        dt = F.pad(dt, (0, 0, 0, pad))
        s = s + pad
    nc = s // q
    rep = h // bm.shape[2]

    def r4(t):  # (B, S, ...) -> (B, nc, q, ...)
        return t.reshape((b, nc, q) + tuple(t.shape[2:]))

    xh_, dtc = r4(xh), r4(dt)
    bmh = torch.repeat_interleave(r4(bm), rep, dim=3)    # (B, nc, q, H, N)
    cmh = torch.repeat_interleave(r4(cm), rep, dim=3)
    da = dtc * a.to(dtc.dtype)                           # (B, nc, q, H)
    da_cs = torch.cumsum(da, dim=2)                      # inclusive
    da_tot = da_cs[:, :, -1:, :]                         # (B, nc, 1, H)

    # intra-chunk: y_i += sum_{j<=i} C_i.B_j exp(cs_i - cs_j) dt_j x_j
    decay = torch.exp(da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :])
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], decay,
                        torch.zeros((), device=xh.device))  # (B,nc,q,q,H)
    cb = torch.einsum("bcihn,bcjhn->bcijh", cmh.to(torch.float32),
                      bmh.to(torch.float32))
    w = cb * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(xh_.dtype), xh_)

    # chunk summary states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    sdecay = torch.exp(da_tot - da_cs)                   # (B, nc, q, H)
    xw = xh_ * (sdecay * dtc)[..., None].to(xh_.dtype)
    chunk_states = torch.einsum("bcjhn,bcjhp->bchpn", bmh, xw)

    # inter-chunk recurrence: S_c' = S_{c-1}' exp(da_tot_c) + S_c
    decay_c = torch.exp(da_tot[:, :, 0, :])[:, :, :, None, None].to(
        xh.dtype)                                        # (B, nc, H, 1, 1)
    state = torch.zeros((b, h, p, bm.shape[3]), dtype=xh.dtype,
                        device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)  # the state before this chunk
        state = state * decay_c[:, c] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B, nc, H, P, N)

    # inter-chunk contribution: y_i += C_i . S_prev exp(cs_i)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", cmh, prev_states)
    y_inter = y_inter * torch.exp(da_cs)[..., None].to(y_inter.dtype)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], state


def _in_proj(params: Dict, cfg: ArchConfig, x: torch.Tensor):
    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"].to(x.dtype))
    return _split_in_proj(cfg, zxbcdt)


def _dt_a(params: Dict, dtr: torch.Tensor):
    """dt = softplus(dtr + dt_bias) and a = -exp(A_log), in float32."""
    dt = _softplus(dtr.to(torch.float32)
                   + params["dt_bias"].to(torch.float32))
    return dt, -torch.exp(params["A_log"].to(torch.float32))


def _gate_out(params: Dict, cfg: ArchConfig, y: torch.Tensor,
              z: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, params["out_proj"].to(x_dtype))


def ssm_forward(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence SSD (train / prefill). x: (B, S, d). With
    return_state, also the cache after the sequence:
    {state, conv}."""
    di, g, n, h, p, _, _ = _dims(cfg)
    z, xbc, dtr = _in_proj(params, cfg, x)
    xbc, conv_carry = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    b, s = xbc.shape[:2]
    xs = xbc[..., :di]
    bm = xbc[..., di: di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt, a = _dt_a(params, dtr)
    xh = xs.reshape(b, s, h, p)
    y, state = _ssd_chunked(xh, bm, cm, dt, a, cfg.ssm_chunk)
    y = y + xh * params["D"].to(y.dtype)[None, None, :, None]
    out = _gate_out(params, cfg, y.reshape(b, s, di), z, x.dtype)
    if return_state:
        return out, dict(state=state, conv=conv_carry)
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    _, _, n, h, p, conv_dim, _ = _dims(cfg)
    return dict(
        state=torch.zeros((batch, h, p, n), dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
    )


def ssm_fill_cache(cache: Dict, new: Dict) -> Dict:
    """Prefill: copy `ssm_forward(return_state=True)`'s state and conv
    window into the cache, in place."""
    cache["state"].copy_(new["state"])
    cache["conv"].copy_(new["conv"])
    return cache


def ssm_decode(params: Dict, cfg: ArchConfig, x: torch.Tensor,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent update. x: (B, 1, d). Updates the cache in
    place."""
    di, g, n, h, p, _, _ = _dims(cfg)
    z, xbc, dtr = _in_proj(params, cfg, x)
    xbc, conv_carry = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   carry=cache["conv"])
    b = xbc.shape[0]
    xs = xbc[..., :di]
    bm = xbc[..., di: di + g * n].reshape(b, g, n)
    cm = xbc[..., di + g * n:].reshape(b, g, n)
    dt, a = _dt_a(params, dtr[:, 0])                     # (B, H), (H,)
    xh = xs.reshape(b, h, p)
    bmh = torch.repeat_interleave(bm, h // g, dim=1)     # (B, H, N)
    cmh = torch.repeat_interleave(cm, h // g, dim=1)
    decay = torch.exp(dt * a[None, :])                   # (B, H)
    upd = torch.einsum("bhn,bhp->bhpn", bmh,
                       xh * dt[..., None].to(xh.dtype))
    state = cache["state"] * decay[:, :, None, None].to(xh.dtype) + upd
    y = torch.einsum("bhpn,bhn->bhp", state, cmh)
    y = y + xh * params["D"].to(y.dtype)[None, :, None]
    out = _gate_out(params, cfg, y.reshape(b, 1, di), z, x.dtype)
    return out, ssm_fill_cache(cache, dict(state=state, conv=conv_carry))
