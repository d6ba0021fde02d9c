"""Forward attention with masks from position vectors (flash attention).

The port of `repro.kernels.flash_attention.flash_attention_bhsd` with
the layout and GQA mapping of `repro.kernels.ops.flash_attention`: q
(B, Sq, H, d), k and v (B, Sk, Kv, d), query head h reading kv head
h // (H / Kv); qpos (Sq,) and kpos (Sk,) int32 positions, −1 marking
padding. For each query row the visible keys are

    kpos >= 0  ∧  (causal: kpos <= qpos)  ∧  (window: kpos > qpos − window),

the fp32 scores q·k are scaled by d**-0.5 after the product, masked
scores are −1e30, and the output is softmax(scores) · v in q's dtype. A
row with no visible key therefore averages v over all Sk keys, as both
the Pallas kernel and its jnp oracle do.

Two executions of the one function:

  * `flash_attention_cuda` launches a hand-written Hopper kernel on the
    tensors as they lie: q, k and v are read in the (B, S, H, d) layout
    through their strides (no transpose and no GQA repeat is made), the
    output is a new contiguous (B, Sq, H, d) tensor. `cuda_route` picks
    the kernel from the dtype and d: bfloat16 at d in `WGMMA_HEAD_DIMS`
    (64, 80, 96, 128) runs `csrc/flash_attention_sm90.cu` (wgmma, TMA, a
    warp-specialised pipeline; d cut into the swizzled slabs of
    `csrc/sm90.cuh`'s `Slabs<D>`, 16-column ones at d = 80), bfloat16 at
    d 16 and 32 `csrc/flash_attention.cu`'s mma.sync kernel, float32 that
    file's kernel on the CUDA cores in full fp32. It takes d in
    `HEAD_DIMS` and any Sq, Sk. Its launches are counted by route in
    `launches`;
  * `flash_attention_plain` is the plain PyTorch version, the formula of
    `repro.kernels.ref.flash_attention_ref`: fp32 scores, −1e30, softmax,
    P·V in fp32. Above `CHUNK_THRESHOLD` queries it works in chunks of
    `CHUNK` queries, as the reference's CPU attention bounds its memory.

`bf16_agreement` is the bound that the checks hold a bfloat16 output to.

`kernels/ops.py` picks between them by the tensors' device.

The launches are operators (`kernels/oplib.py`): `flash_fwd`,
`flash_fwd_lse` and `flash_bwd` in `torch.ops.repro_torch`, whose fakes
give meta tensors the outputs' shapes and whose FLOP formulas
(`torch.utils.flop_counter`) count what the plain version's products
count on the CPU: 4·B·H·Sq·Sk·d forward, 8·B·H·Sq·Sk·d for the
gradient, over the full square (`attention_flops`). That is the
reference's convention, not the kernels' work: they skip the masked
tiles, and the backward recomputes S. `WORK_FLOPS` gives each operator
both counts; the kernels' work (`pair_flops` over `visible_pairs`, with
`FWD_PRODUCTS` and `BWD_PRODUCTS`) is what a roofline divides by, and
what `chip_smoke.py`'s bounds and `launch/graph_analysis.py`'s
`flops_work` count.

The gradient. `FlashAttention` is the autograd function of the CUDA
path: its forward is `flash_attention_cuda`, which also writes each
row's LSE of the scaled scores (natural log units, +inf for a row with
no visible key) when an input needs a gradient, and its backward
`flash_attention_backward_cuda`, which takes that LSE (a missing one
raises: nothing recomputes it). `cuda_bwd_route` picks the backward's
kernels: bfloat16 at d in `WGMMA_HEAD_DIMS` runs
`csrc/flash_attention_bwd_sm90.cu` (dQ, then dK/dV, on wgmma with TMA
rings), bfloat16 at d 16 and 32 and float32 at every d
`csrc/flash_attention_bwd.cu` (Delta, dK/dV, dQ; mma.sync, or the CUDA
cores in fp32). Calls are counted by route in `bwd_launches`. It takes
the forward's dtypes and head dims, and raises on any other; there is
no fallback. The plain version needs no such function, since autograd
differentiates it; `flash_attention_backward_plain` is that gradient and
`flash_attention_lse_plain` that LSE, for the checks. Above
`_banded_swa`'s condition the plain version computes a causal window
banded, as the reference's CPU path does.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import oplib

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
# the bf16 head dims of the wgmma kernels, forward and backward alike
WGMMA_HEAD_DIMS = (64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# route -> the CUDA kernel it launches (a template over d)
ROUTES = {"wgmma": "flash_attention_wgmma_kernel",
          "mma": "flash_attention_mma_kernel",
          "fp32": "flash_attention_tile_kernel"}
# query chunking of the plain version (repro.models.attention:94-95)
CHUNK_THRESHOLD = 8192
CHUNK = 1024

# the bf16 agreement of the kernel with the plain version (bf16_agreement)
BF16_ATOL, BF16_RTOL, BF16_REL_L2 = 2e-3, 1e-2, 1e-2
BF16_MAX_ABS = 3e-2  # the reference's own bf16 tolerance, kept as a ceiling

# CUDA launches since the last reset (kernels/ops.py), by route
launches = dict.fromkeys(ROUTES, 0)
# the backward's routes -> the CUDA kernels one call launches, in order
BWD_ROUTES = {"wgmma": ("fa_bwd_dq_wgmma", "fa_bwd_dkv_wgmma"),
              "mma": ("fa_bwd_delta_kernel", "fa_bwd_dkv_mma_kernel",
                      "fa_bwd_dq_mma_kernel"),
              "fp32": ("fa_bwd_delta_kernel", "fa_bwd_dkv_f32_kernel",
                       "fa_bwd_dq_f32_kernel")}
# the kernels of the bf16 backward at the served head dims
BWD_KERNELS = BWD_ROUTES["wgmma"]
# backward calls since the last reset, by route
bwd_launches = dict.fromkeys(BWD_ROUTES, 0)
# query rows of the wgmma backward's tile summaries (its int4 scratch)
QTILE = 64


def cuda_route(dtype: torch.dtype, d: int) -> str:
    """Which CUDA kernel serves (dtype, head dim d): "wgmma", "mma" or
    "fp32" (a key of ROUTES)."""
    if dtype not in DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"no CUDA kernel for {dtype} at head_dim {d}")
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma"


def cuda_bwd_route(dtype: torch.dtype, d: int) -> str:
    """Which CUDA kernels compute the gradient at (dtype, head dim d): a
    key of BWD_ROUTES, the forward's route (`cuda_route`): bf16 at
    WGMMA_HEAD_DIMS takes the wgmma kernels; bf16 at 16 and 32 the
    mma.sync ones; float32 the CUDA cores'."""
    return cuda_route(dtype, d)


def visible_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                 window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query row sees."""
    qp, kp = qpos.to(torch.int64)[:, None], kpos.to(torch.int64)[None, :]
    mask = (kp >= 0).expand(qp.shape[0], kp.shape[1])
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    return mask


def _attend_plain(q, k, v, qpos, kpos, causal, window):
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32))
    s = s * (d ** -0.5)
    mask = visible_mask(qpos, kpos, causal, window)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                        device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def _banded_swa(q, k, v, window: int):
    """Causal sliding-window attention over positions 0..S-1 as a banded
    two-block computation, the reference's `_banded_swa`
    (repro.models.attention:113-141): each window-sized query chunk
    attends only to [the previous, its own] key chunks, O(S·2w) scores
    instead of O(S²). Exact where S % w == 0; fp32 scores and P·V in
    fp32, as `_attend_plain`."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g, w = h // kvh, window
    nw = s // w
    kc = k.reshape(b, nw, w, kvh, d).to(torch.float32)
    vc = v.reshape(b, nw, w, kvh, d).to(torch.float32)
    k2 = torch.cat([torch.roll(kc, 1, dims=1), kc], dim=2)
    v2 = torch.cat([torch.roll(vc, 1, dims=1), vc], dim=2)
    pq = torch.arange(s, dtype=torch.int64, device=q.device).reshape(nw, w)
    # chunk 0 has no previous chunk: its rolled positions are invalid
    prev = torch.roll(pq, 1, dims=0)
    prev[0] = -1
    pk = torch.cat([prev, pq], dim=1)                       # (nw, 2w)
    qg = q.reshape(b, nw, w, kvh, g, d).to(torch.float32)
    sc = torch.einsum("bnwkgd,bntkd->bnkgwt", qg, k2) * (d ** -0.5)
    qi, kj = pq[:, None, None, :, None], pk[:, None, None, None, :]
    mask = (kj >= 0) & (kj <= qi) & (kj > qi - w)
    sc = torch.where(mask, sc, torch.full((), NEG_INF, dtype=sc.dtype,
                                          device=sc.device))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bnkgwt,bntkd->bnwkgd", p, v2)
    return out.reshape(b, s, h, d).to(q.dtype)


def _banded(q, k, qpos, kpos, causal, window) -> bool:
    """The reference's condition for `_banded_swa` (causal, a window,
    S % w == 0, S >= 2w), on self-attention over positions 0..S-1."""
    s = q.shape[1]
    if not (causal and window is not None and k.shape[1] == s
            and s % window == 0 and s >= 2 * window):
        return False
    pos = torch.arange(s, dtype=torch.int64, device=qpos.device)
    return bool(torch.equal(qpos.to(pos.dtype), pos)
                and torch.equal(kpos.to(pos.dtype), pos))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          qpos: torch.Tensor, kpos: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version: q (B, Sq, H, d), k/v (B, Sk, Kv, d) → (B, Sq, H, d)
    in q's dtype; the query heads of a group share their kv head by a
    reshape, not a copy. A causal window over positions 0..S-1 under the
    reference's condition goes banded (`_banded_swa`), the same function
    at O(S·2w) memory."""
    if _banded(q, k, qpos, kpos, causal, window):
        return _banded_swa(q, k, v, window)
    sq = q.shape[1]
    if sq <= CHUNK_THRESHOLD:
        return _attend_plain(q, k, v, qpos, kpos, causal, window)
    return torch.cat([_attend_plain(q[:, i:i + CHUNK], k, v,
                                    qpos[i:i + CHUNK], kpos, causal, window)
                      for i in range(0, sq, CHUNK)], dim=1)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              qpos: torch.Tensor, kpos: torch.Tensor,
                              causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """(B, H, Sq) float32: each row's log-sum-exp, in natural log units,
    of the plain version's scores (fp32 q·k scaled by d**-0.5, −1e30 where
    not visible); +inf for a row with no visible key, the marker that
    the kernels write."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (d ** -0.5)
    mask = visible_mask(qpos, kpos, causal, window)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                        device=s.device))
    lse = torch.where(mask.any(-1), torch.logsumexp(s, dim=-1),
                      torch.full((), float("inf"), device=s.device))
    return lse.reshape(b, h, sq)


def bf16_agreement(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
                   causal: bool = True,
                   window: Optional[int] = None) -> dict:
    """How far a bfloat16 `out` of an engine that rounds p to bf16 before
    P·V (the kernel, and the reference's Pallas kernel) lies from the plain
    version, which does not. Each element is held to

        BF16_ATOL + BF16_RTOL·|plain| + 2^-7 · Σ p|v| / l :

    the fp32 sums' own differences near 0; one bf16 ulp of the output
    (at most 2^-7 of |x|); and twice the most that rounding each p (by at
    most 2^-8 of p) can move the output, Σ p|v| / l being the plain
    version on |v|. The whole is held to a relative L2 error of
    BF16_REL_L2, and no error may pass BF16_MAX_ABS. Returns the max abs error, `worst` (the largest error
    over its element's bound), the relative L2 error, the mean |plain|
    and `ok`."""
    want = flash_attention_plain(q, k, v, qpos, kpos, causal,
                                 window).float()
    spread = flash_attention_plain(q, k, v.abs(), qpos, kpos, causal,
                                   window).float()
    bound = BF16_ATOL + BF16_RTOL * want.abs() + 2 ** -7 * spread
    diff = (out.float() - want).abs()
    worst = float((diff / bound).max())
    rel = float(torch.linalg.vector_norm(diff)
                / torch.linalg.vector_norm(want))
    err = float(diff.max())
    return dict(max_abs_err=err, worst=worst, rel_l2=rel,
                mean_abs_want=float(want.abs().mean()),
                ok=worst <= 1.0 and rel <= BF16_REL_L2
                and err <= BF16_MAX_ABS)


def check_kernel_args(q, k, v, qpos, kpos, window) -> None:
    """Raise ValueError on shapes, dtypes or a window that the kernel
    does not take (devices aside)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, Sq, H, d) and k, v (B, Sk, Kv, d) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not taken by the kernel "
                         f"(takes {HEAD_DIMS})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{tuple(DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if qpos.shape != (sq,) or kpos.shape != (k.shape[1],):
        raise ValueError(f"qpos ({sq},) and kpos ({k.shape[1]},) expected, "
                         f"got {tuple(qpos.shape)}, {tuple(kpos.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _readable(x: torch.Tensor) -> bool:
    """Whether the kernel reads x in place: a unit stride on d and, for
    the bf16 kernels' 16-byte loads of 8 elements (and TMA's 16-byte
    strides), a 16-byte aligned start and positive strides in multiples of
    8 elements on the dims longer than 1."""
    if x.stride(-1) != 1:
        return False
    if x.dtype != torch.bfloat16:
        return True
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st % 8 == 0)
        for st, n in zip(x.stride()[:-1], x.shape[:-1]))


def _strides(x: torch.Tensor) -> tuple:
    """x's (batch, seq, head) element strides, a dim of length 1 given the
    stride of a packed tensor (its own stride is never used, and a tensor
    map takes only positive multiples of 16 bytes)."""
    (sb, ss, sh), (nb, ns, nh) = x.stride()[:3], x.shape[:3]
    sh = sh if nh > 1 else x.shape[3]
    ss = ss if ns > 1 else sh * nh
    sb = sb if nb > 1 else ss * ns
    return sb, ss, sh


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         qpos: torch.Tensor, kpos: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None,
                         return_lse: bool = False):
    """Launch the kernel that `cuda_route(q.dtype, d)` picks on the
    current stream of q's device, through its operator
    (`torch.ops.repro_torch.flash_fwd`, or `flash_fwd_lse` with
    return_lse). q (B, Sq, H, d), k/v (B, Sk, Kv, d), any strides with a
    unit stride on d (a tensor the kernel cannot read in place is copied);
    qpos (Sq,), kpos (Sk,) integer positions. Returns a contiguous
    (B, Sq, H, d) tensor; with return_lse, also the kernel's (B, H, Sq)
    float32 LSE of each row's scaled scores (natural log units, +inf for a
    row with no visible key; `flash_attention_lse_plain`). Meta tensors
    get the operator's fake."""
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("qpos", qpos),
                    ("kpos", kpos)):
        if x.device != dev or not oplib.on_card_route(x):
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{x.device}")
    check_kernel_args(q, k, v, qpos, kpos, window)
    q, k, v = (x if _readable(x) else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    qpos = qpos.to(torch.int32).contiguous()
    kpos = kpos.to(torch.int32).contiguous()
    op = FWD_LSE_OP if return_lse else FWD_OP
    return op(q, k, v, qpos, kpos, causal, window)


def _forward_launch(q, k, v, qpos, kpos, causal, window, return_lse):
    oplib.check_launchable("flash_attention", q, k, v, qpos, kpos)
    dev = q.device
    route = cuda_route(q.dtype, q.shape[3])
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return out, lse
    from repro_torch.kernels._build import library

    lib = library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    sizes = (b, h, kvh, sq, sk, d)
    tail = (int(causal), 0 if window is None else int(window),
            float(d ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if route == "wgmma":
            err = lib.flash_attention_wgmma_launch(
                *ptrs, *sizes, *_strides(q), *_strides(k), *_strides(v),
                *tail)
        else:
            err = lib.flash_attention_launch(
                *ptrs, DTYPES[q.dtype], *sizes, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *tail)
    if err == -1:
        raise RuntimeError("flash_attention: the driver refused a tensor "
                           "map of q, k or v")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches[route] += 1
    return out, lse


def _forward_fake(q, k, v, qpos, kpos, causal, window):
    return q.new_empty(q.shape)


def _forward_lse_fake(q, k, v, qpos, kpos, causal, window):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq),
                                             dtype=torch.float32)


def flash_attention_backward_plain(dout: torch.Tensor, q: torch.Tensor,
                                   k: torch.Tensor, v: torch.Tensor,
                                   qpos: torch.Tensor, kpos: torch.Tensor,
                                   causal: bool = True,
                                   window: Optional[int] = None) -> tuple:
    """(dq, dk, dv) of the plain version at (q, k, v) for the output
    gradient dout, by torch.autograd.grad under torch.enable_grad(): the
    yardstick of the backward kernel (not valid under inference_mode)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention_plain(*leaves, qpos, kpos, causal, window)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_backward_cuda(dout: torch.Tensor, q: torch.Tensor,
                                  k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, qpos: torch.Tensor,
                                  kpos: torch.Tensor, causal: bool = True,
                                  window: Optional[int] = None,
                                  lse: Optional[torch.Tensor] = None) -> tuple:
    """The gradient of `flash_attention_cuda` by the kernels that
    `cuda_bwd_route(q.dtype, d)` picks, launched in order on the current
    stream of q's device through their operator
    (`torch.ops.repro_torch.flash_bwd`; meta tensors get its fake): dout and out (B, Sq, H, d) and the forward's
    (B, H, Sq) float32 `lse` (`flash_attention_cuda(..., return_lse=True)`)
    beside the forward's inputs, each read through its strides (a tensor
    they cannot read in place is copied). Returns contiguous (dq, dk, dv)
    in q's dtype. A missing lse, or a dtype or head dim the kernels do
    not take, raises ValueError: nothing recomputes the LSE."""
    if lse is None:
        raise ValueError("flash_attention backward needs the forward's lse "
                         "(flash_attention_cuda(..., return_lse=True))")
    dev = q.device
    for name, x in (("dout", dout), ("q", q), ("k", k), ("v", v),
                    ("out", out), ("lse", lse), ("qpos", qpos),
                    ("kpos", kpos)):
        if x.device != dev or not oplib.on_card_route(x):
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{x.device}")
    check_kernel_args(q, k, v, qpos, kpos, window)
    b, sq, h, d = q.shape
    if (out.shape != q.shape or dout.shape != q.shape
            or out.dtype != q.dtype or dout.dtype != q.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must have q's "
                         f"shape and dtype, {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    q, k, v, out, dout = (x if _readable(x) else x.clone(
        memory_format=torch.contiguous_format)
        for x in (q, k, v, out, dout))
    return BWD_OP(dout, q, k, v, out, qpos.to(torch.int32).contiguous(),
                  kpos.to(torch.int32).contiguous(), lse.contiguous(),
                  causal, window)


def _backward_launch(dout, q, k, v, out, qpos, kpos, lse, causal, window):
    oplib.check_launchable("flash_attention backward", dout, q, k, v, out,
                           qpos, kpos, lse)
    dev = q.device
    b, sq, h, d = q.shape
    route = cuda_bwd_route(q.dtype, d)
    sk, kvh = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, kvh, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, sk, kvh, d), dtype=q.dtype, device=dev)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    from repro_torch.kernels._build import library

    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            lse.data_ptr(), delta.data_ptr()]
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (int(causal), 0 if window is None else int(window),
            float(d ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if route == "wgmma":
            # the kernels' int4 summaries of each 64-row query tile
            qtiles = torch.empty((b, h, -(-sq // QTILE), 4),
                                 dtype=torch.int32, device=dev)
            strides = [st for x in (q, k, v, out, dout) for st in _strides(x)]
            err = library().flash_attention_bwd_wgmma_launch(
                *ptrs, qtiles.data_ptr(), *outs, b, h, kvh, sq, sk, d,
                *strides, *tail)
        else:
            strides = [st for x in (q, k, v, out, dout)
                       for st in x.stride()[:3]]
            err = library().flash_attention_bwd_launch(
                *ptrs, *outs, DTYPES[q.dtype], b, h, kvh, sq, sk, d,
                *strides, *tail)
    if err == -1:
        raise RuntimeError("flash_attention backward: cuTensorMapEncodeTiled "
                           "refused a tensor map of q, k, v or dout")
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    bwd_launches[route] += 1
    return dq, dk, dv


def _backward_fake(dout, q, k, v, out, qpos, kpos, lse, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), k.new_empty(k.shape)


_FWD_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor qpos, Tensor kpos, "
             "bool causal, int? window")
FWD_OP = oplib.define(
    f"flash_fwd({_FWD_ARGS}) -> Tensor",
    lambda *a: _forward_launch(*a, False)[0], _forward_fake)
FWD_LSE_OP = oplib.define(
    f"flash_fwd_lse({_FWD_ARGS}) -> (Tensor, Tensor)",
    lambda *a: _forward_launch(*a, True), _forward_lse_fake)
BWD_OP = oplib.define(
    "flash_bwd(Tensor dout, Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor qpos, Tensor kpos, Tensor lse, bool causal, int? window) -> "
    "(Tensor, Tensor, Tensor)", _backward_launch, _backward_fake)


# the products that the kernels must compute per (query, key) pair: the
# forward's S = QKᵀ and O = PV; the backward's dP = dO Vᵀ, dV = PᵀdO,
# dQ = dS K and dK = dSᵀQ, and S again, since P is not kept
FWD_PRODUCTS = 2
BWD_PRODUCTS = 5


def pair_flops(q_shape, pairs: int, products: int) -> int:
    """2·d FLOP per product, (query, key) pair and query head."""
    b, _, h, d = q_shape
    return 2 * products * b * h * d * pairs


@functools.lru_cache(maxsize=None)
def visible_pairs(sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs that `visible_mask` leaves visible at the
    positions 0..sq-1 and 0..sk-1, the model's own: a meta tensor's
    positions hold no values to count."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(q - window + 1, 0) if window is not None
          else np.zeros(sq, dtype=np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(q_shape, k_shape, products: int) -> int:
    """2·B·H·Sq·Sk·d per product of two (Sq × d)·(d × Sk)-sized operands,
    over the full square whatever the mask, as torch's SDPA formula and
    the reference's HLO of its plain attention count."""
    return pair_flops(q_shape, q_shape[1] * k_shape[1], products)


@register_flop_formula([torch.ops.repro_torch.flash_fwd,
                        torch.ops.repro_torch.flash_fwd_lse])
def _forward_flops(q, k, *args, out_shape=None, **kwargs) -> int:
    """The forward: the two products S = QKᵀ and O = PV."""
    return attention_flops(q, k, 2)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _backward_flops(dout, q, k, *args, out_shape=None, **kwargs) -> int:
    """The gradient's four products, dV = PᵀdO, dP = dO Vᵀ, dQ = dS K and
    dK = dSᵀQ, as autograd of the plain version (and the reference's
    jitted gradient) computes them; the kernels also recompute S, which
    is not counted, so that the count is the same on every route."""
    return attention_flops(q, k, 4)


def _forward_counts(q, k, v, qpos, kpos, causal, window):
    return (attention_flops(q.shape, k.shape, 2),
            pair_flops(q.shape, visible_pairs(q.shape[1], k.shape[1],
                                              causal, window),
                       FWD_PRODUCTS))


def _backward_counts(dout, q, k, v, out, qpos, kpos, lse, causal, window):
    return (attention_flops(q.shape, k.shape, 4),
            pair_flops(q.shape, visible_pairs(q.shape[1], k.shape[1],
                                              causal, window),
                       BWD_PRODUCTS))


# operator -> f(its arguments) = (what its FLOP formula counts, the
# kernels' work)
WORK_FLOPS = {FWD_OP: _forward_counts, FWD_LSE_OP: _forward_counts,
              BWD_OP: _backward_counts}


class FlashAttention(torch.autograd.Function):
    """`flash_attention_cuda` with its gradient: the forward kernel, which
    writes each row's LSE only when q, k or v needs a gradient (serving
    writes none), and `flash_attention_backward_cuda` from the saved q, k,
    v, out, LSE and positions."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window):
        if any(ctx.needs_input_grad[:3]):
            out, lse = flash_attention_cuda(q, k, v, qpos, kpos, causal,
                                            window, return_lse=True)
        else:
            out, lse = flash_attention_cuda(q, k, v, qpos, kpos, causal,
                                            window), None
        ctx.save_for_backward(q, k, v, out, lse, qpos, kpos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            dout, q, k, v, out, qpos, kpos, ctx.causal, ctx.window, lse=lse)
        return dq, dk, dv, None, None, None, None
