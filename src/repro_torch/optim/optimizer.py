"""AdamW and its learning-rate schedule: the port of `repro.optim.optimizer`.

The reference's arithmetic, written out in float32 tensors (not
`torch.optim.AdamW`, which orders its rounding differently): the schedule
and the bias corrections `b1 ** step` are float32 operations on the step,
as JAX computes them, not Python float64. Trees are flat dicts of
tensors keyed by parameter name (`train/train_step.make_train_state`);
the moments live beside the parameters on their device. Weight decay
applies to every leaf, norm scales included, as in the reference.

`global_norm` sums each leaf's squares in the dict's order; the
reference sums its pytree leaves in theirs (sorted keys, scan layers
stacked into one leaf), so the two norms can differ in the last bits.
A tree's leaves may lie on several devices: each leaf is updated on its
own, and the norm's partial sums and the step's scalars move to where
they are used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10% of peak, in float32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.peak_lr * (0.1 + 0.9 * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict:
    """mu and nu zeros like each parameter; step an int32 zero."""
    dev = next(iter(params.values())).device
    return dict(
        mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    on the first leaf's device."""
    dev = next(iter(tree.values())).device
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))).to(
        dev) for g in tree.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """grads scaled by min(1, max_norm / max(norm, 1e-9)), and the norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.device, g.dtype)
            for k, g in grads.items()}, gnorm


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: Dict,
                 cfg: OptConfig) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step (clipped grads, the step's lr), written into the
    parameters, moments and step counter in place (under
    torch.no_grad()), so a model that holds the parameters sees it.
    Returns (params, opt_state, {"lr", "grad_norm"}), the reference's
    triple, holding the updated tensors."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            p32 = p.to(torch.float32)
            lr_p, bc1_p, bc2_p = (x.to(p.device) for x in (lr, bc1, bc2))
            m = b1 * opt_state["mu"][k] + (1 - b1) * g
            v = b2 * opt_state["nu"][k] + (1 - b2) * torch.square(g)
            newp = p32 - lr_p * ((m / bc1_p)
                                 / (torch.sqrt(v / bc2_p) + cfg.eps)
                                 + cfg.weight_decay * p32)
            p.copy_(newp)
            opt_state["mu"][k].copy_(m)
            opt_state["nu"][k].copy_(v)
        opt_state["step"].copy_(step)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
