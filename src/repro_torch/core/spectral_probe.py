"""Solver-free effective-resistance estimation (after SF-GRASS,
arXiv:2008.07633): spectral quality at sizes the dense oracle cannot
reach.

The port of `repro.core.spectral_probe`. The estimator sketches the edge
dimension with P Rademacher probes ξ_p ∈ {±1}^m, lifts them to nodes
(y_p = Bᵀ W^{1/2} ξ_p), and runs k rounds of weighted-Jacobi or
Chebyshev iteration on L x_p = y_p, one spmv per round. Then

    R̂(a, b) = (1/P) Σ_p (x_p[a] − x_p[b])²,     E_ξ[R̂] → R as k → ∞.

Both iterations are polynomial filters p_k(λ) ≈ 1/λ on the
degree-normalised spectrum [0, 2] whose residual stays in [0, 1], so the
estimate is finite on any input, disconnected forests included.
Truncation only underestimates R; the probes add relative noise
~ sqrt(2/P) per edge. The reference's docstring has the derivation.

On a CUDA device every scatter of the estimator (the lift, the degree,
each spmv) is a kernel of `csrc/spmv.cu` on a CSR of arcs built once
per call (`build_arc_csr`, `laplacian_operator`): an ordered sum, so a run is
deterministic and its scatters equal the CPU's bit for bit. R̂ itself is
equal across devices up to the order of the final sum over P.

Differences of form from the reference:

  * probes: `xi=` takes an explicit (m, P) ±1 float32 matrix in place of
    `key=` (torch cannot draw `jax.random.rademacher`'s bits); `seed=`
    draws ξ from a CPU `torch.Generator`, then moves it to the device,
    so a CPU run and a CUDA run with the same seed use the same probes;
  * there is no `use_spmv_kernel` knob: one spmv engine per device;
  * the entry points run on the CUDA device unless the caller passes
    `device="cpu"`, and raise without one.

The Chebyshev scalars stay float32, computed on the host as numpy
scalars, as the reference keeps them float32 in its loop carry.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.sort import radix_argsort_u32
from repro_torch.core.sparsify import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.spmv import ArcCSR, LaplacianOperator

# spectrum of D^{-1} L lives in [0, 2]; the filters are built for it
LAM_MAX = 2.0
INT32_MAX = 2 ** 31 - 1


def auto_lam_min(n_iters: int) -> float:
    """Smallest eigenvalue k Chebyshev rounds can resolve: the interval
    [α, 2] with k·sqrt(2α) ≈ 4 keeps T_k(θ/δ) ≈ cosh(4), i.e. the
    residual uniformly ≲ 0.07 on [α, 2]."""
    return min(0.5, 8.0 / float(max(n_iters, 1)) ** 2)


def _masked_weight(w: torch.Tensor,
                   edge_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """float32 weights with padding slots zeroed."""
    if edge_valid is not None:
        w = torch.where(edge_valid, w, torch.zeros_like(w))
    return w.to(torch.float32)


def _div(t: torch.Tensor, s) -> torch.Tensor:
    """t / s for a host float32 scalar s, as a true division on every
    device (CUDA divides by a host scalar as a product with its
    reciprocal, which rounds differently)."""
    return t / torch.tensor(np.float32(s), device=t.device)


def build_arc_csr(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  n: int) -> ArcCSR:
    """CSR of the arcs [u-arcs; v-arcs] in a stable ascending sort by
    tail, from the port's radix argsort (the `radix_hist` kernel on a
    CUDA device): node a's arcs are its u-arcs in edge order, then its
    v-arcs in edge order, the order of the plain version's two
    scatters."""
    m = u.shape[0]
    if 2 * m > INT32_MAX or n + 1 > INT32_MAX:
        raise ValueError(f"n={n}, m={m}: arc indices must fit int32")
    u, v = u.to(torch.int64), v.to(torch.int64)
    tail = torch.cat([u, v])
    order = radix_argsort_u32(tail)
    counts = torch.bincount(tail, minlength=n)
    rowptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
    return ArcCSR(rowptr=rowptr.to(torch.int32),
                  arc=order.to(torch.int32),
                  other=torch.cat([v, u])[order].to(torch.int32),
                  w_arc=torch.cat([w, w]).to(torch.float32)[order],
                  n=n, m=m)


def laplacian_operator(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       n: int) -> LaplacianOperator:
    """L of (u, v, w) on n nodes, prepared once for many products: on a
    CUDA device the arc CSR is built here (one stable radix sort) and
    each product is one kernel launch; on the CPU each is the plain
    version."""
    csr = build_arc_csr(u, v, w, n) if w.device.type == "cuda" else None
    return ops.laplacian_operator(u, v, w, n, csr)


def weighted_degree(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    n: int,
                    edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) float32 weighted degrees (padding edges contribute 0)."""
    return laplacian_operator(u, v, _masked_weight(w, edge_valid),
                              n).degree()


def laplacian_spmv(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, *,
                   edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = L x for x: (n, P). Padding edges carry zero weight, so they
    contribute exactly nothing."""
    return laplacian_operator(u, v, _masked_weight(w, edge_valid),
                              x.shape[0])(x)


def _solve_jacobi(spmv, dinv, y, n_iters: int, omega) -> torch.Tensor:
    """x ← x + ω D⁻¹ (y − L x), x₀ = 0: residual filter (1 − ωλ̃)^k."""
    om = np.float32(omega)
    x = torch.zeros_like(y)
    for _ in range(n_iters):
        x = x + om * dinv[:, None] * (y - spmv(x))
    return x


def _solve_cheby(spmv, dinv, y, n_iters: int, lam_min) -> torch.Tensor:
    """Chebyshev iteration on D⁻¹L x = D⁻¹y over [lam_min, LAM_MAX]
    (Saad, Alg. 12.1), with float32 scalars computed on the host."""
    f32 = np.float32
    lam_min = f32(lam_min)
    theta = f32(0.5) * (f32(LAM_MAX) + lam_min)
    delta = f32(0.5) * (f32(LAM_MAX) - lam_min)
    sigma1 = theta / delta
    c = dinv[:, None] * y
    x, r, d, rho = torch.zeros_like(c), c, _div(c, theta), f32(1.0) / sigma1
    for _ in range(n_iters):
        x = x + d
        r = r - dinv[:, None] * spmv(d)
        rho_new = f32(1.0) / (f32(2.0) * sigma1 - rho)
        d = rho_new * rho * d + (f32(2.0) * rho_new / delta) * r
        rho = rho_new
    return x


def _tensor(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array or tensor as a tensor of `dtype` on `dev`."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(device=dev, dtype=dtype)


def _rademacher(m: int, n_probes: int, seed: int) -> torch.Tensor:
    """(m, P) float32 ±1 probes from a CPU generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    bits = torch.randint(0, 2, (m, n_probes), generator=gen)
    return (bits * 2 - 1).to(torch.float32)


def _probe_er(u, v, wm, qu, qv, xi, omega, lam_min, n: int, n_iters: int,
              method: str) -> torch.Tensor:
    """The device program: lift → k spmv rounds → R̂ gathers."""
    op = laplacian_operator(u, v, wm, n)
    y = op.lift(torch.sqrt(wm)[:, None] * xi)          # Bᵀ W^{1/2} ξ
    deg = op.degree()
    dinv = torch.where(deg > 0.0, 1.0 / deg, torch.zeros_like(deg))
    if method == "jacobi":
        x = _solve_jacobi(op, dinv, y, n_iters, omega)
    else:
        x = _solve_cheby(op, dinv, y, n_iters, lam_min)
    d = x[qu] - x[qv]                                  # (Lq, P)
    return _div(torch.sum(d * d, dim=1, dtype=torch.float32), xi.shape[1])


def probe_edge_resistance(
    u,
    v,
    w,
    n: int,
    qu=None,
    qv=None,
    *,
    n_probes: int = 64,
    n_iters: int = 64,
    method: str = "cheby",
    omega: float = 2.0 / 3.0,
    lam_min: Optional[float] = None,
    seed: int = 0,
    xi=None,
    edge_valid=None,
    device=None,
) -> torch.Tensor:
    """Solver-free approximate effective resistances R̂(qu_i, qv_i), an
    (Lq,) float32 tensor on the device.

    Queries default to the graph's own edge list. `method` picks the
    filter: "cheby" (default) or "jacobi" (`omega` is its damping).
    `lam_min` bounds the Chebyshev interval from below (None →
    `auto_lam_min(n_iters)`). Probes: `xi`, an (m, P) ±1 float32 matrix,
    if given (P then overrides `n_probes`); else drawn from `seed`. With
    `edge_valid`, padding slots carry zero weight everywhere and R̂ is
    returned for every query slot (a padded query, node 0 against
    itself, gives 0.0); ξ is drawn at the padded shape (L_pad, P), as in
    the reference. Arrays may be numpy or torch; `device` is where the
    estimator runs (the CUDA device by default; it raises without one).
    """
    if method not in ("cheby", "jacobi"):
        raise ValueError(f"unknown probe method {method!r}")
    dev = resolve_device(device)
    u, v = _tensor(u, dev, torch.int64), _tensor(v, dev, torch.int64)
    w = _tensor(w, dev, torch.float32)
    qu = u if qu is None else _tensor(qu, dev, torch.int64)
    qv = v if qv is None else _tensor(qv, dev, torch.int64)
    if edge_valid is not None:
        edge_valid = _tensor(edge_valid, dev, torch.bool)
    m = u.shape[0]
    if xi is None:
        xi = _rademacher(m, int(n_probes), seed)
    xi = _tensor(xi, dev, torch.float32)
    if xi.dim() != 2 or xi.shape[0] != m:
        raise ValueError(f"xi must be (m={m}, P), got {tuple(xi.shape)}")
    if lam_min is None:
        lam_min = auto_lam_min(n_iters)
    return _probe_er(u, v, _masked_weight(w, edge_valid), qu, qv, xi,
                     omega, lam_min, int(n), int(n_iters), method)


def probe_edge_resistance_batched(
    u,
    v,
    w,
    edge_valid,
    n: int,
    *,
    n_probes: int = 64,
    n_iters: int = 64,
    method: str = "cheby",
    omega: float = 2.0 / 3.0,
    lam_min: Optional[float] = None,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """`probe_edge_resistance` over a padded batch: (B, L_max) edge
    arrays in, (B, L_max) per-edge R̂ out. Lane i is bit-identical to a
    single call on the same padded arrays with seed `seed + i` (it is
    that call: lanes run one after another)."""
    return torch.stack([probe_edge_resistance(
        u[i], v[i], w[i], n, n_probes=n_probes, n_iters=n_iters,
        method=method, omega=omega, lam_min=lam_min, seed=seed + i,
        edge_valid=edge_valid[i], device=device)
        for i in range(len(u))])


def probe_criticality(w: torch.Tensor, r_hat: torch.Tensor) -> torch.Tensor:
    """Solver-free criticality proxy w(e) · R̂(u, v)."""
    w = torch.as_tensor(w, device=r_hat.device)
    return w.to(torch.float32) * r_hat


def trace_similarity(w: torch.Tensor, r_hat: torch.Tensor,
                     mask=None) -> torch.Tensor:
    """Approximate tr(L_G⁺ L_H) = Σ_{e ∈ H} w_e R_G(u_e, v_e), with H
    the `mask`-selected subgraph and R̂ estimated once on G. A 0-d
    float32 tensor in [0, n − #components]; equality at H = G; larger
    is spectrally closer; a lower bound on the true trace in
    expectation."""
    terms = probe_criticality(w, r_hat)
    if mask is not None:
        mask = torch.as_tensor(mask, device=r_hat.device).to(torch.bool)
        terms = torch.where(mask, terms, torch.zeros_like(terms))
    return torch.sum(terms, dtype=torch.float32)
