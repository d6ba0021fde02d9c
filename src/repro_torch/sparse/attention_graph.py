"""LGRASS as a long-context attention sparsifier (beyond the paper).

The port of `repro.sparse.attention_graph`. Long-context attention over S
tokens is a dense graph over S/B blocks. `build_block_graph` weights the
block graph (sliding-window locality edges plus content chords from
mean-pooled block embeddings, in numpy: the same edges and weights as the
reference); `plan_block_mask` runs the port's `lgrass_sparsify` on it,
so on a CUDA device the radix, MARK and REC kernels, and keeps the
sparsifier's edges as a causal block mask. The spanning tree keeps every
block reachable; the spectrally critical chords keep the long-range
links. `block_sparse_attention` is the reference's dense masked attention
(two einsums, outside any kernel in the reference too), in fp32.

Both entry points that compute run on the CUDA device unless
`device="cpu"` is passed; without a CUDA device the default raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.sparsify import lgrass_sparsify, resolve_device


@dataclasses.dataclass
class BlockMaskPlan:
    n_blocks: int
    mask: np.ndarray        # (n_blocks, n_blocks) bool, causal, incl. diag
    kept_edges: int
    total_edges: int


def build_block_graph(block_feats: np.ndarray, window: int = 2,
                      n_chords_per_block: int = 4,
                      seed: int = 0) -> Graph:
    """block_feats: (NB, d) mean-pooled block embeddings (host numpy)."""
    nb, d = block_feats.shape
    f = block_feats / (np.linalg.norm(block_feats, axis=1, keepdims=True)
                       + 1e-6)
    sim = f @ f.T  # (NB, NB) cosine
    edges = {}
    # locality edges (always candidates, strongly weighted)
    for i in range(nb):
        for j in range(max(0, i - window), i):
            edges[(j, i)] = 2.0 + max(sim[i, j], 0.0)
    # content chords: top-k similar earlier blocks
    for i in range(nb):
        if i <= window:
            continue
        cand = sim[i, : max(i - window, 0)]
        top = np.argsort(-cand)[:n_chords_per_block]
        for j in top:
            key = (min(int(j), i), max(int(j), i))
            edges.setdefault(key, 1.0 + max(float(cand[j]), 0.0))
    u = np.array([a for a, _ in edges], np.int32)
    v = np.array([b for _, b in edges], np.int32)
    w = np.array(list(edges.values()), np.float32)
    g = Graph(n=nb, u=u, v=v, w=w)
    g.validate()
    return g


def plan_block_mask(block_feats: np.ndarray, keep_frac: float = 0.15,
                    window: int = 2, device=None) -> BlockMaskPlan:
    """LGRASS-sparsified causal block mask, planned on `device`."""
    g = build_block_graph(block_feats, window=window)
    budget = max(1, int(keep_frac * g.n))
    res = lgrass_sparsify(g, budget=budget, parallel=False,
                          device=resolve_device(device))
    nb = g.n
    mask = np.zeros((nb, nb), bool)
    np.fill_diagonal(mask, True)
    for eid in np.where(res.edge_mask)[0]:
        a, b = int(g.u[eid]), int(g.v[eid])
        lo, hi = min(a, b), max(a, b)
        mask[hi, lo] = True  # causal: later block attends to earlier
    return BlockMaskPlan(n_blocks=nb, mask=mask,
                         kept_edges=int(res.edge_mask.sum()),
                         total_edges=g.m)


def block_sparse_attention(q, k, v, mask_blocks, block: int,
                           device=None) -> torch.Tensor:
    """Exact attention restricted to allowed (q-block, k-block) pairs.

    q/k/v: (B, S, H, D) tensors or arrays; mask_blocks: (S/block,
    S/block) bool (causal). Dense with the mask, scores in fp32, on
    `device`; returns a (B, S, H, D) tensor in v's dtype there.
    """
    dev = resolve_device(device)
    q, k, v, mask_blocks = (torch.as_tensor(x, device=dev)
                            for x in (q, k, v, mask_blocks))
    b, s, h, d = q.shape
    scale = d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    tok_mask = mask_blocks.to(torch.bool).repeat_interleave(
        block, 0).repeat_interleave(block, 1)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    full = tok_mask & causal
    scores = torch.where(full[None, None], scores,
                         torch.full_like(scores, -1e9))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
