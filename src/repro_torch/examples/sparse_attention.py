"""LGRASS as a long-context attention-mask planner (beyond the paper).

    PYTHONPATH=src python -m repro_torch.examples.sparse_attention
    PYTHONPATH=src python -m repro_torch.examples.sparse_attention --device cpu

The twin of the JAX package's `examples/sparse_attention.py`: a block
graph over S = 1,024 tokens (blocks of 32) goes through the LGRASS
pipeline, and block-sparse attention with its mask is compared with
dense attention: the mask's density and the dense attention mass it
covers, then the block graph's connectivity. It runs on the CUDA device
unless `--device` names another; without a CUDA device the default
raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.sparsify import resolve_device
from repro_torch.sparse.attention_graph import (block_sparse_attention,
                                                plan_block_mask)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    B, S, H, D = 1, 1024, 4, 64
    block = 32
    nb = S // block

    # token stream with locality + a few long-range dependencies
    x = rng.standard_normal((B, S, H * D)).astype(np.float32)
    x[:, 700:732] += x[:, 100:132] * 2.0  # long-range copy structure

    feats = x[0].reshape(nb, block, -1).mean(1)
    plan = plan_block_mask(feats, keep_frac=0.3, window=2, device=dev)
    density = plan.mask.sum() / (nb * (nb + 1) / 2)
    print(f"{nb}x{nb} block mask: kept {plan.kept_edges}/{plan.total_edges}"
          f" graph edges -> causal mask density {density:.2%}")

    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, D)),
                               dtype=torch.float32, device=dev)
               for _ in range(3))
    sparse = block_sparse_attention(q, k, v, plan.mask, block, device=dev)

    # how much of the *dense* attention probability mass the mask covers
    scale = D ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=dev))
    p_dense = torch.softmax(torch.where(causal, scores, -1e9), -1)
    mask = torch.as_tensor(plan.mask, device=dev)
    tok_mask = mask.repeat_interleave(block, 0).repeat_interleave(
        block, 1) & causal
    covered = float((p_dense * tok_mask[None, None]).sum() / p_dense.sum())
    print(f"attention mass covered by LGRASS mask: {covered:.1%} "
          f"at {density:.1%} of the compute")

    # connectivity guarantee: the kept block graph (incl. spanning tree)
    # is connected, so information can propagate between any two blocks
    adj = plan.mask | plan.mask.T
    seen = np.zeros(nb, bool)
    seen[0] = True
    frontier = [0]
    while frontier:
        nxt = []
        for a in frontier:
            for b in np.where(adj[a])[0]:
                if not seen[b]:
                    seen[b] = True
                    nxt.append(int(b))
        frontier = nxt
    print(f"block graph connected (spanning-tree guarantee): "
          f"{bool(seen.all())}")
    return dict(plan=plan, out=sparse, covered=covered,
                connected=bool(seen.all()))


if __name__ == "__main__":
    main()
