"""Quickstart: sparsify a power-grid-style graph with LGRASS on the GPU
and check that the output is bit-identical to the baseline program's.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The twin of the JAX package's `examples/quickstart.py`: the same graph
and the same call (k_cap=8, parallel=False, a depth-bounded lifting
table). It runs on the CUDA device unless `--device` names
another; without a CUDA device the default raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (baseline_sparsify, lgrass_sparsify,
                              powergrid_like_graph)
from repro_torch.core.sparsify import resolve_device


def _timed(fn, dev):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None) -> bool:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    dev = resolve_device(parser.parse_args(argv).device)

    # a ~1.6K-node power-grid-like case (official cases are 4K/7K/16K)
    g = powergrid_like_graph(40, 0.25, seed=0)
    print(f"graph: {g.n} nodes, {g.m} edges; device {dev}")

    # the reference example's call; parallel=False picks the basic engine
    # under schedule="scan", and the default chunked schedule ignores it
    def run():
        return lgrass_sparsify(g, k_cap=8, parallel=False,
                               auto_lift_bound=True, device=dev)

    _, t_first = _timed(run, dev)
    result, t_lgrass = _timed(run, dev)  # steady state
    print(f"LGRASS: kept {int(result.edge_mask.sum())}/{g.m} edges "
          f"({result.n_accepted} off-tree) in {t_lgrass * 1e3:.1f} ms "
          f"steady-state ({t_first:.1f} s incl. the first call; "
          f"{result.n_groups} marking groups)")

    base, t_base = _timed(lambda: baseline_sparsify(g), torch.device("cpu"))
    print(f"baseline semantics (host python/numpy): {t_base * 1e3:.1f} ms")

    identical = np.array_equal(base.edge_mask, result.edge_mask)
    print(f"outputs identical: {identical}")
    if not identical:
        raise SystemExit("the LGRASS mask differs from the baseline's")
    return identical


if __name__ == "__main__":
    main()
