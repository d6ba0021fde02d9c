"""Batched sparsification: many graphs through the bucketing service.

    PYTHONPATH=src python -m repro_torch.examples.batch_sparsify
    PYTHONPATH=src python -m repro_torch.examples.batch_sparsify --device cpu

The twin of the JAX package's `examples/batch_sparsify.py`: the same
mixed-size request batch and the same call (`SparsifyService(
parallel=False)`), with every result checked bit-identical to a single
`lgrass_sparsify` call. It runs on the CUDA device unless `--device`
names another; without a CUDA device the default raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import lgrass_sparsify
from repro_torch.core.graph import powergrid_like_graph, random_connected_graph
from repro_torch.core.sparsify import resolve_device
from repro_torch.serve.sparsify_service import SparsifyService


def main(argv=None) -> bool:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    graphs = []
    for i in range(12):
        if i % 3 == 0:
            graphs.append(powergrid_like_graph(int(rng.integers(5, 9)),
                                               0.3, seed=i))
        else:
            n = int(rng.integers(24, 64))
            graphs.append(random_connected_graph(n, 2 * n, seed=i))
    print(f"request batch: {len(graphs)} graphs, "
          f"n in [{min(g.n for g in graphs)}, {max(g.n for g in graphs)}], "
          f"L in [{min(g.m for g in graphs)}, {max(g.m for g in graphs)}]; "
          f"device {dev}")

    # parallel=False picks the basic engine under schedule="scan"; the
    # service's default chunked schedule ignores it (the MARK kernel)
    svc = SparsifyService(parallel=False, device=dev)
    t0 = time.perf_counter()
    results = svc.sparsify(graphs)
    t_serve = time.perf_counter() - t0

    kept = [int(r.edge_mask.sum()) for r in results]
    print(f"served in {t_serve:.2f}s (incl. the kernels' first launches) "
          f"with {svc.stats.n_dispatches} device dispatch(es) over "
          f"{len(svc.stats.bucket_counts)} shape bucket(s); "
          f"padding overhead {svc.stats.padding_overhead:.0%}")
    for key, cnt in sorted(svc.stats.bucket_counts.items()):
        print(f"  bucket n<={key[0]:4d} L<={key[1]:4d}: {cnt} graph(s)")
    print(f"kept edges per graph: {kept}")

    for g, r in zip(graphs, results):
        single = lgrass_sparsify(g, parallel=False, device=dev)
        if not np.array_equal(r.edge_mask, single.edge_mask):
            raise SystemExit("a served mask differs from its single call")
    print("all results bit-identical to single-graph lgrass_sparsify")
    return True


if __name__ == "__main__":
    main()
