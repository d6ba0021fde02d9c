"""Graph containers and generators for LGRASS (host/numpy side).

A copy of `repro.core.graph` for the PyTorch port: the same numpy calls
give the same arrays, so a graph made from a seed here equals the one the
JAX package makes. Edges are stored as parallel arrays (u, v, w). The
graph is undirected, connected, simple (no self loops / multi edges).
Node ids are 0..n-1.

Conventions shared by the numpy oracle (`baseline.py`) and the torch
pipeline (`sparsify.py`) — these pin down every tie-break so the two
implementations are bit-identical:

  * root            = node with maximum degree, ties -> smallest id.
  * BFS parent rule = smallest-id neighbour in the previous level.
  * effective weight eff(e) = w(e) * (depth[u] + depth[v] + 1.0)
    with depth from the *graph* BFS (feGRASS-style depth-scaled weight).
  * spanning tree   = MAXIMUM spanning tree under (eff desc, edge-id asc)
    total order (unique because the order is total).
  * criticality     = w(e) * R_tree(u, v) for off-tree e, processed in
    (criticality desc, edge-id asc) order.
  * beta(e)         = max(min(depth_t[u], depth_t[v]) - depth_t[lca], 1)
    with depth_t from the *tree* BFS rooted at `root`.
  * ball(u, b)      = nodes with tree distance (hops) <= b from u.
  * greedy          = accept edge iff not marked; accepted edge marks all
    off-tree edges (x, y) with (x in B(u), y in B(v)) or swapped; stop
    after `budget` accepts.

Padding conventions (batched pipeline, `GraphBatch`):

  * a batch pads B graphs to shared (n_max, L_max); node padding is
    implicit (ids n..n_max-1 are simply never referenced by real edges).
  * padding edges are self loops on node 0 with sentinel weight 0.0 and
    edge_valid == False; every stage threads the mask so padding edges
    never gain degree, never enter the spanning tree, and never join a
    crossing group — real slots equal an unpadded single-graph run.
  * real edges always occupy the leading L slots, so padding slots sort
    strictly after every real slot under the stable (key desc, id asc)
    orders above.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected weighted graph in edge-list form (host/numpy side)."""

    n: int
    u: np.ndarray  # (L,) int32
    v: np.ndarray  # (L,) int32
    w: np.ndarray  # (L,) float32, positive

    @property
    def m(self) -> int:
        return int(self.u.shape[0])

    def validate(self) -> None:
        assert self.u.shape == self.v.shape == self.w.shape
        assert np.all(self.u != self.v), "self loops not allowed"
        assert np.all(self.w > 0), "weights must be positive"
        key = np.minimum(self.u, self.v) * np.int64(self.n) + np.maximum(
            self.u, self.v
        )
        assert len(np.unique(key)) == self.m, "multi-edges not allowed"


def trivial_graph() -> Graph:
    """The minimal legal graph: one node, zero edges.

    The canonical degenerate input: the pipeline returns empty masks
    for it.
    """
    return Graph(n=1, u=np.zeros(0, np.int32), v=np.zeros(0, np.int32),
                 w=np.zeros(0, np.float32))


PAD_ENDPOINT = 0     # padding edges are self loops on node 0
PAD_WEIGHT = 0.0     # sentinel: real weights are strictly positive


@dataclasses.dataclass
class GraphBatch:
    """B graphs padded to shared (n_max, L_max) for one batched call.

    Edge arrays are (B, L_max); `edge_valid` marks real slots, padding
    slots hold (PAD_ENDPOINT, PAD_ENDPOINT, PAD_WEIGHT). Real edges of
    graph i occupy slots 0..m_i-1 (see the padding conventions in the
    module docstring). The original `Graph` objects are kept so results
    can be sliced back to per-graph shapes.
    """

    graphs: list
    n_max: int
    L_max: int
    u: np.ndarray           # (B, L_max) int32
    v: np.ndarray           # (B, L_max) int32
    w: np.ndarray           # (B, L_max) float32
    edge_valid: np.ndarray  # (B, L_max) bool
    n_real: np.ndarray      # (B,) int32 — true node counts
    m_real: np.ndarray      # (B,) int32 — true edge counts

    @property
    def batch_size(self) -> int:
        return len(self.graphs)

    @classmethod
    def from_graphs(
        cls,
        graphs,
        n_max: Optional[int] = None,
        L_max: Optional[int] = None,
    ) -> "GraphBatch":
        """Pad `graphs` to a shared bucket; n_max/L_max may round the
        bucket up (for example to powers of two)."""
        graphs = list(graphs)
        if not graphs:
            raise ValueError("empty batch")
        need_n = max(g.n for g in graphs)
        need_L = max(g.m for g in graphs)
        n_max = need_n if n_max is None else int(n_max)
        L_max = need_L if L_max is None else int(L_max)
        if n_max < need_n or L_max < need_L:
            raise ValueError(
                f"bucket ({n_max}, {L_max}) too small for ({need_n}, {need_L})"
            )
        B = len(graphs)
        u = np.full((B, L_max), PAD_ENDPOINT, np.int32)
        v = np.full((B, L_max), PAD_ENDPOINT, np.int32)
        w = np.full((B, L_max), PAD_WEIGHT, np.float32)
        edge_valid = np.zeros((B, L_max), bool)
        for i, g in enumerate(graphs):
            u[i, : g.m] = g.u
            v[i, : g.m] = g.v
            w[i, : g.m] = g.w
            edge_valid[i, : g.m] = True
        return cls(
            graphs=graphs,
            n_max=n_max,
            L_max=L_max,
            u=u,
            v=v,
            w=w,
            edge_valid=edge_valid,
            n_real=np.array([g.n for g in graphs], np.int32),
            m_real=np.array([g.m for g in graphs], np.int32),
        )


def random_connected_graph(
    n: int,
    extra_edges: int,
    seed: int = 0,
    weight: str = "lognormal",
) -> Graph:
    """Random spanning tree + `extra_edges` distinct chords."""
    rng = np.random.default_rng(seed)
    # random spanning tree: attach node i to a uniform previous node
    parents = np.array([rng.integers(0, i) for i in range(1, n)])
    tu = np.arange(1, n, dtype=np.int64)
    tv = parents.astype(np.int64)
    existing = set(zip(np.minimum(tu, tv).tolist(), np.maximum(tu, tv).tolist()))
    cu, cv = [], []
    max_extra = n * (n - 1) // 2 - (n - 1)
    extra_edges = min(extra_edges, max_extra)
    while len(cu) < extra_edges:
        k = extra_edges - len(cu)
        a = rng.integers(0, n, size=2 * k + 8)
        b = rng.integers(0, n, size=2 * k + 8)
        for x, y in zip(a.tolist(), b.tolist()):
            if x == y:
                continue
            key = (min(x, y), max(x, y))
            if key in existing:
                continue
            existing.add(key)
            cu.append(x)
            cv.append(y)
            if len(cu) == extra_edges:
                break
    u = np.concatenate([tu, np.array(cu, dtype=np.int64)])
    v = np.concatenate([tv, np.array(cv, dtype=np.int64)])
    m = len(u)
    if weight == "lognormal":
        w = rng.lognormal(mean=0.0, sigma=1.0, size=m)
    elif weight == "uniform":
        w = rng.uniform(0.5, 2.0, size=m)
    elif weight == "ties":  # many duplicate weights to stress tie-breaks
        w = rng.integers(1, 4, size=m).astype(np.float64)
    else:
        raise ValueError(weight)
    # shuffle edge order so edge-id tie-breaks are exercised
    perm = rng.permutation(m)
    g = Graph(n=n, u=u[perm].astype(np.int32), v=v[perm].astype(np.int32),
              w=w[perm].astype(np.float32))
    g.validate()
    return g


def feeder_like_graph(
    n: int,
    chords: int,
    span: int = 24,
    seed: int = 0,
) -> Graph:
    """Radial-feeder topology: a chain with `chords` local shortcuts.

    Distribution networks are chain-heavy; on a chain, a chord (i, j)
    has its shallower endpoint as the LCA, so almost every off-tree edge
    is NON-crossing — phase 1 has nothing to decide and the Algorithm-6
    recovery replay does all the work. This is the recovery-dominated
    regime; the parity tests use it to hammer the non-crossing /
    after-effects paths.
    """
    rng = np.random.default_rng(seed)
    span = min(max(span, 2), n - 1)
    tu = np.arange(n - 1, dtype=np.int64)
    tv = np.arange(1, n, dtype=np.int64)
    seen = set(zip(tu.tolist(), tv.tolist()))
    cu, cv = [], []
    # the generator only reaches pairs with 2 <= j - i <= span; clamping
    # to the all-pairs bound would let the rejection loop spin forever
    max_chords = sum(n - d for d in range(2, span + 1))
    chords = min(chords, max_chords)
    while len(cu) < chords:
        i = int(rng.integers(0, n - 2))
        j = min(i + int(rng.integers(2, span + 1)), n - 1)
        key = (min(i, j), max(i, j))
        if i == j or key in seen:
            continue
        seen.add(key)
        cu.append(i)
        cv.append(j)
    u = np.concatenate([tu, np.array(cu, dtype=np.int64)])
    v = np.concatenate([tv, np.array(cv, dtype=np.int64)])
    w = rng.lognormal(0.0, 1.0, size=len(u))
    perm = rng.permutation(len(u))
    g = Graph(n=n, u=u[perm].astype(np.int32), v=v[perm].astype(np.int32),
              w=w[perm].astype(np.float32))
    g.validate()
    return g


def powergrid_like_graph(n_side: int, chord_frac: float = 0.25,
                         seed: int = 0) -> Graph:
    """2-D grid (power-grid-ish topology, as in the IPCC cases) + chords."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    idx = np.arange(n).reshape(n_side, n_side)
    hu = idx[:, :-1].ravel()
    hv = idx[:, 1:].ravel()
    vu = idx[:-1, :].ravel()
    vv = idx[1:, :].ravel()
    u = np.concatenate([hu, vu])
    v = np.concatenate([hv, vv])
    existing = set(zip(np.minimum(u, v).tolist(), np.maximum(u, v).tolist()))
    n_chords = int(chord_frac * n)
    cu, cv = [], []
    while len(cu) < n_chords:
        x, y = int(rng.integers(0, n)), int(rng.integers(0, n))
        if x == y:
            continue
        key = (min(x, y), max(x, y))
        if key in existing:
            continue
        existing.add(key)
        cu.append(x)
        cv.append(y)
    u = np.concatenate([u, np.array(cu, dtype=np.int64)])
    v = np.concatenate([v, np.array(cv, dtype=np.int64)])
    w = rng.lognormal(0.0, 0.5, size=len(u))
    perm = rng.permutation(len(u))
    g = Graph(n=n, u=u[perm].astype(np.int32), v=v[perm].astype(np.int32),
              w=w[perm].astype(np.float32))
    g.validate()
    return g


# The three official IPCC cases are 4K / 7K / 16K nodes. We reconstruct
# equivalently-sized synthetic cases (the official inputs are not public).
OFFICIAL_CASE_SHAPES = {
    "case1": dict(n_side=64, chord_frac=0.25, seed=101),   # ~4K nodes
    "case2": dict(n_side=84, chord_frac=0.20, seed=202),   # ~7K nodes
    "case3": dict(n_side=127, chord_frac=0.25, seed=303),  # ~16K nodes
}


def official_case(name: str) -> Graph:
    return powergrid_like_graph(**OFFICIAL_CASE_SHAPES[name])


def edge_case_graphs() -> dict:
    """Small graphs off the generators' path, each with the
    `lgrass_sparsify` arguments it is checked at: name -> (graph,
    arguments, whether the numpy baseline's mask is the answer).

    A two-tree forest with four isolated nodes (every node off the root's
    component is unreachable); multi-edges and self-loops; zero, 1e-30
    and 1e30 weights; tied weights at k_cap = 2; a budget above the
    number of candidates. Each case with the default distance engine and,
    where it matters, with use_tree_kernel. Past the root's component the
    reference's int32 distances decide (they wrap on two unreachable
    depths) where the baseline's BFS balls decide otherwise: there the
    reference's mask is the answer, not the baseline's.
    """
    a = random_connected_graph(20, 20, seed=1)
    b = random_connected_graph(15, 15, seed=2)
    forest = Graph(n=44, u=np.concatenate([a.u, b.u + 20]).astype(np.int32),
                   v=np.concatenate([a.v, b.v + 20]).astype(np.int32),
                   w=np.concatenate([a.w, b.w]).astype(np.float32))
    g = random_connected_graph(30, 40, seed=5)
    multi = Graph(n=30,
                  u=np.concatenate([g.u, g.u[:10], np.arange(5)]).astype(
                      np.int32),
                  v=np.concatenate([g.v, g.v[:10], np.arange(5)]).astype(
                      np.int32),
                  w=np.concatenate([g.w, g.w[:10] * 0.5, np.ones(5)]).astype(
                      np.float32))
    g = random_connected_graph(30, 40, seed=6)
    w = g.w.copy()
    w[::5], w[1::7], w[2::9] = 0.0, 1e-30, 1e30
    weights = Graph(n=30, u=g.u, v=g.v, w=w.astype(np.float32))
    ties = random_connected_graph(40, 80, seed=4, weight="ties")
    tree = dict(use_tree_kernel=True)
    past = dict(budget=12, b_cap=16)
    return {
        "forest_isolated": (forest, dict(budget=6), True),
        "forest_isolated_tree_kernel": (forest, dict(budget=6, **tree), True),
        "forest_past_the_component": (forest, past, False),
        "forest_past_the_component_tree_kernel": (forest, dict(past, **tree),
                                                  False),
        "multi_edges_self_loops": (multi, dict(budget=5), True),
        "zero_tiny_huge_weights": (weights, dict(budget=5), True),
        "ties_k_cap_2": (ties, dict(budget=8, k_cap=2), True),
        "ties_k_cap_2_tree_kernel": (ties, dict(budget=8, k_cap=2, **tree),
                                     True),
        "budget_above_candidates": (ties, dict(budget=200), True),
    }


def from_reference(g) -> Graph:
    """The port's `Graph` from any object with `.n` and `.u/.v/.w` numpy
    arrays (for example `repro.core.graph.Graph`). The graph is the
    system's only state, so this is how an input crosses between the
    two packages; arrays are copied with the pipeline's dtypes."""
    return Graph(n=int(g.n),
                 u=np.array(g.u, dtype=np.int32),
                 v=np.array(g.v, dtype=np.int32),
                 w=np.array(g.w, dtype=np.float32))
