"""The port's pipeline against the JAX package, on the CPU.

`repro_torch.core.phase1_device` and `lgrass_sparsify(device="cpu")` run
the plain versions of the kernels; every output is held against
`repro.core` on the same graphs with tolerance zero: integers, masks and
permutations equal, criticality bit-equal (compared as int32 views,
since one ulp can reorder the sort). The graphs of each family share one
(n, L) so the JAX programs compile once. JAX is imported only by the
`J` fixture, so on a card without JAX the `cuda` leg still runs.
"""
import types

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core import graph as tgraph
from repro_torch.core.sparsify import phase1_device as t_phase1_device

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The JAX package's pipeline (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core import graph as jgraph
    from repro.core.sparsify import phase1_device

    return types.SimpleNamespace(core=jcore, graph=jgraph,
                                 phase1_device=phase1_device)


N, L = 64, 128  # shared shape of the families below


def _chain(m):  # a path whose node ids are shuffled, plus local chords
    g = m.feeder_like_graph(N, L - (N - 1), span=3, seed=7)
    perm = np.random.default_rng(7).permutation(N).astype(np.int32)
    return m.Graph(n=N, u=perm[g.u], v=perm[g.v], w=g.w)


FAMILIES = {
    "chain": _chain,
    "feeder": lambda m: m.feeder_like_graph(N, L - (N - 1), span=8, seed=1),
    "grid": lambda m: m.powergrid_like_graph(8, 0.25, seed=2),
    "lognormal": lambda m: m.random_connected_graph(N, L - (N - 1), seed=3),
    "ties": lambda m: m.random_connected_graph(N, L - (N - 1), seed=4,
                                               weight="ties"),
}


def _graphs(J, name):
    tg, jg = FAMILIES[name](tgraph), FAMILIES[name](J.graph)
    assert (tg.n, tg.m) == (N, L)
    return tg, jg


def _tensors(g):
    return (torch.from_numpy(g.u.astype(np.int64)),
            torch.from_numpy(g.v.astype(np.int64)),
            torch.from_numpy(g.w))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_phase1_device_matches_reference(J, family):
    tg, jg = _graphs(J, family)
    want = {k: np.asarray(x) for k, x in J.phase1_device(
        jg.u, jg.v, jg.w, jg.n).items()}
    got = {k: x.numpy() for k, x in t_phase1_device(
        *_tensors(tg), tg.n).items()}
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["crit"].view(np.int32),
                          want["crit"].view(np.int32))
    for key in sorted(want):
        if key != "crit":
            assert np.array_equal(got[key], want[key]), key
    assert want["accept_sorted"].any()  # the families exercise phase 1


def _check_sparsify(J, tg, jg, **kw):
    j = J.core.lgrass_sparsify(jg, **kw)
    t = tcore.lgrass_sparsify(tg, device="cpu", **kw)
    b = tcore.baseline_sparsify(tg, budget=kw.get("budget"))
    assert np.array_equal(t.edge_mask, j.edge_mask)
    assert np.array_equal(t.edge_mask, b.edge_mask)
    assert np.array_equal(t.tree_mask, j.tree_mask)
    assert np.array_equal(t.accepted_mask, j.accepted_mask)
    for stat in ("n_accepted", "n_groups", "n_overflow_groups", "n_dirty"):
        assert getattr(t, stat) == getattr(j, stat), stat
    return t


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("budget", [2, 8])
def test_lgrass_sparsify_matches_reference_and_baseline(J, family, budget):
    tg, jg = _graphs(J, family)
    t = _check_sparsify(J, tg, jg, budget=budget, b_cap=8)
    assert t.n_accepted <= budget


@pytest.mark.parametrize("seed", range(8))
def test_block_sizes_sweep_matches_baseline(seed):
    """The fixed-point block replays of phase 1 and recovery give the
    baseline's greedy for any block size: 1, odd, pow2 and larger than L,
    with tiny and roomy accept tables."""
    rng = np.random.default_rng(seed)
    g = tgraph.random_connected_graph(
        36, 80, seed=seed, weight=("lognormal", "ties")[seed % 2])
    budget = int(rng.integers(2, 30))
    want = tcore.baseline_sparsify(g, budget=budget).edge_mask
    for chunk, p1_chunk, k_cap in ((1, 1, 1), (3, 3, 2), (16, 64, 32),
                                   (500, 500, 4)):
        r = tcore.lgrass_sparsify(g, budget=budget, chunk=chunk,
                                  p1_chunk=p1_chunk, k_cap=k_cap,
                                  device="cpu")
        assert np.array_equal(r.edge_mask, want), (chunk, p1_chunk, k_cap)


def test_budget_exhaustion_and_run_dry(J):
    tg, jg = _graphs(J, "lognormal")
    full = _check_sparsify(J, tg, jg, budget=8, b_cap=8)
    assert full.n_accepted == 8  # the greedy stops at the budget
    one = _check_sparsify(J, tg, jg, budget=1, b_cap=8)
    assert one.n_accepted == 1
    tg, jg = _graphs(J, "grid")
    dry = _check_sparsify(J, tg, jg, budget=60, b_cap=64)
    assert dry.n_accepted < 60  # candidates run out before the budget


def test_k_cap_one_overflow_recovery(J):
    tg, jg = _graphs(J, "ties")
    t = _check_sparsify(J, tg, jg, budget=8, b_cap=8, k_cap=1)
    assert t.n_overflow_groups > 0 and t.n_dirty > 0


def test_trivial_graph(J):
    t = _check_sparsify(J, tgraph.trivial_graph(), J.graph.trivial_graph())
    assert t.edge_mask.shape == (0,) and t.n_accepted == 0


def test_star_has_no_crossing_edges(J):
    """A star is all tree; a chain whose chords have an endpoint as LCA
    has off-tree edges but no crossing one: recovery alone decides."""
    def star(m):
        return m.Graph(n=8, u=np.zeros(7, np.int32),
                       v=np.arange(1, 8, dtype=np.int32),
                       w=np.ones(7, np.float32))

    def chain_noncrossing(m):
        return m.Graph(n=6, u=np.array([0, 1, 2, 3, 4, 0, 2], np.int32),
                       v=np.array([1, 2, 3, 4, 5, 2, 4], np.int32),
                       w=np.ones(7, np.float32))

    t = _check_sparsify(J, star(tgraph), star(J.graph), budget=2)
    assert t.edge_mask.all() and t.n_accepted == 0 and t.n_groups == 1
    t = _check_sparsify(J, chain_noncrossing(tgraph),
                        chain_noncrossing(J.graph), budget=2)
    assert t.n_accepted > 0 and t.n_dirty == 0


def test_use_tree_kernel_matches_reference(J):
    tg, jg = _graphs(J, "grid")
    _check_sparsify(J, tg, jg, budget=8, b_cap=8, use_tree_kernel=True)


@pytest.mark.parametrize("side", [0, 2])
def test_root_tree_euler_on_both_sides_of_the_pack_switch(side):
    """Up to EULER_PACK_MAX_N nodes the arc sort packs (tail, head) into
    one u32 key; beyond, it runs the 8-pass pair sort. Both must root the
    tree as a BFS over its edges does, and answer LCA queries exactly."""
    from repro_torch.core import _host as H
    from repro_torch.core.bfs import EULER_PACK_MAX_N, root_tree_euler
    from repro_torch.core.lca import tree_distance_euler

    n = EULER_PACK_MAX_N + side
    rng = np.random.default_rng(n)
    parent = np.array([-1] + [int(rng.integers(0, i)) for i in range(1, n)])
    perm = rng.permutation(n - 1)
    u, v = np.arange(1, n)[perm], parent[1:][perm]
    flip = rng.random(n - 1) < 0.5
    u, v = np.where(flip, v, u), np.where(flip, u, v)
    depth, par, euler = root_tree_euler(
        torch.from_numpy(u), torch.from_numpy(v), n, torch.tensor(0),
        torch.ones(n - 1, dtype=torch.bool))
    want_d, want_p = H.bfs_np(u, v, n, 0)
    assert np.array_equal(depth.numpy(), want_d)
    assert np.array_equal(par.numpy(), want_p)
    a, b = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    got = tree_distance_euler(euler, torch.from_numpy(a), torch.from_numpy(b))
    up = H.build_lifting_np(want_p, want_d, n)
    assert np.array_equal(got.numpy(), H.tree_dist_np(up, want_d, a, b))


def test_unported_options_raise():
    g = tgraph.random_connected_graph(10, 5, seed=0)
    for kw in (dict(recovery="host"), dict(schedule="scan"),
               dict(bfs_engine="levels"), dict(auto_lift_bound=True)):
        with pytest.raises(NotImplementedError):
            tcore.lgrass_sparsify(g, device="cpu", **kw)


@pytest.mark.cuda
def test_cuda_masks_equal_cpu_and_count_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from repro_torch.kernels import ops

    tg = FAMILIES["grid"](tgraph)
    want = tcore.baseline_sparsify(tg, budget=8).edge_mask
    for use_tree_kernel in (False, True):
        ops.reset_launch_counts()
        r = tcore.lgrass_sparsify(tg, budget=8,
                                  use_tree_kernel=use_tree_kernel)
        counts = ops.launch_counts()
        assert np.array_equal(r.edge_mask, want)
        assert counts["radix_hist"] > 0
        assert (counts["tree_dist"] > 0) == use_tree_kernel
