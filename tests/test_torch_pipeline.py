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


def _check_sparsify(J, tg, jg, against_baseline=True, **kw):
    j = J.core.lgrass_sparsify(jg, **kw)
    t = tcore.lgrass_sparsify(tg, device="cpu", **kw)
    assert np.array_equal(t.edge_mask, j.edge_mask)
    if against_baseline:
        b = tcore.baseline_sparsify(tg, budget=kw.get("budget"))
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


# -- graphs beyond the families: forests, multi-edges, extreme weights ----

EDGE_CASES = tgraph.edge_case_graphs()


def _forest():
    return EDGE_CASES["forest_isolated"][0]


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_coverage_graphs_match_reference_and_baseline(J, case):
    """Each edge case: port == reference, masks and statistics, and ==
    the numpy baseline where its mask is the answer (`edge_case_graphs`:
    past the root's component the reference's int32 distances decide)."""
    tg, kw, against_baseline = EDGE_CASES[case]
    jg = J.graph.Graph(n=tg.n, u=tg.u, v=tg.v, w=tg.w)
    t = _check_sparsify(J, tg, jg, against_baseline=against_baseline, **kw)
    if case == "budget_above_candidates":
        assert 0 < t.n_accepted < kw["budget"]


def test_euler_distance_wraps_as_the_reference_does(J):
    """Two nodes off the root's component have depth INT32_MAX; the
    reference's int32 sum wraps, and so do the port's distances."""
    from repro.core.lca import EulerLCA as JEulerLCA
    from repro.core.lca import tree_distance_euler as j_dist

    from repro_torch.core.lca import tree_distance_euler
    from repro_torch.core.sparsify import _phase1_program

    g = _forest()
    _, euler, _ = _phase1_program(*_tensors(g), g.n, 32)
    a = torch.arange(g.n).repeat_interleave(g.n)
    b = torch.arange(g.n).repeat(g.n)
    got = tree_distance_euler(euler, a, b)
    assert got.dtype == torch.int32
    assert (got < 0).any()  # the wrap happened: unreachable pairs
    jt = JEulerLCA(*[x.numpy().astype(np.int32) for x in euler])
    want = np.asarray(j_dist(jt, a.numpy().astype(np.int32),
                             b.numpy().astype(np.int32)))
    assert np.array_equal(got.numpy(), want)


def test_walk_order_compacts_the_off_tree_edges_in_order():
    from repro_torch.kernels.phase1 import walk_order

    rng = np.random.default_rng(0)
    for m in (0, 1, 7, 200):
        order = torch.from_numpy(rng.permutation(m))
        offtree = torch.from_numpy(rng.random(m) < 0.4)
        walk, n_walk = walk_order(offtree, order)
        want = order[offtree[order]]
        assert walk.shape == (m + 1,) and walk.dtype == torch.int32
        assert int(n_walk) == len(want)
        assert torch.equal(walk[:len(want)].long(), want)


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
        assert counts["radix_hist"] == 5
        # the distances are computed inside MARK and REC on both engines
        assert counts["tree_dist"] == 0
        assert counts["mark"] == 1 and counts["rec"] == 1


# -- the MARK and REC kernels' schedules, emulated on the CPU --------------
#
# csrc/mark.cu and csrc/recover.cu run only on the card. These emulations
# follow their chunking, classes, filters and bitmask resolution step by
# step (numpy, with the plain distance engines), so the CPU tests hold the
# kernels' design against the plain loops: a wrong class, filter or mask in
# the design shows here as a decision that differs.

MARK_CHAIN, MARK_THREADS = 32, 256
REC_WIN, REC_CHUNK = 512, 32
FULL, SAFE, MAYBE = 0, 1, 2


def _engine_fns(t, euler):
    """dist(a, b) -> int64 array, the kernels' engine: the Euler tables,
    or the lifting climb when `euler` is None; both wrap to int32."""
    from repro_torch.core.lca import tree_distance_euler
    from repro_torch.kernels.tree_dist import tree_dist_pairs_plain

    if euler is None:
        def dist(a, b):
            return tree_dist_pairs_plain(
                t.up, t.depth, torch.from_numpy(a),
                torch.from_numpy(b)).numpy().astype(np.int64)
        return dist

    def dist(a, b):
        return tree_distance_euler(euler, torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy().astype(
                                       np.int64)
    return dist


def _covers(dist, depth, eu, ev, eb, x, y):
    """ball_pair.cuh's `covers` over arrays of (entry, edge) pairs; with
    `depth` (every node reachable) it skips on depths alone, as the kernels
    do, which must never change a decision."""
    if len(x) == 0:
        return np.zeros(0, bool)

    def within(a, c):
        ok = dist(a, c) <= eb
        if depth is not None:
            ok &= np.abs(depth[a] - depth[c]) <= eb
        return ok
    return (within(x, eu) & within(y, ev)) | (within(x, ev) & within(y, eu))


def _emulate_mark(dist, depth, su, sv, sb, layout, k_cap):
    """csrc/mark.cu: per group, 32-slot chunks resolved on bitmasks while
    the group can store, then 256-slot chunks of independent slots."""
    L = len(su)
    accept, overflow = np.zeros(L, bool), np.zeros(L, bool)
    gs, active = layout.group_start.numpy(), layout.active.numpy()
    for g in range(int(layout.n_groups)):
        s0, s1 = gs[g], (gs[g + 1] if g + 1 < L else L)
        if not active[s0]:
            continue
        ent = []  # stored slots, in order
        base = s0
        while base < s1:
            chain = len(ent) < k_cap
            c = min(MARK_CHAIN if chain else MARK_THREADS, s1 - base)
            sl = np.arange(base, base + c)
            ii, jj = np.meshgrid(sl, np.array(ent, np.int64), indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
            cov = _covers(dist, depth, su[jj], sv[jj], sb[jj], su[ii],
                          sv[ii]).reshape(c, len(ent)).any(axis=1)
            if chain:
                i, j = np.tril_indices(c, -1)
                cm = np.zeros((c, c), bool)
                cm[i, j] = _covers(dist, depth, su[sl[j]], sv[sl[j]], sb[sl[j]],
                                   su[sl[i]], sv[sl[i]])
                stored = np.zeros(c, bool)
                for i in np.flatnonzero(~cov):
                    if (cm[i] & stored).any():
                        continue
                    accept[base + i] = True
                    if len(ent) + stored.sum() < k_cap:
                        stored[i] = True
                    else:
                        overflow[g] = True
                ent += list(sl[stored])
            else:
                accept[sl] = ~cov
                overflow[g] |= (~cov).any()
            base += c
    return accept, overflow


def _emulate_rec(dist, depth, u, v, beta, offtree, crossing, order, p1a,
                 group, dirty0, budget, b_cap):
    """csrc/recover.cu: the off-tree edges in order, 32-edge chunks with
    FULL / SAFE / MAYBE classes, the lemma's skips when every node is
    reachable (`depth` given), and warp 0's resolution on bitmasks."""
    connected = depth is not None
    L = len(u)
    budget = max(min(budget, b_cap), 0)
    walk = order[offtree[order]]
    out, gflag = np.zeros(L, bool), np.zeros(L, bool)
    ent = []  # accepted edge ids, in order
    g_of = np.where(crossing, group, -1)
    for cb in range(0, len(walk), REC_CHUNK):
        if len(ent) >= budget:
            break
        ids = walk[cb:cb + REC_CHUNK]
        c = len(ids)
        gi, cr = g_of[ids], crossing[ids]
        same = [[j for j in range(i) if gi[j] >= 0 and gi[j] == gi[i]]
                for i in range(c)]
        clean = [cr[i] and not dirty0[ids[i]] and not gflag[gi[i]]
                 for i in range(c)]
        cls = [(MAYBE if same[i] else SAFE) if clean[i] else FULL
               for i in range(c)]
        e = np.array(ent, np.int64)
        eg = g_of[e]
        cov_any, cov_nc = np.zeros(c, bool), np.zeros(c, bool)
        for i in range(c):
            test = eg < 0  # SAFE: the non-crossing entries only
            if cls[i] != SAFE:  # all others, less the lemma's skips
                test |= (eg == gi[i]) | (not (connected and gi[i] >= 0))
            hit = _covers(dist, depth, u[e[test]], v[e[test]], beta[e[test]],
                          np.full(test.sum(), u[ids[i]]),
                          np.full(test.sum(), v[ids[i]]))
            cov_any[i] = hit.any()
            cov_nc[i] = hit[eg[test] < 0].any()
        i, j = np.tril_indices(c, -1)
        cm = np.zeros((c, c), bool)
        cm[i, j] = _covers(dist, depth, u[ids[j]], v[ids[j]], beta[ids[j]],
                           u[ids[i]], v[ids[i]])
        acc, flip, nc = (np.zeros(c, bool) for _ in range(3))
        for i in range(c):
            if len(ent) >= budget:
                break
            covered = cov_any[i] or (cm[i] & acc).any()
            if cls[i] == FULL:
                dec = not covered
            else:
                dirty = (flip[same[i]].any() or cov_nc[i]
                         or (cm[i] & acc & nc).any())
                dec = (not covered) if dirty else bool(p1a[ids[i]])
            if cr[i] and dec != p1a[ids[i]]:
                flip[i] = True
                gflag[gi[i]] = True
            if dec:
                acc[i], nc[i] = True, not cr[i]
                out[ids[i]] = True
                ent.append(ids[i])
    return out, len(ent)


def _mark_rec_inputs(g, k_cap=32, use_tree_kernel=False, device="cpu",
                     budget=8):
    """Everything MARK and REC take, from the port's phase 1 on `device`,
    as the pipeline hands it to them; plus phase 1's own outputs."""
    from repro_torch.core.sparsify import (_bucket_b_cap, _phase1_program,
                                           _rec_inputs)

    u, v, w = (x.to(device) for x in _tensors(g))
    d, euler, layout = _phase1_program(u, v, w, g.n, k_cap,
                                       use_tree_kernel=use_tree_kernel)
    rec = _rec_inputs(d, u, v)
    return types.SimpleNamespace(
        t=rec[0], euler=euler, d=d, layout=layout, su=u[layout.perm],
        sv=v[layout.perm], sbeta=d["beta"][layout.perm], k_cap=k_cap,
        rec=rec, budget=budget, b_cap=_bucket_b_cap([budget]))


@pytest.mark.parametrize("engine", ["euler", "lifting"])
@pytest.mark.parametrize("graph", sorted(FAMILIES) + ["forest"])
def test_mark_rec_kernel_schedules_emulated_match_plain(graph, engine):
    """The kernels' schedules (`_emulate_mark`, `_emulate_rec`) make the
    plain loops' decisions: k_cap 1 (every group past its first store is
    in the independent-slot phase), 2 and 32; budgets that stop the walk
    and one that runs it dry."""
    from repro_torch.core.bfs import INF
    from repro_torch.core.recovery import _recover_scan

    g = _forest() if graph == "forest" else FAMILIES[graph](tgraph)
    for k_cap, budget in ((1, 12), (2, 8), (32, 64)):
        x = _mark_rec_inputs(g, k_cap, engine == "lifting", budget=budget)
        dist = _engine_fns(x.t, x.euler)
        connected = bool((x.t.depth != INF).all())
        assert connected == (graph != "forest")
        depth = x.t.depth.numpy().astype(np.int64) if connected else None
        acc, ovf = _emulate_mark(dist, depth, x.su.numpy(), x.sv.numpy(),
                                 x.sbeta.numpy(), x.layout, k_cap)
        assert np.array_equal(acc, x.d["accept_sorted"].numpy()), k_cap
        assert np.array_equal(ovf, x.d["group_overflow"].numpy()), k_cap
        want, n_want = _recover_scan(*x.rec, x.budget, x.b_cap,
                                     engine == "lifting", 32, x.euler)
        got, n_got = _emulate_rec(dist, depth,
                                  *[y.numpy() for y in x.rec[1:]],
                                  x.budget, x.b_cap)
        assert np.array_equal(got, want.numpy()) and n_got == n_want


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["euler", "lifting"])
@pytest.mark.parametrize("graph", sorted(FAMILIES) + ["forest"])
def test_cuda_mark_rec_kernels_equal_plain_loops(graph, engine,
                                                 monkeypatch):
    """On the card: the MARK and REC kernels against the plain loops run
    on the same CUDA tensors, every output equal; k_cap 300 and b_cap
    16,384 take the kernels' global-memory buffers. The plain loops'
    lifting distances come from `tree_dist_pairs_plain`, so the climb the
    kernels inline (`csrc/tree_dist.cuh`) is on one side only; and the
    kernels run with and without their depth-difference skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from repro_torch.kernels import ops, phase1, tree_dist

    monkeypatch.setattr(ops, "tree_dist_pairs",
                        tree_dist.tree_dist_pairs_plain)

    g = _forest() if graph == "forest" else FAMILIES[graph](tgraph)
    lifting = engine == "lifting"
    for k_cap, budget, b_cap in ((1, 12, 16), (2, 8, 8), (32, 64, 64),
                                 (300, 8, 16384)):
        x = _mark_rec_inputs(g, k_cap, lifting, device="cuda",
                             budget=budget)
        p_acc, p_ovf = phase1.mark_plain(x.t, x.su, x.sv, x.sbeta, x.layout,
                                         k_cap, 7, x.euler)
        want, n_want = phase1.recover_plain(*x.rec, budget, b_cap, 32,
                                            x.euler)
        for skip in (True, False):
            acc, ovf = phase1.mark_cuda(x.t, x.su, x.sv, x.sbeta, x.layout,
                                        k_cap, x.euler, depth_skip=skip)
            assert torch.equal(acc, p_acc) and torch.equal(ovf, p_ovf), \
                (k_cap, skip)
            got, n_got = phase1.recover_cuda(*x.rec, budget, b_cap, x.euler,
                                             depth_skip=skip)
            assert torch.equal(got, want) and n_got == n_want, \
                (k_cap, b_cap, skip)
