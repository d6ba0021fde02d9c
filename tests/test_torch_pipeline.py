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
    """Every engine of the reference is ported (tests/test_torch_engines.py
    holds them); a name that is no engine raises, as in the reference."""
    g = tgraph.random_connected_graph(10, 5, seed=0)
    for kw in (dict(recovery="hots"), dict(schedule="scans"),
               dict(bfs_engine="level"), dict(schedule="scan",
                                              bfs_engine="bfs")):
        with pytest.raises(ValueError):
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

MARK_CHAIN = 32
REC_WIN, REC_CHUNK, REC_THREADS, REC_CLUSTER = 512, 32, 1024, 16
FULL, SAFE, MAYBE = 0, 1, 2
ALL_LIST, NC_LIST, GROUP_LIST = 0, 1, 2


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
    """csrc/mark.cu's two launches. The chain: per group, 32-slot chunks
    resolved on bitmasks while the group has stored fewer than k_cap
    entries; a group left with slots publishes its entries at its first
    slot, and every group records where its tail starts. The tail: every
    slot at or past its group's tail start, all groups at once, alone
    against the published entries."""
    L = len(su)
    accept, overflow = np.zeros(L, bool), np.zeros(L, bool)
    gs, active = layout.group_start.numpy(), layout.active.numpy()
    gidx = layout.gidx.numpy()
    pub = np.full(L, -1, np.int64)  # the published entries (slot ids)
    tail_start = np.full(L, -1, np.int64)
    for g in range(int(layout.n_groups)):
        s0, s1 = gs[g], (gs[g + 1] if g + 1 < L else L)
        if not active[s0]:
            continue
        ent = []  # stored slots, in order
        base = s0
        while base < s1 and len(ent) < k_cap:
            c = min(MARK_CHAIN, s1 - base)
            sl = np.arange(base, base + c)
            ii, jj = np.meshgrid(sl, np.array(ent, np.int64), indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
            cov = _covers(dist, depth, su[jj], sv[jj], sb[jj], su[ii],
                          sv[ii]).reshape(c, len(ent)).any(axis=1)
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
            base += MARK_CHAIN
        if base < s1:
            assert len(ent) == k_cap
            pub[s0:s0 + k_cap] = ent
        tail_start[g] = base
    # the tail launch: one thread per slot over all L slots
    s = np.flatnonzero(active)
    s = s[s >= tail_start[gidx[s]]]
    g = gidx[s]
    ent = pub[gs[g][:, None] + np.arange(k_cap)[None, :]].ravel()
    assert (ent >= 0).all()
    xs = np.repeat(s, k_cap)
    cov = _covers(dist, depth, su[ent], sv[ent], sb[ent], su[xs],
                  sv[xs]).reshape(len(s), k_cap).any(axis=1)
    accept[s[~cov]] = True
    overflow[g[~cov]] = True
    return accept, overflow


def _emulate_rec(dist, depth, u, v, beta, offtree, crossing, order, p1a,
                 group, dirty0, budget, b_cap):
    """csrc/recover.cu: the off-tree edges in order, staged 512 at a time,
    32-edge chunks with FULL / SAFE / MAYBE classes, the lemma's lists
    when every node is reachable (`depth` given); the flat pair range cut
    over the cluster's ranks, each rank's cover bits ORed into the
    cluster's, and the resolution on bitmasks that every block repeats
    (the edges no earlier edge of the chunk can change decided at once,
    the rest in order, then the budget's cut), with the list slots and
    lengths it writes."""
    connected = depth is not None
    L = len(u)
    budget = max(min(budget, b_cap), 0)
    walk = order[offtree[order]]
    out, gflag = np.zeros(L, bool), np.zeros(L, bool)
    g_of = np.where(crossing, group, -1)
    sizes = np.bincount(g_of[g_of >= 0], minlength=L)
    group_off = np.cumsum(sizes) - sizes
    buf, nc_list = [], []                  # entry edge ids
    lists = np.full(L, -1, np.int64)       # the groups' lists
    list_len = np.zeros(L, np.int64)
    cnt = 0
    cthreads = REC_CLUSTER * REC_THREADS
    for pos in range(0, len(walk), REC_WIN):
        if cnt >= budget:
            break
        win = walk[pos:pos + REC_WIN]
        for cb in range(0, len(win), REC_CHUNK):
            if cnt >= budget:
                break
            ids = win[cb:cb + REC_CHUNK]
            c = len(ids)
            gi, cr = g_of[ids], crossing[ids]
            same = [sum(1 << j for j in range(i) if gi[j] >= 0
                        and gi[j] == gi[i]) for i in range(c)]
            later = [sum(1 << j for j in range(i + 1, c) if gi[j] >= 0
                         and gi[j] == gi[i]) for i in range(c)]
            glen = [list_len[gi[i]] if gi[i] >= 0 else 0 for i in range(c)]
            cls, kind, length = [], [], []
            for i in range(c):
                k = FULL
                if cr[i] and not dirty0[ids[i]] and not gflag[gi[i]]:
                    k = MAYBE if same[i] else SAFE
                if k == SAFE:
                    lk, n = NC_LIST, len(nc_list)
                elif connected and gi[i] >= 0:
                    lk, n = GROUP_LIST, len(nc_list) + glen[i]
                else:
                    lk, n = ALL_LIST, cnt
                cls.append(k)
                kind.append(lk)
                length.append(n)
            start = np.concatenate([[0], np.cumsum(length)])
            # the flat pair range, pair p on rank (p mod threads) // 1024
            p = np.arange(start[-1])
            i = np.searchsorted(start, p, side="right") - 1
            j = p - start[i]
            lk = np.array(kind, np.int64)[i]
            ent = np.where(lk == ALL_LIST,
                           np.array(buf + [0], np.int64)[np.minimum(
                               j, len(buf))], 0)
            nc = np.where(lk == ALL_LIST, g_of[ent] < 0, j < len(nc_list))
            in_nc = (lk != ALL_LIST) & nc
            ent = np.where(in_nc, np.array(nc_list + [0], np.int64)[
                np.minimum(j, len(nc_list))], ent)
            in_g = (lk != ALL_LIST) & ~nc
            gl = np.where(in_g, group_off[np.maximum(gi[i], 0)]
                          + j - len(nc_list), 0)
            ent = np.where(in_g, lists[gl], ent)
            assert (ent >= 0).all()
            hit = _covers(dist, depth, u[ent], v[ent], beta[ent],
                          u[ids[i]], v[ids[i]])
            rank = (p % cthreads) // REC_THREADS
            part_any = np.zeros((REC_CLUSTER, c), bool)
            part_nc = np.zeros((REC_CLUSTER, c), bool)
            np.logical_or.at(part_any, (rank, i), hit)
            np.logical_or.at(part_nc, (rank, i), hit & nc)
            cov_any, cov_nc = part_any.any(axis=0), part_nc.any(axis=0)
            ii, jj = np.tril_indices(c, -1)
            cm = np.zeros((c, c), bool)
            cm[ii, jj] = _covers(dist, depth, u[ids[jj]], v[ids[jj]],
                                 beta[ids[jj]], u[ids[ii]], v[ids[ii]])
            cmask = [sum(1 << int(j) for j in np.flatnonzero(cm[r]))
                     for r in range(c)]
            # the edges no earlier edge of the chunk can change, decided
            # at once; then the others in order; then the budget's cut
            acc = flip = ncm = dep = 0
            for r in range(c):
                p1 = bool(p1a[ids[r]])
                if cls[r] == FULL:
                    ind, dec = cov_any[r] or not cmask[r], not cov_any[r]
                else:
                    ind = cov_nc[r] or (cls[r] == SAFE and not cmask[r])
                    dec = False if cov_nc[r] else p1
                if not ind:
                    dep |= 1 << r
                    continue
                flip |= (1 << r) if cr[r] and dec != p1 else 0
                acc |= (1 << r) if dec else 0
                ncm |= (1 << r) if dec and not cr[r] else 0
            for r in (r for r in range(c) if (dep >> r) & 1):
                covered = cov_any[r] or (cmask[r] & acc)
                if cls[r] == FULL:
                    dec = not covered
                else:
                    dirty = ((flip & same[r]) or cov_nc[r]
                             or (cmask[r] & acc & ncm))
                    dec = (not covered) if dirty else bool(p1a[ids[r]])
                if cr[r] and dec != p1a[ids[r]]:
                    flip |= 1 << r
                if dec:
                    acc |= 1 << r
                    if not cr[r]:
                        ncm |= 1 << r
            room = budget - cnt
            if bin(acc).count("1") > room:  # keep up to the room-th accept
                pos = [r for r in range(c) if (acc >> r) & 1][room - 1]
                keep = (2 << pos) - 1
                acc, flip, ncm = acc & keep, flip & keep, ncm & keep
            n = cnt + bin(acc).count("1")
            nnc = len(nc_list)
            for r in range(c):
                if not (acc >> r) & 1:
                    continue
                below = (1 << r) - 1
                out[ids[r]] = True
                assert len(buf) == cnt + bin(acc & below).count("1")
                buf.append(ids[r])
                if gi[r] >= 0:
                    at = glen[r] + bin(acc & same[r]).count("1")
                    lists[group_off[gi[r]] + at] = ids[r]
                    if not acc & later[r]:
                        list_len[gi[r]] = at + 1
                else:
                    assert len(nc_list) == nnc + bin(
                        acc & ncm & below).count("1")
                    nc_list.append(ids[r])
            for r in range(c):
                if (flip >> r) & 1:
                    gflag[gi[r]] = True
            cnt = n
    return out, cnt


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


def _long_tail():
    """A graph whose largest group (299 slots) stores k_cap = 4 entries in
    its first chunk and leaves a long tail decided alone, and whose REC
    walk (1,024 off-tree edges) spans two 512-edge windows."""
    return tgraph.random_connected_graph(256, 1024, seed=3)


MARK_REC_GRAPHS = {"forest": _forest, "long_tail": _long_tail,
                   **{k: (lambda k=k: FAMILIES[k](tgraph)) for k in FAMILIES}}
# (k_cap, budget, b_cap); b_cap None: the pipeline's bucket for the budget
MARK_REC_CASES = ((1, 12, None), (2, 8, None), (32, 64, None))
LONG_TAIL_CASES = ((4, 1024, None),)


def _one_group(x, m, seed):
    """MARK's inputs cut to one synthetic group of m slots on x's tables:
    random node pairs with radii 0-3, so that the group stores k_cap
    entries early and leaves a long tail of slots decided alone, most of
    them accepted."""
    rng = np.random.default_rng(seed)
    n, dev = x.t.depth.shape[0], x.su.device
    su, sv = (torch.from_numpy(rng.integers(0, n, m)).to(dev, x.su.dtype)
              for _ in range(2))
    sb = torch.from_numpy(rng.integers(0, 4, m)).to(dev, x.sbeta.dtype)
    lay = x.layout
    start = torch.full((m,), m, dtype=lay.group_start.dtype, device=dev)
    start[0] = 0
    one = type(lay)(perm=torch.arange(m, device=dev).to(lay.perm.dtype),
                    gidx=torch.zeros((m,), dtype=lay.gidx.dtype, device=dev),
                    group_start=start,
                    active=torch.ones((m,), dtype=torch.bool, device=dev),
                    n_groups=torch.ones((), dtype=lay.n_groups.dtype,
                                        device=dev))
    return su, sv, sb, one


@pytest.mark.parametrize("engine", ["euler", "lifting"])
@pytest.mark.parametrize("graph", sorted(MARK_REC_GRAPHS))
def test_mark_rec_kernel_schedules_emulated_match_plain(graph, engine):
    """The kernels' schedules (`_emulate_mark`, `_emulate_rec`) make the
    plain loops' decisions: k_cap 1 (every group past its first store is
    in the tail), 2 and 32; budgets that stop the walk and one that runs it
    dry; on `long_tail`, a 299-slot group whose tail starts after its
    first chunk and a walk of two windows."""
    from repro_torch.core.bfs import INF
    from repro_torch.core.recovery import _recover_scan

    g = MARK_REC_GRAPHS[graph]()
    cases = MARK_REC_CASES + (LONG_TAIL_CASES if graph == "long_tail"
                              else ())
    for k_cap, budget, _ in cases:
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
    if graph == "long_tail":
        walk = x.rec[6][x.rec[4][x.rec[6]]]
        assert len(walk) > REC_WIN and n_want < budget  # two windows, dry
        sizes = torch.bincount(x.layout.gidx[x.layout.active])
        assert int(sizes.max()) == 299


@pytest.mark.parametrize("engine", ["euler", "lifting"])
def test_mark_tail_of_one_large_group_emulated_match_plain(engine):
    """One synthetic group of 1,000 slots at k_cap 300 (entries past the
    kernel's shared memory, in the published array): the chain stores 300
    entries, and the tail's 700-odd slots, each alone against them, make
    the plain loop's decisions."""
    from repro_torch.core.marking import phase1_chunked

    x = _mark_rec_inputs(_long_tail(), 300, engine == "lifting")
    su, sv, sb, one = _one_group(x, 1000, seed=9)
    want = phase1_chunked(x.t, su, sv, sb, one, k_cap=300, chunk=32,
                          use_tree_kernel=engine == "lifting", euler=x.euler)
    depth = x.t.depth.numpy().astype(np.int64)
    acc, ovf = _emulate_mark(_engine_fns(x.t, x.euler), depth, su.numpy(),
                             sv.numpy(), sb.numpy(), one, 300)
    assert np.array_equal(acc, want.accept.numpy())
    assert np.array_equal(ovf, want.group_overflow.numpy())
    assert bool(ovf[0]) and 300 < int(acc.sum()) < 1000


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["euler", "lifting"])
@pytest.mark.parametrize("graph", sorted(MARK_REC_GRAPHS))
def test_cuda_mark_rec_kernels_equal_plain_loops(graph, engine,
                                                 monkeypatch):
    """On the card: the MARK and REC kernels against the plain loops run
    on the same CUDA tensors, every output equal; k_cap 300 and b_cap
    16,384 take the kernels' global-memory buffers, on `long_tail` with a
    walk of two windows and hundreds of accepted entries, and one
    synthetic group of 1,000 slots stores 300 entries and leaves its tail
    to the tail launch. The plain loops' lifting distances come from
    `tree_dist_pairs_plain`, so the climb the kernels inline
    (`csrc/tree_dist.cuh`) is on one side only; and the kernels run with
    and without their depth-difference skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from repro_torch.kernels import ops, phase1, tree_dist

    monkeypatch.setattr(ops, "tree_dist_pairs",
                        tree_dist.tree_dist_pairs_plain)

    g = MARK_REC_GRAPHS[graph]()
    lifting = engine == "lifting"
    cases = ((1, 12, 16), (2, 8, 8), (32, 64, 64), (300, 8, 16384))
    if graph == "long_tail":
        cases += ((4, 1024, 1024), (4, 1024, 16384))
    assert phase1.rec_cluster_size(lifting) >= 2
    for k_cap, budget, b_cap in cases:
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
    if graph == "long_tail":
        x = _mark_rec_inputs(g, 300, lifting, device="cuda")
        one = _one_group(x, 1000, seed=9)
        want = phase1.mark_plain(x.t, *one, 300, 32, x.euler)
        got = phase1.mark_cuda(x.t, *one, 300, x.euler)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # the phase clocks count the walk's 32 chunks (1,024 edges, dry)
        x = _mark_rec_inputs(g, 4, lifting, device="cuda", budget=1024)
        clocks = torch.zeros((phase1.rec_clock_count(),), dtype=torch.int64,
                             device="cuda")
        want = phase1.recover_plain(*x.rec, 1024, 1024, 32, x.euler)
        got = phase1.recover_cuda(*x.rec, 1024, 1024, x.euler, clocks=clocks)
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
        c = clocks.cpu().tolist()
        assert c[5] == 32 and c[6] > 0 and all(v > 0 for v in c[:5] + c[7:])
