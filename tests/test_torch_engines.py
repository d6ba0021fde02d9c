"""The port's other engines of `lgrass_sparsify` against the JAX package,
on the CPU.

Every combination of `bfs_engine` × `schedule`/`parallel` × `recovery` ×
`auto_lift_bound` × `use_euler_lca` runs through
`repro_torch.core.lgrass_sparsify(device="cpu")` and
`repro.core.lgrass_sparsify` on the same graph: masks `np.array_equal`
to each other and to the numpy baseline, statistics equal. Then the
pieces: the scan engines against the reference's and the port's chunked
loop, `bfs_levels` and `build_euler` tables, `recover_host` and
`recover_device`, a lifting table shorter than log2(n + 1) levels.

The reference's `lgrass_sparsify` runs with its two programs
(`lgrass_device`, `phase1_device`) unjitted, so that their stages, each
jitted on its own, compile once for all 48 combinations (one fused
compile per combination took ~5 s). JAX's caches are cleared before and
after this file: each compile holds ~900 memory maps until then, and a
process may hold 65,530.
"""
import itertools
import types

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core import graph as tgraph
from repro_torch.core.lca import LiftingTables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The JAX package (skips where JAX is absent), its two programs
    unjitted for this file."""
    jax = pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core import bfs as jbfs
    from repro.core import graph as jgraph
    from repro.core import lca as jlca
    from repro.core import marking as jmarking
    from repro.core import recovery as jrecovery
    from repro.core import sparsify as jsparsify

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("lgrass_device", "phase1_device"):
            mp.setattr(jsparsify, name, getattr(jsparsify, name).__wrapped__)
        yield types.SimpleNamespace(core=jcore, bfs=jbfs, graph=jgraph,
                                    lca=jlca, marking=jmarking,
                                    recovery=jrecovery)
    jax.clear_caches()


N, L = 200, 300  # the graphs of the engine sweep


def _sweep_graphs(m):
    return {"random": m.random_connected_graph(N, L - (N - 1), seed=11),
            "feeder": m.feeder_like_graph(N, L - (N - 1), span=8, seed=12)}


def _jgraph(J, g):
    return J.graph.Graph(n=g.n, u=g.u, v=g.v, w=g.w)


def _check(J, tg, kw, against_baseline=True):
    """port == reference (masks and statistics), and == the baseline."""
    t = tcore.lgrass_sparsify(tg, device="cpu", **kw)
    j = J.core.lgrass_sparsify(_jgraph(J, tg), **kw)
    assert np.array_equal(t.edge_mask, j.edge_mask)
    assert np.array_equal(t.tree_mask, j.tree_mask)
    assert np.array_equal(t.accepted_mask, j.accepted_mask)
    for stat in ("n_accepted", "n_groups", "n_overflow_groups", "n_dirty"):
        assert getattr(t, stat) == getattr(j, stat), stat
    if against_baseline:
        want = tcore.baseline_sparsify(tg, budget=kw.get("budget")).edge_mask
        assert np.array_equal(t.edge_mask, want)
    return t


SCHEDULES = {"chunked": dict(schedule="chunked"),
             "scan_parallel": dict(schedule="scan", parallel=True),
             "scan_basic": dict(schedule="scan", parallel=False)}
COMBOS = {
    f"{bfs}-{sched}-{rec}-{'lift_bound' if alb else 'full_table'}-"
    f"{'euler' if eul else 'lifting'}": dict(
        bfs_engine=bfs, recovery=rec, auto_lift_bound=alb,
        use_euler_lca=eul, **SCHEDULES[sched])
    for bfs, sched, rec, alb, eul in itertools.product(
        ("doubling", "levels"), SCHEDULES, ("device", "host"),
        (False, True), (True, False))}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_engine_combination_matches_reference_and_baseline(J, combo):
    """The port == the reference's run of the same combination == the
    baseline on the random graph; the port == the baseline on the feeder
    (one reference compile a case: a compile takes seconds, a port run a
    tenth of one)."""
    kw = dict(COMBOS[combo], budget=10, k_cap=4)
    graphs = _sweep_graphs(tgraph)
    assert _check(J, graphs["random"], kw).n_accepted > 0
    g = graphs["feeder"]
    r = tcore.lgrass_sparsify(g, device="cpu", **kw)
    assert r.n_accepted > 0
    assert np.array_equal(r.edge_mask,
                          tcore.baseline_sparsify(g, budget=10).edge_mask)


EDGE_CASES = tgraph.edge_case_graphs()


@pytest.mark.parametrize("case", sorted(
    c for c, (_, _, baseline) in EDGE_CASES.items() if baseline))
def test_edge_cases_under_every_engine_match_baseline(case):
    """The edge cases whose answer is the baseline's (`edge_case_graphs`),
    through every engine combination of the port."""
    g, kw, _ = EDGE_CASES[case]
    want = tcore.baseline_sparsify(g, budget=kw["budget"]).edge_mask
    for combo, opts in COMBOS.items():
        r = tcore.lgrass_sparsify(g, device="cpu", **dict(kw, **opts))
        assert np.array_equal(r.edge_mask, want), combo


@pytest.mark.parametrize("recovery", ["device", "host"])
@pytest.mark.parametrize("schedule", ["chunked", "scan_parallel"])
def test_forest_on_the_levels_engine_matches_reference(J, recovery,
                                                       schedule):
    """A two-tree forest with isolated nodes on the levels engine: the
    second BFS and `build_euler` tour only the root's component; past it
    the reference's int32 distances decide, so there the reference's mask
    is the answer, not the baseline's."""
    kw = dict(bfs_engine="levels", recovery=recovery, **SCHEDULES[schedule])
    for case in ("forest_isolated", "forest_past_the_component"):
        g, case_kw, baseline = EDGE_CASES[case]
        _check(J, g, dict(kw, **case_kw), against_baseline=baseline)


def _layout_inputs(g, lift_levels=None, k_cap=2):
    """MARK's inputs from the port's phase 1 on the CPU."""
    from repro_torch.core.sparsify import _phase1_program

    u, v, w = (torch.from_numpy(g.u.astype(np.int64)),
               torch.from_numpy(g.v.astype(np.int64)), torch.from_numpy(g.w))
    d, euler, layout = _phase1_program(u, v, w, g.n, k_cap,
                                       lift_levels=lift_levels)
    return types.SimpleNamespace(
        d=d, euler=euler, layout=layout, u=u, v=v,
        t=LiftingTables(up=d["up"], depth=d["depth_t"]),
        su=u[layout.perm], sv=v[layout.perm], sbeta=d["beta"][layout.perm])


SCAN_GRAPHS = {
    "random": lambda: tgraph.random_connected_graph(N, L - (N - 1), seed=11),
    "ties": lambda: tgraph.random_connected_graph(N, L - (N - 1), seed=4,
                                                  weight="ties"),
    "forest": lambda: EDGE_CASES["forest_isolated"][0],
}


@pytest.mark.parametrize("graph", sorted(SCAN_GRAPHS))
def test_scan_engines_match_reference_and_chunked(J, graph):
    """`phase1_basic` and `phase1_parallel` on the sorted slots: accept
    and group_overflow equal to the reference's engines and to the port's
    chunked loop on the lifting climb (k_cap = 2, so groups overflow)."""
    from repro_torch.core.marking import (phase1_basic, phase1_chunked,
                                          phase1_parallel)

    x = _layout_inputs(SCAN_GRAPHS[graph]())
    lay = x.layout
    jt = J.lca.LiftingTables(up=x.d["up"].numpy(),
                             depth=x.d["depth_t"].numpy().astype(np.int32))
    m = lay.perm.shape[0]
    jlay = J.marking.GroupLayout(
        perm=lay.perm.numpy().astype(np.int32),
        gidx=lay.gidx.numpy().astype(np.int32),
        group_start=lay.group_start.numpy().astype(np.int32),
        group_size=np.bincount(lay.gidx.numpy(), minlength=m).astype(
            np.int32),
        active=lay.active.numpy(), n_groups=np.int32(lay.n_groups))
    js = [a.numpy().astype(np.int32) for a in (x.su, x.sv, x.sbeta)]
    chunked = phase1_chunked(x.t, x.su, x.sv, x.sbeta, lay, k_cap=2,
                             chunk=8, use_tree_kernel=True)
    for t_fn, j_fn in ((phase1_basic, J.marking.phase1_basic),
                       (phase1_parallel, J.marking.phase1_parallel)):
        got = t_fn(x.t, x.su, x.sv, x.sbeta, lay, k_cap=2)
        want = j_fn(jt, *js, jlay, k_cap=2)
        for key in ("accept", "group_overflow"):
            g_, w_ = getattr(got, key).numpy(), np.asarray(getattr(want, key))
            assert np.array_equal(g_, w_), (t_fn.__name__, key)
            assert torch.equal(getattr(got, key), getattr(chunked, key)), \
                (t_fn.__name__, key)
    if graph != "forest":
        assert chunked.group_overflow.any() and chunked.accept.any()


@pytest.mark.parametrize("graph", ["feeder", "forest"])
def test_bfs_levels_and_build_euler_tables_equal_reference(J, graph):
    """Depth and parent of `bfs_levels` (the graph pass, the tree pass
    and a padding mask), and every table of `build_euler`, equal to the
    reference's."""
    from repro_torch.core.bfs import bfs_levels, select_root
    from repro_torch.core.lca import build_euler

    g = (_sweep_graphs(tgraph)["feeder"] if graph == "feeder"
         else EDGE_CASES["forest_isolated"][0])
    u, v = torch.from_numpy(g.u.astype(np.int64)), \
        torch.from_numpy(g.v.astype(np.int64))
    ju, jv = g.u.astype(np.int32), g.v.astype(np.int32)
    root = select_root(u, v, g.n)
    x = _layout_inputs(g)
    mask = np.random.default_rng(0).random(g.m) < 0.8
    for emask in (None, x.d["tree_mask"].numpy(), mask):
        tm = None if emask is None else torch.from_numpy(emask)
        depth, parent = bfs_levels(u, v, g.n, root, tm)
        jd, jp = J.bfs.bfs_levels(ju, jv, g.n, np.int32(int(root)), emask)
        assert np.array_equal(depth.numpy(), np.asarray(jd))
        assert np.array_equal(parent.numpy(), np.asarray(jp))
    depth, parent = bfs_levels(u, v, g.n, root, x.d["tree_mask"])
    got = build_euler(parent, depth, root, g.n)
    want = J.lca.build_euler(parent.numpy().astype(np.int32),
                             depth.numpy().astype(np.int32),
                             np.int32(int(root)), g.n)
    for key in got._fields:
        assert np.array_equal(getattr(got, key).numpy(),
                              np.asarray(getattr(want, key))), key


def test_recover_host_and_recover_device_match_reference(J):
    """Both replays driven from one graph's phase-1 outputs: the port's
    `recover_host` and `recover_device` (Euler tables rebuilt from up[0],
    and the lifting climb) equal to the reference's, the budget clamped
    to b_cap as there."""
    from repro_torch.core.sparsify import phase1_views_np

    g = tgraph.feeder_like_graph(96, 48, span=6, seed=0)
    x = _layout_inputs(g, k_cap=1)
    d = {k: val.numpy() for k, val in x.d.items()}
    tree, crossing, accept, group, dirty0, order = phase1_views_np(d, g.m)
    host_args = dict(
        n=g.n, u=g.u.astype(np.int64), v=g.v.astype(np.int64),
        tree_mask=tree, parent_t=d["parent_t"].astype(np.int32),
        depth_t=d["depth_t"].astype(np.int32), up=d["up"],
        beta=d["beta"].astype(np.int32), crossing=crossing,
        crit_order=order[: int((~tree).sum())], phase1_accept=accept,
        group_of_edge=group, dirty0=dirty0)
    rec = (d["up"], d["depth_t"].astype(np.int32), g.u, g.v,
           d["beta"].astype(np.int32), tree, crossing,
           order.astype(np.int32), accept, group.astype(np.int32), dirty0)
    for budget, b_cap in ((6, 8), (9, 4)):
        want_host = J.recovery.recover_host(
            **dict(host_args, budget=min(budget, b_cap)))
        got_host = tcore.recover_host(**dict(host_args,
                                             budget=min(budget, b_cap)))
        assert np.array_equal(got_host, want_host)
        if budget == 6:  # the replay accepts non-crossing edges too
            assert (~tree & ~crossing & got_host).any()
        for use_euler in (True, False):
            got, n_got = tcore.recover_device(
                *rec, budget, b_cap, use_euler_lca=use_euler, device="cpu")
            want, n_want = J.recovery.recover_device(
                *rec, np.int32(budget), b_cap=b_cap, use_euler_lca=use_euler)
            assert np.array_equal(got.numpy(), np.asarray(want)), use_euler
            assert n_got == int(n_want) == int(want_host.sum())


def test_lifting_table_shorter_than_log_n_gives_the_same_decisions():
    """`auto_lift_bound`'s table has fewer than log2_ceil(n + 1) levels;
    with 2^levels above the tree depth, MARK and REC on the lifting
    engine decide as on the full table."""
    from repro_torch.core.pow2 import log2_ceil
    from repro_torch.core.sparsify import _rec_inputs
    from repro_torch.kernels import ops

    g = tgraph.powergrid_like_graph(12, 0.4, seed=3)
    full = _layout_inputs(g)
    depth_max = int(full.d["depth_t"].max())
    levels = depth_max.bit_length()  # the least with 2^levels > depth
    assert levels < log2_ceil(g.n + 1)
    short = _layout_inputs(g, lift_levels=levels)
    assert short.d["up"].shape[0] == levels
    outs = []
    for x in (full, short):
        accept, ovf = ops.mark(x.t, x.su, x.sv, x.sbeta, x.layout, 2, 8)
        rec = _rec_inputs(x.d, x.u, x.v)
        outs.append((accept, ovf, *ops.recover(*rec, 12, 16)))
    for a, b in zip(*outs):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def _deep_tree_graph(n=48):
    """A hub tied to every node by light edges and a chain of heavy ones:
    the graph BFS is 1 deep, the spanning tree (the chain) ~n/2, so the
    depth bound guessed from the graph BFS fails and is redone."""
    rng = np.random.default_rng(5)
    chain_u = np.arange(1, n - 1)
    hub_v = np.arange(1, n)
    u = np.concatenate([chain_u, np.zeros(n - 1, np.int64)])
    v = np.concatenate([chain_u + 1, hub_v])
    w = np.concatenate([rng.uniform(50, 60, n - 2),
                        rng.uniform(0.01, 0.02, n - 1)])
    return tgraph.Graph(n=n, u=u.astype(np.int32), v=v.astype(np.int32),
                        w=w.astype(np.float32))


@pytest.mark.parametrize("recovery", ["device", "host"])
def test_auto_lift_bound_redo_when_the_tree_is_deeper(J, recovery):
    from repro_torch.core.bfs import bfs, select_root
    from repro_torch.core.sparsify import phase1_device

    g = _deep_tree_graph()
    u, v, w = (torch.from_numpy(g.u.astype(np.int64)),
               torch.from_numpy(g.v.astype(np.int64)), torch.from_numpy(g.w))
    depth_g, _ = bfs(u, v, g.n, select_root(u, v, g.n))
    assert int(depth_g.max()) == 1  # the guess is 3 levels: 2^3 = 8
    assert int(phase1_device(u, v, w, g.n)["depth_t"].max()) >= 8
    _check(J, g, dict(budget=4, auto_lift_bound=True, recovery=recovery))
