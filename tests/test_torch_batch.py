"""The port's batched pipeline against the JAX package, on the CPU.

`GraphBatch` pads B graphs to one (n_max, L_max) bucket; each lane runs
the padded program with its `edge_valid` mask. `phase1_device_batched`
must equal the reference's vmapped program on every key and every slot,
padding included; `lgrass_sparsify_batch` must equal per-graph
`lgrass_sparsify` and the baseline for every budget form and both
recovery modes; `recover_device_batched` must replay batched phase-1
outputs as the reference's does. The tests marked `cuda` run on the card
(`chip_smoke.py` drives the same paths at full size).
"""
import types

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core import graph as tgraph
from repro_torch.core.sparsify import phase1_views_np

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The JAX package (skips where JAX is absent); its caches are
    cleared before and after this file (each compile holds memory maps
    until then)."""
    jax = pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core import graph as jgraph
    from repro.core import recovery as jrecovery
    from repro.core import sort as jsort
    from repro.core import sparsify as jsparsify

    jax.clear_caches()
    yield types.SimpleNamespace(core=jcore, graph=jgraph,
                                recovery=jrecovery, sort=jsort,
                                sparsify=jsparsify)
    jax.clear_caches()


def _families(m, edgeless=True):
    """Mixed sizes and families, not sorted by size, and one graph with
    no edge at all. Its padded lane counts one group, the padding's, where
    its own run counts none (in the reference too), so the comparisons
    with single runs leave it out."""
    graphs = [m.random_connected_graph(30, 60, seed=0),
              m.powergrid_like_graph(6, 0.4, seed=3),
              m.random_connected_graph(45, 110, seed=1, weight="ties"),
              m.trivial_graph(),
              m.feeder_like_graph(40, 20, span=5, seed=2)]
    return graphs if edgeless else graphs[:3] + graphs[4:]


def _batch_tensors(b):
    return (torch.from_numpy(b.u.astype(np.int64)),
            torch.from_numpy(b.v.astype(np.int64)), torch.from_numpy(b.w),
            torch.from_numpy(b.edge_valid))


def test_graphbatch_layout_matches_reference(J):
    graphs = _families(tgraph)
    for bucket in ((None, None), (64, 256)):
        tb = tcore.GraphBatch.from_graphs(graphs, *bucket)
        jb = J.graph.GraphBatch.from_graphs(_families(J.graph), *bucket)
        assert (tb.batch_size, tb.n_max, tb.L_max) == (
            jb.batch_size, jb.n_max, jb.L_max)
        for key in ("u", "v", "w", "edge_valid", "n_real", "m_real"):
            a, b = getattr(tb, key), getattr(jb, key)
            assert a.dtype == b.dtype and np.array_equal(a, b), key
        for i, g in enumerate(graphs):
            assert not tb.edge_valid[i, g.m:].any()
            assert (tb.u[i, g.m:] == tgraph.PAD_ENDPOINT).all()
            assert (tb.w[i, g.m:] == tgraph.PAD_WEIGHT).all()
    g = graphs[0]
    for kw in (dict(n_max=8), dict(L_max=10)):
        for mod in (tgraph, J.graph):
            with pytest.raises(ValueError, match="too small"):
                mod.GraphBatch.from_graphs([g], **kw)
    with pytest.raises(ValueError, match="empty batch"):
        tcore.GraphBatch.from_graphs([])


@pytest.mark.parametrize("bucket", ["exact", "pow2"])
def test_phase1_device_batched_matches_reference_on_every_slot(J, bucket):
    """Every output of every lane, padding slots and padded nodes
    included, equal to the reference's vmapped phase 1 (criticality
    compared bit for bit)."""
    pad = dict(exact=(None, None), pow2=(64, 256))[bucket]
    tb = tcore.GraphBatch.from_graphs(_families(tgraph), *pad)
    jb = J.graph.GraphBatch.from_graphs(_families(J.graph), *pad)
    got = {k: x.numpy() for k, x in tcore.phase1_device_batched(
        *_batch_tensors(tb), tb.n_max).items()}
    want = {k: np.asarray(x) for k, x in J.core.phase1_device_batched(
        jb.u, jb.v, jb.w, jb.edge_valid, jb.n_max).items()}
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        a, b = got[key], want[key]
        if key == "crit":
            a, b = a.view(np.int32), b.view(np.int32)
        assert a.shape == b.shape and np.array_equal(a, b), key
    assert (want["depth_t"] == 2 ** 31 - 1).any()  # padded nodes


BUDGETS = {"default": None, "scalar": 5, "sequence": [3, None, 6, 2]}


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("recovery", ["device", "host"])
def test_lgrass_sparsify_batch_equals_single_and_baseline(recovery, budget):
    """A Graph list and a pow2-padded GraphBatch: each lane equals its
    graph's own `lgrass_sparsify` call (masks and statistics) and the
    baseline."""
    graphs = _families(tgraph, edgeless=False)
    b = BUDGETS[budget]
    per = b if isinstance(b, list) else [b] * len(graphs)
    runs = [tcore.lgrass_sparsify_batch(graphs, budget=b, recovery=recovery,
                                        device="cpu"),
            tcore.lgrass_sparsify_batch(
                tcore.GraphBatch.from_graphs(graphs, 64, 256), budget=b,
                recovery=recovery, device="cpu")]
    for results in runs:
        for g, gb, r in zip(graphs, per, results):
            one = tcore.lgrass_sparsify(g, budget=gb, recovery=recovery,
                                        device="cpu")
            assert np.array_equal(r.edge_mask, one.edge_mask)
            assert np.array_equal(r.tree_mask, one.tree_mask)
            assert np.array_equal(r.accepted_mask, one.accepted_mask)
            for stat in ("n_accepted", "n_groups", "n_overflow_groups",
                         "n_dirty"):
                assert getattr(r, stat) == getattr(one, stat), stat
            assert np.array_equal(
                r.edge_mask, tcore.baseline_sparsify(g, budget=gb).edge_mask)
    with pytest.raises(ValueError, match="one budget per graph"):
        tcore.lgrass_sparsify_batch(graphs, budget=[1, 2], device="cpu")


def test_lgrass_sparsify_batch_matches_reference(J):
    """Both recovery modes, k_cap = 1 (every group overflows), per-graph
    budgets: the port's batch == the reference's batch."""
    kw = dict(budget=[6, 4, 9, 1, 3], k_cap=1)
    j = J.core.lgrass_sparsify_batch(_families(J.graph), **kw)
    for recovery in ("device", "host"):
        t = tcore.lgrass_sparsify_batch(_families(tgraph), device="cpu",
                                        recovery=recovery, **kw)
        for a, b in zip(t, j):
            assert np.array_equal(a.edge_mask, b.edge_mask)
            assert (a.n_accepted, a.n_groups, a.n_overflow_groups,
                    a.n_dirty) == (b.n_accepted, b.n_groups,
                                   b.n_overflow_groups, b.n_dirty)
    assert sum(r.n_overflow_groups for r in j) > 0


def _batched_views(d, L_pad):
    """Each lane's `phase1_views_np` over the padded length, stacked."""
    views = [phase1_views_np({k: x[i] for k, x in d.items()}, L_pad)
             for i in range(d["tree_mask"].shape[0])]
    return [np.stack(col) for col in zip(*views)]


def test_recover_device_batched_from_batched_phase1(J):
    """`recover_device_batched` driven from `phase1_device_batched`
    outputs: every lane equals its graph's host replay, the Euler and the
    lifting engines agree, padding is never accepted, and the reference's
    batched replay of the same inputs agrees."""
    graphs = [tgraph.feeder_like_graph(80, 40, span=6, seed=11),
              tgraph.random_connected_graph(45, 110, seed=12,
                                            weight="ties"),
              tgraph.powergrid_like_graph(6, 0.4, seed=13)]
    tb = tcore.GraphBatch.from_graphs(graphs)
    d = {k: x.numpy() for k, x in tcore.phase1_device_batched(
        *_batch_tensors(tb), tb.n_max).items()}
    tree, crossing, accept, group, dirty0, order = _batched_views(
        d, tb.L_max)
    args = (d["up"], d["depth_t"].astype(np.int32), tb.u, tb.v,
            d["beta"].astype(np.int32), tree, crossing,
            order.astype(np.int32), accept, group.astype(np.int32), dirty0)
    budgets = np.array([6, 9, 5], np.int32)
    outs = {}
    for use_euler in (True, False):
        outs[use_euler] = tcore.recover_device_batched(
            *args, budgets, 16, edge_valid=tb.edge_valid,
            use_euler_lca=use_euler, device="cpu")
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])
    got, cnt = outs[True]
    for i, (g, b) in enumerate(zip(graphs, budgets)):
        want = tcore.lgrass_sparsify(g, budget=int(b), recovery="host",
                                     device="cpu").accepted_mask
        assert np.array_equal(got[i, :g.m].numpy(), want), i
        assert int(cnt[i]) == int(want.sum())
        assert not got[i, g.m:].any()
    j_got, j_cnt = J.recovery.recover_device_batched(
        *args, budgets, b_cap=16, edge_valid=tb.edge_valid)
    assert np.array_equal(got.numpy(), np.asarray(j_got))
    assert np.array_equal(cnt.numpy(), np.asarray(j_cnt))


def test_stable_group_sort_matches_reference(J):
    from repro_torch.core.sort import stable_group_sort

    rng = np.random.default_rng(0)
    for m in (1, 7, 300):
        groups = rng.integers(-3, 5, m).astype(np.int32)
        rank_perm = rng.permutation(m).astype(np.int32)
        got = stable_group_sort(torch.from_numpy(groups.astype(np.int64)),
                                torch.from_numpy(rank_perm.astype(np.int64)))
        want = J.sort.stable_group_sort(groups, rank_perm)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_new_entry_points_need_a_card_unless_asked(monkeypatch):
    """Without a CUDA device, the batch, the standalone replays and the
    quickstart raise by default and run with device="cpu": none drops to
    the CPU quietly."""
    from repro_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graphs = _families(tgraph)[:2]
    g = graphs[0]
    u, v, w = (torch.from_numpy(x) for x in (g.u.astype(np.int64),
                                             g.v.astype(np.int64), g.w))
    d = {k: x.numpy() for k, x in tcore.phase1_device(u, v, w, g.n).items()}
    tree, crossing, accept, group, dirty0, order = phase1_views_np(d, g.m)
    rec = (d["up"], d["depth_t"], g.u, g.v, d["beta"], tree, crossing,
           order, accept, group, dirty0)
    calls = {
        "lgrass_sparsify_batch": lambda **kw: tcore.lgrass_sparsify_batch(
            graphs, budget=3, **kw),
        "recover_device": lambda **kw: tcore.recover_device(*rec, 3, 8,
                                                            **kw),
        "recover_device_batched": lambda **kw: tcore.recover_device_batched(
            *(x[None] for x in rec), [3], 8, **kw),
        "quickstart": lambda **kw: quickstart.main(
            ["--device", kw["device"]] if kw else []),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu") is not None, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_batch_lanes_launch_mark_rec_radix(card):
    """On the card each lane of a batch launches MARK once, REC once and
    the radix argsort 5 times, and every lane's mask equals the
    baseline's; a scan schedule launches no MARK kernel."""
    from repro_torch.kernels import ops

    graphs = _families(tgraph)  # every lane has L_max slots, even the
    lanes = len(graphs)           # edgeless graph's
    for recovery in ("device", "host"):
        ops.reset_launch_counts()
        results = tcore.lgrass_sparsify_batch(graphs, budget=4,
                                              recovery=recovery)
        counts = ops.launch_counts()
        assert counts["mark"] == lanes
        assert counts["rec"] == (lanes if recovery == "device" else 0)
        assert counts["radix_hist"] == (5 if recovery == "device" else 4) * \
            len(graphs)
        for g, r in zip(graphs, results):
            assert np.array_equal(
                r.edge_mask, tcore.baseline_sparsify(g, budget=4).edge_mask)
    g = graphs[2]
    for parallel in (True, False):
        ops.reset_launch_counts()
        r = tcore.lgrass_sparsify(g, budget=4, schedule="scan",
                                  parallel=parallel)
        assert ops.launch_counts()["mark"] == 0
        assert np.array_equal(
            r.edge_mask, tcore.baseline_sparsify(g, budget=4).edge_mask)
