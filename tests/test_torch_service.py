"""The port's serving plane against the JAX package, on the CPU.

`repro_torch.serve.sparsify_service.SparsifyService` must return results
in request order, bit-identical to per-graph `lgrass_sparsify` (and the
baseline) in every mode: sync, async, async+donate and a mesh, here an
8-shard CPU mesh in place of XLA's forced host device count. Its
`ServiceStats` and `program_specs` must equal the reference service's on
the same traffic, and a 60-node graph padded past the reference's BFS
and Euler switch points must give the reference's masks. The test marked
`cuda` runs on the card (`chip_smoke.py` drives the service there).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import (baseline_sparsify, lgrass_sparsify,
                              lgrass_sparsify_batch)
from repro_torch.core import graph as tgraph
from repro_torch.core.distributed import batch_mesh, mesh_size
from repro_torch.core.graph import (GraphBatch, powergrid_like_graph,
                                    random_connected_graph, trivial_graph)
from repro_torch.core.sparsify import (lgrass_device_batched,
                                       lgrass_device_batched_donated)
from repro_torch.serve.sparsify_service import ServiceStats, SparsifyService

torch.set_num_threads(1)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def J():
    """The JAX package (skips where JAX is absent); its caches are
    cleared before and after this file (each compile holds memory maps
    until then)."""
    jax = pytest.importorskip("jax")
    from repro.core import graph as jgraph
    from repro.serve import sparsify_service as jservice

    jax.clear_caches()
    yield types.SimpleNamespace(graph=jgraph, service=jservice)
    jax.clear_caches()


def _mixed_graphs(m=tgraph):
    """Mixed sizes/families across several pow2 buckets, with trivial
    (edgeless) requests interleaved mid-stream."""
    gs = [
        m.random_connected_graph(30, 60, seed=0, weight="lognormal"),
        m.random_connected_graph(45, 110, seed=1, weight="ties"),
        m.powergrid_like_graph(6, 0.4, seed=3),
        m.trivial_graph(),
        m.random_connected_graph(24, 40, seed=2),
        m.random_connected_graph(18, 25, seed=7),
        m.trivial_graph(),
        m.random_connected_graph(40, 95, seed=5, weight="ties"),
    ]
    budgets = [8, None, 5, None, 3, None, 2, 7]
    return gs, budgets


def _reference(graphs, budgets):
    """The port's single CPU calls, each held to the baseline."""
    out = []
    for g, b in zip(graphs, budgets):
        if not g.m:
            out.append(None)
            continue
        r = lgrass_sparsify(g, budget=b, parallel=False, **CPU)
        assert np.array_equal(r.edge_mask,
                              baseline_sparsify(g, budget=b).edge_mask)
        out.append(r)
    return out


def _assert_request_order_parity(graphs, budgets, results, ref):
    assert len(results) == len(graphs)
    for k, (g, r) in enumerate(zip(graphs, results)):
        if g.m == 0:
            assert r.edge_mask.shape == (0,), k
            assert r.tree_mask.shape == (0,), k
            assert r.accepted_mask.shape == (0,), k
            assert r.n_accepted == 0, k
        else:
            assert np.array_equal(r.edge_mask, ref[k].edge_mask), k
            assert np.array_equal(r.tree_mask, ref[k].tree_mask), k
            assert np.array_equal(r.accepted_mask, ref[k].accepted_mask), k
            assert r.n_accepted == ref[k].n_accepted, k


def _cpu_mesh(n=8):
    return batch_mesh(n, device="cpu")


# ------------------------------------------------------------------ modes

@pytest.mark.parametrize("mode", ["sync", "async", "async_donate"])
def test_service_mode_parity(mode):
    """Mixed sizes, explicit+None budgets, chunk boundaries (chunks of
    3), and placeholder tails stay bit-identical to per-graph runs for
    every serving mode, including on a second call, which reuses the
    staging and donated pools."""
    graphs, budgets = _mixed_graphs()
    ref = _reference(graphs, budgets)
    svc = SparsifyService(
        parallel=False, max_batch_size=3,
        async_dispatch=(mode != "sync"),
        donate=(mode == "async_donate"), **CPU,
    )
    for _ in range(2):
        results = svc.sparsify(graphs, budget=budgets)
        _assert_request_order_parity(graphs, budgets, results, ref)


@pytest.mark.parametrize("mode", ["sync", "async_donate"])
def test_service_sharded_parity(mode):
    """Batch-axis sharding over an 8-shard CPU mesh is invisible in the
    results, composing with async + donation."""
    graphs, budgets = _mixed_graphs()
    ref = _reference(graphs, budgets)
    svc = SparsifyService(
        parallel=False, max_batch_size=4, mesh=_cpu_mesh(),
        async_dispatch=(mode != "sync"), donate=(mode == "async_donate"),
        **CPU,
    )
    for _ in range(2):
        results = svc.sparsify(graphs, budget=budgets)
        _assert_request_order_parity(graphs, budgets, results, ref)
    assert svc.stats.n_batch_pad_edge_slots > 0  # placeholder rows ran


def test_service_sharded_pad_batch_mesh_multiple():
    """With a mesh, the batch pad target is a whole multiple of the mesh
    size so every shard gets equal rows."""
    mesh = _cpu_mesh()
    ms = mesh_size(mesh)
    svc = SparsifyService(parallel=False, mesh=mesh, **CPU)
    for n_chunk in (1, 2, ms - 1, ms, ms + 1, 3 * ms):
        B = svc._pad_batch(n_chunk)
        assert B >= n_chunk and B % ms == 0, (n_chunk, B)


def test_service_single_device_mesh_path():
    """mesh=batch_mesh(1) runs the sharded code path on one device:
    results identical, pad target unchanged (pow2)."""
    graphs, budgets = _mixed_graphs()
    ref = _reference(graphs, budgets)
    svc = SparsifyService(parallel=False, mesh=_cpu_mesh(1),
                          async_dispatch=True, **CPU)
    results = svc.sparsify(graphs, budget=budgets)
    _assert_request_order_parity(graphs, budgets, results, ref)
    assert svc._pad_batch(3) == 4


def test_host_recovery_rejects_serving_modes():
    """The host oracle tail blocks per chunk by design; the serving modes
    require the device program."""
    for kw in (dict(async_dispatch=True), dict(donate=True),
               dict(mesh=_cpu_mesh(1))):
        with pytest.raises(ValueError):
            SparsifyService(recovery="host", **kw, **CPU)
    with pytest.raises(ValueError):
        SparsifyService(recovery="nope", **CPU)
    # plain host mode still serves
    g = random_connected_graph(20, 30, seed=3)
    svc = SparsifyService(parallel=False, recovery="host", **CPU)
    [r] = svc.sparsify([g], budget=4)
    assert np.array_equal(
        r.edge_mask,
        lgrass_sparsify(g, budget=4, parallel=False, recovery="host",
                        **CPU).edge_mask,
    )


# -------------------------------------------------------- trivial graphs

def test_trivial_graph_direct_and_batched():
    """Edgeless / single-node graphs return empty masks through the
    direct API and the batched path (an L_max == 0 batch)."""
    g1 = trivial_graph()
    g5 = dataclasses.replace(trivial_graph(), n=5)  # isolated nodes
    for g in (g1, g5):
        r = lgrass_sparsify(g, parallel=False, **CPU)
        assert r.edge_mask.shape == (0,) and r.n_accepted == 0
    batch = GraphBatch.from_graphs([g1, g5])
    assert batch.L_max == 0
    for r in lgrass_sparsify_batch(batch, parallel=False, **CPU):
        assert r.edge_mask.shape == (0,) and r.n_accepted == 0


def test_trivial_graph_service_regression():
    """Edgeless requests bucket through next_pow2(0), mixed with real
    traffic and empty request lists; 3 trivial graphs in a (1, 1) bucket
    force a placeholder row into the smallest possible bucket."""
    svc = SparsifyService(parallel=False, **CPU)
    assert svc.sparsify([]) == []

    g = random_connected_graph(20, 30, seed=1)
    ref = lgrass_sparsify(g, budget=5, parallel=False, **CPU)
    results = svc.sparsify([trivial_graph(), g, trivial_graph()],
                           budget=[None, 5, None])
    assert results[0].edge_mask.shape == (0,)
    assert results[2].edge_mask.shape == (0,)
    assert np.array_equal(results[1].edge_mask, ref.edge_mask)

    svc_min = SparsifyService(parallel=False, min_n_bucket=1,
                              min_L_bucket=1, **CPU)
    out = svc_min.sparsify([trivial_graph()] * 3)
    assert [r.edge_mask.shape for r in out] == [(0,)] * 3
    assert svc_min.stats.n_batch_pad_edge_slots == 1
    assert svc_min.warmup([(1, 0)]) == 1


# -------------------------------------------------------- stats: padding

def test_padding_overhead_split_pinned():
    """batch_pad (placeholder rows) vs shape_pad (real rows' tail) on a
    known request set, pinned to the reference's numbers.

    Set: 3x (n=20, m=49) -> bucket (32, 64), one chunk padded B=4
         1x (n=40, m=109) -> bucket (64, 128), one chunk of B=1
    """
    graphs = [random_connected_graph(20, 30, seed=s) for s in range(3)]
    graphs.append(random_connected_graph(40, 70, seed=9))
    assert [g.m for g in graphs] == [49, 49, 49, 109]
    svc = SparsifyService(parallel=False, **CPU)
    svc.sparsify(graphs, budget=4)
    s = svc.stats
    assert s.n_dispatches == 2
    assert s.bucket_counts == {(32, 64): 3, (64, 128): 1}
    assert s.n_padded_edge_slots == 4 * 64 + 1 * 128          # 384
    assert s.n_real_edge_slots == 3 * 49 + 109                # 256
    assert s.n_batch_pad_edge_slots == 1 * 64                 # 1 filler row
    assert s.n_shape_pad_edge_slots == (3 * 64 - 147) + (128 - 109)  # 64
    assert s.batch_pad_overhead == pytest.approx(64 / 384)
    assert s.shape_pad_overhead == pytest.approx(64 / 384)
    assert s.padding_overhead == pytest.approx((64 + 64) / 384)
    assert (s.n_real_edge_slots + s.n_batch_pad_edge_slots
            + s.n_shape_pad_edge_slots) == s.n_padded_edge_slots


def test_padding_overhead_empty_stats():
    s = ServiceStats()
    assert s.padding_overhead == 0.0
    assert s.batch_pad_overhead == 0.0
    assert s.shape_pad_overhead == 0.0


# -------------------------------------------- stats: on-path compiles

def test_on_path_compile_accounting():
    """warmup covering the traffic's dispatch signatures => zero on-path
    compiles; a request whose explicit budget exceeds the bucket default
    widens b_cap into a signature warmup never ran => counted once."""
    graphs = [random_connected_graph(20, 30, seed=s) for s in range(3)]
    svc = SparsifyService(parallel=False, **CPU)
    svc.warmup([(graphs[0].n, graphs[0].m)],   # B_pad 4, default b_cap
               batch_sizes=(3,))
    res = svc.sparsify(graphs)                 # one chunk of 3 -> B=4
    assert svc.stats.n_on_path_compiles == 0
    assert all(r is not None for r in res)

    # explicit budget 30 > default_budget(32) = 2: b_cap widens 8 -> 32
    svc.sparsify([graphs[0]], budget=30)
    assert svc.stats.n_on_path_compiles == 1
    svc.sparsify([graphs[0]], budget=30)       # same signature: not recounted
    assert svc.stats.n_on_path_compiles == 1
    assert (32, 64, 1, 32) in svc.compiled_signatures()

    svc2 = SparsifyService(parallel=False, **CPU)
    svc2.warmup([(graphs[0].n, graphs[0].m)], batch_sizes=(1, 3),
                budgets=[30])
    svc2.sparsify(graphs, budget=30)
    svc2.sparsify([graphs[0]], budget=30)
    assert svc2.stats.n_on_path_compiles == 0


def test_warmup_warms_the_traffic_program_variant():
    """warmup goes through the same dispatch funnel as traffic: with
    donate=True it leaves one donated buffer set for the signature in the
    pool, and serving that signature allocates no other."""
    g = random_connected_graph(20, 30, seed=3)
    svc = SparsifyService(parallel=False, async_dispatch=True, donate=True,
                          **CPU)
    assert svc.dispatch_fn is lgrass_device_batched_donated
    assert svc._device_pool.n_buffer_sets == 0
    svc.warmup([(g.n, g.m)])
    assert svc._device_pool.n_buffer_sets == 1
    [r] = svc.sparsify([g])
    assert svc._device_pool.n_buffer_sets == 1
    assert svc.stats.n_on_path_compiles == 0
    assert np.array_equal(
        r.edge_mask, lgrass_sparsify(g, parallel=False, **CPU).edge_mask)
    plain = SparsifyService(parallel=False, **CPU)
    plain.warmup([(g.n, g.m)])
    assert plain.dispatch_fn is lgrass_device_batched
    assert plain._device_pool.n_buffer_sets == 0


# ------------------------------------------------------- staging pool

def test_staging_pool_steady_state_no_growth():
    """The fenced pools grow only while chunks are in flight; repeat
    traffic reuses the same buffer sets, and results stay exact."""
    graphs, budgets = _mixed_graphs()
    ref = _reference(graphs, budgets)
    svc = SparsifyService(parallel=False, max_batch_size=3,
                          async_dispatch=True, donate=True, **CPU)
    _assert_request_order_parity(
        graphs, budgets, svc.sparsify(graphs, budget=budgets), ref)
    sets_after_first = svc._pool.n_buffer_sets
    donated_after_first = svc._device_pool.n_buffer_sets
    for _ in range(3):
        _assert_request_order_parity(
            graphs, budgets, svc.sparsify(graphs, budget=budgets), ref)
    assert svc._pool.n_buffer_sets <= sets_after_first + 1
    assert svc._device_pool.n_buffer_sets <= donated_after_first + 1


def test_async_budget_isolation_across_chunks():
    """Regression for the staging race: chunks of the same bucket carry
    different budgets; with async dispatch (and donation, whose device
    sets are fenced until drained) a later chunk's refill must not leak
    into an earlier undrained chunk."""
    graphs = [random_connected_graph(20, 30, seed=s) for s in range(6)]
    budgets = [2, 3, 4, 5, 6, 7]
    for donate in (False, True):
        svc = SparsifyService(parallel=False, max_batch_size=2,
                              async_dispatch=True, donate=donate, **CPU)
        for _ in range(2):
            results = svc.sparsify(graphs, budget=budgets)
            for g, b, r in zip(graphs, budgets, results):
                single = lgrass_sparsify(g, budget=b, parallel=False, **CPU)
                assert np.array_equal(r.edge_mask, single.edge_mask), b
                assert r.n_accepted == single.n_accepted, b
        if donate:  # three chunks of one shape in flight at once
            assert svc._device_pool.n_buffer_sets == 3


# ------------------------------------------------- the donated program

def test_donated_program_equals_plain_and_aliases_edge_valid():
    """`lgrass_device_batched_donated` gives the plain form's outputs bit
    for bit, and its tree_mask is the storage of the edge_valid it was
    handed."""
    graphs, _ = _mixed_graphs()
    b = GraphBatch.from_graphs(graphs, 64, 256)
    args = lambda: (torch.from_numpy(b.u.astype(np.int64)),  # noqa: E731
                    torch.from_numpy(b.v.astype(np.int64)),
                    torch.from_numpy(b.w.copy()),
                    torch.from_numpy(b.edge_valid.copy()))
    budgets = np.array([4, 2, 5, 1, 3, 2, 1, 6], np.int32)
    plain = lgrass_device_batched(*args(), budgets, 64, b_cap=8)
    donated_args = args()
    donated = lgrass_device_batched_donated(*donated_args, budgets, 64,
                                            b_cap=8)
    assert donated["tree_mask"].data_ptr() == donated_args[3].data_ptr()
    assert sorted(plain) == sorted(donated)
    for k in plain:
        assert torch.equal(plain[k], donated[k]), k


# ---------------------------------------------- against the reference

def test_stats_and_program_specs_equal_the_reference(J):
    """The reference's service and the port's on the same traffic: equal
    results, `ServiceStats` field for field (warmup time aside), and the
    same `program_specs` signatures and static kwargs."""
    kw = dict(parallel=False, max_batch_size=3)
    graphs, budgets = _mixed_graphs()
    jgraphs, _ = _mixed_graphs(J.graph)
    jsvc = J.service.SparsifyService(**kw)
    tsvc = SparsifyService(**kw, **CPU)
    jres = jsvc.sparsify(jgraphs, budget=budgets)
    tres = tsvc.sparsify(graphs, budget=budgets)
    for a, b in zip(tres, jres):
        assert np.array_equal(a.edge_mask, np.asarray(b.edge_mask))
        assert a.n_accepted == b.n_accepted
    js, ts = dataclasses.asdict(jsvc.stats), dataclasses.asdict(tsvc.stats)
    js.pop("warmup_seconds"), ts.pop("warmup_seconds")
    assert ts == js
    for prop in ("padding_overhead", "batch_pad_overhead",
                 "shape_pad_overhead"):
        assert getattr(tsvc.stats, prop) == getattr(jsvc.stats, prop)
    assert tsvc.compiled_signatures() == jsvc.compiled_signatures()
    sizes = [(g.n, g.m) for g in graphs] + [(5000, 20000)]
    for spec_kw in (dict(), dict(batch_sizes=(1, 3, 5), budgets=[30, 4])):
        for which in (None, sizes):
            tspecs = tsvc.program_specs(which, **spec_kw)
            jspecs = jsvc.program_specs(which, **spec_kw)
            assert [s.signature for s in tspecs] == \
                [s.signature for s in jspecs]
            assert [s.static_kwargs for s in tspecs] == \
                [s.static_kwargs for s in jspecs]
            assert [[a[0] for a in s.args] for s in tspecs] == \
                [[tuple(a.shape) for a in s.args] for s in jspecs]


def test_past_the_reference_switch_points(J):
    """A 60-node graph served at min_n_bucket=131072 runs a program whose
    n is past both of the reference's switch points (the packed BFS key
    at 46,339 nodes, the packed Euler key at 65,535): the two packages'
    masks are equal to each other and to the baseline."""
    from repro.core.bfs import EULER_PACK_MAX_N, PACKED_KEY_MAX_N

    assert 131072 > max(EULER_PACK_MAX_N, PACKED_KEY_MAX_N)
    kw = dict(parallel=False, min_n_bucket=131072)
    g = random_connected_graph(60, 120, seed=4)
    [t] = SparsifyService(**kw, **CPU).sparsify([g])
    [j] = J.service.SparsifyService(**kw).sparsify(
        [J.graph.random_connected_graph(60, 120, seed=4)])
    base = baseline_sparsify(g)
    assert np.array_equal(t.edge_mask, np.asarray(j.edge_mask))
    assert np.array_equal(t.accepted_mask, np.asarray(j.accepted_mask))
    assert t.n_accepted == j.n_accepted
    assert np.array_equal(t.edge_mask, base.edge_mask)


# ----------------------------------------------------- device resolution

def test_new_entry_points_need_a_card_unless_asked(monkeypatch):
    """Without a CUDA device the service, the two example twins,
    `block_sparse_attention` and `batch_mesh` raise by default and run
    with device="cpu": none drops to the CPU quietly."""
    from repro_torch.examples import batch_sparsify, sparse_attention
    from repro_torch.sparse import block_sparse_attention

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = random_connected_graph(20, 30, seed=1)
    q = np.ones((1, 64, 1, 8), np.float32)
    mask = np.tril(np.ones((2, 2), bool))
    calls = {
        "SparsifyService": lambda **kw: SparsifyService(
            parallel=False, **kw).sparsify([g]),
        "batch_sparsify": lambda **kw: batch_sparsify.main(
            ["--device", kw["device"]] if kw else []),
        "sparse_attention": lambda **kw: sparse_attention.main(
            ["--device", kw["device"]] if kw else []),
        "block_sparse_attention": lambda **kw: block_sparse_attention(
            q, q, q, mask, 32, **kw),
        "batch_mesh": lambda **kw: batch_mesh(2, **kw),
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
def test_cuda_donated_equals_plain_and_service_modes(card):
    """On the card: the donated form equals the plain form with tree_mask
    aliasing edge_valid, and every serving mode equals the single calls
    with one MARK and one REC launch per dispatched lane."""
    from repro_torch.kernels import ops

    graphs, budgets = _mixed_graphs()
    b = GraphBatch.from_graphs(graphs, 64, 256)
    args = lambda: tuple(torch.as_tensor(x, device=card) for x in (  # noqa
        b.u.astype(np.int64), b.v.astype(np.int64), b.w, b.edge_valid))
    bud = np.array([4, 2, 5, 1, 3, 2, 1, 6], np.int32)
    plain = lgrass_device_batched(*args(), bud, 64, b_cap=8)
    dargs = args()
    donated = lgrass_device_batched_donated(*dargs, bud, 64, b_cap=8)
    assert donated["tree_mask"].data_ptr() == dargs[3].data_ptr()
    for k in plain:
        assert torch.equal(plain[k], donated[k]), k
    ref = [lgrass_sparsify(g, budget=bb, parallel=False) if g.m else None
           for g, bb in zip(graphs, budgets)]
    for kw in (dict(), dict(async_dispatch=True),
               dict(async_dispatch=True, donate=True),
               dict(mesh=batch_mesh())):
        svc = SparsifyService(parallel=False, max_batch_size=3, **kw)
        for _ in range(2):
            ops.reset_launch_counts()
            res = svc.sparsify(graphs, budget=budgets)
            _assert_request_order_parity(graphs, budgets, res, ref)
            lanes = sum(svc._pad_batch(c) for c in (2, 2, 1, 1, 2))
            counts = ops.launch_counts()
            assert counts["mark"] == counts["rec"] == lanes, kw
