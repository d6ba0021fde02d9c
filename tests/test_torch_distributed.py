"""The port's multi-device module against the JAX package, on the CPU.

A mesh of 8 shards on `cpu` takes the place of XLA's forced host device
count. `partition_groups` must give the reference's plan array for array;
the group-sharded phase 1 (`lgrass_phase1_distributed`, one MARK call per
shard) must accept exactly what the unsharded phase 1 accepts in both
packages, and with the host replay give the baseline's mask. The test
marked `cuda` runs 4 shards of `cuda:0` on the card.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import (baseline_sparsify, phase1_device,
                              random_connected_graph)
from repro_torch.core import _host as H
from repro_torch.core.distributed import (Mesh, batch_mesh,
                                          lgrass_phase1_distributed,
                                          make_phase1_sharded, mesh_size,
                                          partition_groups,
                                          shard_batch_leading)
from repro_torch.core.marking import phase1_edge_views
from repro_torch.core.recovery import recover_host

torch.set_num_threads(1)

SEEDS = (0, 3)


@pytest.fixture(scope="module")
def J():
    """The JAX package (skips where JAX is absent); its caches are
    cleared before and after this file."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import lgrass as jconfigs
    from repro.core import distributed as jdist
    from repro.core import graph as jgraph
    from repro.core import sparsify as jsparsify

    jax.clear_caches()
    yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                dist=jdist, graph=jgraph, sparsify=jsparsify)
    jax.clear_caches()


def _tensors(g, dev="cpu"):
    return tuple(torch.as_tensor(x, device=dev) for x in (
        g.u.astype(np.int64), g.v.astype(np.int64), g.w))


def _unsharded_accept(d, L):
    """phase 1's accept scattered to edge order (torch or numpy dict)."""
    perm, acc = (np.asarray(d[k].cpu() if torch.is_tensor(d[k]) else d[k])
                 for k in ("perm", "accept_sorted"))
    out = np.zeros(L, bool)
    out[perm] = acc
    return out


def _reference_phase1(J, seed):
    g = J.graph.random_connected_graph(60, 140, seed=seed)
    u, v = (J.jnp.asarray(x, J.jnp.int32) for x in (g.u, g.v))
    w = J.jnp.asarray(g.w, J.jnp.float32)
    return {k: np.asarray(x) for k, x in J.jax.device_get(
        J.sparsify.phase1_device(u, v, w, g.n, 32, True)).items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_groups_equals_reference(J, seed):
    """The LPT plan, array for array, on the reference's group layout,
    for several shard counts."""
    d = _reference_phase1(J, seed)
    perm = d["perm"].astype(np.int64)
    gidx = d["gidx"].astype(np.int64)
    active = d["crossing"].astype(bool)[perm]
    for n_shards in (1, 3, 8):
        got = partition_groups(perm, gidx, active, n_shards)
        want = J.dist.partition_groups(perm, gidx, active, n_shards)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


@pytest.mark.parametrize("seed", SEEDS)
def test_sharded_phase1_equals_local(J, seed):
    """8 shards on the CPU accept exactly what the unsharded phase 1
    accepts, the reference's and the port's; the phase-1 outputs it
    returns are the port's `phase1_device`'s."""
    g = random_connected_graph(60, 140, seed=seed)
    mesh = Mesh(("cpu",) * 8, ("data",))
    acc, dirty, d = lgrass_phase1_distributed(g, mesh, ("data",))
    want = _unsharded_accept(_reference_phase1(J, seed), g.m)
    port = phase1_device(*_tensors(g), g.n, 32, True)
    assert np.array_equal(acc, want)
    assert np.array_equal(acc, _unsharded_accept(port, g.m))
    assert not dirty.any()
    for k, x in port.items():
        assert np.array_equal(d[k], x.numpy()), k


def _shard_blocks(g, n_shards, k_cap):
    """The plan's shard blocks of g as the sharded phase 1 builds them:
    (tables, [(su, sv, sbeta, gstart, active) per shard])."""
    from repro_torch.core.lca import LiftingTables

    u, v, w = _tensors(g)
    d = phase1_device(u, v, w, g.n, k_cap, True)
    perm = d["perm"].numpy()
    plan = partition_groups(perm, d["gidx"].numpy(),
                            d["crossing"].numpy()[perm], n_shards)
    eid = torch.from_numpy(np.where(plan.slot_edge >= 0, plan.slot_edge, 0))
    cols = (u[eid], v[eid], d["beta"][eid],
            torch.from_numpy(plan.group_start),
            torch.from_numpy(plan.slot_edge >= 0))
    lo = plan.local_len
    blocks = [tuple(c[j * lo:(j + 1) * lo] for c in cols)
              for j in range(n_shards)]
    return LiftingTables(up=d["up"], depth=d["depth_t"]), blocks


@pytest.mark.parametrize("seed", SEEDS)
def test_shard_layouts_keep_the_mark_kernels_contract(seed):
    """Each shard's block as a group layout: `group_start` indexed by
    dense group (first slot of each group, the slot count past the last),
    the padding as one inactive tail group; and csrc/mark.cu's schedule,
    emulated in numpy (`test_torch_pipeline._emulate_mark`), makes the
    plain loop's decisions on it."""
    from test_torch_pipeline import _emulate_mark, _engine_fns

    from repro_torch.core.distributed import _local_layout, _local_phase1

    g = random_connected_graph(60, 140, seed=seed)
    for n_shards, k_cap in ((3, 1), (8, 2), (8, 32)):
        t, blocks = _shard_blocks(g, n_shards, k_cap)
        dist = _engine_fns(t, None)
        depth = t.depth.numpy().astype(np.int64)
        for su, sv, sb, gstart, active in blocks:
            layout, head = _local_layout(gstart, active)
            m, ng = su.shape[0], int(layout.n_groups)
            gs, gidx = layout.group_start.numpy(), layout.gidx.numpy()
            firsts = np.flatnonzero(np.r_[True, gidx[1:] != gidx[:-1]])
            assert np.array_equal(gs[:ng], firsts)
            assert (gs[ng:] == m).all()
            assert np.array_equal(head.numpy(), np.isin(np.arange(m),
                                                        firsts))
            act = active.numpy()
            assert not (act[1:] & ~act[:-1]).any()  # crossing slots first
            acc, ovf = _emulate_mark(dist, depth, su.numpy(), sv.numpy(),
                                     sb.numpy(), layout, k_cap)
            want_acc, want_ovf = _local_phase1(t.up, t.depth, su, sv, sb,
                                               gstart, active, k_cap)
            assert np.array_equal(acc, want_acc.numpy())
            assert np.array_equal(head.numpy() & ovf[gidx],
                                  want_ovf.numpy())


def test_sharded_phase1_overflow_marks_the_group_dirty():
    """k_cap = 1 overflows groups: the dirty set by edge equals the
    unsharded phase 1's initial dirty set, and accept still equals."""
    g = random_connected_graph(60, 140, seed=0)
    acc, dirty, _ = lgrass_phase1_distributed(g, batch_mesh(8, device="cpu"),
                                              k_cap=1)
    d = phase1_device(*_tensors(g), g.n, 1, True)
    _, _, dirty0 = phase1_edge_views(d["perm"], d["gidx"],
                                     d["accept_sorted"], d["group_overflow"],
                                     d["crossing"])
    assert dirty.any()
    assert np.array_equal(dirty, dirty0.numpy())
    assert np.array_equal(acc, _unsharded_accept(d, g.m))


def test_distributed_sparsify_equals_oracle():
    """The sharded phase 1 followed by the host replay gives the
    baseline's mask at budget 10."""
    g = random_connected_graph(50, 120, seed=5)
    b = baseline_sparsify(g, budget=10)
    acc, dirty, d = lgrass_phase1_distributed(g, batch_mesh(8, device="cpu"))
    tree = d["tree_mask"].astype(bool)
    crossing = d["crossing"].astype(bool)
    perm = d["perm"].astype(np.int64)
    group = np.full(g.m, -1, np.int64)
    group[perm] = d["gidx"].astype(np.int64)
    group[~crossing] = -1
    keys = np.where(~tree, d["crit"], np.float32(-np.inf))
    order = H.desc_stable_order_np(keys)[: int((~tree).sum())]
    final = recover_host(g.n, g.u.astype(np.int64), g.v.astype(np.int64),
                         tree, d["parent_t"], d["depth_t"], d["up"],
                         d["beta"], crossing, order, acc, group, dirty, 10)
    assert np.array_equal(tree | final, b.edge_mask)


def test_make_phase1_sharded_refuses_a_partial_axis_set():
    mesh = Mesh(("cpu",) * 4, ("pod", "data"), (2, 2))
    assert mesh.shape == {"pod": 2, "data": 2} and mesh_size(mesh) == 4
    with pytest.raises(ValueError, match="every axis"):
        make_phase1_sharded(mesh, ("data",))
    assert make_phase1_sharded(mesh) is not None


def test_shard_batch_leading_splits_and_refuses_ragged_axes():
    mesh = batch_mesh(4, device="cpu")
    x = torch.arange(8 * 3).reshape(8, 3)
    y = torch.arange(8)
    parts = shard_batch_leading((x, y), mesh)
    assert len(parts) == 4
    for j, (px, py) in enumerate(parts):
        assert torch.equal(px, x[2 * j: 2 * j + 2])
        assert torch.equal(py, y[2 * j: 2 * j + 2])
        assert px.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch_leading((torch.zeros(6, 2),), mesh)


def test_mesh_construction(monkeypatch):
    """A CPU mesh may repeat its device; a mesh naming CUDA without a
    card raises, as does batch_mesh by default."""
    assert batch_mesh(8, device="cpu").devices == (torch.device("cpu"),) * 8
    assert batch_mesh(device="cpu").shape == {"batch": 1}
    with pytest.raises(ValueError):
        Mesh(("cpu",) * 3, ("a", "b"), (2, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cannot see"):
        Mesh(("cuda:0",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_mesh()


def test_lgrass_cases_equal_reference(J):
    from repro_torch.configs.lgrass import CASES

    assert {k: dataclasses.asdict(c) for k, c in CASES.items()} == \
        {k: dataclasses.asdict(c) for k, c in J.configs.CASES.items()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sharded_phase1_four_shards_of_one_card(card):
    """4 shards of cuda:0: one MARK launch per shard (plus the unsharded
    phase 1's), accept equal to the unsharded phase 1's."""
    from repro_torch.core import official_case
    from repro_torch.kernels import ops

    mesh = batch_mesh(4, device="cuda:0")
    for g in (random_connected_graph(60, 140, seed=0),
              official_case("case1")):
        ops.reset_launch_counts()
        acc, dirty, d = lgrass_phase1_distributed(g, mesh)
        assert ops.launch_counts()["mark"] == 1 + 4
        assert np.array_equal(acc, _unsharded_accept(d, g.m))
