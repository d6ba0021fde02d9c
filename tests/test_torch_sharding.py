"""The port's sharding layer against the JAX package, on the CPU:
`models.sharding` (`spec`, `param_specs`, placed values),
`ft.elastic` (`resolve_spec_for_mesh`, `remesh_state`), the checkpoint
restore with shardings, `optim.compression.compressed_psum`,
`launch.mesh`, the `serve_lm` twin and `convert.from_reference`'s
device.

The reference's meshes are built over this box's one CPU device (`spec`
reads only the axis names); the port's meshes repeat the `cpu` device.
Specs are compared as tuples. Every comparison here is exact.
"""

import numpy as np
import pytest
import torch

from _torch_lm import port_cfg, reference_fixture
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.distributed import Mesh
from repro_torch.examples import serve_lm
from repro_torch.ft.elastic import remesh_state, resolve_spec_for_mesh
from repro_torch.launch.mesh import batch_axes_for, make_host_mesh
from repro_torch.models import convert
from repro_torch.models import sharding as tsh
from repro_torch.models.model import LM
from repro_torch.models.sharding import P, Placed, place
from repro_torch.optim.compression import compressed_psum

ARCH_NAMES = sorted(tconfigs.ARCHS)
MESH_AXES = (None, ("data",), ("data", "model"), ("pod", "data", "model"))


@pytest.fixture(scope="module")
def J():
    for ref in reference_fixture():
        from jax.sharding import Mesh as JMesh, PartitionSpec as JP
        from repro.ft import elastic as jel
        from repro.models import sharding as jsh
        from repro.optim import compression as jcomp
        from repro.train import train_step as jts

        ref.Mesh, ref.P, ref.sh, ref.el = JMesh, JP, jsh, jel
        ref.comp, ref.train_step = jcomp, jts
        yield ref


def ref_mesh(J, names):
    """A reference mesh named `names` over the one CPU device."""
    devs = np.array(J.jax.devices()[:1]).reshape((1,) * len(names))
    return J.Mesh(devs, names)


def port_mesh(names, sizes=None):
    sizes = sizes or (1,) * len(names)
    return Mesh((torch.device("cpu"),) * int(np.prod(sizes)), names, sizes)


def both_meshes(J, names):
    """(reference use_mesh, port use_mesh) context managers for `names`
    (None: no mesh)."""
    if names is None:
        return J.sh.use_mesh(None), tsh.use_mesh(None)
    return (J.sh.use_mesh(ref_mesh(J, names)),
            tsh.use_mesh(port_mesh(names)))


@pytest.mark.parametrize("names", MESH_AXES, ids=str)
def test_spec_matches_reference_for_every_logical_name(J, names):
    logical = sorted(tsh.AXIS_RULES) + [None]
    assert set(tsh.AXIS_RULES) == set(J.sh.AXIS_RULES)
    ref_ctx, port_ctx = both_meshes(J, names)
    with ref_ctx:
        want = [tuple(J.sh.spec(n)) for n in logical]
        want_all = tuple(J.sh.spec(*logical))
    with port_ctx:
        got = [tuple(tsh.spec(n)) for n in logical]
        got_all = tuple(tsh.spec(*logical))
    assert got == want
    assert got_all == want_all
    assert tsh.current_mesh() is None


def _ref_param_specs(J, cfg):
    """The reference's LM.init specs as {port name: spec tuple}, the scan
    layout's stack axis dropped."""
    specs = J.train_step.make_train_state_specs(J.model.LM(cfg))["params"]
    out = {}

    def walk(prefix, node, drop):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v, drop)
        else:
            out[prefix] = tuple(node)[1:] if drop else tuple(node)

    walk("", {k: v for k, v in specs.items() if k != "layers"}, False)
    layers = specs["layers"]
    for i in range(cfg.n_layers):
        if isinstance(layers, dict):      # scan: stacked
            assert all(tuple(p)[0] is None for p in J.jax.tree.leaves(
                layers, is_leaf=lambda x: isinstance(x, J.P)))
            walk(f"layers.{i}", layers, True)
        else:
            walk(f"layers.{i}", layers[i], False)
    return out


@pytest.mark.parametrize("names", (None, ("data", "model")), ids=str)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_reference_init(J, name, names):
    cfg = J.configs.ARCHS[name].reduced()
    model = LM(port_cfg(cfg), device="meta")
    ref_ctx, port_ctx = both_meshes(J, names)
    with ref_ctx:
        want = _ref_param_specs(J, cfg)
    with port_ctx:
        got = {n: tuple(p) for n, p in tsh.param_specs(model).items()}
    assert got == want


RESOLVE_CASES = [
    (P(("pod", "data"), None, "model"), ("data",)),   # test_ckpt_ft_data
    (P(("pod", "data"), None, "model"), ("data", "model")),
    (P(("pod", "data"), "model"), ("pod", "data", "model")),
    (P("data", "model"), ("model",)),
    (P(("data", "model"), None), ("data",)),
    (P(None, ("pod", "model")), ("pod",)),
    (P(), ("data",)),
    (P("pod"), ("data", "model")),
]


@pytest.mark.parametrize("p,names", RESOLVE_CASES, ids=str)
def test_resolve_spec_for_mesh_matches_reference(J, p, names):
    want = J.el.resolve_spec_for_mesh(J.P(*p), ref_mesh(J, names))
    got = resolve_spec_for_mesh(p, port_mesh(names))
    assert tuple(got) == tuple(want)
    assert isinstance(got, P)


@pytest.mark.parametrize("seed,shape", [(0, (64,)), (1, (5, 7)),
                                        (2, (3, 1, 33))])
def test_compressed_psum_equals_reference(J, seed, shape):
    xs = np.random.default_rng(seed).standard_normal(
        (8,) + shape).astype(np.float32)
    xs[3] *= 40.0     # one shard sets the shared scale
    fn = J.jax.vmap(lambda a: J.comp.compressed_psum(a, "d"), axis_name="d")
    want = np.asarray(fn(J.jnp.asarray(xs)))
    got = compressed_psum([torch.from_numpy(x) for x in xs])
    assert len(got) == 8
    for j, g in enumerate(got):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert np.array_equal(g.numpy(), want[j]), j
    exact = xs.sum(0)
    err = np.abs(got[0].numpy() - exact).max() / np.abs(exact).max()
    assert err < 0.05, err


def test_remesh_8_to_4x2_is_bit_equal():
    """tests/test_distributed.py:74-90 on CPU shards."""
    mesh8 = make_host_mesh(8, device="cpu")
    mesh42 = port_mesh(("data", "model"), (4, 2))
    x = place(np.arange(32, dtype=np.float32), mesh8, P("data"))
    assert [s.tolist() for s in x.shards] == [
        [4.0 * j, 4.0 * j + 1, 4.0 * j + 2, 4.0 * j + 3] for j in range(8)]
    state = {"w": x, "opt": {"step": torch.tensor(6, dtype=torch.int32)},
             "rows": [np.ones((4, 3), np.float32)]}
    spec = {"w": P("data"), "opt": {"step": P()},
            "rows": [P(("pod", "data"), "model")]}
    out = remesh_state(state, spec, mesh42)
    w = out["w"]
    assert isinstance(w, Placed) and w.mesh.shape["data"] == 4
    assert torch.equal(w.full(), torch.arange(32, dtype=torch.float32))
    for j, local in enumerate(w.shards):     # entry (j // 2, j % 2)
        assert local.tolist() == list(range(8 * (j // 2), 8 * (j // 2) + 8))
    assert int(out["opt"]["step"].full()) == 6
    rows = out["rows"][0]
    assert rows.spec == P("data", "model")
    assert [tuple(s.shape) for s in rows.shards] == [(1, 2), (1, 1)] * 4
    assert torch.equal(rows.full(), torch.ones(4, 3))


@pytest.mark.parametrize("shape,p,sizes", [
    ((10, 3), P("data"), (4, 2)),
    ((6, 5), P(("data", "model")), (2, 3)),
    ((6, 5), P("model", "data"), (2, 3)),
    ((2, 3, 4), P(None, None, ("model", "data")), (2, 2)),
    ((), P(), (2, 2)),
])
def test_place_blocks_and_full_round_trip(shape, p, sizes):
    """Blocks of ceil(n / parts) rows, the first axis of a tuple major;
    full() gives the tensor back."""
    mesh = port_mesh(("data", "model"), sizes)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    placed = place(x, mesh, p)
    assert torch.equal(placed.full(), x)
    for j, local in enumerate(placed.shards):
        d, m = divmod(j, sizes[1])
        at = {"data": d, "model": m}
        want = x
        for dim, entry in enumerate(p):
            axes = tsh._entry_axes(entry)
            parts = int(np.prod([dict(data=sizes[0], model=sizes[1])[a]
                                 for a in axes]))
            idx = 0
            for a in axes:
                idx = idx * dict(data=sizes[0], model=sizes[1])[a] + at[a]
            step = -(-shape[dim] // parts)
            want = want.narrow(dim, min(idx * step, shape[dim]),
                               max(0, min(step, shape[dim] - idx * step)))
        assert torch.equal(local, want), j
    # a placed value of one device shares its memory: no copy per shard
    if placed.shards:
        assert placed.shards[0].data_ptr() == x.data_ptr()


def test_place_refuses_axes_the_mesh_lacks():
    mesh = make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        place(torch.zeros(4), mesh, P("model"))
    with pytest.raises(ValueError):
        place(torch.zeros(4, 4), mesh, P("data", "data"))
    with pytest.raises(ValueError):
        place(torch.zeros(4), mesh, P(None, None))


def test_restore_with_shardings_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    state = {"params": {"a": torch.from_numpy(
        rng.standard_normal((8, 3)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(5).astype(np.float32))},
        "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, state)
    mesh = make_host_mesh(4, device="cpu")
    mesh22 = port_mesh(("data", "model"), (2, 2))
    shardings = {"params": {"a": (mesh, P("data")), "b": (mesh22,
                                                           P("model"))},
                 "opt": {"step": (mesh, P())}}
    out = ck.restore(3, state, shardings=shardings)
    a, b, step = out["params"]["a"], out["params"]["b"], out["opt"]["step"]
    assert isinstance(a, Placed) and a.mesh is mesh and a.spec == P("data")
    assert [tuple(s.shape) for s in a.shards] == [(2, 3)] * 4
    assert torch.equal(a.full(), state["params"]["a"])
    assert b.mesh is mesh22
    assert [tuple(s.shape) for s in b.shards] == [(3,), (2,)] * 2
    assert torch.equal(b.full(), state["params"]["b"])
    assert step.full().dtype == torch.int32 and int(step.full()) == 3
    host = ck.restore(3, state)
    assert isinstance(host["params"]["a"], np.ndarray)


@pytest.mark.parametrize("batch,sizes,names", [
    (256, (2, 16, 16), ("pod", "data", "model")),
    (1, (2, 16, 16), ("pod", "data", "model")),
    (16, (2, 16, 16), ("pod", "data", "model")),
    (8, (8,), ("data",)),
    (12, (8,), ("data",)),
    (8, (4, 2), ("data", "model")),
    (6, (3, 2), ("pod", "data")),
    (8, (2,), ("model",)),
])
def test_batch_axes_for_matches_reference(J, batch, sizes, names):
    from repro.launch import mesh as jmesh

    class FakeMesh:   # the reference reads only names and shape
        axis_names = names
        shape = dict(zip(names, sizes))

    want = jmesh.batch_axes_for(batch, FakeMesh())
    got = batch_axes_for(batch, port_mesh(names, sizes))
    assert got == want


def test_make_host_mesh():
    mesh = make_host_mesh(8, device="cpu")
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 8}
    assert set(mesh.devices) == {torch.device("cpu")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_host_mesh()


def test_shard_and_fsdp_use_leave_values_unchanged():
    x = torch.ones(3)
    with tsh.use_mesh(make_host_mesh(2, device="cpu")):
        assert tsh.shard(x, "batch") is x
        assert tsh.fsdp_use(x, "embed") is x
    assert tsh.OPTIMIZATIONS == set() and not tsh.opt_enabled("embed_dshard")


def test_serve_lm_twin_tokens_equal_reference(J, capsys):
    """The twin's `serve` on the reference's weights (carried across by
    models/convert) gives the reference example's tokens."""
    cfg = J.configs.ARCHS["hymba-1.5b"].reduced()
    m = J.model.LM(cfg)
    params, _ = m.init(J.jax.random.PRNGKey(0))
    params = J.jax.tree.map(np.asarray, params)
    batch, prompt_len, max_new = 4, 24, 16
    prompts = serve_lm.prompts_for(cfg, batch, prompt_len)
    rng = np.random.default_rng(0)      # the reference example's draw
    assert np.array_equal(prompts, rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)))
    want = J.serve_step.generate(m, params, J.jnp.asarray(prompts), max_new,
                                 prompt_len + max_new + 1)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    got = serve_lm.serve(model, prompts, max_new)
    assert got.shape == (batch, max_new)
    assert np.array_equal(got.numpy(), np.asarray(want))
    out = serve_lm.main(["--device", "cpu"])
    assert out.shape == (4, 16)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch=hymba-1.5b (reduced) batch=4 prompt=24 new=16"
    assert lines[1].startswith("64 tokens in ")
    assert lines[2] == f"  sample 0: {out[0].tolist()}"


def test_from_reference_defaults_to_the_card(J):
    cfg = J.configs.ARCHS["phi3-mini-3.8b"].reduced()
    params, _ = J.model.LM(cfg).init(J.jax.random.PRNGKey(0))
    params = J.jax.tree.map(np.asarray, params)
    if torch.cuda.is_available():
        model = convert.from_reference(port_cfg(cfg), params)
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.from_reference(port_cfg(cfg), params)
    assert convert.from_reference(port_cfg(cfg), params,
                                  device="cpu").device.type == "cpu"
