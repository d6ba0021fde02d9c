"""The port's FSDP over 'data' against the JAX package, on the CPU.

A train state laid out by the reference's full `param_specs`
(`train_step.make_train_state(model, specs=param_specs(model))` under
`use_mesh`): each mesh entry holds its ('data', 'model') block of every
parameter, mu and nu, a layer's weights are gathered before use
(`models.sharding.fsdp_use`, the `data_allgather` operator) and their
gradients go back to the blocks' keepers. The meshes: 8 data shards of
`cpu`, and a ('data', 'model') mesh of (4, 2) whose data shards 1 to 3
sit on `cpu:1` (which compares unequal to `cpu`, so a gather crosses
devices).

  * the FSDP step of phi3 (dense), hymba (hybrid: FSDP on 'data' alone)
    and granite (MoE) on 8 data shards, and of phi3 and granite on
    (4, 2), against the reference's jitted whole-batch step, with two
    microbatches on the uneven-mask batch of `test_torch_mesh_train.py`;
  * the same steps `torch.equal` to the port's ZeRO step
    (`grad_shard_specs=param_specs`) on the same mesh with the clip on
    (loss, grad_norm, aux, every parameter, mu and nu), and two runs
    bit-equal; so are int8 and top-k compression (error feedback too);
  * the layout after a step: no entry holds another entry's block or a
    whole 'model' block; the distinct local tensors' bytes sum to the
    unsharded state's; `_replicas` finds no other tensor for a block;
  * serving on the FSDP model (prefill and three decode steps): logits
    `torch.equal` to the model's in its default layout;
  * a checkpoint of an FSDP state writes the unsharded save's arrays;
    restored and remeshed from 8 data shards to FSDP on (4, 2) and to the
    'model' layout, 4 + 4 steps against 8 unsharded steps;
  * `data_gather` and its gradient against a plain concatenation;
  * the dry-run's trace of a train step in the reference's layout on a
    ('data', 'model') meta mesh: its state bytes are the reference
    layout's, and its "gather" collectives are counted;
  * bf16 tensor parallelism: a replicated input's gradient on four
    'model' entries is one entry's (float32 partials rounded once), and
    the unsharded block's own bf16 rounding is what sets them apart
    from it.

Tolerances are `test_torch_train.py`'s, for the reasons given there:
loss 1e-5; gradients, mu and nu at 1e-4 of a leaf's max; params through
AdamW's first step. The restart's losses: 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm import port_cfg, reference_fixture
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.distributed import Mesh
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.ft.elastic import remesh_state
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import sharding as sh
from repro_torch.models.model import LM
from repro_torch.optim.optimizer import OptConfig
from repro_torch.serve import serve_step as tserve
from repro_torch.train import train_step as tts
from test_torch_mesh_train import MOE, reference_step, uneven_batch
from test_torch_tensor_parallel import check_step, whole_state
from test_torch_train import OPT

torch.set_num_threads(1)

CPU = torch.device("cpu")
CPU1 = torch.device("cpu", 1)   # compares unequal to `cpu`
PHI3, HYMBA = "phi3-mini-3.8b", "hymba-1.5b"
# (arch, mesh) of the train cases
CASES = [(PHI3, "data8"), (HYMBA, "data8"), (MOE, "data8"),
         (PHI3, "4x2 cpu1"), (MOE, "4x2 cpu1")]


@pytest.fixture(scope="module")
def J():
    for ref in reference_fixture():
        from repro.optim import compression as jcomp
        from repro.optim import optimizer as jopt
        from repro.train import train_step as jts

        ref.opt, ref.comp, ref.train_step = jopt, jcomp, jts
        yield ref


def mesh_of(name: str) -> Mesh:
    """8 data shards of `cpu`, or (4, 2) ('data', 'model') with data
    shards 1 to 3 on `cpu:1`."""
    if name == "data8":
        return make_host_mesh(8, device="cpu")
    return Mesh(tuple(CPU1 if j // 2 else CPU for j in range(8)),
                ("data", "model"), (4, 2))


def laid_out(model, mesh, fsdp=True):
    """`model`'s train state under `mesh`: by `param_specs` (FSDP), or in
    the default layout; and the specs."""
    with sh.use_mesh(mesh):
        specs = sh.param_specs(model)
        state = tts.make_train_state(model, specs=specs if fsdp else None)
    return state, specs


def run_step(model, state, specs, mesh, batch, opt):
    """One step of two microbatches on `mesh`, the accumulator's tiles by
    `specs` (ZeRO)."""
    with sh.use_mesh(mesh):
        step = tts.make_train_step(model, opt, micro_batches=2,
                                   grad_shard_specs=specs)
        return step(state, {k: torch.as_tensor(v) for k, v in batch.items()})


def check_fsdp_layout(model, state, mesh):
    """Every leaf whose spec names 'data' is an FSDP value of the model and
    of the state (its moments too), each entry holding its own block:
    no entry another's, nor a whole 'model' block."""
    cfg = model.cfg
    with sh.use_mesh(mesh):
        specs = sh.param_specs(model)
    leaves = dict(sh.named_leaves(model))
    assert sh.placed_mesh(model) == mesh and sh.placed_specs(model) == specs
    for name, p in specs.items():
        laid = sh.layout_spec(p, mesh, cfg)
        for tree in (state["params"], state["opt"]["mu"],
                     state["opt"]["nu"]):
            x = tree[name]
            if laid is None:
                assert not isinstance(x, sh.Placed), name
                continue
            assert sh.is_fsdp(x) and x.spec == laid, name
            for j, local in enumerate(x.shards):
                want = tuple(s.stop - s.start for s in x.block(j))
                assert tuple(local.shape) == want, (name, j)
                assert local.untyped_storage().nbytes() == \
                    local.numel() * local.element_size(), (name, j)
                rest = sh.block_slices(x.shape, sh.drop_batch_axes(x.spec),
                                       mesh.shape, sh.entry_coords(mesh, j))
                assert local.numel() < np.prod([s.stop - s.start
                                                for s in rest]), (name, j)
        assert state["params"][name] is leaves[name], name


@pytest.mark.parametrize("name,mesh", CASES)
def test_fsdp_step_matches_reference_whole_batch(J, name, mesh):
    """The FSDP step against the reference's jitted whole-batch step (two
    microbatches); the state laid out by `param_specs` before and after
    it."""
    cfg, _, batch, start, want_state, want = reference_step(J, name)
    m = mesh_of(mesh)
    model = LM(port_cfg(cfg), device="cpu", param_dtype=torch.float32)
    state, specs = laid_out(model, m)
    tts.load_train_state(state, convert.from_reference_train_state(
        model.cfg, start))
    check_fsdp_layout(model, state, m)
    state, got = run_step(model, state, specs, m, batch, OptConfig(**OPT))
    check_fsdp_layout(model, state, m)
    check_step(got, state, want, want_state, cfg)


def _seeded(name):
    cfg = tconfigs.get_arch(name).reduced()
    return LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
              param_dtype=torch.float32)


@pytest.mark.parametrize("name,mesh", CASES)
def test_fsdp_step_equals_zero_step(name, mesh):
    """With the clip on (it scales this step's gradients), the FSDP step
    is `torch.equal` to the ZeRO step on the same mesh: the same
    products on the same values, the data shards' gradients of a block
    summed in float32 in mesh order on its keeper, the tiles in the same
    order (so the global norm sums alike); two FSDP runs are bit-equal."""
    batch = uneven_batch(tconfigs.get_arch(name).reduced())
    opt = OptConfig(clip_norm=0.1, **OPT)
    out = []
    for fsdp in (False, True, True):
        model = _seeded(name)
        state, specs = laid_out(model, mesh_of(mesh), fsdp)
        state, got = run_step(model, state, specs, mesh_of(mesh), batch, opt)
        out.append((whole_state(state), got))
    (zero, zm), (a, am), (b, bm) = out
    assert float(zm["grad_norm"]) > opt.clip_norm
    for other, om in ((a, am), (b, bm)):
        assert set(om) == set(zm)
        for k in zm:
            assert torch.equal(om[k], zm[k]), k
        for part in ("params", "mu", "nu"):
            tree = other["params"] if part == "params" else other["opt"][part]
            ztree = zero["params"] if part == "params" else zero["opt"][part]
            for n in ztree:
                assert torch.equal(tree[n], ztree[n]), (part, n)


@pytest.mark.parametrize("compress", ["int8", "topk"])
def test_fsdp_compressed_step_equals_zero_step(compress):
    """Compression on an FSDP state (the error feedback laid out as the
    parameters): the blocks' sums gathered on the root, compressed on
    the reference's leaves, handed back to their keepers, as for ZeRO:
    `torch.equal` to the ZeRO step on (4, 2), error feedback included."""
    from repro_torch.optim import compression as tcomp

    batch = uneven_batch(tconfigs.get_arch(PHI3).reduced())
    mesh = mesh_of("4x2 cpu1")
    out = []
    for fsdp in (False, True):
        model = _seeded(PHI3)
        state, specs = laid_out(model, mesh, fsdp)
        state["err"] = tcomp.init_error_state(state["params"])
        with sh.use_mesh(mesh):
            step = tts.make_train_step(model, OptConfig(**OPT),
                                       micro_batches=2, compress=compress,
                                       grad_shard_specs=specs)
            state, got = step(state, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
        assert fsdp == sh.is_fsdp(state["err"]["embedding"])
        out.append((whole_state(state), {n: e.full(CPU)
                                         if isinstance(e, sh.Placed) else e
                                         for n, e in state["err"].items()},
                    got))
    (zs, ze, zm), (fs, fe, fm) = out
    for k in zm:
        assert torch.equal(fm[k], zm[k]), k
    for n in zs["params"]:
        assert torch.equal(fs["params"][n], zs["params"][n]), n
        assert torch.equal(fs["opt"]["mu"][n], zs["opt"]["mu"][n]), n
        assert torch.equal(fe[n], ze[n]), n


@pytest.mark.parametrize("name", [PHI3, MOE])
def test_fsdp_entries_hold_their_own_blocks_alone(name):
    """After a step on (4, 2) with entries on `cpu` and `cpu:1`: the
    distinct local tensors of the parameters, mu and nu add up to the
    unsharded state's bytes (no block is held twice, none whole), and no
    other tensor holds an FSDP block (`_replicas`), so AdamW's updated
    blocks are copied nowhere."""
    batch = uneven_batch(tconfigs.get_arch(name).reduced())
    whole = _seeded(name)
    want = 3 * sum(p.numel() * p.element_size() for p in whole.parameters())
    mesh = mesh_of("4x2 cpu1")
    model = _seeded(name)
    state, specs = laid_out(model, mesh)
    state, _ = run_step(model, state, specs, mesh, batch, OptConfig(**OPT))
    check_fsdp_layout(model, state, mesh)
    held = 0
    for tree in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for x in tree.values():
            held += sum(t.numel() * t.element_size()
                        for t in sh.local_tensors(x))
            if sh.is_fsdp(x):
                keys = {(x.mesh.devices[j], x.block_key(j))
                        for j in range(len(x.shards))}
                assert len(x.distinct()) == len(keys), x
                assert {x.mesh.devices[j] for j, _ in x.distinct()} == {
                    CPU, CPU1}
                for j in range(len(x.shards)):
                    assert tts._replicas(x, j) == [j]
    assert held == want
    with sh.use_mesh(mesh):
        per = tts.entry_bytes(model, state, 32, specs)
    assert sum(e["accumulator"] for e in per) == want // 3
    assert all(e["params"] == e["mu"] == e["nu"] for e in per)


@pytest.mark.parametrize("name,mesh", [(PHI3, "4x2 cpu1"), (PHI3, "data8"),
                                       (MOE, "4x2 cpu1"), (HYMBA, "data8")])
def test_fsdp_serving_logits_equal_the_default_layout(name, mesh):
    """bf16 activations, float32 leaves: the prefill's logits and three
    decode steps' on the FSDP model (each layer gathered per step, in
    bf16) `torch.equal` to the same model's in its default layout (the
    'model' blocks, or whole leaves), fed the same tokens."""
    cfg = dataclasses.replace(tconfigs.get_arch(name).reduced(),
                              dtype="bfloat16")
    model = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
               param_dtype=torch.float32)
    m = mesh_of(mesh)
    b, s, max_len = 8, 12, 20
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    runs = []
    for fsdp in (True, False):
        with sh.use_mesh(m):
            if fsdp:
                sh.lay_out_model(model, sh.param_specs(model))
                assert any(sh.is_fsdp(x) for _, x in sh.named_leaves(model))
            else:
                sh.gather_model(model)
            caches = tserve.init_caches(model, b, max_len)
            logits, caches = tserve.make_prefill_step(model)(
                toks[:, :s - 3], caches)
            out = [logits]
            decode = tserve.make_decode_step(model)
            for i in range(s - 3, s):
                _, logits, caches = decode(toks[:, i:i + 1], i, caches)
                out.append(logits)
        assert fsdp == any(sh.is_fsdp(x) for _, x in sh.named_leaves(model))
        runs.append(out)
    for i, (a, c) in enumerate(zip(*runs)):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, c), f"step {i}"


@pytest.mark.parametrize("target", ["fsdp", "model"])
def test_fsdp_state_checkpoints_restores_and_remeshes(tmp_path, target):
    """4 FSDP steps on 8 data shards, a checkpoint (the arrays an
    unsharded save of the same state writes, byte for byte),
    restore(shardings=) in the FSDP layout there, `remesh_state` onto
    (4, 2) by `param_specs` (FSDP) or by the 'model' layout, a fresh
    state there filled from it, 4 more steps: the 8 losses against 8
    unsharded steps (1e-5)."""
    cfg = tconfigs.get_arch(PHI3).reduced()
    opt = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=8, seed=3), device="cpu")

    def fresh():
        return LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu", param_dtype=torch.float32)

    model = fresh()
    state = tts.make_train_state(model)
    step = tts.make_train_step(model, opt)
    want = [float(step(state, data.batch(i))[1]["loss"]) for i in range(8)]
    m8, m42 = mesh_of("data8"), mesh_of("4x2 cpu1")
    model = fresh()
    state, specs8 = laid_out(model, m8)
    step = tts.make_train_step(model, opt)
    with sh.use_mesh(m8):
        losses = [float(step(state, data.batch(i))[1]["loss"])
                  for i in range(4)]
    assert sh.is_fsdp(state["params"]["embedding"])
    ck = Checkpointer(str(tmp_path / "fsdp"), async_save=False)
    ck.save(4, state)
    whole = whole_state(state)
    Checkpointer(str(tmp_path / "whole"), async_save=False).save(4, whole)
    with np.load(tmp_path / "fsdp" / "step_4" / "proc_0.npz") as a, \
            np.load(tmp_path / "whole" / "step_4" / "proc_0.npz") as b:
        assert a.files == b.files and "params/embedding" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    names = list(whole["params"])

    def tree(leaf):
        return {"params": {n: leaf(n) for n in names},
                "opt": {"mu": {n: leaf(n) for n in names},
                        "nu": {n: leaf(n) for n in names},
                        "step": leaf(None)}}

    restored = ck.restore(4, tree(lambda n: None), shardings=tree(
        lambda n: (m8, sh.P() if n is None else specs8[n])))
    assert sh.is_fsdp(restored["opt"]["mu"]["embedding"])
    model = fresh()
    state, specs42 = laid_out(model, m42, fsdp=target == "fsdp")
    layout = {n: (specs42[n] if target == "fsdp" else
                  sh.leaf_spec(cfg, n, len(whole["params"][n].shape)))
              for n in names}
    placed = remesh_state(restored, tree(
        lambda n: sh.P() if n is None else layout[n]), m42)
    tts.load_train_state(state, placed)
    if target == "fsdp":
        check_fsdp_layout(model, state, m42)
    else:
        assert not any(sh.is_fsdp(x) for x in state["params"].values())
    for n, x in whole_state(state)["params"].items():
        assert torch.equal(x, whole["params"][n]), n
    step = tts.make_train_step(model, opt)
    with sh.use_mesh(m42):
        losses += [float(step(state, data.batch(i))[1]["loss"])
                   for i in range(4, 8)]
    assert int(state["opt"]["step"]) == 8
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)


def test_data_gather_and_its_gradient():
    """An FSDP leaf's gathered block for an entry is the plain
    concatenation of its blocks along its 'data' dimension, cast; its
    gradient hands each block its slice, in the block's dtype; a leaf
    not laid out over batch axes comes back unchanged."""
    mesh = mesh_of("4x2 cpu1")
    x = torch.randn(10, 6, dtype=torch.float32)
    w = sh.place(x, mesh, sh.P("data", "model"), own=True)
    for t in sh.local_tensors(w):
        t.requires_grad_(True)
    assert sh.is_fsdp(w) and not sh.is_fsdp(sh.place(x, mesh,
                                                     sh.P(None, "model")))
    for j in (0, 3, 6):
        g = sh.data_gather(w, j, torch.bfloat16)
        blk = w.block(j)[1]
        # (a CPU tensor's device has no index: `cpu:1` reads `cpu`)
        assert g.device.type == "cpu" and g.dtype == torch.bfloat16
        assert torch.equal(g, x[:, blk].to(torch.bfloat16))
        seed = torch.randn(g.shape).to(torch.bfloat16)
        d, src = sh.gather_sources(w, j)
        assert d == 0 and len(src) == 4
        grads = torch.autograd.grad((g * seed).sum(),
                                    [w.shards[i] for i in src])
        rows = 0
        for i, gr in zip(src, grads):
            n = w.shards[i].shape[0]
            assert gr.dtype == torch.float32
            assert torch.equal(gr, seed[rows:rows + n].float())
            rows += n
    y = torch.ones(3)
    assert sh.fsdp_use(y, "embed") is y


def test_dryrun_traces_the_reference_layout():
    """A train step traced in the reference's layout on a (4, 2) ('data',
    'model') meta mesh (`dryrun._trace_train`): the entry's parameters,
    mu and nu bytes are the reference layout's (`launch/specs.py`), its
    blocks are FSDP values, and each layer's gather and its gradient's
    reduce-scatter are counted by kind (two gathers a use under remat:
    the forward's and the recompute's)."""
    from repro_torch.launch import dryrun as D

    cfg = dataclasses.replace(tconfigs.get_arch(PHI3).reduced(), remat=True)
    mesh = Mesh((torch.device("meta"),) * 8, ("data", "model"), (4, 2))
    hlo, (n, blocks), held = D._trace_train(cfg, 2, 16, 2, 2, mesh)
    assert held == D.reference_state_bytes(cfg, mesh) > 0
    assert 0 < blocks < n
    counts = hlo["data_collective_counts"]
    # 7 leaves a layer, gathered in the forward and the recompute; the
    # embedding and the head once a microbatch
    per_mb = cfg.n_layers * 7 * 2 + 2
    assert counts["gather"] == 2 * per_mb
    assert counts["gather:bwd"] == 2 * (cfg.n_layers * 7 + 2)
    assert hlo["data_collective_by_kind"]["gather"] > 0
    model, _ = D._meta_model(cfg, 2, mesh, param_dtype=torch.float32)
    assert sh.is_fsdp(dict(sh.named_leaves(model))["layers.0.mlp.wi"])


def test_tp_replicated_input_gradient_rounds_once():
    """bf16 activations, an attention block at d 256 (8 heads of 32): its
    input's gradient on four 'model' entries (each column-parallel
    product's input gradient a float32 partial, `column_product`, summed
    and rounded once by `model_copy`) equals one entry's, which computes
    the same float32 gradients over all heads, to float32's order (1e-4
    rel. L2), while the unsharded block's, which rounds each product's
    input gradient and their sum to bf16, lies 1e-3 or more from both:
    the bf16 TP step's distance to the unsharded one is that rounding."""
    cfg = dataclasses.replace(tconfigs.get_arch(PHI3).reduced(),
                              dtype="bfloat16", d_model=256, d_ff=512,
                              n_heads=8, n_kv_heads=8, head_dim=32,
                              vocab_size=512, n_layers=1)
    model = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
               param_dtype=torch.float32)
    blk = model.layers[0]
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn((4, 64, 256), generator=gen).to(torch.bfloat16)
    seed = torch.randn((4, 64, 256), generator=gen).to(torch.bfloat16)
    pos = torch.arange(64, dtype=torch.int32).expand(4, 64)
    mesh = Mesh((CPU,) * 4, ("data", "model"), (1, 4))

    def grad(entries):
        x = x0.clone().requires_grad_()
        h = tlayers.rmsnorm(x, blk.attn_norm, cfg.norm_eps)
        y = blk._attention(blk.attn, cfg, h, pos, None, "train", None, None,
                           entries)
        return torch.autograd.grad((y.float() * seed.float()).sum(),
                                   [x])[0].double()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    whole = grad(None)
    one = grad(sh.Entries(1, (0,), (CPU,)))
    sh.place_model(model, mesh)
    four = grad(sh.model_entries(mesh, {}, cfg))
    assert rel(four, one) < 1e-4
    assert rel(one, whole) > 1e-3 and rel(four, whole) > 1e-3
