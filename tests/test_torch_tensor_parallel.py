"""The port's tensor parallelism on 'model' against the JAX package, on the
CPU: ('data', 'model') meshes of (4, 2) and (2, 4) over `cpu`, and the
same with data shard 1's entries on `cpu:1` (which compares unequal to
`cpu`, so each block has two tensors to keep equal), each held against
the reference's jitted computation of the same config on one device,
with the reference's weights carried across (`models/convert`).

The state is placed (`models.sharding.place_model`): each entry holds
its blocks of the parameters, mu, nu and the accumulator, and no whole
sharded leaf is held or copied (`check_layout`, after the placement and
after a step). The train step (two microbatches, the uneven-mask batch
of `test_torch_mesh_train.py`) for phi3's reduced config (vocab 97:
uneven vocab blocks), granite's (experts over 'model', with and without
capacity drops), hubert's (encode and the masked CE), a config whose 16
kv heads shard, and one where neither the q-heads block nor the group
divides the other (kv heads repeated); the ZeRO accumulator on (4, 2);
the global norm against the unsharded step's; compression on the placed
state; the step laying a state out for its mesh; prefill logits, three
decode steps' logits and `generate`'s tokens on (2, 4) against the
reference's serving steps; the vocab-parallel CE against the
reference's `cross_entropy` on padded vocabularies; the error on heads
that 'model' does not divide; MLA and SSM configs on a 'model' axis
(they do not shard) as before; a state trained under TP saved (whole
leaves, as an unsharded save writes them), restored and remeshed onto
another ('data', 'model') shape; and the dry-run's one traced entry
against the mesh it stands for.

Tolerances are `test_torch_train.py`'s, for the reasons given there:
loss 1e-5; gradients, mu and nu at 1e-4 of a leaf's max; params through
AdamW's first step. Serving: the logits at `_torch_lm.MODEL_TOL` (1e-4),
the tokens equal.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from _torch_lm import (MODEL_TOL, close, port_cfg, ref_model,
                       reference_fixture)
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.distributed import Mesh
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.ft.elastic import remesh_state
from repro_torch.launch.graph_analysis import analyze_program
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import sharding as sh
from repro_torch.models.model import LM
from repro_torch.optim.optimizer import OptConfig
from repro_torch.serve import serve_step as tserve
from repro_torch.train import train_step as tts
from test_torch_mesh_train import B, S, uneven_batch
from test_torch_train import (FLIPS, GRAD_TOL, LOSS_TOL, OPT, batch_for,
                              close_grads, close_step, host_tree, leaves,
                              port_state, ref_state)

torch.set_num_threads(1)

CPU = torch.device("cpu")
CPU1 = torch.device("cpu", 1)   # compares unequal to `cpu`
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
# the meshes of the train cases: all on `cpu`, or data shard 1's entries
# on `cpu:1`, so that each block has two tensors (replicas) to keep equal
TRAIN_MESHES = ("4x2", "2x4", "4x2 cpu1", "2x4 cpu1")
# (reduced config, field changes): the cases of the train step
CASES = {
    "phi3": ("phi3-mini-3.8b", ()),
    "granite": ("granite-moe-3b-a800m", ()),
    "granite_drops": ("granite-moe-3b-a800m", (("capacity_factor", 0.5),)),
    "hubert": ("hubert-xlarge", ()),
    # 16 kv heads: they shard over 'model', and so do the caches
    "kv16": ("phi3-mini-3.8b", (("n_heads", 16), ("n_kv_heads", 16),
                                ("head_dim", 8))),
    # 24 / 6 heads over 4: an entry's 6 q heads and the group of 4 do not
    # divide each other, so its 2 kv heads are repeated to its q heads
    "repeat": ("phi3-mini-3.8b", (("n_heads", 24), ("n_kv_heads", 6),
                                  ("head_dim", 16))),
}


@pytest.fixture(scope="module")
def J():
    for ref in reference_fixture():
        from repro.optim import compression as jcomp
        from repro.optim import optimizer as jopt
        from repro.train import train_step as jts

        ref.opt, ref.comp, ref.train_step = jopt, jcomp, jts
        yield ref


def mesh_of(name: str) -> Mesh:
    """A mesh of `MESHES`; with " cpu1", data shard 1's entries on
    `cpu:1`."""
    shape, _, two = name.partition(" ")
    d, m = MESHES[shape]
    devs = [CPU1 if two and j // m == 1 else CPU for j in range(d * m)]
    return Mesh(tuple(devs), ("data", "model"), (d, m))


def whole_state(state):
    """A train state's params and moments as whole CPU tensors."""
    def whole(tree):
        return {n: (x.full(CPU) if isinstance(x, sh.Placed) else x).detach()
                for n, x in tree.items()}

    return dict(params=whole(state["params"]),
                opt=dict(mu=whole(state["opt"]["mu"]),
                         nu=whole(state["opt"]["nu"]),
                         step=state["opt"]["step"]))


def reachable(model):
    """Every tensor and Placed value that `model`'s modules hold."""
    out = []
    for mod in model.modules():
        out += [x for x in (*mod._parameters.values(),
                            *mod._buffers.values(), *vars(mod).values())
                if torch.is_tensor(x) or isinstance(x, sh.Placed)]
    return out


def check_layout(model, state, mesh):
    """The placed layout (see `test_tp_train_step_matches_reference_whole_
    batch`): each entry holds exactly its `tp_block` of every sharded leaf
    in the parameters, mu and nu, as a tensor of its own; the model holds
    nothing else but the replicated leaves, whole Parameters on the first
    device; a block's tensors (one per device) are equal. Returns the
    sharded names."""
    cfg, tp = model.cfg, mesh.shape["model"]
    assert sh.placed_mesh(model) == mesh
    leaves = dict(sh.named_leaves(model))
    assert list(leaves) == list(state["params"])
    sharded = [n for n in leaves if sh.model_dim(cfg, n) is not None]
    replicated = [n for n in leaves if n not in sharded]
    assert sharded and list(dict(model.named_parameters())) == replicated
    held = {id(x) for x in reachable(model)}
    assert held == {id(leaves[n]) for n in leaves}
    for name in leaves:
        d = sh.model_dim(cfg, name)
        assert state["params"][name] is leaves[name], name
        for tree in (state["params"], state["opt"]["mu"],
                     state["opt"]["nu"]):
            x = tree[name]
            if d is None:
                assert not isinstance(x, sh.Placed) and x.device == CPU, name
                continue
            assert isinstance(x, sh.Placed) and x.mesh == mesh, name
            assert len(x.distinct()) == tp * len(set(mesh.devices)), name
            for j, local in enumerate(x.shards):
                m = j % tp
                want = list(x.shape)
                blk = sh.tp_block(want[d], tp, m)
                want[d] = blk.stop - blk.start
                assert list(local.shape) == want, (name, j)
                assert x.block(j)[d] == blk, (name, j)
                assert local.untyped_storage().nbytes() == \
                    local.numel() * local.element_size(), (name, j)
                assert torch.equal(local, x.shards[m]), (name, j)
    return sharded


def batch_of(cfg):
    """`uneven_batch`, and for the encoder frame features in the tokens'
    place."""
    batch = uneven_batch(cfg)
    if cfg.is_encoder:
        rng = np.random.default_rng(5)
        batch = dict(features=rng.standard_normal(
            (B, S, cfg.feat_dim)).astype(np.float32),
            labels=batch["labels"], mask=batch["mask"])
    return batch


_WANT = {}


def reference_step(J, case):
    """The reference's config of `case`, the batch, its start state and
    its jitted whole-batch step's (state, metrics)."""
    if case not in _WANT:
        name, changes = CASES[case]
        cfg, m, params = ref_model(J, name, seed=4, **dict(changes))
        batch = batch_of(cfg)
        start = ref_state(J, m, params)
        want_state, want = J.jax.jit(J.train_step.make_train_step(
            m, J.opt.OptConfig(**OPT), micro_batches=2))(
            start, {k: J.jnp.asarray(v) for k, v in batch.items()})
        _WANT[case] = (cfg, m, params, batch, start, host_tree(want_state),
                       host_tree(want))
    return _WANT[case]


def tp_step(cfg, start, batch, mesh, check=False, **kw):
    """The port's state made and loaded under `mesh` (placed), one step
    there; with `check`, `check_layout` after the placement and after
    the step, and the step's AdamW gradients (`adamw_update`'s) of each
    sharded leaf checked to be its blocks."""
    with sh.use_mesh(mesh):
        model, state = port_state(cfg, start)
        if check:
            check_layout(model, state, mesh)
        step = tts.make_train_step(model, OptConfig(**OPT), micro_batches=2,
                                   **kw)
        seen = []
        real = tts.adamw_update
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tts, "adamw_update",
                       lambda p, g, *a, **k: seen.append(g) or real(p, g, *a,
                                                                    **k))
            state, got = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    if check:
        sharded = check_layout(model, state, mesh)
        tp = mesh.shape["model"]
        grads, = seen
        for name in sharded:
            leaf = state["params"][name]
            tiles = [g for k, g in grads.items() if k.split("#")[0] == name]
            # the accumulator: each entry of the first data shard keeps
            # its block's sum (with ZeRO, each entry its 'data' block of
            # it), no tile larger than a block; AdamW updates each tile
            # once, on its keeper, which `check_layout` found copied to
            # the block's other tensors
            if "grad_shard_specs" in kw:
                assert len(tiles) > tp, name
            else:
                assert [(g.shape, g.device) for g in tiles] == [
                    (leaf.shards[m].shape, leaf.shards[m].device)
                    for m in range(tp)], name
            # every element once: the global norm's terms
            assert sum(g.numel() for g in tiles) == np.prod(leaf.shape)
            block = leaf.shards[0].numel() * 4
            assert all(g.untyped_storage().nbytes() <= block
                       for g in tiles), name
    return model, state, got


def check_step(got, state, want, want_state, cfg):
    close(got["loss"], want["loss"], LOSS_TOL, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                               rtol=1e-6)
    close_step(whole_state(state), want_state, cfg, float(want["lr"]))


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_train_step_matches_reference_whole_batch(J, case, mesh, monkeypatch):
    """The step on a ('data', 'model') mesh, on the placed state, against
    the reference's whole-batch step; the 'model' reductions run
    (counted). The layout, after the placement and after the step: each
    entry holds exactly its `tp_block` of every sharded leaf (parameters,
    mu, nu, and the accumulator's tiles that AdamW reads), as a tensor of
    its own no larger than the block; the tensors of one block (on `cpu`
    and on `cpu:1`) are equal; no sharded leaf is copied per step
    (`copy_params` sees the replicated ones only)."""
    cfg, _, _, batch, start, want_state, want = reference_step(J, case)
    calls, copied = [], []
    real = sh._ModelSum.forward
    monkeypatch.setattr(sh._ModelSum, "forward", staticmethod(
        lambda ctx, tp, kind, dtype, *p: calls.append((tp, kind, len(p)))
        or real(ctx, tp, kind, dtype, *p)))
    real_copy = tts.copy_params

    def copy_params(named, *a, **k):
        named = list(named)
        copied.extend(n for n, _ in named)
        return real_copy(named, *a, **k)

    monkeypatch.setattr(tts, "copy_params", copy_params)
    _, state, got = tp_step(cfg, start, batch, mesh_of(mesh), check=True)
    tp = MESHES[mesh.split()[0]][1]
    sharded = {n for n in state["params"]
               if sh.model_dim(port_cfg(cfg), n) is not None}
    assert bool(copied) == mesh.endswith("cpu1")
    assert not sharded & set(copied)
    kinds = {k for _, k, _ in calls}
    assert {"attn_out", "ce_sumexp", "ce_gold"} <= kinds
    assert ("moe_combine" if cfg.is_moe else "mlp_out") in kinds
    assert ("embed" in kinds) != cfg.is_encoder
    assert all(t == tp and n == tp for t, _, n in calls)
    check_step(got, state, want, want_state, cfg)


def test_tp_moe_with_drops_drops_pairs_and_reports_the_aux(J):
    """At cf 0.5 the routing (once per data shard, never per entry) drops
    pairs; the step's aux is the whole microbatches' mean aux of the
    one-device `loss_fn`."""
    from repro_torch.models import moe as tmoe

    cfg, _, _, batch, start, want_state, want = reference_step(
        J, "granite_drops")
    model, _ = port_state(cfg, start)
    with torch.no_grad():
        aux = sum(model.loss_fn({k: torch.from_numpy(v[i * B // 2:
                                                       (i + 1) * B // 2])
                                 for k, v in batch.items()})[1]["aux"]
                  for i in range(2)) / 2
    with sh.use_mesh(mesh_of("2x4")):
        model, state = port_state(cfg, start)
    seen, routes = [], []
    model.layers[0].mlp.register_forward_pre_hook(
        lambda mod, args: seen.append(args[1].detach()))
    real = tmoe.route
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "route", lambda *a: routes.append(1) or real(*a))
        with sh.use_mesh(mesh_of("2x4")):
            state, got = tts.make_train_step(
                model, OptConfig(**OPT), micro_batches=2)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()})
    # once per MoE layer per data shard and microbatch, never per entry
    assert len(routes) == cfg.n_layers * 2 * 2
    _, _, idx = tmoe.route(model.layers[0].mlp, model.cfg, seen[0])
    cap = tmoe.capacity(S, cfg.moe_top_k, cfg.n_experts, 0.5)
    assert (tmoe.dispatch_ranks(idx, cfg.n_experts) >= cap).any()
    close(got["aux"], aux, LOSS_TOL, "aux")
    check_step(got, state, want, want_state, cfg)


@pytest.mark.parametrize("mesh", ["4x2", "4x2 cpu1"])
def test_tp_zero_accumulator_matches_reference(J, mesh):
    """The ZeRO accumulator (`grad_shard_specs=param_specs`) on (4, 2):
    each entry keeps its 'data' block of its 'model' block of every
    sharded leaf's gradient sum, AdamW runs on those tiles."""
    cfg, _, _, batch, start, want_state, want = reference_step(J, "phi3")
    model, _ = port_state(cfg, start)
    with sh.use_mesh(mesh_of(mesh)):
        specs = sh.param_specs(model)
    assert specs["layers.0.mlp.wi"] == sh.P("data", "model")
    _, state, got = tp_step(cfg, start, batch, mesh_of(mesh), check=True,
                            grad_shard_specs=specs)
    check_step(got, state, want, want_state, cfg)


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("case", ["phi3", "granite"])
def test_tp_global_norm_counts_each_block_once(J, case, mesh):
    """The placed step's grad_norm (each sharded block once, not once per
    data coordinate or per tensor that holds it; each replicated leaf
    once) against the port's unsharded step's from the same state, at
    GRAD_TOL."""
    cfg, _, _, batch, start, _, _ = reference_step(J, case)
    model, state = port_state(cfg, start)
    _, one = tts.make_train_step(model, OptConfig(**OPT), micro_batches=2)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, _, got = tp_step(cfg, start, batch, mesh_of(mesh))
    close(got["grad_norm"], one["grad_norm"].numpy(), GRAD_TOL, "grad_norm")


@pytest.mark.parametrize("compress", ["topk", "int8"])
def test_tp_compressed_step_matches_reference(J, compress):
    """Compression with error feedback on the placed state ("2x4 cpu1"):
    the tiles of the gradient sum gathered on the model's device into the
    reference's leaves, compressed, cut back; the error feedback a placed
    value, each entry its blocks. Params, moments and the new error
    against the reference's step, as `test_torch_train.py` holds the
    one-device step (with its FLIPS)."""
    cfg, m, params = ref_model(J, "phi3-mini-3.8b", seed=4)
    batch = batch_for(cfg, b=4, seed=3)
    kw = dict(compress=compress, topk_frac=0.05)
    want_state, want = J.jax.jit(J.train_step.make_train_step(
        m, J.opt.OptConfig(**OPT), **kw))(
        ref_state(J, m, params, True),
        {k: J.jnp.asarray(v) for k, v in batch.items()})
    mesh = mesh_of("2x4 cpu1")
    with sh.use_mesh(mesh):
        model, state = port_state(cfg, ref_state(J, m, params, True))
        state, got = tts.make_train_step(model, OptConfig(**OPT), **kw)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    check_layout(model, state, mesh)
    err = state["err"]["layers.0.mlp.wi"]
    assert isinstance(err, sh.Placed) and len(err.distinct()) == 8
    want_state = host_tree(want_state)
    flips = FLIPS.get(compress)
    close(got["loss"], want["loss"], LOSS_TOL, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    tops = close_step(whole_state(state), want_state, cfg, float(want["lr"]),
                      flips)
    clip = min(1.0, 1.0 / float(want["grad_norm"]))
    errs = leaves(cfg, want_state["err"])
    got_err = {n: x.full(CPU) if isinstance(x, sh.Placed) else x
               for n, x in state["err"].items()}
    close_grads(got_err, errs, "err", (flips or {}).get("err", 0),
                {n: max(t / clip, float(errs[n].abs().max()))
                 for n, t in tops.items()})


SERVED = ("phi3", "granite", "kv16", "repeat")


@pytest.mark.parametrize("case", SERVED)
def test_tp_serving_matches_reference(J, case):
    """On (2, 4): the prefill's last logits and three decode steps' logits
    against the reference's `prefill` / `decode_step`, fed the same
    tokens; `generate`'s tokens equal the reference's greedy loop through
    those steps. Each entry's cache holds its block of the kv heads where
    they shard, else all of them. The model is placed on the mesh by
    `from_reference(..., mesh=)` for phi3 and kv16, by the first step
    for the others."""
    cfg, m, params = reference_step(J, case)[:3]
    # placed by `from_reference` (on the meta device, then block by
    # block), or by the first step
    model = convert.from_reference(
        port_cfg(cfg), params, device="cpu",
        mesh=mesh_of("2x4") if case in ("phi3", "kv16") else None)
    assert (sh.placed_mesh(model) is None) == (case not in ("phi3", "kv16"))
    b, s, max_len = 4, 12, 32
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                             (b, s)).astype(np.int32)
    jt, tt = J.jnp.asarray(toks), torch.from_numpy(toks)
    jprefill = J.jax.jit(J.serve_step.make_prefill_step(m))
    jdecode = J.jax.jit(J.serve_step.make_decode_step(m))
    with sh.use_mesh(mesh_of("2x4")):
        caches = tserve.init_caches(model, b, max_len)
        prefill = tserve.make_prefill_step(model)
        decode = tserve.make_decode_step(model)
        tl, caches = prefill(tt[:, :s - 3], caches)
        jl, jc = jprefill(params, jt[:, :s - 3], m.init_caches(b, max_len))
        close(tl, jl, MODEL_TOL, "prefill")
        for i in range(s - 3, s):
            _, tl, caches = decode(tt[:, i:i + 1], i, caches)
            _, jl, jc = jdecode(params, jt[:, i:i + 1], J.jnp.int32(i), jc)
            close(tl, jl, MODEL_TOL, f"decode at {i}")
        got = tserve.generate(model, tt[:, :s - 3], max_new=5,
                              max_len=max_len)
    # the reference's greedy loop through the same (jitted) serving steps
    jl, jc = jprefill(params, jt[:, :s - 3], m.init_caches(b, max_len))
    want = [J.jnp.argmax(jl, axis=-1).astype(J.jnp.int32)[:, None]]
    for i in range(4):
        tok, _, jc = jdecode(params, want[-1], J.jnp.int32(s - 3 + i), jc)
        want.append(tok)
    assert np.array_equal(got.numpy(), np.concatenate(want, axis=1))
    assert len(caches) == 2                   # one per data shard
    entry_caches = caches[0][0]["attn"]
    assert len(entry_caches) == 4             # one per 'model' entry
    kv = cfg.n_kv_heads // 4 if sh.kv_shards(cfg) else cfg.n_kv_heads
    assert all(c["k"].shape == (b // 2, max_len, kv, cfg.resolved_head_dim)
               for c in entry_caches)


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
def test_vocab_parallel_cross_entropy_matches_reference(J, tp):
    """`cross_entropy_parallel` over the entries' blocks of a padded
    vocabulary (real 90 of 97 and of 100 columns, the padding inside the
    last block or across two) against the reference's `cross_entropy`,
    with and without a mask; its gradient against the port's
    `cross_entropy`'s."""
    rng = np.random.default_rng(tp)
    entries = sh.Entries(tp, tuple(range(tp)), (CPU,) * tp)
    for vocab, real in ((97, 90), (100, 90), (96, 0)):
        logits = rng.standard_normal((3, 7, vocab)).astype(np.float32) * 4
        labels = rng.integers(0, real or vocab, (3, 7)).astype(np.int32)
        mask = rng.random((3, 7)) < 0.6
        for m in (None, mask):
            want = J.layers.cross_entropy(
                J.jnp.asarray(logits), J.jnp.asarray(labels),
                None if m is None else J.jnp.asarray(m), real)
            lg = torch.from_numpy(logits).requires_grad_(True)
            tm = None if m is None else torch.from_numpy(m)
            got = tlayers.cross_entropy_parallel(
                [lg[..., e.block(vocab)] for e in entries],
                torch.from_numpy(labels), entries, vocab, tm, real)
            close(got, want, LOSS_TOL, f"vocab {vocab} tp {tp}")
            one = tlayers.cross_entropy(lg, torch.from_numpy(labels), tm,
                                        real)
            g_got, = torch.autograd.grad(got, lg)
            g_want, = torch.autograd.grad(one, lg)
            close(g_got, g_want.numpy(), LOSS_TOL, "gradient")


def test_heads_the_model_axis_does_not_divide_raise():
    """Heads, sharded kv heads and experts must divide by the 'model'
    extent: a ValueError that points to `padded_for_mesh`; the vocab and
    d_ff take uneven blocks."""
    base = tconfigs.get_arch("granite-moe-3b-a800m").reduced()
    mesh = Mesh((CPU,) * 6, ("data", "model"), (2, 3))
    for changes in (dict(), dict(n_heads=6, n_kv_heads=2, n_experts=4),
                    dict(n_heads=48, n_kv_heads=16, head_dim=4,
                         n_experts=6)):
        cfg = dataclasses.replace(base, **changes)
        with pytest.raises(ValueError, match="padded_for_mesh"):
            sh.model_entries(mesh, {"data": 0}, cfg)
    model = LM(dataclasses.replace(base, n_heads=6, n_kv_heads=2,
                                   n_experts=6),
               generator=torch.Generator().manual_seed(0), device="cpu")
    with sh.use_mesh(mesh):
        logits = tserve.make_prefill_step(model)(
            torch.zeros((2, 4), dtype=torch.int32),
            tserve.init_caches(model, 2, 8))[0]
    assert logits.shape == (2, 97)
    # padding makes every count divide, as the reference pads
    padded = base.padded_for_mesh(3)
    assert sh.model_entries(mesh, {}, padded).tp == 3


@pytest.mark.parametrize("name", ["minicpm3-4b", "mamba2-370m",
                                  "hymba-1.5b"])
def test_mla_and_ssm_on_a_model_axis_keep_the_data_shards_step(name):
    """MLA and SSM layers do not shard over 'model': on (4, 2) the step is
    the one on 4 data shards (each data coordinate's first entry works),
    bit for bit, which `test_torch_mesh_train.py` holds against the
    reference; no 'model' reduction runs."""
    cfg = tconfigs.get_arch(name).reduced()
    batch = {k: torch.from_numpy(v) for k, v in uneven_batch(cfg).items()}
    assert sh.model_entries(mesh_of("4x2"), {"data": 0}, cfg) is None
    out = []
    for mesh in (mesh_of("4x2"), Mesh((CPU,) * 4, ("data",))):
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        state = tts.make_train_state(model)
        with sh.use_mesh(mesh):
            state, metrics = tts.make_train_step(
                model, OptConfig(**OPT), micro_batches=2)(state, batch)
        out.append((metrics, state))
    (m0, s0), (m1, s1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    for n in s0["params"]:
        assert torch.equal(s0["params"][n], s1["params"][n]), n


def test_state_trained_under_tp_restores_and_remeshes(tmp_path):
    """4 steps on (2, 4) on the placed state, a checkpoint (whole leaves in
    the reference's layout: the arrays an unsharded save of the same
    state writes, byte for byte), restore(shardings=) onto that mesh,
    `remesh_state` onto (4, 2) with the parameter specs, a fresh model
    placed there and filled from it, 4 more steps: the 8 losses against
    8 unsharded steps (1e-5), and the filled leaves equal the saved
    ones."""
    cfg = tconfigs.get_arch("granite-moe-3b-a800m").reduced()
    opt = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=8, seed=3), device="cpu")

    def fresh():
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        return model, tts.make_train_state(model)

    model, state = fresh()
    step = tts.make_train_step(model, opt)
    want = [float(step(state, data.batch(i))[1]["loss"]) for i in range(8)]
    m24, m42 = mesh_of("2x4"), mesh_of("4x2")
    with sh.use_mesh(m24):
        model, state = fresh()
        step = tts.make_train_step(model, opt)
        losses = [float(step(state, data.batch(i))[1]["loss"])
                  for i in range(4)]
        specs = sh.param_specs(model)
    assert isinstance(state["params"]["embedding"], sh.Placed)
    ck = Checkpointer(str(tmp_path / "tp"), async_save=False)
    ck.save(4, state)
    whole = whole_state(state)
    Checkpointer(str(tmp_path / "whole"), async_save=False).save(4, whole)
    with np.load(tmp_path / "tp" / "step_4" / "proc_0.npz") as a, \
            np.load(tmp_path / "whole" / "step_4" / "proc_0.npz") as b:
        assert a.files == b.files and "params/embedding" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    saved = whole["params"]
    names = list(saved)

    def tree(leaf):
        return {"params": {n: leaf(n) for n in names},
                "opt": {"mu": {n: leaf(n) for n in names},
                        "nu": {n: leaf(n) for n in names},
                        "step": leaf(None)}}

    restored = ck.restore(4, tree(lambda n: None),
                          shardings=tree(lambda n: (m24, sh.P())))
    placed = remesh_state(restored, tree(
        lambda n: sh.P() if n is None else specs[n]), m42)
    # the experts' block on 'model', d_model's on 'data' (the reference's)
    assert placed["params"]["layers.0.mlp.wi"].spec[:2] == ("model", "data")
    with sh.use_mesh(m42):
        model, state = fresh()
    tts.load_train_state(state, placed)
    check_layout(model, state, m42)
    for n, x in whole_state(state)["params"].items():
        assert torch.equal(x, saved[n]), n
    step = tts.make_train_step(model, opt)
    with sh.use_mesh(m42):
        losses += [float(step(state, data.batch(i))[1]["loss"])
                   for i in range(4, 8)]
    assert int(state["opt"]["step"]) == 8
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)


def test_step_lays_the_state_out_for_its_mesh():
    """A state made without a mesh is placed by its first step on a
    ('data', 'model') mesh (`lay_out_state`), laid out anew on another
    such mesh, and gathered into whole leaves again for a step without
    one; the moments follow, block for block. The losses of the six
    steps against six unsharded ones (1e-5), and the state after them
    against the unsharded one's at GRAD_TOL."""
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    opt = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=8, seed=3), device="cpu")

    def fresh():
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        return model, tts.make_train_state(model)

    model, state = fresh()
    step = tts.make_train_step(model, opt)
    want = [float(step(state, data.batch(i))[1]["loss"]) for i in range(6)]
    want_state = whole_state(state)
    model, state = fresh()
    step = tts.make_train_step(model, opt)
    losses = []
    for i, mesh in enumerate((mesh_of("2x4"), mesh_of("2x4"),
                              mesh_of("4x2 cpu1"), mesh_of("4x2 cpu1"),
                              None, None)):
        with sh.use_mesh(mesh):
            losses.append(float(step(state, data.batch(i))[1]["loss"]))
        if mesh is not None:
            check_layout(model, state, mesh)
        else:
            assert sh.placed_mesh(model) is None
            assert all(torch.is_tensor(x) for x in state["opt"]["mu"].values())
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
    # gathered, the parameters are registered in a fresh model's order
    order = list(dict(fresh()[0].named_parameters()))
    assert list(dict(model.named_parameters())) == order
    assert list(model.state_dict()) == list(fresh()[0].state_dict())
    assert list(state["params"]) == order
    got = whole_state(state)
    for part in ("mu", "nu"):
        for n, w in want_state["opt"][part].items():
            close(got["opt"][part][n], w.numpy(), GRAD_TOL, f"{part} {n}")
    for n, w in want_state["params"].items():
        close(got["params"][n], w.numpy(), GRAD_TOL, n)


@pytest.mark.parametrize("start", ["no mesh", "4x2"])
def test_serving_between_steps_lays_the_state_out_anew(start):
    """A state made without a mesh (or on (4, 2)), then `generate` on
    ("2x4 cpu1"), which lays the model out there, then two steps on that
    mesh: the step finds the state's parameters stale (not the model's
    leaves) and lays it out anew, so every sharded leaf trains. Then
    `generate` without a mesh and on a data-only mesh gathers the model
    into whole leaves, and a last step without a mesh. The losses against
    the unsharded steps' (1e-5), the state after them at GRAD_TOL, the
    tokens equal the unsharded model's after as many steps."""
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    opt = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=8, seed=3), device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 6)).astype(np.int32))

    def fresh():
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        return model, tts.make_train_state(model)

    model, state = fresh()
    step = tts.make_train_step(model, opt)
    want = [float(step(state, data.batch(i))[1]["loss"]) for i in range(2)]
    want_tokens = tserve.generate(model, prompt, max_new=4, max_len=16)
    want.append(float(step(state, data.batch(2))[1]["loss"]))
    want_state = whole_state(state)
    with sh.use_mesh(None if start == "no mesh" else mesh_of("4x2")):
        model, state = fresh()
    mesh = mesh_of("2x4 cpu1")
    with sh.use_mesh(mesh):
        tserve.generate(model, prompt, max_new=2, max_len=16)
        assert sh.placed_mesh(model) == mesh
        assert state["params"]["lm_head"] is not sh.named_leaves(
            model)[-1][1]
        step = tts.make_train_step(model, opt)
        losses = [float(step(state, data.batch(i))[1]["loss"])
                  for i in range(2)]
    check_layout(model, state, mesh)
    tokens = []
    for m in (None, Mesh((CPU,) * 2, ("data",))):
        with sh.use_mesh(m):
            tokens.append(tserve.generate(model, prompt, max_new=4,
                                          max_len=16))
        assert sh.placed_mesh(model) is None
    losses.append(float(step(state, data.batch(2))[1]["loss"]))
    assert all(state["params"][n] is p for n, p in model.named_parameters())
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
    got = whole_state(state)
    for part in ("mu", "nu"):
        for n, w in want_state["opt"][part].items():
            close(got["opt"][part][n], w.numpy(), GRAD_TOL, f"{part} {n}")
    for n, w in want_state["params"].items():
        close(got["params"][n], w.numpy(), GRAD_TOL, n)
    for t in tokens:        # the weights of the two steps on the mesh
        assert torch.equal(t, want_tokens)


def test_traced_entry_counts_a_quarter_of_the_mesh_step():
    """The dry-run's one entry (`entry_model`, `place_model` for entry 0
    alone, + `traced_entry` on meta tensors) against the real (1, 4)
    mesh step on the placed state it stands for, phi3's
    reduced config with a vocab of 96 (blocks of 24) and remat, in fp32
    and with bf16 activations (float32 partials,
    `sharding.partial_product`): its FLOPs times 4 equal the mesh step's
    with remat's early stop off (the norms, which the entries would
    repeat, count none), its reductions are the mesh step's by kind, and
    its state holds a quarter of the sharded leaves. With early stop on
    (the real path), the one process that drives the four entries
    recomputes the last products of the first three, which a lone entry
    skips, so the mesh step counts three entries without early stop and
    one with. (In bf16 the two counts are equal: a partial product's
    inputs are saved once it has run, so its recompute runs it.)"""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(
            tconfigs.get_arch("phi3-mini-3.8b").reduced(), vocab_size=96,
            remat=True, dtype=dtype)
        batch = {k: torch.from_numpy(v)
                 for k, v in uneven_batch(cfg).items()}
        mesh = Mesh((CPU,) * 4, ("data", "model"), (1, 4))
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
        with sh.use_mesh(mesh):
            state = tts.make_train_state(model)
        meta = sh.entry_model(LM(cfg, device="meta",
                                 param_dtype=torch.float32), 4)
        mstate = tts.make_train_state(meta)
        mbatch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batch.items()}
        real, traced = {}, {}
        for early in (False, True):
            with sh.use_mesh(mesh), set_checkpoint_early_stop(early):
                real[early] = analyze_program(
                    tts.make_train_step(model, OptConfig()), state, batch)
            with sh.use_entries(sh.traced_entry(4, "meta")), \
                    set_checkpoint_early_stop(early):
                traced[early] = analyze_program(
                    tts.make_train_step(meta, OptConfig()), mstate, mbatch)
        assert traced[False]["flops"] * 4 == real[False]["flops"] > 0
        assert (traced[False]["flops"] * 3 + traced[True]["flops"]
                == real[True]["flops"])
        if dtype == "float32":
            assert traced[True]["flops"] < traced[False]["flops"]
        for early in (False, True):
            assert traced[early]["model_collective_counts"] == \
                real[early]["model_collective_counts"]
            assert traced[early]["model_collective_bytes"] == \
                real[early]["model_collective_bytes"] > 0
        for name, p in sh.named_leaves(meta):
            d = sh.model_dim(cfg, name)
            want = list(whole[name])
            if d is not None:
                want[d] = -(-want[d] // 4)
                p = p.shards[0]
            assert list(p.shape) == want, name


def test_tp_serving_shard_on_another_device_runs_on_a_copy(monkeypatch):
    """A data shard whose entries are not on the model's device (`cpu:1`,
    which compares unequal to `cpu`) serves the placed model: its
    entries read the blocks they hold there, and only the replicated
    leaves (norms, router, whole kv weights) run on a copy made per call
    through `torch.func.functional_call`, one call per step for that
    shard; no sharded leaf is copied. `generate` on (2, 4) gives the
    tokens of the mesh with every entry on `cpu`. A change written into
    the entries' blocks (and the replicated leaves) is served by the
    next step."""
    cfg = tconfigs.get_arch("granite-moe-3b-a800m").reduced()
    model = LM(cfg, generator=torch.Generator().manual_seed(0),
               device="cpu")
    sharded = {n for n, _ in model.named_parameters()
               if sh.model_dim(cfg, n) is not None}
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 6)).astype(np.int32))
    calls = []
    call = torch.func.functional_call
    monkeypatch.setattr(torch.func, "functional_call",
                        lambda mod, named, *a, **k: calls.append(set(named))
                        or call(mod, named, *a, **k))
    two = Mesh((CPU,) * 4 + (CPU1,) * 4, ("data", "model"), (2, 4))
    out = []
    for mesh in (mesh_of("2x4"), two):
        with sh.use_mesh(mesh):
            out.append(tserve.generate(model, prompt, max_new=4, max_len=16))
        assert sh.placed_mesh(model) == mesh
    assert len(calls) == 4          # the prefill and 3 decode steps
    copied = {n.partition(".")[2] for n in set.union(*calls)}
    assert copied and not copied & sharded
    assert copied == set(dict(model.named_parameters()))
    assert torch.equal(out[0], out[1])
    with sh.use_mesh(two):
        prefill = tserve.make_prefill_step(model)
        before = prefill(prompt, tserve.init_caches(model, 4, 16))[0]
        with torch.no_grad():
            for _, leaf in sh.named_leaves(model):
                for t in sh.local_tensors(leaf):
                    t.mul_(1.5)
        after = prefill(prompt, tserve.init_caches(model, 4, 16))[0]
    with sh.use_mesh(mesh_of("2x4")):
        want = tserve.make_prefill_step(model)(
            prompt, tserve.init_caches(model, 4, 16))[0]
    assert torch.equal(after, want) and not torch.equal(before, after)


# (n_heads, n_kv_heads, 'model' extent) -> (q heads an entry, kv heads it
# reads, whether they repeat): the grouping rule's cases
GROUPS = {(32, 32, 4): (8, 8, False),    # phi3: kv heads shard
          (24, 8, 4): (6, 2, False),     # granite: g = 3 divides h = 6
          (48, 8, 4): (12, 2, False),    # dbrx: g = 6 divides h = 12
          (32, 8, 16): (2, 1, False),    # granite padded: h = 2 divides g
          (24, 6, 4): (6, 2, True)}      # neither: kv heads repeated


@pytest.mark.parametrize("heads", sorted(GROUPS), ids=lambda h: "%d-%d-tp%d"
                         % h)
def test_head_blocks_sum_to_the_reference_attention(J, heads):
    """Each entry's `head_block` (its q heads, the kv heads they read) and
    its partial attention, summed over the entries, against the
    reference's `gqa_attention` over a full sequence; then a cache per
    entry filled with the prompt and one decode step against the
    reference's `gqa_decode`."""
    from repro_torch.models import attention as tattn

    n_h, n_kv, tp = heads
    cfg = dataclasses.replace(J.configs.ARCHS["phi3-mini-3.8b"].reduced(),
                              n_heads=n_h, n_kv_heads=n_kv, head_dim=8)
    d, rng = cfg.d_model, np.random.default_rng(n_h + n_kv)
    ref_attn = {k: (rng.standard_normal(shape) * 0.1).astype(np.float32)
                for k, shape in (("wq", (d, n_h, 8)), ("wk", (d, n_kv, 8)),
                                 ("wv", (d, n_kv, 8)), ("wo", (n_h, 8, d)))}
    tcfg = port_cfg(cfg)
    port_attn = {k: torch.from_numpy(v.copy()) for k, v in ref_attn.items()}
    entries = sh.Entries(tp, tuple(range(tp)), (CPU,) * tp)
    blocks = [tattn.head_block(tcfg, e) for e in entries]
    h, need, rep = GROUPS[heads]
    for blk in blocks:
        assert blk.q.stop - blk.q.start == h
        assert blk.need.stop - blk.need.start == need
        assert (blk.rep is not None) == rep
    b, s, max_len = 2, 24, 32
    x = np.random.default_rng(6).standard_normal(
        (b, s + 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jp = {k: J.jnp.asarray(v) for k, v in ref_attn.items()}

    @J.jax.jit
    def reference(p, x, pos):
        att = J.attention
        full = att.gqa_attention(p, cfg, x[:, :s], pos)
        c = att.gqa_fill_cache(p, cfg, x[:, :s], pos, att.init_gqa_cache(
            cfg, b, max_len, None, J.jnp.float32), None)
        return full, att.gqa_decode(p, cfg, x[:, s:], J.jnp.int32(s), c,
                                    None)[0]

    want, want_dec = reference(jp, J.jnp.asarray(x), J.jnp.asarray(pos))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    got = sum(tattn.gqa_attention(port_attn, tcfg, tx[:, :s], tpos, blk=blk)
              for blk in blocks)
    close(got, want, MODEL_TOL, "attention")
    parts = []
    for blk in blocks:
        c = tattn.init_gqa_cache(tcfg, b, max_len, None, torch.float32,
                                 blk=blk)
        tattn.gqa_fill_cache(port_attn, tcfg, tx[:, :s], tpos, c, None, blk)
        parts.append(tattn.gqa_decode(port_attn, tcfg, tx[:, s:], s, c,
                                      None, blk)[0])
    close(sum(parts), want_dec, MODEL_TOL, "decode")


def test_bf16_partials_round_once():
    """With bf16 activations each entry's partial of a row-parallel
    product is float32 (`sharding.partial_product`) and `model_sum`
    rounds the sum once, as the unsharded product rounds its result: the
    MLP and the attention over 4 entries give the unsharded bf16 outputs
    up to the float32 order of the sum (within one bf16 step, on few
    elements), closer than bf16 partials summed would."""
    from repro_torch.models import attention as tattn

    cfg = dataclasses.replace(tconfigs.get_arch("phi3-mini-3.8b").reduced(),
                              dtype="bfloat16")
    bf, tp = torch.bfloat16, 4
    gen = torch.Generator().manual_seed(0)
    d, ff = cfg.d_model, cfg.d_ff
    entries = sh.Entries(tp, tuple(range(tp)), (CPU,) * tp)
    x = torch.randn((2, 16, d), generator=gen).to(bf)
    mlp = tlayers.init_mlp(d, ff, cfg.act, bf, gen, CPU)
    att = tattn.init_gqa(cfg, bf, gen, CPU)
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    blocks = [tattn.head_block(cfg, e) for e in entries]

    def bf16_partials_mlp():
        wg = mlp.get("wg")
        return sh.model_sum([tlayers._mlp(
            e.take(mlp["wi"], 1, e.block(ff), ff),
            None if wg is None else e.take(wg, 1, e.block(ff), ff),
            e.take(mlp["wo"], 0, e.block(ff), ff), x, cfg.act)
            for e in entries], entries, "mlp_out")

    for name, whole, tp_out, old in (
            ("mlp", tlayers.mlp(mlp, x, cfg.act),
             tlayers.mlp(mlp, x, cfg.act, entries, ff), bf16_partials_mlp()),
            ("attn", tattn.gqa_attention(att, cfg, x, pos),
             sh.model_sum([tattn.gqa_attention(att, cfg, x, pos, blk=blk)
                           for blk in blocks], entries, "attn_out", bf),
             None)):
        assert tp_out.dtype == whole.dtype == bf, name
        ref = whole.float()
        diff = (tp_out.float() - ref).abs()
        step = ref.abs() * 2.0 ** -7 + 1e-30
        assert bool((diff <= step).all()), name
        assert float((diff > 0).float().mean()) < 0.05, name
        if old is not None:
            old_diff = (old.float() - ref).abs()
            assert float(old_diff.sum()) > float(diff.sum()), name
