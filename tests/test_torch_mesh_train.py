"""The port's training step on a mesh against the JAX package, on the
CPU: 8 shards of `cpu` on a ('data',) mesh (`launch.mesh.make_host_mesh`).

phi3's (scan, dense) and hymba's (unroll, hybrid attention + SSM)
reduced steps on the mesh, with and without the ZeRO-sharded
accumulator (`grad_shard_specs=param_specs(model)`), two microbatches,
on a batch whose masks differ across rows (so across shards: the loss is
the whole batch's masked mean, not a mean of the shards' means), each
against the reference's jitted step on the whole batch; a bf16 gradient
sync and int8 compression with the ZeRO accumulator; the elastic restart
(6 steps on 8 shards, a checkpoint, a restore placed on that mesh,
`remesh_state` onto a (4, 2) ('data', 'model') mesh, 6 more steps)
against 12 unsharded steps of the port; MoE on a 2-shard mesh raises.

Tolerances are `test_torch_train.py`'s, for the reasons given there:
loss 1e-5; gradients, mu and nu at 1e-4 of a leaf's max; params through
AdamW's first step; the bf16 sync's and int8's rounding flips. The
elastic restart's losses: 1e-5 (the same arithmetic as the unsharded
steps but for the order of the shards' sums).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm import close, ref_model, reference_fixture
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.distributed import Mesh
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.ft.elastic import remesh_state
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.models.sharding import P, Placed, param_specs, use_mesh
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train import train_step as tts
from test_torch_train import (FLIPS, GRAD_TOL, LOSS_TOL, OPT, close_grads,
                              close_step, host_tree, leaves, port_state,
                              ref_state)

torch.set_num_threads(1)

SHARDS = 8
B, S = 32, 16


@pytest.fixture(scope="module")
def J():
    for ref in reference_fixture():
        from repro.optim import compression as jcomp
        from repro.optim import optimizer as jopt
        from repro.train import train_step as jts

        ref.opt, ref.comp, ref.train_step = jopt, jcomp, jts
        yield ref


def uneven_batch(cfg, seed=3):
    """B x S tokens and labels, and a mask whose density differs by row
    (row 0 all masked out, the last row all in)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    keep = rng.random((B, S)) < np.linspace(0.0, 1.0, B)[:, None]
    keep[-1] = True
    return dict(tokens=toks[:, :-1].astype(np.int32),
                labels=toks[:, 1:].astype(np.int32), mask=keep)


_WANT = {}


def reference_step(J, name, **kw):
    """The reference's reduced `name` (seed 4), the batch, its start
    state and its jitted step's (state, metrics) on the whole batch."""
    key = (name,) + tuple(sorted(kw.items()))
    if key not in _WANT:
        cfg, m, params = ref_model(J, name, seed=4)
        batch = uneven_batch(cfg)
        compress = kw.get("compress")
        start = ref_state(J, m, params, bool(compress))
        want_state, want = J.jax.jit(J.train_step.make_train_step(
            m, J.opt.OptConfig(**OPT), micro_batches=2, topk_frac=0.05,
            **kw))(start, {k: J.jnp.asarray(v) for k, v in batch.items()})
        _WANT[key] = (cfg, m, batch, start, host_tree(want_state),
                      host_tree(want))
    return _WANT[key]


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "hymba-1.5b"])
def test_mesh_step_matches_reference_whole_batch(J, name, zero):
    cfg, m, batch, start, want_state, want = reference_step(J, name)
    model, state = port_state(cfg, start)
    mesh = make_host_mesh(SHARDS, device="cpu")
    with use_mesh(mesh):
        specs = param_specs(model) if zero else None
        step = tts.make_train_step(model, OptConfig(**OPT), micro_batches=2,
                                   grad_shard_specs=specs)
        state, got = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    if zero:   # the embed ('data') dimension is split 8 ways
        assert specs["embedding"] == P(None, "data")
    close(got["loss"], want["loss"], LOSS_TOL, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                               rtol=1e-6)
    close_step(state, want_state, cfg, float(want["lr"]))


def test_mesh_step_zero_equals_replicated_gradient_sums():
    """The ZeRO blocks hold exactly the replicated sum's slices: with the
    clip off (a huge clip norm) both steps give bit-equal moments, and
    two runs of the mesh step are bit-equal."""
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in uneven_batch(cfg).items()}
    out = []
    for zero in (False, True, True):
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        state = tts.make_train_state(model)
        with use_mesh(make_host_mesh(SHARDS, device="cpu")):
            step = tts.make_train_step(
                model, OptConfig(clip_norm=1e9), micro_batches=2,
                grad_shard_specs=param_specs(model) if zero else None)
            state, metrics = step(state, batch)
        out.append(state)
    for n in out[0]["params"]:
        for part in ("mu", "nu"):
            assert torch.equal(out[0]["opt"][part][n],
                               out[1]["opt"][part][n]), (part, n)
        assert torch.equal(out[1]["params"][n], out[2]["params"][n]), n


@pytest.mark.parametrize("kw", [dict(grad_sync_dtype="bfloat16"),
                                dict(compress="int8")],
                         ids=["bf16_sync", "int8"])
def test_mesh_zero_step_options_match_reference(J, kw):
    """A bf16 gradient sync (the microbatch's summed gradient rounded to
    bf16) and int8 compression (on the gathered sum, over the reference's
    stacked leaves) with the ZeRO accumulator, against the reference's
    step with the same option."""
    name = "phi3-mini-3.8b"
    cfg, m, batch, start, want_state, want = reference_step(J, name, **kw)
    model, state = port_state(cfg, start)
    with use_mesh(make_host_mesh(SHARDS, device="cpu")):
        step = tts.make_train_step(model, OptConfig(**OPT), micro_batches=2,
                                   topk_frac=0.05,
                                   grad_shard_specs=param_specs(model), **kw)
        state, got = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    flips = FLIPS[kw.get("grad_sync_dtype") or kw.get("compress")]
    close(got["loss"], want["loss"], LOSS_TOL, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    tops = close_step(state, want_state, cfg, float(want["lr"]), flips)
    if "compress" in kw:
        clip = min(1.0, 1.0 / float(want["grad_norm"]))
        errs = leaves(cfg, want_state["err"])
        close_grads(state["err"], errs, "err", flips["err"],
                    {n: max(t / clip, float(errs[n].abs().max()))
                     for n, t in tops.items()})


def test_grad_shard_specs_without_a_mesh_change_nothing():
    """As the reference's constraint is a no-op without a mesh, the step
    with `grad_shard_specs` and no mesh is the one-device step, bit for
    bit; so is a mesh whose data axis does not divide the batch."""
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in uneven_batch(cfg).items()}
    out = []
    for specs, mesh in ((False, None), (True, None),
                        (True, make_host_mesh(3, device="cpu"))):
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        state = tts.make_train_state(model)
        with use_mesh(mesh):
            state, metrics = tts.make_train_step(
                model, OptConfig(**OPT), grad_shard_specs=(
                    param_specs(model) if specs else None))(state, batch)
        out.append((state, metrics))
    (s0, m0) = out[0]
    for s1, m1 in out[1:]:
        assert torch.equal(m0["loss"], m1["loss"])
        assert torch.equal(m0["grad_norm"], m1["grad_norm"])
        for n in s0["params"]:
            assert torch.equal(s0["params"][n], s1["params"][n]), n


def test_shards_on_another_device_run_on_a_copy_of_the_parameters(
        monkeypatch):
    """A shard whose device is not the model's runs `loss_fn` through
    `torch.func.functional_call` on a copy of the parameters there. The
    CPU stands in for a second device as `cpu:1` (a device that compares
    unequal to `cpu`); the step equals the one on a mesh of one device
    bit for bit, and the model keeps its own parameter tensors."""
    cfg = tconfigs.get_arch("hymba-1.5b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in uneven_batch(cfg).items()}
    two = Mesh((torch.device("cpu"), torch.device("cpu", 1)) * 4, ("data",))
    calls = []
    call = torch.func.functional_call
    monkeypatch.setattr(torch.func, "functional_call",
                        lambda *a, **k: calls.append(1) or call(*a, **k))
    out = []
    for mesh in (make_host_mesh(SHARDS, device="cpu"), two):
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        state = tts.make_train_state(model)
        before = dict(model.named_parameters())
        with use_mesh(mesh):
            state, metrics = tts.make_train_step(
                model, OptConfig(**OPT), micro_batches=2,
                grad_shard_specs=param_specs(model))(state, batch)
        assert all(p is before[n] for n, p in model.named_parameters())
        out.append((state, metrics))
    assert len(calls) == 8      # 4 shards on cpu:1, 2 microbatches
    (s1, m1), (s2, m2) = out
    assert torch.equal(m1["loss"], m2["loss"])
    for n in s1["params"]:
        assert torch.equal(s1["params"][n], s2["params"][n]), n
        assert torch.equal(s1["opt"]["nu"][n], s2["opt"]["nu"][n]), n


def test_elastic_restart_on_a_smaller_mesh_matches_unsharded(tmp_path):
    """tests/test_distributed.py:137-183 on the port: 6 steps on 8 data
    shards, a checkpoint, restore(shardings=) onto that mesh, a fresh
    model, `remesh_state` onto (4, 2) ('data', 'model'), 6 more steps;
    the 12 losses against 12 unsharded steps, the step counter at 12."""
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
    want = [float(step(state, data.batch(i))[1]["loss"]) for i in range(12)]

    mesh8 = make_host_mesh(8, device="cpu")
    model, state = fresh()
    step = tts.make_train_step(model, opt)
    losses = []
    with use_mesh(mesh8):
        for i in range(6):
            losses.append(float(step(state, data.batch(i))[1]["loss"]))
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(6, state)

    del model, state, step          # the failure: a new process's state
    names = list(dict(fresh()[0].named_parameters()))

    def tree(leaf):
        return {"params": {n: leaf for n in names},
                "opt": {"mu": {n: leaf for n in names},
                        "nu": {n: leaf for n in names}, "step": leaf}}

    template, spec_tree, shardings = tree(None), tree(P()), tree((mesh8,
                                                                 P()))
    restored = ck.restore(6, template, shardings=shardings)
    assert isinstance(restored["params"]["embedding"], Placed)
    mesh42 = Mesh((torch.device("cpu"),) * 8, ("data", "model"), (4, 2))
    placed = remesh_state(restored, spec_tree, mesh42)
    assert placed["params"]["embedding"].mesh.shape["data"] == 4
    model, state = fresh()
    tts.load_train_state(state, placed)
    step = tts.make_train_step(model, opt)
    with use_mesh(mesh42):
        for i in range(6, 12):
            losses.append(float(step(state, data.batch(i))[1]["loss"]))
    assert int(state["opt"]["step"]) == 12
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)


def test_moe_on_more_than_one_data_shard_raises():
    cfg = tconfigs.get_arch("granite-moe-3b-a800m").reduced()
    model = LM(cfg, generator=torch.Generator().manual_seed(0),
               device="cpu", param_dtype=torch.float32)
    state = tts.make_train_state(model)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                    global_batch=4, seed=0), device="cpu")
    step = tts.make_train_step(model, OptConfig())
    before = {n: p.detach().clone() for n, p in state["params"].items()}
    with use_mesh(make_host_mesh(2, device="cpu")):
        with pytest.raises(ValueError, match="MoE"):
            step(state, data.batch(0))
    assert all(torch.equal(before[n], p) for n, p in state["params"].items())
    with use_mesh(make_host_mesh(1, device="cpu")):   # one shard: allowed
        _, metrics = step(state, data.batch(0))
    assert torch.isfinite(metrics["loss"])
    # an odd batch that no data axis divides runs on one shard
    odd = TokenPipeline(dataclasses.replace(data.cfg, global_batch=3),
                        device="cpu")
    with use_mesh(make_host_mesh(2, device="cpu")):
        _, metrics = step(state, odd.batch(1))
    assert torch.isfinite(metrics["loss"])
