"""The port's checkpoints, data pipeline, fault tolerance and trainer
(`repro_torch.ckpt`, `data`, `ft`, `train.trainer`), on the CPU: the
cases of `tests/test_ckpt_ft_data.py` (its mesh case is in
`tests/test_torch_sharding.py`), the pipeline's
batches against the reference pipeline's bit for bit, a checkpoint that
the reference's `Checkpointer` wrote restored through
`models/convert.from_reference_train_state` with the next step against
the reference's, and the launcher.

Tolerances of the next step after a restore: loss 1e-5, grad_norm,
mu and nu as `test_torch_train`'s gradients (1e-4 of a leaf's max);
params at 1e-6 + 1e-3·lr, but where the reference's sqrt(vhat) is
below 1e-5 (the step's sensitivity to its gradient passes 1e5 there;
both steps' gradients of that entry are then below it) at 2·lr: AdamW's
update of an entry is at most lr·(1 + wd·|p|) in size.
"""
import logging
import os

import numpy as np
import pytest
import torch

from _torch_lm import close, port_cfg, reference_fixture
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.ft.elastic import (FailureInjector, FaultConfig,
                                    StragglerMonitor)
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train import GRAD_TOL, batch_for, close_grads, leaves

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    for ref in reference_fixture():
        from repro.ckpt import checkpoint as jckpt
        from repro.data import pipeline as jdata
        from repro.optim import optimizer as jopt
        from repro.train import train_step as jts

        ref.ckpt, ref.data, ref.opt, ref.train_step = jckpt, jdata, jopt, jts
        yield ref


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = {"a": torch.arange(6).reshape(2, 3),
             "nested": {"b": torch.ones((4,)) * 2.5},
             "lst": [torch.zeros((2,)), torch.ones((2,))]}
    ck.save(3, state)
    assert ck.latest_step() == 3
    got = ck.restore(3, state)
    assert np.array_equal(got["a"], state["a"].numpy())
    assert np.array_equal(got["nested"]["b"], state["nested"]["b"].numpy())
    assert [x.tolist() for x in got["lst"]] == [[0, 0], [1, 1]]
    assert sorted(os.listdir(tmp_path / "step_3")) == ["meta.json",
                                                       "proc_0.npz"]


def test_checkpoint_gc_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.full((3,), s)})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


def test_async_save_writes_the_state_as_it_was(tmp_path):
    """The host copy is taken at save time: a CPU tensor overwritten right
    after (the next step) does not reach the file."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    x = torch.zeros(1 << 16)
    ck.save(1, {"x": x})
    x.fill_(7.0)
    ck.wait()
    assert not ck.restore(1, {"x": None})["x"].any()


def test_checkpoint_layout_is_the_references(J, tmp_path):
    """Either side reads what the other wrote: the same `/`-joined sorted
    keys, npz file and meta.json."""
    state = {"params": {"w": torch.arange(4.0)},
             "opt": {"step": torch.tensor(5, dtype=torch.int32),
                     "mu": {"w": torch.ones(4)}}}
    Checkpointer(str(tmp_path / "port"), async_save=False).save(2, state)
    jc = J.ckpt.Checkpointer(str(tmp_path / "port"), async_save=False)
    got = jc.restore(2, J.jax.tree.map(lambda x: x.numpy(), state))
    assert np.array_equal(np.asarray(got["params"]["w"]), np.arange(4.0))
    assert int(got["opt"]["step"]) == 5
    jc2 = J.ckpt.Checkpointer(str(tmp_path / "ref"), async_save=False)
    jc2.save(2, J.jax.tree.map(lambda x: x.numpy(), state))
    back = Checkpointer(str(tmp_path / "ref")).restore(2, state)
    assert np.array_equal(back["opt"]["mu"]["w"], np.ones(4))
    import json
    metas = [json.load(open(tmp_path / d / "step_2" / "meta.json"))
             for d in ("port", "ref")]
    assert metas[0]["keys"] == metas[1]["keys"]


@pytest.mark.parametrize("kind", ["synthetic", "file", "encoder"])
def test_batches_equal_reference_pipeline(J, tmp_path, kind):
    kw = dict(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    if kind == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 100, 5000).astype(
            np.uint16).tofile(path)
        kw.update(kind="file", path=path)
    if kind == "encoder":
        kw.update(is_encoder=True, feat_dim=12)
    port = TokenPipeline(DataConfig(**kw), device="cpu")
    ref = J.data.TokenPipeline(J.data.DataConfig(**kw))
    for step in (0, 5, 6):
        got, want = port.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for k in got:
            w = np.asarray(want[k])
            assert got[k].dtype == torch.from_numpy(w).dtype, k
            assert np.array_equal(got[k].numpy(), w), (step, k)


def test_data_determinism():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    p1, p2 = TokenPipeline(cfg, device="cpu"), TokenPipeline(cfg,
                                                             device="cpu")
    b1 = p1.batch(5)
    assert torch.equal(b1["tokens"], p2.batch(5)["tokens"])
    assert not torch.equal(b1["tokens"], p1.batch(6)["tokens"])
    raw = p1._host_batch(5)
    np.testing.assert_array_equal(raw["tokens"][:, 1:], raw["labels"][:, :-1])
    it = iter(p1)
    assert torch.equal(next(it)["tokens"], p1.batch(0)["tokens"])


def _mk_trainer(tmp_path, fail_steps=(), total=12, ckpt_every=4, seq_len=16,
                batch=4, lr=5e-3):
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    model = LM(cfg, device="cpu", param_dtype=torch.float32)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq_len, global_batch=batch,
                                    seed=1), device="cpu")
    return Trainer(
        model, data, OptConfig(peak_lr=lr, warmup_steps=3, total_steps=total),
        TrainerConfig(total_steps=total, log_every=100), str(tmp_path),
        fault_cfg=FaultConfig(ckpt_every=ckpt_every, max_restarts=3),
        failure_injector=FailureInjector(fail_steps))


def test_trainer_loss_decreases(tmp_path):
    t = _mk_trainer(tmp_path, total=40, ckpt_every=50, seq_len=32, batch=8,
                    lr=1e-2)
    out = t.run()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert out["restarts"] == 0


def test_trainer_restarts_from_checkpoint(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="repro_torch.trainer")
    t = _mk_trainer(tmp_path, fail_steps=(9,), total=12, ckpt_every=4)
    out = t.run()
    assert out["restarts"] == 1
    steps = [h["step"] for h in out["history"]]
    # after failing at 9 it restarted from the checkpoint of step 8
    assert steps == list(range(9)) + list(range(8, 12))
    assert "restored checkpoint at step 8" in caplog.text
    by_step = {}
    for h in out["history"]:
        by_step.setdefault(h["step"], []).append(h["loss"])
    replayed = [ls for ls in by_step.values() if len(ls) > 1]
    assert replayed and all(abs(ls[0] - ls[1]) < 1e-4 for ls in replayed)
    assert Checkpointer(str(tmp_path)).latest_step() == 12


def test_trainer_resumes_a_finished_run(tmp_path):
    """A second Trainer on the same directory restores the last step and
    has nothing left to run; its state equals the first run's."""
    first = _mk_trainer(tmp_path, total=6, ckpt_every=3).run()
    t = _mk_trainer(tmp_path, total=6, ckpt_every=3)
    out = t.run()
    assert out["history"] == []
    for name, p in first["state"]["params"].items():
        assert torch.equal(p, out["state"]["params"][name]), name


def test_trainer_with_compression_and_microbatches(tmp_path):
    cfg = tconfigs.get_arch("mamba2-370m").reduced()
    model = LM(cfg, device="cpu", param_dtype=torch.float32)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4, seed=2), device="cpu")
    out = Trainer(model, data, OptConfig(peak_lr=5e-3, warmup_steps=2,
                                         total_steps=4),
                  TrainerConfig(total_steps=4, micro_batches=2,
                                compress="int8"),
                  str(tmp_path), fault_cfg=FaultConfig(ckpt_every=2)).run()
    assert len(out["history"]) == 4
    assert set(out["state"]) == {"params", "opt", "err"}
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_straggler_monitor():
    mon = StragglerMonitor(FaultConfig(straggler_factor=3.0))
    flags = [mon.observe(i, 0.1) for i in range(10)]
    assert not any(flags)
    assert mon.observe(10, 1.0)  # 10x the EWMA -> straggler
    assert len(mon.events) == 1


def test_failure_injector_fires_once():
    inj = FailureInjector((2,))
    inj.check(1)
    with pytest.raises(RuntimeError):
        inj.check(2)
    inj.check(2)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "hymba-1.5b"])
def test_reference_checkpoint_restores_and_next_step_agrees(J, tmp_path,
                                                            name):
    """The reference trains one step and saves it with its Checkpointer;
    the port restores the file, converts the state
    (`from_reference_train_state`: `scan` phi3, `unroll` hymba) and takes
    the next step beside the reference's (see the docstring)."""
    jcfg = J.configs.ARCHS[name].reduced()
    m = J.model.LM(jcfg)
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = J.jax.jit(J.train_step.make_train_step(m, J.opt.OptConfig(**opt)))
    b1, b2 = (batch_for(jcfg, seed=s) for s in (1, 2))
    state = J.train_step.make_train_state(m, J.jax.random.PRNGKey(3))
    state, _ = step(state, {k: J.jnp.asarray(v) for k, v in b1.items()})
    J.ckpt.Checkpointer(str(tmp_path), async_save=False).save(1, state)
    template = J.jax.tree.map(np.asarray, J.jax.device_get(state))
    want_state, want = step(state, {k: J.jnp.asarray(v)
                                    for k, v in b2.items()})

    restored = Checkpointer(str(tmp_path)).restore(1, template)
    cfg = port_cfg(jcfg)
    model = LM(cfg, device="cpu", param_dtype=torch.float32)
    tstate = tts.make_train_state(model)
    tts.load_train_state(tstate, convert.from_reference_train_state(
        cfg, restored))
    for n, p in convert.float32_leaves(cfg, template["params"]).items():
        assert torch.equal(tstate["params"][n], p), n
    tstate, got = tts.make_train_step(model, OptConfig(**opt))(
        tstate, {k: torch.from_numpy(v) for k, v in b2.items()})
    want_state = J.jax.tree.map(np.asarray, want_state)
    close(got["loss"], want["loss"], 1e-5, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    assert int(tstate["opt"]["step"]) == 2
    mu, nu = (leaves(jcfg, want_state["opt"][k]) for k in ("mu", "nu"))
    close_grads(tstate["opt"]["mu"], mu, "mu")
    close_grads(tstate["opt"]["nu"], nu, "nu")
    lr = float(want["lr"])
    for n, w in leaves(jcfg, want_state["params"]).items():
        vhat = nu[n].numpy() / (1 - 0.95 ** 2)
        tol = np.where(np.sqrt(vhat) < 1e-5, 2 * lr, 1e-6 + 1e-3 * lr)
        diff = np.abs(tstate["params"][n].detach().numpy() - w.numpy())
        assert (diff <= tol).all(), n


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    out = tlaunch.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                        "--device", "cpu", "--steps", "4", "--batch", "2",
                        "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
                        str(tmp_path)])
    assert len(out["history"]) == 4 and out["restarts"] == 0
    assert "trained 4 steps" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
