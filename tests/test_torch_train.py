"""The port's training path against the JAX package, on the CPU.

For every config's `reduced()` (fp32, 2 layers), with the reference's
weights carried across (`models/convert.from_reference_train_state`):
the loss, CE and aux of `LM.loss_fn` and every gradient leaf against
`jax.value_and_grad(LM.loss_fn)`; then one `train_step` against the
reference's (params, mu, nu, lr, grad_norm): the reference's
`adamw_update` on its own gradients, which is its `train_step` without
options. Also: microbatched against
full (`tests/test_models_smoke.py:66`) and against the reference's
microbatched step with a bf16 gradient sync, top-k and int8 compression
with their error feedback, and remat (`torch.utils.checkpoint`) against
no remat.

Tolerances, each with its reason:
  * loss, CE, aux: atol = rtol = 1e-5 (float32 over two layers and a
    97-way logsumexp; the order of sums differs);
  * gradients: max |diff| <= GRAD_TOL x the leaf's max |grad| (1e-4:
    the backward sums the same products in another order, and a leaf's
    small entries carry the large ones' rounding);
  * after one AdamW step: mu, nu and grad_norm as the gradients (they
    are linear in them); params at 1e-6 + 1e-4·lr + lr·swing, with g the
    clipped gradient (the reference's mu / (1 - b1)), δ its tolerance,
    and swing the most that r(x) = x / (|x| + eps), AdamW's first-step
    mhat / sqrt(vhat), moves over [g - δ, g + δ]: the gradient tolerance
    carried through the step, so an entry with |g| near eps (1e-8) may
    swing by up to 2·lr while one with |g| >> eps may not move;
  * lr: float32 equality within one ulp (rtol 1e-6);
  * where the step rounds the gradient (a bf16 gradient sync rounds each
    microbatch's to bf16; int8 compression rounds g + err to a quantum
    of its row, max |row| / 127), an entry within the sums' rounding of
    a rounding boundary goes the other way on one side. Such an entry
    may differ by one such rounding (FLIPS, as a fraction of the leaf's
    max: in mu 2^-7 and in nu 2^-6 for bf16; in mu and err 1/127 and in
    nu 2/127 for int8, err taken on the scale of the gradient it came
    from), and such entries must be rare: at most 1 in 10^3 of a leaf,
    or one.
The reference runs jitted (`jax.jit`), as its trainer runs it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm import close, port_cfg, ref_model, reference_fixture
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.optim import compression as tcomp
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

ARCH_NAMES = sorted(tconfigs.ARCHS)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# the most an entry may move where one rounding went the other way, by
# option and part, as a fraction of the leaf's max (see the docstring)
FLIPS = {"bfloat16": dict(mu=2.0 ** -7, nu=2.0 ** -6),
         "int8": dict(mu=1 / 127, nu=2 / 127, err=1 / 127)}
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def J():
    for ref in reference_fixture():
        from repro.optim import optimizer as jopt
        from repro.optim import compression as jcomp
        from repro.train import train_step as jts

        ref.opt, ref.comp, ref.train_step = jopt, jcomp, jts
        yield ref


def batch_for(cfg, b=2, s=32, seed=0):
    """The reference's smoke-test batch (`tests/test_models_smoke.py`) as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return dict(
            features=rng.standard_normal((b, s, cfg.feat_dim)).astype(
                np.float32),
            labels=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            mask=rng.random((b, s)) < 0.5)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    return dict(tokens=toks[:, :-1].astype(np.int32),
                labels=toks[:, 1:].astype(np.int32))


def ref_state(J, m, params, compress=False):
    """The reference's train state over `params` (numpy leaves)."""
    state = dict(params=params, opt=J.opt.init_opt_state(params))
    if compress:
        state["err"] = J.comp.init_error_state(params)
    return J.jax.tree.map(np.asarray, state)


def port_state(cfg, state_np):
    """A port model with float32 leaves on the CPU and its train state,
    loaded from the reference's (numpy) state."""
    model = LM(port_cfg(cfg), device="cpu", param_dtype=torch.float32)
    state = tts.make_train_state(model)
    if "err" in state_np:
        state["err"] = tcomp.init_error_state(state["params"])
    tts.load_train_state(state, convert.from_reference_train_state(
        model.cfg, state_np))
    return model, state


def leaves(cfg, tree):
    """A params-shaped reference tree as {port name: float32 tensor}."""
    return convert.float32_leaves(port_cfg(cfg), host_tree(tree))


def host_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def close_grads(got, want, what, flip=0.0, tops=None):
    """Each leaf within rtol GRAD_TOL and atol GRAD_TOL x its max |value|
    (or x tops[name], its scale where given); with `flip`, a few entries
    (see the docstring) may be off by up to flip x that more."""
    for name, w in want.items():
        g = got[name].detach().numpy()
        w = w.numpy()
        top = float(tops[name]) if tops else float(np.abs(w).max())
        diff = np.abs(g - w)
        tight = diff <= GRAD_TOL * (top + np.abs(w)) + 1e-9
        if not flip:
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * top + 1e-9,
                                       err_msg=f"{what} {name}")
            continue
        assert (diff <= (flip + GRAD_TOL) * top + 1e-9).all(), \
            f"{what} {name}: {diff.max()} over {flip} x {top}"
        assert (~tight).sum() <= max(1, 1e-3 * w.size), \
            f"{what} {name}: {(~tight).sum()} of {w.size} entries off"


def close_step(got_state, want_state, cfg, lr, flips=None, b1=0.9,
               eps=1e-8):
    """Port and reference states after one step from zero moments (see
    the docstring). Returns the clipped gradients' max per leaf."""
    flips = flips or {}
    want = {k: leaves(cfg, v) for k, v in (
        ("params", want_state["params"]), ("mu", want_state["opt"]["mu"]),
        ("nu", want_state["opt"]["nu"]))}
    got = dict(params=got_state["params"], mu=got_state["opt"]["mu"],
               nu=got_state["opt"]["nu"])
    for part in ("mu", "nu"):
        close_grads(got[part], want[part], part, flips.get(part, 0))
    tops = {}
    def r(x):
        return x / (np.abs(x) + eps)

    for name, w in want["params"].items():
        gc = want["mu"][name].numpy().astype(np.float64) / (1 - b1)
        tops[name] = top = float(np.abs(gc).max())
        delta = GRAD_TOL * (top + np.abs(gc)) + flips.get("mu", 0) * top
        swing = np.maximum(np.abs(r(gc + delta) - r(gc)),
                           np.abs(r(gc - delta) - r(gc)))
        tol = 1e-6 + 1e-4 * lr + lr * swing
        diff = np.abs(got["params"][name].detach().numpy() - w.numpy())
        assert (diff <= tol).all(), \
            f"params {name}: {int((diff > tol).sum())} entries off"
    assert int(got_state["opt"]["step"]) == int(want_state["opt"]["step"])
    return tops


_REF = {}


def ref_loss_and_grads(J, name):
    """The reference's reduced `name` (seed 1), the batch, and its jitted
    value_and_grad of loss_fn there; once per module."""
    if name not in _REF:
        cfg, m, params = ref_model(J, name)
        batch = batch_for(cfg)
        out = J.jax.jit(J.jax.value_and_grad(m.loss_fn, has_aux=True))(
            params, {k: J.jnp.asarray(v) for k, v in batch.items()})
        _REF[name] = (cfg, m, params, batch, host_tree(out))
    return _REF[name]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_gradients_match_reference(J, name):
    cfg, m, params, batch, ((loss, metrics), grads) = ref_loss_and_grads(
        J, name)
    model, state = port_state(cfg, ref_state(J, m, params))
    tloss, tmetrics = model.loss_fn({k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        close(tmetrics[k], metrics[k], LOSS_TOL, k)
    close(tloss, loss, LOSS_TOL, "loss")
    names = list(state["params"])
    tgrads = torch.autograd.grad(tloss, [state["params"][n] for n in names],
                                 allow_unused=True)
    got = {n: torch.zeros_like(state["params"][n]) if g is None else g
           for n, g in zip(names, tgrads)}
    want = leaves(cfg, grads)
    assert set(got) == set(want)
    close_grads(got, want, "grad")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step_matches_reference(J, name):
    cfg, m, params, batch, ((loss, _), grads) = ref_loss_and_grads(J, name)
    start = ref_state(J, m, params)
    new_params, new_opt, om = J.jax.jit(J.opt.adamw_update,
                                        static_argnums=3)(
        params, grads, start["opt"], J.opt.OptConfig(**OPT))
    want_state = dict(params=new_params, opt=new_opt)
    want = dict(loss=loss, **om)
    model, state = port_state(cfg, start)
    step = tts.make_train_step(model, OptConfig(**OPT))
    params_before = state["params"]["embedding"]
    state, got = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert state["params"]["embedding"] is params_before  # in place
    assert dict(model.named_parameters())["embedding"] is params_before
    close(got["loss"], want["loss"], LOSS_TOL, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                               rtol=1e-6)
    close_step(state, host_tree(want_state), cfg, float(want["lr"]))


def test_microbatched_step_matches_full():
    """The port's own microbatching: 2 microbatches equal one batch
    (tests/test_models_smoke.py:66's tolerances)."""
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    batch = {k: torch.from_numpy(v)
             for k, v in batch_for(cfg, b=4).items()}
    out = []
    for micro in (1, 2):
        model = LM(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", param_dtype=torch.float32)
        state = tts.make_train_state(model)
        state, metrics = tts.make_train_step(model, OptConfig(),
                                             micro_batches=micro)(state,
                                                                  batch)
        out.append((state, metrics))
    (s_full, m_full), (s_micro, m_micro) = out
    np.testing.assert_allclose(float(m_full["loss"]),
                               float(m_micro["loss"]), rtol=1e-5)
    for name, p in s_full["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   s_micro["params"][name].detach().numpy(),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name,compress,micro,sync", [
    ("phi3-mini-3.8b", None, 2, "bfloat16"),
    ("phi3-mini-3.8b", "topk", 1, None),
    ("phi3-mini-3.8b", "int8", 1, None),
    ("hymba-1.5b", "topk", 1, None),
    ("granite-moe-3b-a800m", "int8", 2, None),
])
def test_step_options_match_reference(J, name, compress, micro, sync):
    """Microbatches (with a bf16 gradient sync), top-k (frac 0.05) and int8
    compression with error feedback: params, moments and the new error
    state against the reference's step. phi3 and granite are `scan`
    (compression over the stacked layer leaves), hymba `unroll`."""
    cfg, m, params = ref_model(J, name, seed=4)
    batch = batch_for(cfg, b=4, seed=3)
    kw = dict(micro_batches=micro, compress=compress, topk_frac=0.05,
              grad_sync_dtype=sync)
    want_state, want = J.jax.jit(J.train_step.make_train_step(
        m, J.opt.OptConfig(**OPT), **kw))(
        ref_state(J, m, params, bool(compress)),
        {k: J.jnp.asarray(v) for k, v in batch.items()})
    model, state = port_state(cfg, ref_state(J, m, params, bool(compress)))
    state, got = tts.make_train_step(model, OptConfig(**OPT), **kw)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    want_state = host_tree(want_state)
    flips = FLIPS.get(sync or compress)
    close(got["loss"], want["loss"], LOSS_TOL, "loss")
    close(got["grad_norm"], want["grad_norm"], GRAD_TOL, "grad_norm")
    tops = close_step(state, want_state, cfg, float(want["lr"]), flips)
    if compress:
        # err on the scale of the gradient it came from: the sent
        # gradient's max (the clipped one's over the clip factor), or
        # err's own where top-k sent nothing of a layer's part
        clip = min(1.0, 1.0 / float(want["grad_norm"]))
        errs = leaves(cfg, want_state["err"])
        close_grads(state["err"], errs, "err", (flips or {}).get("err", 0),
                    {n: max(t / clip, float(errs[n].abs().max()))
                     for n, t in tops.items()})


def test_remat_gives_the_same_gradients(J):
    """cfg.remat: each layer under torch.utils.checkpoint. The gradients
    equal those without remat bit for bit (the recompute repeats the
    forward) and the reference's with jax.checkpoint."""
    cfg, m, params = ref_model(J, "granite-moe-3b-a800m", seed=5,
                               remat=True)
    batch = batch_for(cfg, seed=5)
    _, grads = J.jax.jit(J.jax.value_and_grad(m.loss_fn, has_aux=True))(
        params, {k: J.jnp.asarray(v) for k, v in batch.items()})
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model, state = port_state(c, ref_state(J, m, params))
        loss, _ = model.loss_fn({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        names = list(state["params"])
        out.append(dict(zip(names, torch.autograd.grad(
            loss, [state["params"][n] for n in names]))))
    for n in out[0]:
        assert torch.equal(out[0][n], out[1][n]), n
    close_grads(out[0], leaves(cfg, grads), "remat grad")


def test_bf16_training_model_casts_float32_leaves_at_use():
    """param_dtype=float32 with bf16 activations: every leaf float32, the
    loss computed in bf16 activations, finite gradients on every leaf the
    loss reads; the serving default keeps matmul weights in bf16."""
    cfg = dataclasses.replace(tconfigs.get_arch("phi3-mini-3.8b").reduced(),
                              dtype="bfloat16")
    model = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
               param_dtype=torch.float32)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    serving = LM(cfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    assert serving.embedding.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serving.parameters())
    state = tts.make_train_state(model)
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    state, metrics = tts.make_train_step(model, OptConfig())(state, batch)
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    with pytest.raises(ValueError):
        tts.make_train_state(serving)
