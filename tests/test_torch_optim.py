"""The port's optimizer and gradient compression (`repro_torch.optim`): the
cases of `tests/test_optim.py` on the port, and parity with the JAX
package's `adamw_update`, `lr_schedule`, `clip_by_global_norm`,
`topk_compress` and the int8 round trip, on the CPU.

Tolerances: the schedule and the AdamW arithmetic are the reference's
float32 operations in the same order, so the schedule is held to one
float32 ulp (rtol 1e-7) and one update to rtol 1e-6 (pow and sqrt may
round differently in their last ulp); sums over leaves (the global norm)
to rtol 1e-6. Compression selects and rounds the same values: its
outputs are held equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, global_norm,
                                         init_opt_state, lr_schedule)

torch.set_num_threads(1)


def _np_adamw(p, g, m, v, step, cfg):
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mh = m / (1 - cfg.b1 ** step)
    vh = v / (1 - cfg.b2 ** step)
    return m, v, mh, vh


def test_adamw_matches_numpy_reference():
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=1000, total_steps=2000,
                    weight_decay=0.0, clip_norm=1e9)
    p0 = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    params = {"w": torch.from_numpy(p0.copy())}
    grads = {"w": torch.tensor([[0.1, -0.2], [0.3, 0.4]])}
    state = init_opt_state(params)
    newp, newstate, m = adamw_update(params, grads, state, cfg)
    g = grads["w"].numpy()
    mm, vv, mh, vh = _np_adamw(p0, g, np.zeros((2, 2)), np.zeros((2, 2)),
                               1, cfg)
    lr = 1e-2 * 1 / 1000
    want = p0 - lr * mh / (np.sqrt(vh) + cfg.eps)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(newstate["mu"]["w"].numpy(), mm, rtol=1e-6)
    assert int(newstate["step"]) == 1


def test_clip_by_global_norm():
    g = {"a": torch.ones((4,)) * 3.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 6.0) < 1e-5
    np.testing.assert_allclose(clipped["a"].numpy(), np.ones(4) * 0.5,
                               rtol=1e-5)


def test_lr_schedule_shape():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == 0.5
    assert abs(lrs[2] - 1.0) < 0.05
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 0.1) < 1e-3  # decays to 10%


def test_topk_error_feedback_unbiased_over_time():
    """With error feedback, sum of compressed grads ~= sum of true grads."""
    rng = np.random.default_rng(0)
    err = torch.zeros((100,))
    total_sent, total_true = np.zeros(100), np.zeros(100)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
        sent, err = comp.topk_compress(g, 0.1, err)
        total_sent += sent.numpy()
        total_true += g.numpy()
    assert np.abs(total_sent - total_true).max() < 10.0


def test_int8_roundtrip_error_bound():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    q, s = comp.int8_quantize(g)
    assert q.dtype == torch.int8
    deq = comp.int8_dequantize(q, s, g.shape)
    err = float((g - deq).abs().max())
    assert err <= float(g.abs().max()) / 127.0 + 1e-6


def test_int8_ef_state():
    g = torch.tensor([[1.0, -0.003, 2.0]])
    sent, err = comp.int8_roundtrip(g, torch.zeros_like(g))
    np.testing.assert_allclose((sent + err).numpy(), g.numpy(), atol=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 10), (100, 10_000)])
def test_lr_schedule_matches_reference(warmup, total):
    """float32 arithmetic on the step, as the reference's: equal to an ulp
    over warmup, the cosine and past the end."""
    cfg = OptConfig(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg = jopt.OptConfig(peak_lr=3e-4, warmup_steps=warmup,
                          total_steps=total)
    for s in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 7}):
        got = lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = jopt.lr_schedule(jcfg, jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7,
                                   err_msg=f"step {s}")


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (7, 5), "b": (3,), "c": (2, 4, 6)}


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_update_matches_reference_over_steps(clip_norm):
    """Three steps on a tree of three leaves (weight decay on all of them,
    clipping active or not): params, mu, nu, lr and grad_norm."""
    rng = np.random.default_rng(3)
    p = _tree(rng, SHAPES)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              clip_norm=clip_norm)
    cfg, jcfg = OptConfig(**kw), jopt.OptConfig(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = init_opt_state(tp), jopt.init_opt_state(jp)
    for step in range(3):
        g = _tree(rng, SHAPES, scale=0.5)
        tp, ts, tm = adamw_update(tp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, ts, cfg)
        jp, js, jm = jopt.adamw_update(jp, {k: jnp.asarray(v)
                                            for k, v in g.items()}, js, jcfg)
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (ts["mu"][k], js["mu"][k]),
                              (ts["nu"][k], js["nu"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1


def test_adamw_updates_the_given_tensors_in_place():
    """The parameters, moments and step are overwritten and returned (a
    model holding the parameters sees the step); clones updated apart
    end equal."""
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v) for k, v in _tree(rng, SHAPES).items()}
    g = {k: torch.from_numpy(v) for k, v in _tree(rng, SHAPES).items()}
    copy = {k: v.clone() for k, v in p.items()}
    s1, s2 = init_opt_state(p), init_opt_state(copy)
    new, ns, _ = adamw_update(p, g, s1, OptConfig())
    adamw_update(copy, g, s2, OptConfig())
    assert new is p and ns is s1 and int(s1["step"]) == 1
    for k in p:
        assert torch.equal(p[k], copy[k])
        assert torch.equal(s1["mu"][k], s2["mu"][k])
        assert torch.equal(s1["nu"][k], s2["nu"][k])
        assert s1["mu"][k].any()


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(5)
    g = _tree(rng, SHAPES, scale=3.0)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 1e3):
        got, gn = clip_by_global_norm(tg, max_norm)
        want, jn = jopt.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_compress_matches_reference(frac):
    rng = np.random.default_rng(6)
    g = rng.standard_normal((40, 25)).astype(np.float32)
    e = (rng.standard_normal((40, 25)) * 0.1).astype(np.float32)
    sent, err = comp.topk_compress(torch.from_numpy(g), frac,
                                   torch.from_numpy(e))
    jsent, jerr = jcomp.topk_compress(jnp.asarray(g), frac, jnp.asarray(e))
    assert np.array_equal(sent.numpy(), np.asarray(jsent))
    assert np.array_equal(err.numpy(), np.asarray(jerr))


def test_topk_keeps_ties_at_the_threshold():
    """|value| >= the k-th largest: every entry tied with it is sent."""
    g = torch.tensor([3.0, -2.0, 2.0, 2.0, -1.0, 0.5])
    sent, err = comp.topk_compress(g, 2 / 6, torch.zeros(6))
    assert sent.tolist() == [3.0, -2.0, 2.0, 2.0, 0.0, 0.0]
    assert err.tolist() == [0.0, 0.0, 0.0, 0.0, -1.0, 0.5]
    jsent, _ = jcomp.topk_compress(jnp.asarray(g.numpy()), 2 / 6,
                                   jnp.zeros(6))
    assert np.array_equal(sent.numpy(), np.asarray(jsent))


@pytest.mark.parametrize("shape", [(16,), (8, 12), (3, 4, 5)])
def test_int8_roundtrip_matches_reference(shape):
    """Row-wise absmax over the first axis, round half to even: the
    quantised values, the scales and the round trip equal the
    reference's, a half-way value included."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal(shape).astype(np.float32)
    # row 0's max 19.84375 makes its quantum 10 / 64 exactly; 25 / 64 is
    # then q = 2.5, which rounds half to even: 2
    g.reshape(-1)[0] = 1270 / 64
    g.reshape(-1)[1] = 25 / 64
    e = np.zeros(shape, np.float32)
    q, s = comp.int8_quantize(torch.from_numpy(g))
    jq, js = jcomp.int8_quantize(jnp.asarray(g))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    sent, err = comp.int8_roundtrip(torch.from_numpy(g), torch.from_numpy(e))
    jsent, jerr = jcomp.int8_roundtrip(jnp.asarray(g), jnp.asarray(e))
    assert np.array_equal(sent.numpy(), np.asarray(jsent))
    assert np.array_equal(err.numpy(), np.asarray(jerr))
    assert float(s.reshape(-1)[0]) == 10 / 64
    assert int(q.reshape(-1)[1]) == 2


def test_init_error_state():
    p = {"a": torch.ones((2, 3), dtype=torch.bfloat16), "b": torch.ones(4)}
    e = comp.init_error_state(p)
    assert all(v.dtype == torch.float32 and not v.any() for v in e.values())
    assert e["a"].shape == (2, 3)
