"""The port's MoE layer (`models/moe.py`) and its dispatch ranks
(`core/sort.bucket_ranks`) against the JAX package, on the CPU.

`moe_ffn` against the reference's `moe_ffn` in float32 at 1e-5 (the same
arithmetic; a sum of up to 32 products per matmul in another order) with
no drops, with drops (cf 0.26: the same rows zero), with padded experts
and with ties forced at the k-th gate (the same experts chosen); the aux
loss against the reference's; the output against the dense
loop-over-experts reference of `tests/test_moe.py`. In bfloat16 the
dtype of each stage is the reference's and the values agree to 3e-2 (a
bf16 ulp of values up to ~4, where the two frameworks round at other
places). `bucket_ranks` equals the reference's bit for bit, and the
dispatch makes one rank call per layer. The `cuda` tests
hold the layer and the rank entry on the card and skip here.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm import (LAYER_TOL, MODEL_TOL, close, port_cfg, ref_model,
                       reference_fixture, tokens)
from repro_torch.core import sort as tsort
from repro_torch.kernels import ops, radix_hist
from repro_torch.models import convert
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

BF16_TOL = 3e-2


@pytest.fixture(scope="module")
def J():
    yield from reference_fixture()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def _ref_moe(J, e=4, k=2, d=16, f=32, cf=8.0, **changes):
    """The reference's MoE layer as tests/test_moe.py builds it: its
    config, its params (numpy) and the port's params (torch)."""
    from repro.models.layers import ParamSet
    from repro.models.moe import init_moe

    cfg = dataclasses.replace(
        J.configs.ARCHS["dbrx-132b"].reduced(), n_experts=e, moe_top_k=k,
        d_model=d, d_ff=f, capacity_factor=cf, **changes)
    ps = ParamSet()
    init_moe(ps, J.jax.random.PRNGKey(0), cfg)
    params = {n: np.array(v, dtype=np.float32) for n, v in ps.values.items()}
    return cfg, params


def _run_both(J, cfg, params, x):
    from repro.models.moe import moe_ffn

    want_y, want_aux = moe_ffn({n: J.jnp.asarray(v) for n, v in
                                params.items()}, cfg, J.jnp.asarray(x))
    got_y, got_aux = tmoe.moe_ffn({n: torch.from_numpy(v) for n, v in
                                   params.items()}, port_cfg(cfg),
                                  torch.from_numpy(x))
    return got_y, got_aux, np.asarray(want_y), np.asarray(want_aux)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ties(params, k):
    """Router columns k-1 .. E-1 made equal: every token's gates tie there,
    so the k-th choice is always among equal gates. The router is rounded
    to multiples of 1/8 (and the input too, in the test), so that every
    logit is an exact sum in float32 whatever the order of the products:
    equal columns give equal logits in both frameworks."""
    r = np.round(params["router"] * 8) / 8
    r[:, k:] = r[:, k - 1:k]
    return {**params, "router": r.astype(np.float32)}


CASES = {
    "no drops": (dict(e=4, k=2, cf=8.0), (2, 12, 16), 0),
    "drops": (dict(e=2, k=1, cf=0.26), (1, 16, 16), 1),
    "padded experts": (dict(e=4, k=2, real_n_experts=2), (1, 8, 16), 2),
    "ties at the k-th gate": (dict(e=6, k=2), (2, 10, 16), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(J, case):
    changes, shape, seed = CASES[case]
    cfg, params = _ref_moe(J, **changes)
    x = _x(shape, seed)
    if case == "ties at the k-th gate":
        params = _ties(params, cfg.moe_top_k)
        x = (np.round(x * 8) / 8).astype(np.float32)
    got_y, got_aux, want_y, want_aux = _run_both(J, cfg, params, x)
    assert got_y.dtype == torch.float32 and got_aux.dtype == torch.float32
    close(got_y, want_y, LAYER_TOL, "y")
    close(got_aux, want_aux, LAYER_TOL, "aux")

    # the experts chosen are the reference's
    logits = J.jnp.einsum("bsd,de->bse", J.jnp.asarray(x),
                          J.jnp.asarray(params["router"]))
    if cfg.real_n_experts:
        logits = J.jnp.where(J.jnp.arange(cfg.n_experts)
                             >= cfg.real_n_experts, -1e9, logits)
    _, want_idx = J.jax.lax.top_k(J.jax.nn.softmax(logits, axis=-1),
                                  cfg.moe_top_k)
    gates, _, idx = tmoe.route({n: torch.from_numpy(v) for n, v in
                                params.items()}, port_cfg(cfg),
                               torch.from_numpy(x))
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))

    norms = np.linalg.norm(want_y, axis=-1)
    if case == "drops":
        zero = np.linalg.norm(got_y.numpy(), axis=-1) == 0.0
        assert zero.any() and not zero.all()
        assert np.array_equal(zero, norms == 0.0)
    if case == "padded experts":
        assert int(idx.max()) < cfg.real_n_experts
    if case == "ties at the k-th gate":
        k = cfg.moe_top_k
        srt = torch.sort(gates, dim=-1, descending=True).values
        assert bool((srt[..., k - 1] == srt[..., k]).all())
        # the lower expert of a tie comes first
        assert bool((idx[..., :k].max(-1).values < cfg.n_experts - 1).all())


def test_moe_ffn_matches_the_dense_loop_over_experts(J):
    """No drops: the dispatch computes what a dense loop over experts with
    the normalised top-k gates computes (tests/test_moe.py's reference)."""
    from test_moe import _dense_ref

    cfg, params = _ref_moe(J, e=4, k=2, cf=8.0)
    x = _x((2, 12, 16), 4)
    want = _dense_ref({n: J.jnp.asarray(v) for n, v in params.items()}, cfg,
                      J.jnp.asarray(x))
    got, _ = tmoe.moe_ffn({n: torch.from_numpy(v) for n, v in
                           params.items()}, port_cfg(cfg),
                          torch.from_numpy(x), with_aux=False)
    close(got, np.asarray(want), LAYER_TOL)


def test_aux_only_on_request_changes_no_output(J):
    cfg, params = _ref_moe(J, e=4, k=2, cf=0.5)
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    x = torch.from_numpy(_x((2, 12, 16), 5))
    y, aux = tmoe.moe_ffn(tp, port_cfg(cfg), x)
    y2, aux2 = tmoe.moe_ffn(tp, port_cfg(cfg), x, with_aux=False)
    assert aux is not None and aux2 is None
    assert torch.equal(y, y2)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_keeps_the_reference_dtypes_in_bf16(J, act):
    """bfloat16 activations, the weights carried in bf16 as `convert.py`
    stores them (the reference casts its float32 params at use): the
    router's logits, the gates and the aux loss in float32, the output in
    bf16, each stage's values at BF16_TOL."""
    from repro.models.moe import moe_ffn

    cfg, params = _ref_moe(J, e=4, k=2, d=32, f=64, cf=0.5, act=act,
                           dtype="bfloat16")
    x = _x((2, 24, 32), 6)
    jx = J.jnp.asarray(x).astype(J.jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tp = {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in
          params.items()}
    want_y, want_aux = moe_ffn({n: J.jnp.asarray(v) for n, v in
                                params.items()}, cfg, jx)
    got_y, got_aux = tmoe.moe_ffn(tp, port_cfg(cfg), xb)
    assert got_y.dtype == torch.bfloat16 and str(want_y.dtype) == "bfloat16"
    assert got_aux.dtype == torch.float32
    assert str(want_aux.dtype) == "float32"
    close(got_y.float(), np.asarray(want_y.astype(J.jnp.float32)), BF16_TOL,
          "y")
    close(got_aux, np.asarray(want_aux), BF16_TOL, "aux")
    gates, vals, idx = tmoe.route(tp, port_cfg(cfg), xb)
    assert gates.dtype == vals.dtype == torch.float32
    assert idx.dtype == torch.int64
    jl = J.jnp.einsum("bsd,de->bse", jx,
                      J.jnp.asarray(params["router"]).astype(J.jnp.bfloat16))
    close(gates, np.asarray(J.jax.nn.softmax(jl.astype(J.jnp.float32), -1)),
          BF16_TOL, "gates")


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "dbrx-132b"])
def test_model_layers_and_aux_loss_match_reference(J, name):
    """The reduced model's layers in 'train' mode at cf 0.5 (with drops):
    x at 1e-4 and the aux loss (the mean over layers) at 1e-5 against the
    reference's `_run_layers_train`."""
    cfg, m, params = ref_model(J, name, capacity_factor=0.5)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    toks = tokens(cfg.vocab_size, 2, 24, seed=7)
    x, pos = m._embed_inputs(params, {"tokens": J.jnp.asarray(toks)})
    want_x, want_aux = m._run_layers_train(params, x, pos)
    tx, tpos = model._embed_inputs(torch.from_numpy(toks))
    got_x, got_aux = model.run_layers(tx, tpos)
    close(got_x, want_x, MODEL_TOL, "x")
    close(got_aux, want_aux, LAYER_TOL, "aux")
    assert float(got_aux) > 0.0


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "dbrx-132b"])
def test_model_with_drops_matches_reference(J, name):
    """At cf 0.5 the prefill and the full forward drop pairs past
    capacity (a row of 24 tokens sends 48 pairs to 4 experts of capacity
    8: at least 16 drop) and decode (one token a row) drops none, in both
    packages: prefill, decode and full-forward logits against the
    reference's at 1e-4."""
    cfg, m, params = ref_model(J, name, capacity_factor=0.5)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    b, s, max_len = 2, 24, 32
    toks = tokens(cfg.vocab_size, b, s, seed=8)
    jt, tt = J.jnp.asarray(toks), torch.from_numpy(toks)
    x, pos = m._embed_inputs(params, {"tokens": jt})
    want, _ = m._run_layers_train(params, x, pos)
    want = J.layers.lm_logits(params, J.layers.rmsnorm(
        want, params["final_norm"], cfg.norm_eps), cfg.tie_embeddings)
    close(model(tt), want, MODEL_TOL, "full forward")
    jl, jc = m.prefill(params, jt[:, :s - 2], m.init_caches(b, max_len))
    tl, tc = model.prefill(tt[:, :s - 2], model.init_caches(b, max_len))
    close(tl, jl, MODEL_TOL, "prefill")
    for i in range(s - 2, s):
        jl, jc = m.decode_step(params, jt[:, i:i + 1], J.jnp.int32(i), jc)
        tl, tc = model.decode_step(tt[:, i:i + 1], i, tc)
        close(tl, jl, MODEL_TOL, f"decode at {i}")


# -- dispatch ranks ------------------------------------------------------------

@pytest.mark.parametrize("m", [0, 1, 1023, 1025, 5000])
@pytest.mark.parametrize("nb", [2, 40, 160, 256, 300])
def test_bucket_ranks_equals_reference(J, nb, m):
    """M = 0, below, past and far from the reference's chunk of 1,024."""
    from repro.core.sort import bucket_ranks

    keys = np.random.default_rng(nb + m).integers(0, nb, m).astype(np.int32)
    want = np.asarray(bucket_ranks(J.jnp.asarray(keys), nb))
    got = tsort.bucket_ranks(torch.from_numpy(keys), nb)
    assert got.dtype == torch.int32 and got.shape == (m,)
    assert np.array_equal(got.numpy(), want)


def test_bucket_ranks_takes_the_rank_entry_up_to_256_buckets(monkeypatch):
    calls = []
    entry = ops.bucket_rank_hist
    monkeypatch.setattr(ops, "bucket_rank_hist",
                        lambda d: calls.append(d.dtype) or entry(d))
    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, 3000))
    tsort.bucket_ranks(keys, 256)
    assert calls == [torch.int32]
    tsort.bucket_ranks(keys, 257)
    assert calls == [torch.int32]


@pytest.mark.parametrize("b,e", [(4, 40), (4, 64), (5, 64)])
def test_dispatch_ranks_equal_the_per_row_ranks(J, monkeypatch, b, e):
    """Keys row·E + expert in one call over all rows, B·E buckets (the
    rank entry up to 256, the argsort path past it): the reference's
    vmapped per-row ranks either way."""
    from repro.core.sort import bucket_ranks

    idx = np.random.default_rng(e + b).integers(0, e, (b, 50, 8))
    want = np.stack([np.asarray(bucket_ranks(J.jnp.asarray(
        row.reshape(-1).astype(np.int32)), e)) for row in idx])
    seen = []
    monkeypatch.setattr(tmoe, "bucket_ranks",
                        lambda k, n: seen.append(n) or tsort.bucket_ranks(
                            k, n))
    got = tmoe.dispatch_ranks(torch.from_numpy(idx), e)
    assert np.array_equal(got.numpy(), want)
    assert seen == [b * e]


def test_moe_module_call_is_moe_ffn(J):
    """A model's MoE layer is an `MoE` module: its call is `moe_ffn` on
    its weights, and a forward hook sees the layer's input."""
    cfg, params = _ref_moe(J, e=4, k=2, cf=0.5)
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    layer = tmoe.MoE(tp)
    x = torch.from_numpy(_x((2, 12, 16), 8))
    seen = []
    hook = layer.register_forward_hook(
        lambda mod, args, out: seen.append(args[1]))
    y, aux = layer(port_cfg(cfg), x, with_aux=False)
    hook.remove()
    want, _ = tmoe.moe_ffn(tp, port_cfg(cfg), x, with_aux=False)
    assert aux is None and torch.equal(y, want)
    assert len(seen) == 1 and seen[0] is x
    assert sorted(dict(layer.named_parameters())) == sorted(tp)


def test_capacity_equals_reference(J):
    from repro.models.moe import _capacity

    for t, k, e, cf in [(2048, 8, 40, 1.25), (2048, 4, 16, 1.25),
                        (1, 8, 40, 1.25), (16, 1, 2, 0.26), (24, 2, 4, 8.0)]:
        assert tmoe.capacity(t, k, e, cf) == _capacity(t, k, e, cf)
    assert tmoe.capacity(2048, 8, 40, 1.25) == 516
    assert tmoe.capacity(2048, 4, 16, 1.25) == 644


# -- on the card (skip here) --------------------------------------------------

def _moe_layer(dev, cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = tmoe.init_moe(cfg, torch.float32, g, "cpu")
    return {n: v.to(dev) for n, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_cuda_moe_ffn_matches_cpu(cuda_device, cf):
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced(),
                              capacity_factor=cf)
    p = _moe_layer("cpu", cfg)
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, want_aux = tmoe.moe_ffn(p, cfg, x)
    ops.reset_launch_counts()
    got, aux = tmoe.moe_ffn({n: v.to(cuda_device) for n, v in p.items()},
                            cfg, x.to(cuda_device))
    assert ops.launch_counts()["radix_hist"] == 1
    torch.testing.assert_close(got.cpu(), want, atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=LAYER_TOL,
                               rtol=LAYER_TOL)


@pytest.mark.cuda
def test_cuda_moe_ffn_is_deterministic_in_bf16(cuda_device):
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"),
                              capacity_factor=1.25)
    g = torch.Generator(cuda_device).manual_seed(2)
    p = tmoe.init_moe(cfg, torch.bfloat16, g, cuda_device)
    x = torch.randn((4, 512, cfg.d_model), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    a, _ = tmoe.moe_ffn(p, cfg, x, with_aux=False)
    b, _ = tmoe.moe_ffn(p, cfg, x, with_aux=False)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,nb", [(65536, 160), (32, 160), (32768, 64)])
def test_cuda_rank_entry_at_the_moe_shapes(cuda_device, m, nb):
    keys = torch.from_numpy(np.random.default_rng(m).integers(
        0, nb, m).astype(np.int32)).to(cuda_device)
    got, _ = radix_hist.bucket_rank_hist_cuda(keys)
    want, _ = radix_hist.bucket_rank_hist_plain(keys)
    assert torch.equal(got, want)
    assert torch.equal(tsort.bucket_ranks(keys, nb), want)
