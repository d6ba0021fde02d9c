"""The port's LM serving path against the JAX package, on the CPU.

Configs, layer functions, GQA attention (against the reference's jnp path
and its Pallas kernel in interpret mode), the KV cache, and whole reduced
models (phi3-mini-3.8b: SwiGLU, MHA; starcoder2-15b: GELU, GQA reduced to
MQA) with the reference's weights carried across by `models/convert.py`;
the carry-across, the port's own init and the full-size shapes of every
family served (MLA, SSM and hybrid included; their layers and models are
held in `test_torch_{mla,ssm,families}.py`; MoE's and the encoder's in
`test_torch_{moe,encoder}.py`). Inputs are made with numpy
from a seed and go through both packages; tolerances are `_torch_lm`'s.
The `cuda` tests hold the model on the card against the CPU and skip here.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm import (LAYER_TOL, MODEL_TOL, SERVE_TOL, reference_lm)
from _torch_lm import close as _close
from _torch_lm import port_cfg as _port_cfg
from _torch_lm import ref_full_logits as _ref_full_logits
from _torch_lm import ref_model as _ref_model
from _torch_lm import step_logits as _step_logits
from _torch_lm import tokens as _tokens
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.model import LM
from repro_torch.serve import serve_step as tserve

torch.set_num_threads(1)

SERVED = ["phi3-mini-3.8b", "starcoder2-15b"]
# the families of MLA, the SSM and the hybrid block
NEW_FAMILIES = ["minicpm3-4b", "mamba2-370m", "hymba-1.5b"]
# MoE and the encoder with its audio frontend
MOE_AND_ENCODER = ["granite-moe-3b-a800m", "dbrx-132b", "hubert-xlarge"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's LM stack (skips where JAX is absent)."""
    return reference_lm()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_config_equals_reference(J, name):
    ref = J.configs.ARCHS[name]
    port = tconfigs.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert port.n_params() == ref.n_params()
    for shape in J.configs.SHAPES:
        assert (tconfigs.cell_skip_reason(port, tconfigs.SHAPES[shape])
                == J.configs.cell_skip_reason(ref, J.configs.SHAPES[shape]))


# -- layer functions -----------------------------------------------------------

def test_rmsnorm_matches_reference(J):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           J.layers.rmsnorm(J.jnp.asarray(x), J.jnp.asarray(scale), 1e-5),
           LAYER_TOL)


def test_rope_matches_reference(J):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 107, dtype=np.int32), (2, 7))
    _close(tlayers.rope_frequencies(16, 10_000.0),
           J.layers.rope_frequencies(16, 10_000.0), LAYER_TOL)
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(
        pos.copy()), 10_000.0),
           J.layers.apply_rope(J.jnp.asarray(x), J.jnp.asarray(pos),
                               10_000.0), LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(J, act):
    rng = np.random.default_rng(2)
    p = {"wi": rng.standard_normal((32, 48)) * 32 ** -0.5,
         "wo": rng.standard_normal((48, 32)) * 48 ** -0.5}
    if act == "swiglu":
        p["wg"] = rng.standard_normal((32, 48)) * 32 ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act)
    want = J.layers.mlp({k: J.jnp.asarray(v) for k, v in p.items()},
                        J.jnp.asarray(x), act)
    _close(got, want, LAYER_TOL)


def test_gelu_is_the_tanh_approximation(J):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    _close(got, J.jax.nn.gelu(J.jnp.asarray(x)), LAYER_TOL)


def test_embed_and_logits_match_reference(J):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((97, 32)).astype(np.float32)
    toks = _tokens(97, 2, 6)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    _close(tlayers.embed_tokens(torch.from_numpy(table),
                                torch.from_numpy(toks), torch.float32),
           J.layers.embed_tokens({"embedding": J.jnp.asarray(table)},
                                 J.jnp.asarray(toks), J.jnp.float32), 0.0)
    _close(tlayers.lm_logits(torch.from_numpy(table), torch.from_numpy(x)),
           J.layers.lm_logits({"embedding": J.jnp.asarray(table)},
                              J.jnp.asarray(x), True), LAYER_TOL)


# -- GQA attention -----------------------------------------------------------

def _layer0(J, name, **changes):
    cfg, _, params = _ref_model(J, name, **changes)
    ref_attn = J.jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    port_attn = {k: torch.from_numpy(np.array(v)) for k, v in
                 ref_attn.items()}
    return cfg, ref_attn, port_attn


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", SERVED)
def test_gqa_attention_matches_reference(J, name, use_flash, window):
    """Against the reference's jnp path (use_flash=False; with a window at
    S = 128 that is its banded path) and its Pallas kernel (interpret)."""
    cfg, ref_attn, port_attn = _layer0(J, name)
    b, s = 2, 128
    x = np.random.default_rng(4).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    got = tattn.gqa_attention(port_attn, _port_cfg(cfg), torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), window=window)
    want = J.attention.gqa_attention(
        {k: J.jnp.asarray(v) for k, v in ref_attn.items()}, cfg,
        J.jnp.asarray(x), J.jnp.asarray(pos), window=window,
        use_flash=use_flash)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("window", [None, 16])
def test_gqa_cache_and_decode_match_reference(J, window):
    """Prefill 20 tokens into the cache, then decode 24 more (past the
    ring of 16 slots when windowed): every step's output and the cache."""
    cfg, ref_attn, port_attn = _layer0(J, "starcoder2-15b")
    tcfg = _port_cfg(cfg)
    jp = {k: J.jnp.asarray(v) for k, v in ref_attn.items()}
    b, s0, steps, max_len = 2, 20, 24, 64
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s0 + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s0, dtype=np.int32), (b, s0))
    jc = J.attention.init_gqa_cache(cfg, b, max_len, window, J.jnp.float32)
    tc = tattn.init_gqa_cache(tcfg, b, max_len, window, torch.float32)
    jc = J.attention.gqa_fill_cache(jp, cfg, J.jnp.asarray(x[:, :s0]),
                                    J.jnp.asarray(pos), jc, window)
    tc = tattn.gqa_fill_cache(port_attn, tcfg, torch.from_numpy(x[:, :s0]),
                              torch.from_numpy(pos.copy()), tc, window)
    for i in range(s0, s0 + steps):
        want, jc = J.attention.gqa_decode(jp, cfg, J.jnp.asarray(x[:, i:i + 1]),
                                          J.jnp.int32(i), jc, window)
        got, tc = tattn.gqa_decode(port_attn, tcfg,
                                   torch.from_numpy(x[:, i:i + 1]), i, tc,
                                   window)
        _close(got, want, MODEL_TOL, f"step {i}")
    _close(tc["k"], jc["k"], MODEL_TOL)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# -- whole models with the reference's weights -------------------------------

@pytest.mark.parametrize("name", SERVED)
def test_model_prefill_decode_and_forward_match_reference(J, name):
    cfg, m, params = _ref_model(J, name)
    model = convert.from_reference(_port_cfg(cfg), params)
    b, s, max_len = 2, 24, 64
    toks = _tokens(cfg.vocab_size, b, s)
    jt, tt = J.jnp.asarray(toks), torch.from_numpy(toks)
    _close(model(tt), _ref_full_logits(J, m, params, jt), MODEL_TOL,
           "full forward")
    jl, jc = m.prefill(params, jt[:, :s - 3], m.init_caches(b, max_len))
    tl, tc = model.prefill(tt[:, :s - 3], model.init_caches(b, max_len))
    _close(tl, jl, MODEL_TOL, "prefill")
    for i in range(s - 3, s):
        jl, jc = m.decode_step(params, jt[:, i:i + 1], J.jnp.int32(i), jc)
        tl, tc = model.decode_step(tt[:, i:i + 1], i, tc)
        _close(tl, jl, MODEL_TOL, f"decode at {i}")


@pytest.mark.parametrize("name", SERVED)
def test_generate_tokens_equal_reference(J, name):
    cfg, m, params = _ref_model(J, name, seed=3)
    model = convert.from_reference(_port_cfg(cfg), params)
    prompt = _tokens(cfg.vocab_size, 2, 8, seed=6)
    want = J.serve_step.generate(m, params, J.jnp.asarray(prompt), max_new=6,
                                 max_len=32)
    got = tserve.generate(model, torch.from_numpy(prompt), max_new=6,
                          max_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    steps, logits = _step_logits(model, torch.from_numpy(prompt), 6, 32)
    assert logits.shape == (2, 6, cfg.vocab_size)
    assert torch.equal(steps, got)
    assert torch.equal(logits.argmax(-1).to(torch.int32), got)


@pytest.mark.parametrize("name", SERVED)
def test_prefill_plus_decode_equals_full_forward(J, name):
    """The serving contract of tests/test_serve.py, on the port alone."""
    cfg, _, params = _ref_model(J, name)
    model = convert.from_reference(_port_cfg(cfg), params)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 24))
    want = model(toks)[:, -1, :]
    _, caches = model.prefill(toks[:, :21], model.init_caches(2, 64))
    for i in range(21, 24):
        got, caches = model.decode_step(toks[:, i:i + 1], i, caches)
    assert float((got - want).abs().max()) < SERVE_TOL


def test_decode_past_the_cache_end_raises():
    """The reduced phi3 with a cache of max_len 8: decode at position 7
    fills the last slot; at position 8 there is none, and the port raises
    where the reference clamps the write onto slot 7."""
    cfg = dataclasses.replace(tconfigs.get_arch("phi3-mini-3.8b").reduced(),
                              dtype="float32")
    model = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 9))
    _, caches = model.prefill(toks[:, :7], model.init_caches(2, 8))
    logits, caches = model.decode_step(toks[:, 7:8], 7, caches)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match=r"position 8 .*max_len 8"):
        model.decode_step(toks[:, 8:9], 8, caches)


# -- the carry-across and the port's own init --------------------------------

def test_convert_unstacks_scan_and_takes_unroll_lists(J):
    cfg, _, params = _ref_model(J, "phi3-mini-3.8b")
    sd = convert.reference_state_dict(_port_cfg(cfg), params)
    assert torch.equal(sd["layers.1.attn.wq"],
                       torch.from_numpy(params["layers"]["attn"]["wq"][1]))
    ucfg, _, uparams = _ref_model(J, "phi3-mini-3.8b", layout="unroll")
    assert isinstance(uparams["layers"], list)
    usd = convert.reference_state_dict(_port_cfg(ucfg), uparams)
    assert sorted(usd) == sorted(sd)
    assert torch.equal(usd["layers.1.mlp.wo"],
                       torch.from_numpy(uparams["layers"][1]["mlp"]["wo"]))


def test_convert_stores_matmuls_in_the_activation_dtype(J):
    cfg, _, params = _ref_model(J, "phi3-mini-3.8b", dtype="bfloat16")
    sd = convert.reference_state_dict(_port_cfg(cfg), params)
    for name, t in sd.items():
        want = torch.float32 if name.endswith("norm") else torch.bfloat16
        assert t.dtype == want, name
    model = convert.from_reference(_port_cfg(cfg), params)
    assert model.layers[0].attn["wq"].dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32


def test_convert_refuses_fused_weights(J):
    cfg, _, params = _ref_model(J, "phi3-mini-3.8b")
    for where, key in (("attn", "wqkv"), ("mlp", "wig")):
        bad = dict(params)
        bad["layers"] = {**params["layers"], where: {
            **params["layers"][where], key: params["layers"][where][
                "wq" if where == "attn" else "wi"]}}
        with pytest.raises(ValueError):
            convert.reference_state_dict(_port_cfg(cfg), bad)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "starcoder2-15b",
                                  "internlm2-20b", "chameleon-34b"]
                         + NEW_FAMILIES + MOE_AND_ENCODER)
def test_full_size_shapes_equal_reference(J, name):
    """At the published widths (on the meta device: nothing allocated),
    every parameter of the port has the shape of the reference's."""
    cfg = J.configs.ARCHS[name]
    shapes = J.jax.eval_shape(lambda r: J.model.LM(cfg).init(r)[0],
                              J.jax.random.PRNGKey(0))
    flat = {}
    for key, leaf in J.jax.tree_util.tree_leaves_with_path(shapes):
        # a dict key's .key, an unroll layout's list index .idx
        names = [str(getattr(k, "key", getattr(k, "idx", None)))
                 for k in key]
        if names[0] == "layers" and cfg.layout == "unroll":
            flat[".".join(names)] = tuple(leaf.shape)
        elif names[0] == "layers":
            for i in range(cfg.n_layers):
                flat[".".join(["layers", str(i)] + names[1:])] = \
                    tuple(leaf.shape[1:])
        else:
            flat[".".join(names)] = tuple(leaf.shape)
    model = LM(tconfigs.get_arch(name), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == flat


def test_own_init_draws_the_reference_distributions(J):
    """Each drawn leaf's std is the reference's (to 5 %, from a few
    thousand draws); the constant leaves are the reference's values; two
    draws from one seed are equal. A_log is log(linspace(1, e, H)) rounded
    once to float32, which the reference's float32 steps (its linspace and
    log) reach within an ulp: held to 1.2e-7 against them."""
    cfg = dataclasses.replace(tconfigs.get_arch("phi3-mini-3.8b").reduced(),
                              d_model=256, d_ff=512)
    a = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    b = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    stds = {"embedding": 0.02, "lm_head": 256 ** -0.5,
            "layers.0.attn.wq": 256 ** -0.5, "layers.0.attn.wo": 64 ** -0.5,
            "layers.0.mlp.wi": 256 ** -0.5, "layers.0.mlp.wo": 512 ** -0.5}
    sd = a.state_dict()
    for name, std in stds.items():
        assert abs(float(sd[name].std()) / std - 1) < 0.05, name
    assert torch.equal(sd["layers.0.attn_norm"], torch.ones(256))

    # MLA: minicpm3 at d_model 256, ranks 64 / 32, 4 heads of 16 + 8 (v 16)
    mcfg = dataclasses.replace(tconfigs.get_arch("minicpm3-4b").reduced(),
                               d_model=256, q_lora_rank=64, kv_lora_rank=32,
                               qk_nope_head_dim=16, qk_rope_head_dim=8,
                               v_head_dim=16)
    sd = LM(mcfg, generator=torch.Generator().manual_seed(1),
            device="cpu").state_dict()
    for name, std in {"layers.0.attn.q_a": 256 ** -0.5,
                      "layers.0.attn.q_b": 64 ** -0.5,
                      "layers.0.attn.kv_a": 256 ** -0.5,
                      "layers.0.attn.kv_b": 32 ** -0.5,
                      "layers.0.attn.wo": (4 * 16) ** -0.5}.items():
        assert abs(float(sd[name].std()) / std - 1) < 0.05, name
    for name, dim in (("q_a_norm", 64), ("kv_a_norm", 32)):
        assert torch.equal(sd[f"layers.1.attn.{name}"], torch.ones(dim))

    # SSM: hymba at d_model 256 (d_inner 512, 32 heads of 16, state 8)
    hcfg = dataclasses.replace(tconfigs.get_arch("hymba-1.5b").reduced(),
                               d_model=256, d_ff=512)
    sd = LM(hcfg, generator=torch.Generator().manual_seed(2),
            device="cpu").state_dict()
    di, h = hcfg.d_inner, hcfg.ssm_nheads
    conv_dim = di + 2 * hcfg.ssm_ngroups * hcfg.ssm_state
    for name, std in {"layers.0.ssm.in_proj": 256 ** -0.5,
                      "layers.0.ssm.conv_w": 0.1,
                      "layers.0.ssm.out_proj": di ** -0.5}.items():
        assert abs(float(sd[name].std()) / std - 1) < 0.05, name
    ref = J.jax.tree.map(np.asarray, J.model.LM(hcfg).init(
        J.jax.random.PRNGKey(0))[0])["layers"][1]["ssm"]
    for name in ("conv_b", "D", "dt_bias", "norm"):
        assert torch.equal(sd[f"layers.1.ssm.{name}"],
                           torch.from_numpy(np.array(ref[name]))), name
    a_log = sd["layers.1.ssm.A_log"]
    assert torch.equal(a_log, torch.from_numpy(tssm.a_log_init(h)))
    np.testing.assert_allclose(a_log.numpy(), ref["A_log"], rtol=0,
                               atol=1.2e-7)
    assert torch.equal(sd["layers.1.ssm_norm"], torch.ones(256))
    assert sd["layers.1.ssm.conv_b"].shape == (conv_dim,)

    # MoE: granite at d_model 256, 16 experts of d_ff 512
    ecfg = dataclasses.replace(
        tconfigs.get_arch("granite-moe-3b-a800m").reduced(), d_model=256,
        d_ff=512, n_experts=16)
    sd = LM(ecfg, generator=torch.Generator().manual_seed(3),
            device="cpu").state_dict()
    for name, std in {"layers.0.mlp.router": 256 ** -0.5,
                      "layers.0.mlp.wi": 256 ** -0.5,
                      "layers.0.mlp.wg": 256 ** -0.5,
                      "layers.1.mlp.wo": 512 ** -0.5}.items():
        assert abs(float(sd[name].std()) / std - 1) < 0.05, name
    assert sd["layers.0.mlp.wi"].shape == (16, 256, 512)
    assert sd["layers.0.mlp.wo"].shape == (16, 512, 256)

    # the audio frontend: hubert's projection of 512 features
    acfg = dataclasses.replace(tconfigs.get_arch("hubert-xlarge").reduced(),
                               feat_dim=512)
    sd = LM(acfg, generator=torch.Generator().manual_seed(4),
            device="cpu").state_dict()
    assert sd["frontend.proj"].shape == (512, acfg.d_model)
    assert abs(float(sd["frontend.proj"].std()) / 512 ** -0.5 - 1) < 0.05


def test_lm_needs_a_generator_or_a_device():
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    with pytest.raises(ValueError, match="generator"):
        LM(cfg)


def test_lm_lives_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    cfg = tconfigs.get_arch("phi3-mini-3.8b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg, generator=torch.Generator().manual_seed(0))
    model = LM(cfg, generator=torch.Generator().manual_seed(0),
               device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


# -- the entry point -----------------------------------------------------------

def test_launch_serve_runs_reduced_on_the_cpu(capsys):
    out = tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "12",
                        "--max-new", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert "generated 10 tokens" in capsys.readouterr().out


def test_launch_serve_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced"])


# -- on the card (skip here) ---------------------------------------------------

def _cuda_reduced(name):
    """The reduced config of `name` for the card: MLA's qk head dim is
    8 + 4 = 12 there, which no CUDA flash kernel takes, so its card twin
    has 12 + 4 = 16 (v 8)."""
    cfg = tconfigs.get_arch(name).reduced()
    if cfg.attn_type == "mla":
        cfg = dataclasses.replace(cfg, qk_nope_head_dim=12,
                                  qk_rope_head_dim=4, v_head_dim=8)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVED + NEW_FAMILIES + MOE_AND_ENCODER)
def test_cuda_model_matches_cpu(cuda_device, name):
    """generate and its steps' logits (an encode for the encoder), card
    against CPU; a prefill and each decode step make one rank launch per
    MoE layer."""
    cfg = _cuda_reduced(name)
    cpu_model = LM(cfg, generator=torch.Generator().manual_seed(7),
                   device="cpu")
    gpu_model = LM(cfg, device=cuda_device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    if cfg.is_encoder:
        feats = torch.randn((2, 150, cfg.feat_dim),
                            generator=torch.Generator().manual_seed(8))
        ops.reset_launch_counts()
        got = gpu_model.encode(feats.to(cuda_device))
        counts = ops.launch_counts()
        assert counts["flash_attention"] == sum(counts.values()) == \
            cfg.n_layers
        torch.testing.assert_close(got.cpu(), cpu_model.encode(feats),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        return
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 150))
    ops.reset_launch_counts()
    got = tserve.generate(gpu_model, toks, 4, 160)
    assert ops.launch_counts()["flash_attention"] == (
        cfg.n_layers if cfg.has_attention else 0)
    assert ops.launch_counts()["radix_hist"] == (
        4 * cfg.n_layers if cfg.is_moe else 0)
    assert torch.equal(got.cpu(), tserve.generate(cpu_model, toks, 4, 160))
    want = _step_logits(cpu_model, toks, 4, 160)
    got = _step_logits(gpu_model, toks.to(cuda_device), 4, 160)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    torch.testing.assert_close(gpu_model(toks.to(cuda_device)).cpu(),
                               cpu_model(toks), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


@pytest.mark.cuda
def test_cuda_generate_is_deterministic_in_bf16(cuda_device):
    cfg = dataclasses.replace(tconfigs.get_arch("phi3-mini-3.8b").reduced(),
                              dtype="bfloat16")
    model = LM(cfg, generator=torch.Generator(cuda_device).manual_seed(8))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 3, 100)).to(cuda_device)
    assert torch.equal(tserve.generate(model, toks, 8, 120),
                       tserve.generate(model, toks, 8, 120))
    a = _step_logits(model, toks, 8, 120)
    b = _step_logits(model, toks, 8, 120)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
