"""The port's MLA attention against the JAX package, on the CPU.

The reduced minicpm3-4b (4 heads, ranks 24 / 16, qk head dim 8 + 4, v 8)
in float32 with the reference's layer-0 weights: the latent projections,
prefill attention (through the port's flash path, v zero-padded to the
qk head dim) against the reference's and against the plain formula
`_mla_attend`, the latent cache and the absorbed-matrix decode. Inputs
are made with numpy from a seed. The `cuda` test skips here. Tolerance: atol = rtol = 1e-4
(`_torch_lm.MODEL_TOL`: float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from _torch_lm import (MODEL_TOL, close, port_cfg, ref_model,
                       reference_fixture)
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models.model import LM

torch.set_num_threads(1)

ARCH = "minicpm3-4b"


@pytest.fixture(scope="module")
def J():
    yield from reference_fixture()


@pytest.fixture(scope="module")
def layer0(J):
    """(reference config, port config, reference layer-0 attention params
    as jnp arrays, the same as torch tensors)."""
    cfg, _, params = ref_model(J, ARCH)
    ref = {k: v[0] for k, v in params["layers"]["attn"].items()}
    return (cfg, port_cfg(cfg), {k: J.jnp.asarray(v) for k, v in ref.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in ref.items()})


def _inputs(cfg, b, s, start=0, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                          (b, s)).copy()
    return x, pos


@pytest.mark.parametrize("start", [0, 100])
def test_mla_qkv_latent_matches_reference(J, layer0, start):
    cfg, tcfg, jp, tp = layer0
    x, pos = _inputs(cfg, 2, 24, start)
    got = tattn._mla_qkv_latent(tp, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    want = J.attention._mla_qkv_latent(jp, cfg, J.jnp.asarray(x),
                                       J.jnp.asarray(pos))
    for name, g, w in zip(("q_nope", "q_rope", "ckv", "k_rope"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        close(g, w, MODEL_TOL, name)


@pytest.mark.parametrize("s", [24, 40])
def test_mla_attention_matches_reference(J, layer0, s):
    cfg, tcfg, jp, tp = layer0
    x, pos = _inputs(cfg, 2, s, seed=1)
    got = tattn.mla_attention(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    want = J.attention.mla_attention(jp, cfg, J.jnp.asarray(x),
                                     J.jnp.asarray(pos))
    close(got, want, MODEL_TOL)


def test_mla_attention_matches_its_plain_formula(layer0):
    """The flash path (v padded, output cut) against `_mla_attend`, the
    reference's plain formula on the unpadded v."""
    _, tcfg, _, tp = layer0
    x, pos = _inputs(tcfg, 2, 33, seed=2)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    q, k, v = tattn._mla_qkv(tp, tcfg, x, pos)
    scale = (tcfg.qk_nope_head_dim + tcfg.qk_rope_head_dim) ** -0.5
    out = tattn._mla_attend(q, k, v, scale, pos, pos, True, x.dtype)
    want = torch.einsum("bshe,hed->bsd", out, tp["wo"])
    close(tattn.mla_attention(tp, tcfg, x, pos), want.numpy(), MODEL_TOL)


def test_mla_attention_pads_v_to_the_qk_head_dim(layer0, monkeypatch):
    """The kernel's arguments on the CPU are the card's: one head dim
    (8 + 4 = 12) for q, k and v, v's columns past 8 zero."""
    _, tcfg, _, tp = layer0
    seen = []
    flash = ops.flash_attention

    def catch(q, k, v, **kw):
        seen.append((q, k, v))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", catch)
    x, pos = _inputs(tcfg, 2, 16, seed=3)
    tattn.mla_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    (q, k, v), = seen
    e = tcfg.qk_nope_head_dim + tcfg.qk_rope_head_dim
    assert q.shape[-1] == k.shape[-1] == v.shape[-1] == e
    assert q.shape[2] == k.shape[2] == v.shape[2] == tcfg.n_heads
    assert torch.count_nonzero(v[..., tcfg.v_head_dim:]) == 0
    assert torch.count_nonzero(v[..., :tcfg.v_head_dim]) > 0


def test_mla_cache_and_decode_match_reference(J, layer0):
    """Prefill 20 tokens into the latent cache, then decode 8 more: every
    step's output, and the cache after."""
    cfg, tcfg, jp, tp = layer0
    b, s0, steps, max_len = 2, 20, 8, 32
    x, _ = _inputs(cfg, b, s0 + steps, seed=4)
    pos = np.broadcast_to(np.arange(s0, dtype=np.int32), (b, s0)).copy()
    jc = J.attention.init_mla_cache(cfg, b, max_len, J.jnp.float32)
    tc = tattn.init_mla_cache(tcfg, b, max_len, torch.float32)
    jc = J.attention.mla_fill_cache(jp, cfg, J.jnp.asarray(x[:, :s0]),
                                    J.jnp.asarray(pos), jc)
    assert tattn.mla_fill_cache(tp, tcfg, torch.from_numpy(x[:, :s0]),
                                torch.from_numpy(pos), tc) is tc
    close(tc["ckv"], jc["ckv"], MODEL_TOL, "ckv after prefill")
    for i in range(s0, s0 + steps):
        want, jc = J.attention.mla_decode(jp, cfg,
                                          J.jnp.asarray(x[:, i:i + 1]),
                                          J.jnp.int32(i), jc)
        got, tc = tattn.mla_decode(tp, tcfg, torch.from_numpy(x[:, i:i + 1]),
                                   i, tc)
        close(got, want, MODEL_TOL, f"step {i}")
    close(tc["ckv"], jc["ckv"], MODEL_TOL, "ckv")
    close(tc["krope"], jc["krope"], MODEL_TOL, "krope")
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_mla_decode_equals_attention_over_the_prefix(layer0):
    """Decode at position i against a cache of 0..i-1 gives the full
    attention's row i (the absorbed matrices are the expansion's
    algebra)."""
    _, tcfg, _, tp = layer0
    b, s = 2, 12
    x, pos = _inputs(tcfg, b, s, seed=5)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    full = tattn.mla_attention(tp, tcfg, x, pos)
    cache = tattn.mla_fill_cache(tp, tcfg, x[:, :s - 1], pos[:, :s - 1],
                                 tattn.init_mla_cache(tcfg, b, s,
                                                      torch.float32))
    got, _ = tattn.mla_decode(tp, tcfg, x[:, s - 1:], s - 1, cache)
    close(got[:, 0], full[:, -1].numpy(), MODEL_TOL)


def test_mla_decode_past_the_cache_end_raises(layer0):
    """A cache of max_len 8: position 7 fills the last slot; at 8 there is
    none, and the port raises where the reference clamps the write onto
    slot 7."""
    _, tcfg, _, tp = layer0
    x, pos = _inputs(tcfg, 2, 9, seed=6)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    cache = tattn.mla_fill_cache(tp, tcfg, x[:, :7], pos[:, :7],
                                 tattn.init_mla_cache(tcfg, 2, 8,
                                                      torch.float32))
    y, cache = tattn.mla_decode(tp, tcfg, x[:, 7:8], 7, cache)
    assert bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match=r"position 8 .*max_len 8"):
        tattn.mla_decode(tp, tcfg, x[:, 8:9], 8, cache)
    with pytest.raises(ValueError, match="position -1"):
        tattn.mla_decode(tp, tcfg, x[:, 8:9], -1, cache)


@pytest.mark.cuda
def test_cuda_mla_at_a_head_dim_without_a_kernel_raises():
    """The reduced MLA's qk head dim 8 + 4 = 12 is no head dim of the CUDA
    kernels: a prefill on the card raises, with no plain fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    cfg = tconfigs.get_arch(ARCH).reduced()
    assert cfg.qk_nope_head_dim + cfg.qk_rope_head_dim not in fa.HEAD_DIMS
    model = LM(cfg, generator=torch.Generator("cuda").manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim 12"):
        model.prefill(toks, model.init_caches(1, 16))
