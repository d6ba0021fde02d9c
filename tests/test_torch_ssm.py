"""The port's Mamba2/SSD layer and hymba's hybrid block against the JAX
package, on the CPU.

The causal conv (with and without a carry), the chunked SSD at S a
multiple of the chunk and not, `ssm_forward` with its state, `ssm_decode`
continuing a prefill's state (reduced mamba2-370m: d_inner 128, 8 heads
of 16, state 8, chunk 16), and hymba's hybrid block (reduced hymba-1.5b:
GQA 4/1 with a window of 16 on layer 1, the SSM in parallel) in its
train, prefill and decode modes, with the reference's weights. Inputs
are made with numpy from a seed.

Tolerances (`_torch_lm`): the layer functions at 1e-5 (float32, sums of
up to 16 products in another order), the SSM layer and the block at 1e-4
(float32 through in_proj, the SSD and out_proj: sums of 64-128 products
in another order). In bfloat16 the outputs' dtypes are held to the
reference's, and the values to 3e-2 (bf16 ulps of values up to ~4: the
two packages round the same steps, but the reference's XLA CPU build
may keep excess precision inside a fused bf16 expression).
"""
import numpy as np
import pytest
import torch

from _torch_lm import (LAYER_TOL, MODEL_TOL, close, port_cfg, ref_model,
                       reference_fixture)
from repro_torch.models import convert
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

BF16_TOL = 3e-2


@pytest.fixture(scope="module")
def J():
    yield from reference_fixture()


@pytest.fixture(scope="module")
def mamba(J):
    """(reference config, port config, layer-0 SSM params as jnp arrays,
    the same as torch tensors)."""
    cfg, _, params = ref_model(J, "mamba2-370m")
    ref = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    return (cfg, port_cfg(cfg), {k: J.jnp.asarray(v) for k, v in ref.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in ref.items()})


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("name", ["mamba2-370m", "hymba-1.5b"])
def test_dims_match_reference(J, name):
    for cfg in (J.configs.ARCHS[name], J.configs.ARCHS[name].reduced()):
        assert tssm._dims(port_cfg(cfg)) == J.ssm._dims(cfg)


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(J, carry):
    rng = _rng(0)
    xbc = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 24))).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    c = rng.standard_normal((2, 3, 24)).astype(np.float32) if carry else None
    got, got_c = tssm._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(bias),
        None if c is None else torch.from_numpy(c))
    want, want_c = J.ssm._causal_conv(
        J.jnp.asarray(xbc), J.jnp.asarray(w), J.jnp.asarray(bias),
        None if c is None else J.jnp.asarray(c))
    close(got, want, LAYER_TOL, "out")
    close(got_c, want_c, LAYER_TOL, "carry")


def _ssd_inputs(s, h=4, p=8, g=2, n=8, seed=1):
    rng = _rng(seed)
    xh = rng.standard_normal((2, s, h, p)).astype(np.float32)
    bm = rng.standard_normal((2, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((2, s, g, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, s, h)) - 2)).astype(
        np.float32)
    a = -np.exp(rng.uniform(0, 1, h)).astype(np.float32)
    return xh, bm, cm, dt, a


@pytest.mark.parametrize("s", [32, 21])
def test_ssd_chunked_matches_reference(J, s):
    """S = 32: two chunks of 16; S = 21: padded to 32 with dt = 0 steps,
    which leave the final state as it is."""
    args = _ssd_inputs(s)
    y, state = tssm._ssd_chunked(*(torch.from_numpy(x) for x in args), 16)
    wy, wstate = J.ssm._ssd_chunked(*(J.jnp.asarray(x) for x in args), 16)
    assert tuple(y.shape) == (2, s, 4, 8)
    close(y, wy, LAYER_TOL, "y")
    close(state, wstate, LAYER_TOL, "final state")


def test_ssd_chunks_equal_one_chunk(J):
    """The chunked recurrence is the SSD's algebra: chunks of 8 give the
    output of one chunk of 32 (the port alone)."""
    args = [torch.from_numpy(x) for x in _ssd_inputs(32, seed=2)]
    y8, s8 = tssm._ssd_chunked(*args, 8)
    y32, s32 = tssm._ssd_chunked(*args, 32)
    close(y8, y32.numpy(), LAYER_TOL)
    close(s8, s32.numpy(), LAYER_TOL)


@pytest.mark.parametrize("s", [32, 21])
def test_ssm_forward_with_state_matches_reference(J, mamba, s):
    cfg, tcfg, jp, tp = mamba
    x = _rng(3).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    got, st = tssm.ssm_forward(tp, tcfg, torch.from_numpy(x),
                               return_state=True)
    want, wst = J.ssm.ssm_forward(jp, cfg, J.jnp.asarray(x),
                                  return_state=True)
    close(got, want, MODEL_TOL, "out")
    close(st["state"], wst["state"], MODEL_TOL, "state")
    close(st["conv"], wst["conv"], MODEL_TOL, "conv")
    close(tssm.ssm_forward(tp, tcfg, torch.from_numpy(x)), want, MODEL_TOL)


def test_ssm_decode_continues_a_prefill(J, mamba):
    """Prefill 20 tokens, then 6 decode steps from its state: each step
    against the reference's, and all of them against the full forward
    over the 26 tokens."""
    cfg, tcfg, jp, tp = mamba
    b, s0, steps = 2, 20, 6
    x = _rng(4).standard_normal((b, s0 + steps, cfg.d_model)).astype(
        np.float32)
    _, new = tssm.ssm_forward(tp, tcfg, torch.from_numpy(x[:, :s0]),
                              return_state=True)
    cache = tssm.ssm_fill_cache(tssm.init_ssm_cache(tcfg, b, torch.float32),
                                new)
    _, jc = J.ssm.ssm_forward(jp, cfg, J.jnp.asarray(x[:, :s0]),
                              return_state=True)
    outs = []
    for i in range(s0, s0 + steps):
        want, jc = J.ssm.ssm_decode(jp, cfg, J.jnp.asarray(x[:, i:i + 1]),
                                    jc)
        got, cache = tssm.ssm_decode(tp, tcfg, torch.from_numpy(
            x[:, i:i + 1]), cache)
        close(got, want, MODEL_TOL, f"step {i}")
        outs.append(got)
    close(cache["state"], jc["state"], MODEL_TOL, "state")
    close(cache["conv"], jc["conv"], MODEL_TOL, "conv")
    full = tssm.ssm_forward(tp, tcfg, torch.from_numpy(x))
    close(torch.cat(outs, dim=1), full[:, s0:].numpy(), MODEL_TOL,
          "decode vs the full forward")


def test_ssm_keeps_the_reference_dtypes_in_bf16(J, mamba):
    """bfloat16 activations with the reference's weights carried across
    (A_log, dt_bias and the norm in float32): output, state and conv
    window in bf16 as the reference's, values at BF16_TOL."""
    cfg, tcfg, jp, _ = mamba
    tp = {k: torch.from_numpy(np.array(v)).to(
        convert.leaf_dtype(k, torch.bfloat16)) for k, v in jp.items()}
    assert tp["A_log"].dtype == tp["dt_bias"].dtype == torch.float32
    x = _rng(5).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got, st = tssm.ssm_forward(tp, tcfg, xb, return_state=True)
    jx = J.jnp.asarray(x).astype(J.jnp.bfloat16)
    want, wst = J.ssm.ssm_forward(jp, cfg, jx, return_state=True)
    for name, g, w in (("out", got, want), ("state", st["state"],
                                            wst["state"]),
                       ("conv", st["conv"], wst["conv"])):
        assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16", name
        close(g.float(), np.asarray(w.astype(J.jnp.float32)), BF16_TOL, name)
    dec, _ = tssm.ssm_decode(tp, tcfg, xb[:, :1], st)
    assert dec.dtype == torch.bfloat16


# -- hymba's hybrid block -----------------------------------------------------

@pytest.fixture(scope="module")
def hymba(J):
    """(reference config, port config, reference params, port model)."""
    cfg, _, params = ref_model(J, "hymba-1.5b", seed=2)
    tcfg = port_cfg(cfg)
    return cfg, tcfg, params, convert.from_reference(tcfg, params)


def _jtree(J, tree):
    return J.jax.tree.map(J.jnp.asarray, tree)


@pytest.mark.parametrize("s", [32, 21])
@pytest.mark.parametrize("layer", [0, 1])
def test_hybrid_block_train_matches_reference(J, hymba, layer, s):
    """Layer 0 is global, layer 1 windowed (16): at S = 32 the reference
    runs its banded path there (S % 16 == 0, S >= 32), at S = 21 its
    masked softmax; the port's flash computes both."""
    cfg, tcfg, params, model = hymba
    window = J.model._layer_window(cfg, layer)
    assert window == (None if layer == 0 else 16)
    x = _rng(6).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, _, _ = J.model._block(cfg, _jtree(J, params["layers"][layer]),
                                J.jnp.asarray(x), J.jnp.asarray(pos),
                                window=window, mode="train")
    got, _, _ = model.layers[layer].run(tcfg, torch.from_numpy(x),
                                        torch.from_numpy(pos),
                                        model.windows[layer], "train")
    close(got, want, MODEL_TOL)


def test_hybrid_block_prefill_and_decode_match_reference(J, hymba):
    """Layer 1 (window 16): prefill 20 tokens, then decode 24 more, past
    the ring of 16 slots; every step's output and both caches after."""
    cfg, tcfg, params, model = hymba
    b, s0, steps, max_len = 2, 20, 24, 64
    x = _rng(7).standard_normal((b, s0 + steps, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(s0, dtype=np.int32), (b, s0)).copy()
    p1 = _jtree(J, params["layers"][1])
    jc = J.model.LM(cfg).init_caches(b, max_len)[1]
    tc = model.init_caches(b, max_len)[1]
    assert tuple(tc["attn"]["k"].shape) == (b, 16, 1, 16)   # the ring
    want, jc, _ = J.model._block(cfg, p1, J.jnp.asarray(x[:, :s0]),
                                 J.jnp.asarray(pos), window=16,
                                 mode="prefill", cache=jc)
    got, tc, _ = model.layers[1].run(tcfg, torch.from_numpy(x[:, :s0]),
                                     torch.from_numpy(pos), 16, "prefill",
                                     tc)
    close(got, want, MODEL_TOL, "prefill")
    for i in range(s0, s0 + steps):
        xi = x[:, i:i + 1]
        want, jc, _ = J.model._block(
            cfg, p1, J.jnp.asarray(xi),
            J.jnp.full((b, 1), i, J.jnp.int32), window=16, mode="decode",
            cache=jc, pos=J.jnp.int32(i))
        got, tc, _ = model.layers[1].run(tcfg, torch.from_numpy(xi), None,
                                         16, "decode", tc, i)
        close(got, want, MODEL_TOL, f"decode at {i}")
    close(tc["attn"]["k"], jc["attn"]["k"], MODEL_TOL, "ring k")
    assert np.array_equal(tc["attn"]["pos"].numpy(),
                          np.asarray(jc["attn"]["pos"]))
    close(tc["ssm"]["state"], jc["ssm"]["state"], MODEL_TOL, "ssm state")
