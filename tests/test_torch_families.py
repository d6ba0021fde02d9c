"""Whole reduced models of the MLA, SSM, hybrid and MoE families against
the JAX package, on the CPU: minicpm3-4b (MLA + MLP, `scan`), mamba2-370m
(SSM blocks only, tied embeddings, `scan`), hymba-1.5b (parallel GQA
with a window of 16 on layer 1 and SSM heads, then the MLP, `unroll`),
granite-moe-3b-a800m and dbrx-132b (GQA, then an MoE FFN of 4 experts,
top 2, cf 8: no drops, so prefill + decode equals the full forward), with
the reference's weights carried across by `models/convert.py`.

Prefill and decode logits and the full forward against the reference's
(1e-4), `generate`'s tokens equal to the reference's, prefill + decode
against the full forward (5e-5, the reference's own bound), hymba
decoding past twice its window, the dtypes of a bfloat16 conversion, and
the launcher on the CPU. Tolerances are `_torch_lm`'s.
"""
import numpy as np
import pytest
import torch

from _torch_lm import (MODEL_TOL, SERVE_TOL, close, port_cfg,
                       ref_full_logits, ref_model, reference_fixture,
                       step_logits, tokens)
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.serve import serve_step as tserve

torch.set_num_threads(1)

FAMILIES = ["minicpm3-4b", "mamba2-370m", "hymba-1.5b",
            "granite-moe-3b-a800m", "dbrx-132b"]


@pytest.fixture(scope="module")
def J():
    yield from reference_fixture()


@pytest.mark.parametrize("name", FAMILIES)
def test_model_prefill_decode_and_forward_match_reference(J, name):
    """S = 32: hymba's windowed layer runs the reference's banded path in
    the full forward; the prefill of 29 its masked softmax."""
    cfg, m, params = ref_model(J, name)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    b, s, max_len = 2, 32, 64
    toks = tokens(cfg.vocab_size, b, s)
    jt, tt = J.jnp.asarray(toks), torch.from_numpy(toks)
    close(model(tt), ref_full_logits(J, m, params, jt), MODEL_TOL,
          "full forward")
    jl, jc = m.prefill(params, jt[:, :s - 3], m.init_caches(b, max_len))
    tl, tc = model.prefill(tt[:, :s - 3], model.init_caches(b, max_len))
    close(tl, jl, MODEL_TOL, "prefill")
    for i in range(s - 3, s):
        jl, jc = m.decode_step(params, jt[:, i:i + 1], J.jnp.int32(i), jc)
        tl, tc = model.decode_step(tt[:, i:i + 1], i, tc)
        close(tl, jl, MODEL_TOL, f"decode at {i}")


@pytest.mark.parametrize("name", FAMILIES)
def test_generate_tokens_equal_reference(J, name):
    cfg, m, params = ref_model(J, name, seed=3)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    prompt = tokens(cfg.vocab_size, 2, 8, seed=6)
    want = J.serve_step.generate(m, params, J.jnp.asarray(prompt), max_new=6,
                                 max_len=32)
    got = tserve.generate(model, torch.from_numpy(prompt), max_new=6,
                          max_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    steps, logits = step_logits(model, torch.from_numpy(prompt), 6, 32)
    assert logits.shape == (2, 6, cfg.vocab_size)
    assert torch.equal(steps, got)
    assert torch.equal(logits.argmax(-1).to(torch.int32), got)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_plus_decode_equals_full_forward(J, name):
    """The serving contract of tests/test_serve.py, on the port alone."""
    cfg, _, params = ref_model(J, name)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    toks = torch.from_numpy(tokens(cfg.vocab_size, 2, 24))
    want = model(toks)[:, -1, :]
    _, caches = model.prefill(toks[:, :21], model.init_caches(2, 64))
    for i in range(21, 24):
        got, caches = model.decode_step(toks[:, i:i + 1], i, caches)
    assert float((got - want).abs().max()) < SERVE_TOL


def test_hymba_ring_cache_beyond_twice_the_window(J):
    """tests/test_serve.py::test_window_ring_cache_beyond_window on the
    port: prefill 8 tokens, decode to position 39 (> 2 x the window of
    16) through the ring, against the full forward's last logits and the
    reference's decode."""
    cfg, m, params = ref_model(J, "hymba-1.5b", seed=2)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    b, s = 1, 40
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    tt, jt = torch.from_numpy(toks), J.jnp.asarray(toks)
    want = model(tt)[:, -1, :]
    _, caches = model.prefill(tt[:, :8], model.init_caches(b, 64))
    _, jc = m.prefill(params, jt[:, :8], m.init_caches(b, 64))
    assert caches[1]["attn"]["k"].shape[1] == 16     # windowed: a ring
    assert caches[0]["attn"]["k"].shape[1] == 64     # global: full
    for i in range(8, s):
        got, caches = model.decode_step(tt[:, i:i + 1], i, caches)
        jl, jc = m.decode_step(params, jt[:, i:i + 1], J.jnp.int32(i), jc)
    assert float((got - want).abs().max()) < SERVE_TOL
    close(got, jl, MODEL_TOL, "the reference's decode at 39")


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_conversion_keeps_what_the_reference_reads_in_float32(J, name):
    """Every leaf of a bfloat16 conversion in the dtype its use in the
    reference reads: the norm scales (`*norm`; `.astype(jnp.float32)` in
    `rmsnorm`), A_log and dt_bias (`.astype(jnp.float32)` in
    `ssm_forward` / `ssm_decode`) float32; every other leaf (matmul
    weights, the embedding, conv_w, conv_b, D: `.astype(dt)` at use)
    bfloat16. The port's own init stores the same dtypes."""
    cfg, _, params = ref_model(J, name, dtype="bfloat16")
    tcfg = port_cfg(cfg)
    sd = convert.reference_state_dict(tcfg, params)
    fp32 = set()
    for key, t in sd.items():
        leaf = key.rsplit(".", 1)[-1]
        want = (torch.float32 if leaf.endswith("norm")
                or leaf in ("A_log", "dt_bias") else torch.bfloat16)
        assert t.dtype == want, key
        if want == torch.float32:
            fp32.add(leaf)
    assert ("A_log" in fp32) == ("dt_bias" in fp32) == tcfg.has_ssm
    own = LM(tcfg, generator=torch.Generator().manual_seed(0),
             device="cpu").state_dict()
    assert {k: t.dtype for k, t in own.items()} == {
        k: t.dtype for k, t in sd.items()}
    model = convert.from_reference(tcfg, params, device="cpu")
    for key, t in model.state_dict().items():
        assert t.dtype == sd[key].dtype, key
        assert torch.equal(t, sd[key]), key


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_serve_runs_the_family_reduced_on_the_cpu(name, capsys):
    out = tlaunch.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "12",
                        "--max-new", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert f"{name} on cpu: generated 10 tokens" in capsys.readouterr().out
