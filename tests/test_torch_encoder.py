"""hubert-xlarge's encoder and audio frontend against the JAX package, on
the CPU: the reduced model (2 layers, d 64, 4 heads of 16, GELU MLP,
frame features of 32) with the reference's weights carried across by
`models/convert.py`, `LM.encode` against the reference's `encode` at
1e-4 (`_torch_lm`'s model tolerance) at T = 32 and at T = 21; the state
dict, `frontend.proj` included, loads strictly from the reference's
tree; the decoder entries raise on an encoder; attention is
bidirectional; a bf16 conversion keeps the reference's dtypes.
"""
import numpy as np
import pytest
import torch

from _torch_lm import MODEL_TOL, close, port_cfg, ref_model, \
    reference_fixture
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models.model import LM

torch.set_num_threads(1)

ARCH = "hubert-xlarge"


@pytest.fixture(scope="module")
def J():
    yield from reference_fixture()


def _features(cfg, b, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.feat_dim)).astype(np.float32)


@pytest.mark.parametrize("t", [32, 21])
def test_encode_matches_reference(J, t):
    cfg, m, params = ref_model(J, ARCH)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    feats = _features(cfg, 2, t)
    want = m.encode(params, {"features": J.jnp.asarray(feats)})
    got = model.encode(torch.from_numpy(feats))
    assert got.shape == (2, t, cfg.vocab_size)
    close(got, want, MODEL_TOL)


def test_state_dict_loads_strictly_from_the_reference_tree(J):
    cfg, _, params = ref_model(J, ARCH, seed=2)
    sd = convert.reference_state_dict(port_cfg(cfg), params)
    assert torch.equal(sd["frontend.proj"],
                       torch.from_numpy(np.array(params["frontend"]["proj"])))
    assert sd["frontend.proj"].shape == (cfg.feat_dim, cfg.d_model)
    # strict=True
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    own = LM(port_cfg(cfg), generator=torch.Generator().manual_seed(0),
             device="cpu").state_dict()
    assert sorted(own) == sorted(model.state_dict()) == sorted(sd)
    assert "embedding" in own and "lm_head" in own


def test_bf16_conversion_keeps_the_reference_dtypes(J):
    """`frontend.proj` is cast with `.astype(feats.dtype)` at use: bf16,
    like every matmul weight; the norm scales float32."""
    cfg, _, params = ref_model(J, ARCH, dtype="bfloat16")
    sd = convert.reference_state_dict(port_cfg(cfg), params)
    for key, t in sd.items():
        want = (torch.float32 if key.rsplit(".", 1)[-1].endswith("norm")
                else torch.bfloat16)
        assert t.dtype == want, key
    own = LM(port_cfg(cfg), generator=torch.Generator().manual_seed(0),
             device="cpu").state_dict()
    assert {k: t.dtype for k, t in own.items()} == {
        k: t.dtype for k, t in sd.items()}
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    out = model.encode(torch.from_numpy(_features(cfg, 1, 8)))
    assert out.dtype == torch.bfloat16


def test_decoder_entries_raise_on_the_encoder():
    cfg = get_arch(ARCH).reduced()
    model = LM(cfg, generator=torch.Generator().manual_seed(0),
               device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder-only"):
        model.init_caches(1, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        model.prefill(toks, [{} for _ in range(cfg.n_layers)])
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(toks[:, :1], 4, [{} for _ in range(cfg.n_layers)])
    with pytest.raises(ValueError, match="encoder-only"):
        model(toks)
    dec = LM(get_arch("phi3-mini-3.8b").reduced(),
             generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="decoder"):
        dec.encode(torch.zeros((1, 4, 32)))


def test_launcher_refuses_the_encoder():
    """As the reference's launcher does: no decode step to serve."""
    with pytest.raises(SystemExit, match="encoder-only"):
        tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_attention_is_bidirectional(J):
    """Position 0 of a bidirectional encode sees every frame; made causal,
    it sees only itself, and its logits differ. Position 0's causal logits
    also equal an encode of the first frame alone."""
    cfg, _, params = ref_model(J, ARCH)
    model = convert.from_reference(port_cfg(cfg), params, device="cpu")
    feats = torch.from_numpy(_features(cfg, 2, 16, seed=3))
    both = model.encode(feats)
    for blk in model.layers:
        blk.causal = True
    causal = model.encode(feats)
    assert float((both[:, 0] - causal[:, 0]).abs().max()) > 1e-3
    close(causal[:, 0], model.encode(feats[:, :1])[:, 0], MODEL_TOL)
    for blk in model.layers:
        blk.causal = False
    close(model.encode(feats), both.detach(), 0.0)

