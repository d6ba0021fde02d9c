"""The port's attention-mask planner against the JAX package, on the CPU.

`build_block_graph` must give the reference's edges and weights exactly,
`plan_block_mask` (the port's `lgrass_sparsify`) the reference's mask,
and `block_sparse_attention` the reference's output at 1e-5 in fp32. The
planner tests of `tests/test_sparse_attention.py` are mirrored. The test
marked `cuda` plans and attends on the card.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.sparse import (block_sparse_attention, build_block_graph,
                                plan_block_mask)

torch.set_num_threads(1)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def J():
    """The JAX package (skips where JAX is absent); its caches are
    cleared before and after this file."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.sparse import attention_graph as jattn

    jax.clear_caches()
    yield types.SimpleNamespace(jnp=jnp, attn=jattn)
    jax.clear_caches()


def _feats(nb=16, d=32, seed=0):
    return np.random.default_rng(seed).standard_normal((nb, d)).astype(
        np.float32)


def _connected(mask) -> bool:
    adj = mask | mask.T
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for x in frontier:
            for y in np.where(adj[x])[0]:
                if int(y) not in seen:
                    seen.add(int(y))
                    nxt.append(int(y))
        frontier = nxt
    return len(seen) == mask.shape[0]


def test_block_graph_valid():
    g = build_block_graph(_feats(), window=2)
    g.validate()
    assert g.n == 16


@pytest.mark.parametrize("nb,window,chords", [(16, 2, 4), (24, 1, 4),
                                              (40, 3, 2), (3, 2, 4)])
def test_block_graph_equals_reference(J, nb, window, chords):
    feats = _feats(nb, seed=nb)
    got = build_block_graph(feats, window=window, n_chords_per_block=chords)
    want = J.attn.build_block_graph(feats, window=window,
                                    n_chords_per_block=chords)
    assert got.n == want.n
    for k in ("u", "v", "w"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_plan_mask_causal_and_connected():
    plan = plan_block_mask(_feats(24), keep_frac=0.2, **CPU)
    nb = plan.n_blocks
    assert plan.mask.shape == (nb, nb)
    assert np.all(np.diag(plan.mask))
    assert not np.any(np.triu(plan.mask, 1))
    assert _connected(plan.mask)


@pytest.mark.parametrize("nb,keep_frac,window", [(24, 0.2, 2), (32, 0.3, 2),
                                                 (40, 0.15, 1)])
def test_plan_mask_equals_reference(J, nb, keep_frac, window):
    feats = _feats(nb, d=64, seed=7 + nb)
    got = plan_block_mask(feats, keep_frac=keep_frac, window=window, **CPU)
    want = J.attn.plan_block_mask(feats, keep_frac=keep_frac, window=window)
    assert (got.n_blocks, got.kept_edges, got.total_edges) == (
        want.n_blocks, want.kept_edges, want.total_edges)
    assert np.array_equal(got.mask, want.mask)


def test_block_sparse_attention_dense_mask_equals_dense():
    rng = np.random.default_rng(1)
    B, S, H, D, blk = 1, 128, 2, 16, 16
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, D)),
                               dtype=torch.float32) for _ in range(3))
    nb = S // blk
    full = block_sparse_attention(q, k, v, np.ones((nb, nb), bool), blk,
                                  **CPU)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool))
    e = torch.exp(torch.where(causal, s, -1e9))
    p = torch.einsum("bhqk,bkhd->bqhd", e / e.sum(-1, keepdim=True), v)
    np.testing.assert_allclose(full.numpy(), p.numpy(), atol=1e-4, rtol=1e-4)


def test_block_sparse_attention_equals_reference(J):
    """A planned (sparse) mask and the full mask, fp32: allclose to the
    reference's at 1e-5."""
    rng = np.random.default_rng(2)
    B, S, H, D, blk = 2, 256, 2, 32, 32
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    nb = S // blk
    sparse = plan_block_mask(_feats(nb, seed=5), keep_frac=0.3, **CPU).mask
    for mask in (sparse, np.ones((nb, nb), bool)):
        got = block_sparse_attention(q, k, v, mask, blk, **CPU)
        want = J.attn.block_sparse_attention(
            J.jnp.asarray(q), J.jnp.asarray(k), J.jnp.asarray(v),
            J.jnp.asarray(mask), blk)
        assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_sparse_attention_example_twin_on_the_cpu():
    """The twin of examples/sparse_attention.py: S = 1,024 in blocks of
    32, a connected causal mask, output finite."""
    from repro_torch.examples import sparse_attention

    out = sparse_attention.main(["--device", "cpu"])
    assert out["connected"]
    assert out["plan"].mask.shape == (32, 32)
    assert 0.0 < out["covered"] <= 1.0
    assert torch.isfinite(out["out"]).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_planner_and_attention_equal_the_cpu(card):
    feats = _feats(32, d=64, seed=3)
    gpu = plan_block_mask(feats, keep_frac=0.3)
    cpu = plan_block_mask(feats, keep_frac=0.3, **CPU)
    assert np.array_equal(gpu.mask, cpu.mask)
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 1024, 4, 64)).astype(np.float32)
               for _ in range(3))
    a = block_sparse_attention(q, k, v, gpu.mask, 32)
    b = block_sparse_attention(q, k, v, cpu.mask, 32, **CPU)
    torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
