"""The port's flash attention against the JAX package, on the CPU.

The plain version (`repro_torch.kernels.flash_attention`, what
`ops.flash_attention` runs on a CPU tensor) is held against the Pallas
kernel in interpret mode (`repro.kernels.ops.flash_attention`) and its jnp
oracle (`repro.kernels.ref.flash_attention_ref`), on the shape sweep of
`tests/test_kernels.py`. Tolerances: atol = rtol = 2e-5 in float32, the
reference's own for its kernel (the two sum the same fp32 products in
another order). In bfloat16 the reference's 3e-2 is as large as a typical
output of these random inputs (0.04-0.15), so a lost key tile would pass
it alone; each element is also held to `flash_attention.bf16_agreement`'s
bound (2e-3 + 1e-2·|out| + 2^-7·Σ p|v| / l: the fp32 sums near 0, one bf16
ulp of the output, twice what rounding p to bf16 before P·V can move it,
which the Pallas kernel and the CUDA kernel do and the plain version does
not), and the whole to a relative L2 error of 1e-2. Rows with no visible
key must give the mean of v over all keys, as the reference does.

The CUDA kernel cannot run here; `_emulate_kernel` replays its tile loop
(64-query blocks, 64-key tiles, the skip rule from each tile's positions
and the second pass for rows with no visible key) in PyTorch, so the
design is checked here against the plain version. The `cuda` tests hold
the kernel itself against the plain version on the card and skip here.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32_TOL = 2e-5


def _assert_agrees(got, q, k, v, qpos, kpos, causal, window=None):
    """got against the plain version: atol = rtol = F32_TOL in float32,
    `bf16_agreement` in bfloat16 (see the docstring)."""
    if got.dtype == torch.float32:
        want = fa.flash_attention_plain(q, k, v, qpos, kpos, causal, window)
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        res = fa.bf16_agreement(got, q, k, v, qpos, kpos, causal, window)
        assert res["ok"], res


@pytest.fixture(scope="module")
def J():
    """The JAX package's kernel and oracle (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return types.SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _jax_oracle(J, q, k, v, qpos, kpos, causal, window):
    """repro.kernels.ref.flash_attention_ref on the (B, S, H, d) layout,
    kv heads repeated as the reference's ops wrapper does."""
    jnp = J.jnp
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kr, vr = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    bhsd = lambda x: jnp.asarray(  # noqa: E731
        x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d))
    o = J.ref.flash_attention_ref(bhsd(q), bhsd(kr), bhsd(vr),
                                  jnp.asarray(qpos, jnp.int32),
                                  jnp.asarray(kpos, jnp.int32),
                                  causal=causal, window=window)
    return np.asarray(o, np.float32).reshape(b, h, sq, d).transpose(0, 2, 1, 3)


# -- the plain version against the Pallas kernel and its oracle ------------

@pytest.mark.parametrize("s,d,h,kv", [
    (256, 64, 4, 4),
    (256, 128, 4, 2),   # GQA
    (512, 64, 2, 1),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_oracle(J, s, d, h, kv, causal):
    q, k, v = _qkv(s + d, 2, s, s, h, kv, d)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    pallas = np.asarray(J.ops.flash_attention(
        J.jnp.asarray(q), J.jnp.asarray(k), J.jnp.asarray(v), causal=causal,
        interpret=True))
    pos = np.arange(s)
    oracle = _jax_oracle(J, q, k, v, pos, pos, causal, None)
    np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got, oracle, atol=F32_TOL, rtol=F32_TOL)


def test_plain_window_matches_pallas(J):
    q, k, v = _qkv(7, 1, 384, 384, 2, 2, 64)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=100).numpy()
    pallas = np.asarray(J.ops.flash_attention(
        J.jnp.asarray(q), J.jnp.asarray(k), J.jnp.asarray(v), causal=True,
        window=100, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=F32_TOL)


def test_plain_bf16_matches_pallas(J):
    q, k, v = _qkv(8, 1, 256, 256, 2, 2, 64)
    jb = [J.jnp.asarray(x, J.jnp.bfloat16) for x in (q, k, v)]
    pallas = np.asarray(J.ops.flash_attention(*jb, causal=True,
                                              interpret=True), np.float32)
    tb = [_t(np.asarray(x, np.float32), torch.bfloat16) for x in jb]
    got = ops.flash_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    pos = torch.arange(256, dtype=torch.int32)
    assert torch.equal(got, fa.flash_attention_plain(*tb, pos, pos))
    _assert_agrees(_t(pallas, torch.bfloat16), *tb, pos, pos, causal=True)


def _padded_positions(sq, sk):
    """Query rows 0..3 are padding (no visible key), keys 0..1 and the
    last 7 are padding, and query row 4 sees only padded keys."""
    qpos = np.arange(sq, dtype=np.int32)
    kpos = np.arange(sk, dtype=np.int32)
    qpos[:4] = -1
    kpos[:2] = -1
    kpos[-7:] = -1
    qpos[4] = 1
    return qpos, kpos


@pytest.mark.parametrize("window", [None, 20])
def test_plain_padding_and_empty_rows_match_pallas(J, window):
    s = 256
    q, k, v = _qkv(11, 1, s, s, 2, 2, 64)
    qpos, kpos = _padded_positions(s, s)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                              qpos=_t(qpos, torch.int32),
                              kpos=_t(kpos, torch.int32)).numpy()
    pallas = np.asarray(J.ops.flash_attention(
        J.jnp.asarray(q), J.jnp.asarray(k), J.jnp.asarray(v), causal=True,
        window=window, qpos=J.jnp.asarray(qpos), kpos=J.jnp.asarray(kpos),
        block_q=64, block_k=64, interpret=True))
    oracle = _jax_oracle(J, q, k, v, qpos, kpos, True, window)
    np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got, oracle, atol=F32_TOL, rtol=F32_TOL)
    # rows without a visible key: the mean of v over all Sk keys
    mean_v = v.mean(axis=1)  # (B, Kv, d); H == Kv here
    for row in range(5):
        np.testing.assert_allclose(got[:, row], mean_v, atol=F32_TOL,
                                   rtol=F32_TOL)


def test_plain_ragged_sq_ne_sk_matches_oracle(J):
    """Any Sq and Sk: the queries are the last 75 of 131 positions, GQA."""
    q, k, v = _qkv(12, 2, 75, 131, 6, 2, 32)
    qpos, kpos = np.arange(56, 131), np.arange(131)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              qpos=_t(qpos, torch.int32),
                              kpos=_t(kpos, torch.int32)).numpy()
    want = _jax_oracle(J, q, k, v, qpos, kpos, True, None)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def _ring_positions(slots, last):
    """A ring cache of `slots` slots after writing positions 0..last:
    slot i holds the latest position ≡ i (mod slots), -1 if none."""
    kpos = np.full(slots, -1, np.int32)
    for p in range(last + 1):
        kpos[p % slots] = p
    return kpos


def test_plain_single_query_against_ring_matches_oracle(J):
    q, k, v = _qkv(13, 2, 1, 48, 4, 4, 16)
    kpos = _ring_positions(48, 70)
    qpos = np.array([70], np.int32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=48,
                              qpos=_t(qpos, torch.int32),
                              kpos=_t(kpos, torch.int32)).numpy()
    want = _jax_oracle(J, q, k, v, qpos, kpos, True, 48)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_plain_chunks_queries_above_threshold(monkeypatch):
    """The query-chunked path computes the unchunked function."""
    q, k, v = _qkv(14, 1, 100, 100, 2, 1, 16)
    whole = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    monkeypatch.setattr(fa, "CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(fa, "CHUNK", 24)
    chunked = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    torch.testing.assert_close(chunked, whole, atol=0, rtol=0)


def test_ref_layout_matches_jax_oracle(J):
    rng = np.random.default_rng(15)
    q, k, v = (rng.standard_normal((3, 96, 16)).astype(np.float32)
               for _ in range(3))
    qpos, kpos = _padded_positions(96, 96)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v),
                                  _t(qpos, torch.int32),
                                  _t(kpos, torch.int32), causal=True).numpy()
    want = np.asarray(J.ref.flash_attention_ref(
        J.jnp.asarray(q), J.jnp.asarray(k), J.jnp.asarray(v),
        J.jnp.asarray(qpos), J.jnp.asarray(kpos), causal=True))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


# -- the kernel's tile loop, replayed on the CPU ---------------------------

def _emulate_kernel(q, k, v, qpos, kpos, causal, window, bq=64, bk=64):
    """The loop of `csrc/flash_attention.cu` in PyTorch: per block of bq
    query rows, key tiles of bk skipped from their position range, an
    online softmax with p rounded to v's dtype, and a second pass without
    skipping when the block has a row with no visible key."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    out = torch.empty_like(q)
    for q0 in range(0, sq, bq):
        rows = slice(q0, min(q0 + bq, sq))
        qp = qpos[rows].long()
        qt = q[:, rows].float().permute(0, 2, 1, 3)           # (b, h, r, d)
        kh = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
        vh = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)

        def attend(allow_skip):
            m = torch.full(qt.shape[:3], fa.NEG_INF)
            l = torch.zeros(qt.shape[:3])
            acc = torch.zeros(qt.shape)
            skipped = False
            for k0 in range(0, sk, bk):
                kp = kpos[k0:k0 + bk].long()
                valid = kp[kp >= 0]
                if allow_skip and (
                        valid.numel() == 0
                        or (causal and int(valid.min()) > int(qp.max()))
                        or (window is not None and int(valid.max())
                            <= int(qp.min()) - window)):
                    skipped = True
                    continue
                s = torch.einsum("bhrd,bhtd->bhrt", qt,
                                 kh[:, :, k0:k0 + bk]) * (d ** -0.5)
                vis = fa.visible_mask(qp, kp, causal, window)
                s = torch.where(vis, s, torch.tensor(fa.NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                p = p.to(v.dtype).float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhrt,bhtd->bhrd", p, vh[:, :, k0:k0 + bk])
                m = m_new
            return m, l, acc, skipped

        m, l, acc, skipped = attend(True)
        if skipped and bool((m == fa.NEG_INF).any()):
            m, l, acc, _ = attend(False)
        o = acc / l.clamp_min(1e-30)[..., None]
        out[:, rows] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _emulation_cases():
    pad_q, pad_k = _padded_positions(200, 200)
    ring = _ring_positions(150, 260)
    return {
        # name: (b, sq, sk, h, kv, d, qpos, kpos, causal, window)
        "causal": (1, 200, 200, 2, 1, 16, None, None, True, None),
        "bidirectional": (1, 130, 70, 2, 2, 16, None, None, False, None),
        "window": (1, 300, 300, 2, 2, 16, None, None, True, 70),
        "padding": (1, 200, 200, 2, 2, 16, pad_q, pad_k, True, None),
        "padding window": (1, 200, 200, 2, 2, 16, pad_q, pad_k, True, 20),
        "ragged sq != sk": (2, 75, 131, 4, 2, 16, np.arange(56, 131),
                            np.arange(131), True, None),
        "ring, one query": (2, 1, 150, 2, 2, 16, np.array([260]), ring,
                            True, 150),
        "reversed keys": (1, 130, 130, 2, 2, 16, None,
                          np.arange(130)[::-1].copy(), True, None),
    }


@pytest.mark.parametrize("case", sorted(_emulation_cases()))
def test_kernel_tile_loop_emulation_matches_plain(case):
    b, sq, sk, h, kv, d, qpos, kpos, causal, window = _emulation_cases()[case]
    q, k, v = (_t(x) for x in _qkv(len(case), b, sq, sk, h, kv, d))
    qpos = _t(np.arange(sq) if qpos is None else qpos, torch.int32)
    kpos = _t(np.arange(sk) if kpos is None else kpos, torch.int32)
    want = fa.flash_attention_plain(q, k, v, qpos, kpos, causal, window)
    got = _emulate_kernel(q, k, v, qpos, kpos, causal, window)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def _full_cache_case(seed):
    """One query at position 2048 against a 2,081-slot cache filled to
    2048, phi3's heads and head dim, bf16."""
    q, k, v = (_t(x, torch.bfloat16)
               for x in _qkv(seed, 4, 1, 2081, 32, 32, 96))
    kpos = torch.full((2081,), -1, dtype=torch.int32)
    kpos[:2049] = torch.arange(2049, dtype=torch.int32)
    return q, k, v, torch.tensor([2048], dtype=torch.int32), kpos


@pytest.mark.parametrize("case", ["causal 256 d64", "one query, full cache"])
def test_bf16_agreement_takes_the_kernels_rounding(case):
    """The kernel's tile loop in bf16 (p rounded to bf16 before P·V) is
    within the bound that the card's checks hold the kernel to."""
    if case == "one query, full cache":
        q, k, v, qpos, kpos = _full_cache_case(21)
    else:
        q, k, v = (_t(x, torch.bfloat16)
                   for x in _qkv(22, 2, 256, 256, 4, 4, 64))
        qpos = kpos = torch.arange(256, dtype=torch.int32)
    got = _emulate_kernel(q, k, v, qpos, kpos, True, None)
    res = fa.bf16_agreement(got, q, k, v, qpos, kpos, True)
    assert res["ok"], res


def test_bf16_agreement_refuses_a_lost_key_tile():
    """An output that lost one 64-key tile of the cache (of 2,049 visible
    keys) fails the bf16 bound."""
    q, k, v, qpos, kpos = _full_cache_case(23)
    lost = kpos.clone()
    lost[1024:1088] = -1
    dropped = fa.flash_attention_plain(q, k, v, qpos, lost, True)
    res = fa.bf16_agreement(dropped, q, k, v, qpos, kpos, True)
    assert not res["ok"], res


# -- routing and argument checks --------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launch_counts()
    q, k, v = (_t(x) for x in _qkv(16, 1, 8, 8, 2, 1, 16))
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, torch.arange(8), torch.arange(8))
    assert torch.equal(got, want)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError):  # the CUDA entry refuses CPU tensors
        fa.flash_attention_cuda(q, k, v, torch.arange(8), torch.arange(8))
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_arg_checks_refuse_what_the_kernel_does_not_take():
    pos = torch.arange(8, dtype=torch.int32)
    bad = {
        "head dim 24": (torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 24)),
        "float16": (torch.zeros(1, 8, 2, 16, dtype=torch.float16),
                    torch.zeros(1, 8, 2, 16, dtype=torch.float16)),
        "heads 3 over kv 2": (torch.zeros(1, 8, 3, 16),
                              torch.zeros(1, 8, 2, 16)),
        "qpos of another length": (torch.zeros(1, 9, 2, 16),
                                   torch.zeros(1, 8, 2, 16)),
    }
    for name, (q, k) in bad.items():
        with pytest.raises(ValueError):
            fa.check_kernel_args(q, k, k, pos, pos, None)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        fa.check_kernel_args(q, q, q, pos, pos, 0)
    for d in fa.HEAD_DIMS:
        for dt in fa.DTYPES:
            x = torch.zeros(1, 8, 2, d, dtype=dt)
            fa.check_kernel_args(x, x[:, :, :1], x[:, :, :1], pos, pos, 4)


# -- the CUDA kernel against its plain version (card only) ------------------

def _cuda_cases():
    pad_q, pad_k = _padded_positions(300, 300)
    return {
        # name: (b, sq, sk, h, kv, d, qpos, kpos, causal, window)
        "mha d96 causal": (2, 256, 256, 4, 4, 96, None, None, True, None),
        "gqa d128 causal": (1, 200, 200, 6, 2, 128, None, None, True, None),
        "mqa d64 bidirectional": (1, 130, 70, 4, 1, 64, None, None, False,
                                  None),
        "d16 window": (1, 300, 300, 2, 2, 16, None, None, True, 70),
        "d32 padding": (1, 300, 300, 2, 2, 32, pad_q, pad_k, True, None),
        "d80 ragged sq != sk": (2, 75, 131, 4, 2, 80, np.arange(56, 131),
                                np.arange(131), True, None),
        "d96 one query, ring": (2, 1, 150, 2, 2, 96, np.array([260]),
                                _ring_positions(150, 260), True, 150),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_cuda_cases()))
def test_cuda_kernel_equals_plain(cuda_device, case, dtype):
    b, sq, sk, h, kv, d, qpos, kpos, causal, window = _cuda_cases()[case]
    dt = getattr(torch, dtype)
    q, k, v = (_t(x, dt).to(cuda_device)
               for x in _qkv(len(case), b, sq, sk, h, kv, d))
    qpos = _t(np.arange(sq) if qpos is None else qpos,
              torch.int32).to(cuda_device)
    kpos = _t(np.arange(sk) if kpos is None else kpos,
              torch.int32).to(cuda_device)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              qpos=qpos, kpos=kpos)
    assert ops.launch_counts()["flash_attention"] == before + 1
    _assert_agrees(got, q, k, v, qpos, kpos, causal, window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window,
                                qpos=qpos, kpos=kpos)
    assert torch.equal(got, again)  # no atomics: a run is deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_strided_inputs(cuda_device, dtype):
    """q, k, v as views of one fused (B, S, 3, H, d) projection."""
    rng = np.random.default_rng(17)
    qkv = _t(rng.standard_normal((2, 100, 3, 4, 64)).astype(
        np.float32), getattr(torch, dtype)).to(cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)
    assert torch.equal(got, want)
    # an odd element offset: the bf16 kernel's pair loads need a copy
    flat = qkv.reshape(-1)[1:1 + q.numel()].view(q.shape)
    pos = torch.arange(100, device=cuda_device)
    _assert_agrees(ops.flash_attention(flat, flat, flat, causal=True), flat,
                   flat, flat, pos, pos, causal=True)
