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

The CUDA kernels cannot run here; `_emulate_kernel` replays their tile
loops (`TILINGS`: the mma.sync kernel's 64-query blocks and 64-key tiles;
the wgmma kernel's 128-query blocks as two 64-row halves, 128-key tiles
and tiles that every row of a half sees taken without a mask), with the
skip rule from each tile's positions and the second pass for rows with no
visible key, in PyTorch, so each design is checked here against the plain
version. `_emulate_backward` does the same for the wgmma backward's two
kernels (dQ over 128-key tiles, dK/dV over 64-query tiles of each head of
a GQA group; skips from positions; a query tile holding a row whose LSE is
+inf never skipped; P from the given LSE in log2 units; P and dS rounded
to bf16 where asked). The `cuda` tests hold the kernels themselves against
the plain version on the card and skip here.
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
    (256, 80, 4, 4),    # hubert's head dim
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


# -- the kernels' tile loops, replayed on the CPU ---------------------------

# The CUDA kernels' tilings: query rows per block (`bq`), split into
# `groups` that each keep their own softmax state (a warp group of 64 rows
# in the wgmma kernel; the mma kernel's 4 warps decide together), keys per
# tile (`bk`), whether a tile that every row of a group fully sees skips the
# per-element mask (`unmasked`), and whether the scale is folded into exp2.
TILINGS = {
    "mma": dict(bq=64, bk=64, groups=1, unmasked=False, exp2=False),
    "wgmma": dict(bq=128, bk=128, groups=2, unmasked=True, exp2=True),
}


def _emulate_kernel(q, k, v, qpos, kpos, causal, window, tiling="mma",
                    stats=None):
    """The tile loop of a CUDA kernel (`TILINGS`) in PyTorch: per block of
    bq query rows, key tiles of bk skipped from their position range (for
    the whole block), an online softmax per group of rows with p rounded
    to v's dtype, tiles that a group fully sees taken without a mask, and,
    when a tile was skipped and some row of the block has no visible key,
    a second pass over every tile for the whole block. `stats`, a dict,
    counts the tiles taken without a mask ("unmasked") and the second
    passes ("second_passes")."""
    cfg = TILINGS[tiling]
    bq, bk, groups = cfg["bq"], cfg["bk"], cfg["groups"]
    stats = {} if stats is None else stats
    stats.setdefault("unmasked", 0)
    stats.setdefault("second_passes", 0)
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    kh = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vh = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    # the kernels' exp: e^x, or 2^(x log2 e) with the scale folded in
    scale = d ** -0.5 * (1.4426950408889634 if cfg["exp2"] else 1.0)
    exp = torch.exp2 if cfg["exp2"] else torch.exp
    out = torch.empty_like(q)

    def tiles(qp, allow_skip):
        kept, skipped = [], False
        for k0 in range(0, sk, bk):
            kp = kpos[k0:k0 + bk].long()
            valid = kp[kp >= 0]
            if allow_skip and (
                    valid.numel() == 0
                    or (causal and int(valid.min()) > int(qp.max()))
                    or (window is not None
                        and int(valid.max()) <= int(qp.min()) - window)):
                skipped = True
                continue
            kept.append((k0, kp, valid.numel() == bk))
        return kept, skipped

    def attend(qt, qp, kept):
        m = torch.full(qt.shape[:3], fa.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for k0, kp, all_valid in kept:
            s = torch.einsum("bhrd,bhtd->bhrt", qt,
                             kh[:, :, k0:k0 + bk]) * scale
            if (cfg["unmasked"] and all_valid
                    and (not causal or int(kp.max()) <= int(qp.min()))
                    and (window is None
                         or int(kp.min()) > int(qp.max()) - window)):
                stats["unmasked"] += 1
            else:
                vis = fa.visible_mask(qp, kp, causal, window)
                s = torch.where(vis, s, torch.tensor(fa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = exp(m - m_new)
            p = exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            p = p.to(v.dtype).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrt,bhtd->bhrd", p, vh[:, :, k0:k0 + bk])
            m = m_new
        return m, l, acc

    for q0 in range(0, sq, bq):
        nrows = min(bq, sq - q0)
        kept, skipped = tiles(qpos[q0:q0 + nrows].long(), True)
        for allow_skip in (True, False):
            if not allow_skip:
                stats["second_passes"] += 1
                kept, _ = tiles(None, False)
            parts, empty = [], False
            for r0 in range(0, nrows, bq // groups):
                rows = slice(q0 + r0, q0 + min(r0 + bq // groups, nrows))
                qp = qpos[rows].long()
                qt = q[:, rows].float().permute(0, 2, 1, 3)  # (b, h, r, d)
                m, l, acc = attend(qt, qp, kept)
                empty = empty or bool((m == fa.NEG_INF).any())
                parts.append((rows, l, acc))
            if not (skipped and empty):
                break
        for rows, l, acc in parts:
            o = acc / l.clamp_min(1e-30)[..., None]
            out[:, rows] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _emulation_cases():
    pad_q, pad_k = _padded_positions(200, 200)
    ring = _ring_positions(150, 260)
    return {
        # name: (b, sq, sk, h, kv, d, qpos, kpos, causal, window)
        "causal": (1, 200, 200, 2, 1, 16, None, None, True, None),
        "causal 600": (1, 600, 600, 2, 1, 16, None, None, True, None),
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
        # hubert's encoder: bidirectional at d = 80, 300 = 2 x 128 + 44
        # (4 x 64 + 44) queries and keys: a ragged last tile in both
        # tilings, as its 1,500 frames give one
        "hubert-like d80 bidirectional": (2, 300, 300, 2, 2, 80, None,
                                          None, False, None),
    }


def _emulation_inputs(case):
    b, sq, sk, h, kv, d, qpos, kpos, causal, window = _emulation_cases()[case]
    q, k, v = (_t(x) for x in _qkv(len(case), b, sq, sk, h, kv, d))
    qpos = _t(np.arange(sq) if qpos is None else qpos, torch.int32)
    kpos = _t(np.arange(sk) if kpos is None else kpos, torch.int32)
    return q, k, v, qpos, kpos, causal, window


@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("case", sorted(_emulation_cases()))
def test_kernel_tile_loop_emulation_matches_plain(case, tiling):
    args = _emulation_inputs(case)
    want = fa.flash_attention_plain(*args)
    got = _emulate_kernel(*args, tiling=tiling)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case,unmasked,second_passes", [
    # 2 + 4 + 6 + 8 (group, tile) pairs of q blocks 1-4 see whole earlier
    # tiles; the last tile (88 keys) is never whole
    ("causal 600", 20, 0),
    ("padding", 0, 1),         # rows 0-4 see no key; block 0 skips tile 1
    ("reversed keys", 0, 0),   # positions only: the tiles' ranges overlap
])
def test_wgmma_tiling_takes_unmasked_tiles_and_the_second_pass(
        case, unmasked, second_passes):
    """The new tiling's two paths are taken where they should be, and only
    there: tiles without a mask (decided from positions, never indices)
    and the vote-driven second pass."""
    stats = {}
    args = _emulation_inputs(case)
    got = _emulate_kernel(*args, tiling="wgmma", stats=stats)
    torch.testing.assert_close(got, fa.flash_attention_plain(*args),
                               atol=F32_TOL, rtol=F32_TOL)
    assert stats == dict(unmasked=unmasked, second_passes=second_passes)


def _full_cache_kpos():
    """A 2,081-slot cache filled with positions 0..2048."""
    kpos = np.full(2081, -1, np.int32)
    kpos[:2049] = np.arange(2049)
    return kpos


def _full_cache_case(seed):
    """One query at position 2048 against a 2,081-slot cache filled to
    2048, phi3's heads and head dim, bf16."""
    q, k, v = (_t(x, torch.bfloat16)
               for x in _qkv(seed, 4, 1, 2081, 32, 32, 96))
    return (q, k, v, torch.tensor([2048], dtype=torch.int32),
            _t(_full_cache_kpos(), torch.int32))


@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("case", ["causal 256 d64", "one query, full cache"])
def test_bf16_agreement_takes_the_kernels_rounding(case, tiling):
    """The kernel's tile loop in bf16 (p rounded to bf16 before P·V) is
    within the bound that the card's checks hold the kernel to."""
    if case == "one query, full cache":
        q, k, v, qpos, kpos = _full_cache_case(21)
    else:
        q, k, v = (_t(x, torch.bfloat16)
                   for x in _qkv(22, 2, 256, 256, 4, 4, 64))
        qpos = kpos = torch.arange(256, dtype=torch.int32)
    got = _emulate_kernel(q, k, v, qpos, kpos, True, None, tiling=tiling)
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
    assert fa.launches == dict.fromkeys(fa.ROUTES, 0)
    with pytest.raises(ValueError):  # the CUDA entry refuses CPU tensors
        fa.flash_attention_cuda(q, k, v, torch.arange(8), torch.arange(8))
    # a meta tensor takes the card's route to the operator's fake: the
    # kernel's output layout, no launch; the launch itself refuses it
    out = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.is_meta and out.shape == q.shape and out.is_contiguous()
    assert fa.launches == dict.fromkeys(fa.ROUTES, 0)
    with pytest.raises(RuntimeError, match="fake or meta"):
        fa._forward_launch(q.to("meta"), k.to("meta"), v.to("meta"),
                           torch.arange(8, dtype=torch.int32, device="meta"),
                           torch.arange(8, dtype=torch.int32, device="meta"),
                           True, None, False)


def test_kernel_arg_checks_refuse_what_the_kernel_does_not_take():
    pos = torch.arange(8, dtype=torch.int32)
    bad = {
        "head dim 24": (torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 24)),
        # the reduced minicpm3's MLA: 8 + 4
        "head dim 12": (torch.zeros(1, 8, 2, 12), torch.zeros(1, 8, 2, 12)),
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_cuda_route_by_dtype_and_head_dim(d, dtype):
    """float32 stays on the CUDA cores; bf16 takes the wgmma kernel at the
    served head dims 64, 80, 96 and 128, the mma.sync kernel at 16 and
    32."""
    dt = getattr(torch, dtype)
    want = ("fp32" if dt == torch.float32
            else "wgmma" if d in (64, 80, 96, 128) else "mma")
    assert fa.cuda_route(dt, d) == want
    assert want in fa.ROUTES


def test_cuda_route_and_strides_refuse_or_fill_what_they_must():
    for dt, d in ((torch.bfloat16, 24), (torch.float16, 64)):
        with pytest.raises(ValueError):
            fa.cuda_route(dt, d)
    # a dim of length 1 gets a packed stride: a tensor map takes only
    # positive multiples of 16 bytes, and its own stride is never used
    x = torch.zeros(1, 1, 1, 96, dtype=torch.bfloat16)
    assert fa._strides(x) == (96, 96, 96)
    x = torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fa._strides(x.transpose(1, 2)) == (960, 192, 64)
    assert fa._readable(x) and not fa._readable(x[..., 1:9])
    assert not fa._readable(torch.zeros(1, 4, 1, 64).to(
        torch.bfloat16).expand(2, 4, 3, 64))


# -- the CUDA kernels against their plain version (card only) ---------------

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
        "d96 one query, full cache": (2, 1, 2081, 4, 4, 96,
                                      np.array([2048]), _full_cache_kpos(),
                                      True, None),
        "d64 window": (1, 300, 300, 2, 2, 64, None, None, True, 70),
        "d128 padding": (1, 300, 300, 2, 2, 128, pad_q, pad_k, True, None),
        # more work items than SMs: the persistent wgmma kernel's blocks
        # walk several items, some with a second pass
        "d96 padding, 512 items": (4, 512, 512, 32, 32, 96,
                                   *_padded_positions(512, 512), True, None),
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_wgmma_kernel_serves_bf16_at_its_head_dims(cuda_device, d):
    """The wgmma kernel within the bf16 bound of the plain version and
    deterministic on a causal GQA case with a ragged last tile, each launch
    counted under its route; the mma.sync entry refuses bf16 at these d."""
    from repro_torch.kernels._build import library

    q, k, v = (_t(x, torch.bfloat16).to(cuda_device)
               for x in _qkv(d, 2, 333, 333, 4, 2, d))
    pos = torch.arange(333, dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, pos, pos, True, None)
    _assert_agrees(got, q, k, v, pos, pos, causal=True)
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, pos, pos, True,
                                                    None))
    assert fa.launches == dict(wgmma=2, mma=0, fp32=0)
    assert ops.launch_counts()["flash_attention"] == 2
    out = torch.empty_like(q)
    err = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        pos.data_ptr(), out.data_ptr(), None, fa.DTYPES[torch.bfloat16], 2, 4,
        2,
        333, 333, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1, 0,
        float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_wgmma_reads_strided_and_transposed_inputs(cuda_device, d):
    """The tensor maps take the caller's strides: views of a fused
    (B, S, 3, H, d) projection and of a (B, H, S, d) tensor give the
    output of contiguous copies, bit for bit."""
    rng = np.random.default_rng(d)
    qkv = _t(rng.standard_normal((2, 200, 3, 4, d)).astype(np.float32),
             torch.bfloat16).to(cuda_device)
    views = [qkv[:, :, i] for i in range(3)]
    bhsd = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in views]
    want = ops.flash_attention(*(x.contiguous() for x in views), causal=True)
    assert torch.equal(ops.flash_attention(*views, causal=True), want)
    assert torch.equal(ops.flash_attention(*bhsd, causal=True), want)


# -- the gradient: the plain backward, the banded window, the kernel --------
# The plain version's gradient (`flash_attention_backward_plain`, autograd
# through it) against jax.vjp of the reference's oracle and of its model
# path `_masked_softmax_attend`, in float32: atol = rtol = BWD_TOL (each
# gradient sums up to 128 products in another order, on top of the
# forward's 2e-5). `_masked_softmax_attend` has no key padding, so it
# takes the cases without -1 positions.
BWD_TOL = 5e-5


def _bwd_cases():
    """(b, sq, sk, h, kv, d, qpos, kpos, causal, window) per name."""
    qpad, kpad = _padded_positions(96, 96)
    return {
        "causal": (2, 64, 64, 4, 4, 16, None, None, True, None),
        "bidirectional": (2, 48, 48, 2, 2, 32, None, None, False, None),
        "window": (1, 96, 96, 4, 2, 16, None, None, True, 24),
        "GQA 6/2": (1, 64, 64, 6, 2, 16, None, None, True, None),
        "MQA 4/1 window": (2, 64, 64, 4, 1, 16, None, None, True, 16),
        "Sq != Sk": (2, 40, 104, 4, 2, 16, np.arange(64, 104), None, True,
                     None),
        "padding, empty rows": (2, 96, 96, 4, 2, 16, qpad, kpad, True,
                                None),
        "padding, window": (1, 96, 96, 2, 2, 16, qpad, kpad, True, 20),
    }


def _bwd_inputs(name):
    b, sq, sk, h, kv, d, qpos, kpos, causal, window = _bwd_cases()[name]
    q, k, v = _qkv(len(name), b, sq, sk, h, kv, d)
    dout = np.random.default_rng(len(name) + 1).standard_normal(
        q.shape).astype(np.float32)
    qpos = np.arange(sq) if qpos is None else qpos
    kpos = np.arange(sk) if kpos is None else kpos
    return q, k, v, dout, qpos, kpos, causal, window


def _jax_vjp(J, fn, q, k, v, dout):
    import jax

    _, vjp = jax.vjp(fn, *(J.jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(J.jnp.asarray(dout))]


def _plain_grads(q, k, v, dout, qpos, kpos, causal, window):
    return [g.numpy() for g in fa.flash_attention_backward_plain(
        _t(dout), _t(q), _t(k), _t(v), _t(qpos, torch.int32),
        _t(kpos, torch.int32), causal, window)]


@pytest.mark.parametrize("case", sorted(_bwd_cases()))
def test_plain_backward_matches_jax_vjp_of_oracle(J, case):
    q, k, v, dout, qpos, kpos, causal, window = _bwd_inputs(case)
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    jnp = J.jnp

    def oracle(q, k, v):
        kr, vr = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        bhsd = lambda x: x.transpose(0, 2, 1, 3).reshape(  # noqa: E731
            b * h, x.shape[1], d)
        o = J.ref.flash_attention_ref(
            bhsd(q), bhsd(kr), bhsd(vr), jnp.asarray(qpos, jnp.int32),
            jnp.asarray(kpos, jnp.int32), causal=causal, window=window)
        return o.reshape(b, h, sq, d).transpose(0, 2, 1, 3)

    want = _jax_vjp(J, oracle, q, k, v, dout)
    got = _plain_grads(q, k, v, dout, qpos, kpos, causal, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)
    if "empty" in case:  # rows with no visible key give dq = 0
        empty = ~fa.visible_mask(_t(qpos, torch.int32),
                                 _t(kpos, torch.int32), causal,
                                 window).any(-1).numpy()
        assert empty.any() and not got[0][:, empty].any()


@pytest.mark.parametrize("case", [c for c in sorted(_bwd_cases())
                                  if "padding" not in c])
def test_plain_backward_matches_jax_vjp_of_model_path(J, case):
    from repro.models.attention import _masked_softmax_attend

    q, k, v, dout, qpos, kpos, causal, window = _bwd_inputs(case)
    b, kv, d = q.shape[0], k.shape[2], q.shape[3]
    jq = J.jnp.broadcast_to(J.jnp.asarray(qpos), (b, len(qpos)))
    jk = J.jnp.broadcast_to(J.jnp.asarray(kpos), (b, len(kpos)))
    want = _jax_vjp(J, lambda q, k, v: _masked_softmax_attend(
        q, k, v, kv, d ** -0.5, jq, jk, causal, window), q, k, v, dout)
    got = _plain_grads(q, k, v, dout, qpos, kpos, causal, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,s,h,kv,d,w", [
    (2, 128, 4, 2, 16, 32),
    (1, 96, 2, 1, 8, 16),
    (2, 64, 4, 4, 32, 32),
    (1, 256, 8, 2, 8, 64),
])
def test_banded_swa_matches_reference(J, b, s, h, kv, d, w):
    """The plain version's windowed branch takes the reference's banded
    path (tests/test_attention_paths.py:18's shapes) and equals the
    reference's `_banded_swa` and its gradient (atol = rtol = 2e-5 and
    BWD_TOL), and the dense plain version."""
    from repro.models.attention import _banded_swa

    q, k, v = _qkv(s + w, b, s, s, h, kv, d)
    pos = np.arange(s)
    tpos = _t(pos, torch.int32)
    assert fa._banded(_t(q), _t(k), tpos, tpos, True, w)
    got = fa.flash_attention_plain(_t(q), _t(k), _t(v), tpos, tpos, True, w)
    jpos = J.jnp.broadcast_to(J.jnp.asarray(pos), (b, s))
    fn = lambda q, k, v: _banded_swa(  # noqa: E731
        q, k, v, jpos, kv, d ** -0.5, w)
    want = np.asarray(fn(*(J.jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    dense = fa._attend_plain(_t(q), _t(k), _t(v), tpos, tpos, True, w)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)
    dout = np.random.default_rng(s).standard_normal(q.shape).astype(
        np.float32)
    for name, a, wg in zip(("dq", "dk", "dv"),
                           _plain_grads(q, k, v, dout, pos, pos, True, w),
                           _jax_vjp(J, fn, q, k, v, dout)):
        np.testing.assert_allclose(a, wg, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)


def test_banded_condition_is_the_references():
    """Banded only for causal self-attention over 0..S-1 with S % w == 0
    and S >= 2w; anything else takes the dense plain version."""
    q, k, _ = (_t(x) for x in _qkv(1, 1, 64, 64, 2, 2, 8))
    pos = torch.arange(64, dtype=torch.int32)
    assert fa._banded(q, k, pos, pos, True, 32)
    assert not fa._banded(q, k, pos, pos, True, 48)    # S % w != 0
    assert not fa._banded(q, k, pos, pos, True, 64)    # S < 2w
    assert not fa._banded(q, k, pos, pos, False, 16)   # bidirectional
    assert not fa._banded(q, k, pos, pos, True, None)
    assert not fa._banded(q, k, pos + 1, pos + 1, True, 16)
    assert not fa._banded(q[:, :32], k, pos[:32], pos, True, 16)


def test_cpu_autograd_differentiates_the_plain_version():
    """On a CPU tensor `ops.flash_attention` is the plain version, which
    autograd differentiates (no kernel, no count)."""
    q, k, v, dout, qpos, kpos, causal, window = _bwd_inputs("GQA 6/2")
    ops.reset_launch_counts()
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    out.backward(_t(dout))
    want = _plain_grads(q, k, v, dout, qpos, kpos, causal, window)
    for x, w in zip(leaves, want):
        np.testing.assert_array_equal(x.grad.numpy(), w)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


def test_backward_kernel_refuses_what_it_does_not_take():
    """The CUDA backward's checks run before any launch: CPU tensors, a
    head dim outside HEAD_DIMS, mismatched out / dout."""
    q, k, v = (_t(x) for x in _qkv(2, 1, 8, 8, 2, 2, 16))
    pos = torch.arange(8, dtype=torch.int32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        fa.flash_attention_backward_cuda(q, q, k, v, q, pos, pos, lse=lse)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError):     # a head dim no kernel takes
        fa.flash_attention_backward_cuda(
            *(torch.zeros(1, 8, 2, 24, device="meta"),) * 5, pos.to("meta"),
            pos.to("meta"), lse=lse.to("meta"))
    # meta tensors take the operator's fake: the kernels' contiguous
    # outputs and no launch; the launch itself refuses them
    grads = fa.flash_attention_backward_cuda(meta[0], *meta, meta[0],
                                             pos.to("meta"), pos.to("meta"),
                                             lse=lse.to("meta"))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert fa.bwd_launches == dict.fromkeys(fa.BWD_ROUTES, 0)
    with pytest.raises(RuntimeError, match="fake or meta"):
        fa._backward_launch(meta[0], *meta, meta[0], pos.to("meta"),
                            pos.to("meta"), lse.to("meta"), True, None)


def test_backward_refuses_a_missing_lse():
    """The backward takes the forward's LSE; nothing recomputes it, so a
    call without one raises before any other check."""
    q, k, v = (_t(x) for x in _qkv(3, 1, 8, 8, 2, 2, 64))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward_cuda(q, q, k, v, q, pos, pos)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward_cuda(q, q, k, v, q, pos, pos, True, None,
                                         None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_cuda_bwd_route_by_dtype_and_head_dim(d, dtype):
    """bf16 at d 64, 80, 96, 128 takes the wgmma backward (two kernels,
    no row-stats pass); bf16 at 16 and 32 the mma.sync one; float32 the
    CUDA cores'. A dtype or head dim without a kernel raises."""
    dt = getattr(torch, dtype)
    want = ("fp32" if dt == torch.float32
            else "wgmma" if d in (64, 80, 96, 128) else "mma")
    assert fa.cuda_bwd_route(dt, d) == want
    assert fa.BWD_ROUTES["wgmma"] == fa.BWD_KERNELS == (
        "fa_bwd_dq_wgmma", "fa_bwd_dkv_wgmma")
    assert all(n.startswith("fa_bwd_") and "stats" not in n
               for names in fa.BWD_ROUTES.values() for n in names)
    for dt2, d2 in ((torch.bfloat16, 24), (torch.float16, 64)):
        with pytest.raises(ValueError):
            fa.cuda_bwd_route(dt2, d2)


# -- the forward's LSE and the wgmma backward's loops, on the CPU ------------
# `flash_attention_lse_plain` against jax.nn.logsumexp of the oracle's
# scores: both sum the same fp32 exponentials, in another order, so at
# F32_TOL; a row with no visible key is +inf (the kernels' marker).

def _oracle_scores_lse(J, q, k, qpos, kpos, causal, window):
    """jax.nn.logsumexp of the scores `repro.kernels.ref.
    flash_attention_ref` forms, (B, H, Sq), with the kv heads repeated as
    the reference's ops wrapper does."""
    import jax

    jnp = J.jnp
    b, sq, h, d = q.shape
    kr = np.repeat(k, h // k.shape[2], axis=2)
    qb = jnp.asarray(q.transpose(0, 2, 1, 3).reshape(b * h, sq, d))
    kb = jnp.asarray(kr.transpose(0, 2, 1, 3).reshape(b * h, -1, d))
    s = jnp.einsum("bqd,bkd->bqk", qb, kb) * d ** -0.5
    qp, kp = jnp.asarray(qpos, jnp.int32), jnp.asarray(kpos, jnp.int32)
    mask = (kp >= 0)[None, None, :]
    if causal:
        mask = mask & (kp[None, None, :] <= qp[None, :, None])
    if window is not None:
        mask = mask & (kp[None, None, :] > qp[None, :, None] - window)
    s = jnp.where(mask, s, J.ref.NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(b, h, sq)


@pytest.mark.parametrize("case", sorted(_bwd_cases()))
def test_lse_plain_matches_jax_logsumexp(J, case):
    q, k, _, _, qpos, kpos, causal, window = _bwd_inputs(case)
    got = fa.flash_attention_lse_plain(_t(q), _t(k), _t(qpos, torch.int32),
                                       _t(kpos, torch.int32), causal,
                                       window).numpy()
    want = _oracle_scores_lse(J, q, k, qpos, kpos, causal, window)
    empty = ~fa.visible_mask(_t(qpos, torch.int32), _t(kpos, torch.int32),
                             causal, window).any(-1).numpy()
    assert got.shape == want.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert np.isposinf(got[:, :, empty]).all()
    assert (want[:, :, empty] < -1e29).all()  # the oracle's -1e30 row
    np.testing.assert_allclose(got[:, :, ~empty], want[:, :, ~empty],
                               atol=F32_TOL, rtol=F32_TOL)
    assert ("padding" in case) == bool(empty.any())


# The wgmma backward's loops (csrc/flash_attention_bwd_sm90.cu): dQ per
# 128-query item in two warpgroups of 64 rows over 128-key tiles; dK/dV per
# 128-key item in two warpgroups of 64 keys over 64-query tiles of each
# query head of the group in order. Tiles are skipped from position ranges
# alone; a query tile holding a row whose LSE is +inf is never skipped by
# dK/dV; a warpgroup takes a tile without a mask where positions show every
# pair visible. P comes from the given LSE in log2 units.
BWD_TILING = dict(dq_rows=128, dq_keys=128, dkv_keys=128, dkv_rows=64,
                  groups=2)
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _may_see(qmin, qmax, kmin, kmax, causal, window):
    return (kmax is not None and not (causal and kmin > qmax)
            and not (window is not None and kmax <= qmin - window))


def _emulate_backward(q, k, v, dout, out, lse, qpos, kpos, causal, window,
                      tiling=BWD_TILING, round_bf16=False, stats=None):
    """The two kernels' loops in PyTorch on float32 tensors: returns
    (dq, dk, dv). With round_bf16, P and dS are rounded to bf16 before
    their products, as the kernels do. `stats`, a dict, counts the tiles
    each kernel takes, skips, and takes without a mask, and the query
    tiles dK/dV keeps only for a row with no visible key."""
    t = tiling
    stats = {} if stats is None else stats
    for key in ("dq_tiles", "dq_skipped", "dq_unmasked", "dkv_tiles",
                "dkv_skipped", "dkv_kept_for_empty", "dkv_unmasked"):
        stats.setdefault(key, 0)
    rnd = _bf16 if round_bf16 else (lambda x: x)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    qp, kp = qpos.long(), kpos.long()
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)  # b h sq
    lse2 = lse * LOG2E
    dq = torch.zeros(b, sq, h, d)
    dk = torch.zeros(b, sk, kvh, d)
    dv = torch.zeros(b, sk, kvh, d)

    def vis(qrows, keys):
        return fa.visible_mask(qp[qrows], kp[keys], causal, window)

    def prange(pos):
        valid = pos[pos >= 0]
        if valid.numel() == 0:
            return None, None
        return int(valid.min()), int(valid.max())

    # dQ: the items' rows, in two groups of 64, over 128-key tiles
    for q0 in range(0, sq, t["dq_rows"]):
        rows = torch.arange(q0, min(q0 + t["dq_rows"], sq))
        qmin, qmax = int(qp[rows].min()), int(qp[rows].max())
        for k0 in range(0, sk, t["dq_keys"]):
            keys = torch.arange(k0, min(k0 + t["dq_keys"], sk))
            kmin, kmax = prange(kp[keys])
            if not _may_see(qmin, qmax, kmin, kmax, causal, window):
                stats["dq_skipped"] += b * h
                continue
            stats["dq_tiles"] += b * h
            every = (len(keys) == t["dq_keys"] and bool((kp[keys] >= 0).all()))
            gsize = t["dq_rows"] // t["groups"]
            for r0 in range(0, len(rows), gsize):
                grows = rows[r0:r0 + gsize]
                gmin, gmax = int(qp[grows].min()), int(qp[grows].max())
                unmasked = every and (not causal or kmax <= gmin) and (
                    window is None or kmin > gmax - window)
                stats["dq_unmasked"] += b * h * unmasked
                for hh in range(h):
                    hk = hh // g
                    s = torch.einsum("bqd,btd->bqt", q[:, grows, hh],
                                     k[:, keys, hk])
                    p = torch.exp2(s * (scale * LOG2E)
                                   - lse2[:, hh, grows][..., None])
                    if not unmasked:
                        p = torch.where(vis(grows, keys), p, 0.0)
                    dp = torch.einsum("bqd,btd->bqt", dout[:, grows, hh],
                                      v[:, keys, hk])
                    ds = rnd(p * (dp - delta[:, hh, grows][..., None]))
                    dq[:, grows, hh] += torch.einsum("bqt,btd->bqd", ds,
                                                     k[:, keys, hk])
    dq *= scale

    # dK/dV: 128-key items in two groups of 64 keys; 64-query tiles of each
    # query head of the group, in order
    nt = t["dkv_rows"]
    for k0 in range(0, sk, t["dkv_keys"]):
        keys = torch.arange(k0, min(k0 + t["dkv_keys"], sk))
        kmin, kmax = prange(kp[keys])
        for hk in range(kvh):
            for hh in range(hk * g, hk * g + g):
                for q0 in range(0, sq, nt):
                    rows = torch.arange(q0, min(q0 + nt, sq))
                    qmin, qmax = int(qp[rows].min()), int(qp[rows].max())
                    empty_rows = torch.isinf(lse[:, hh, rows])  # (b, rows)
                    empty = bool(empty_rows.any())
                    if not _may_see(qmin, qmax, kmin, kmax, causal, window):
                        if not empty:
                            stats["dkv_skipped"] += b
                            continue
                        stats["dkv_kept_for_empty"] += b
                    stats["dkv_tiles"] += b
                    gsize = t["dkv_keys"] // t["groups"]
                    for c0 in range(0, t["dkv_keys"], gsize):
                        # the warpgroup's keys; those past Sk are no keys
                        gk = torch.arange(k0 + c0, k0 + c0 + gsize)
                        real = gk[gk < sk]
                        gkp = torch.cat([kp[real], torch.full(
                            (gsize - len(real),), -1, dtype=kp.dtype)])
                        gmin, gmax = prange(gkp)
                        unmasked = bool((gkp >= 0).all()) and not empty and (
                            not causal or gmax <= qmin) and (
                            window is None or gmin > qmax - window)
                        stats["dkv_unmasked"] += b * unmasked
                        if len(real) == 0:
                            continue
                        s = torch.einsum("btd,bqd->btq", k[:, real, hk],
                                         q[:, rows, hh])
                        p = torch.exp2(s * (scale * LOG2E)
                                       - lse2[:, hh, rows][:, None, :])
                        if not unmasked:
                            m = fa.visible_mask(qp[rows], gkp[:len(real)],
                                                causal, window).T
                            p = torch.where(m, p, 0.0)
                        # a row with no visible key: P = 1/Sk, dS = 0
                        none = empty_rows[:, None, :]
                        p = torch.where(none, 1.0 / sk, p)
                        dp = torch.einsum("btd,bqd->btq", v[:, real, hk],
                                          dout[:, rows, hh])
                        ds = torch.where(
                            none, 0.0,
                            p * (dp - delta[:, hh, rows][:, None, :]))
                        dv[:, real, hk] += torch.einsum(
                            "btq,bqd->btd", rnd(p), dout[:, rows, hh])
                        dk[:, real, hk] += torch.einsum(
                            "btq,bqd->btd", rnd(ds), q[:, rows, hh])
    dk *= scale
    return dq, dk, dv


def _bwd_inputs_at(name, d):
    """`_bwd_inputs(name)` with head dim d (the same seeds)."""
    b, sq, sk, h, kv, _, qpos, kpos, causal, window = _bwd_cases()[name]
    q, k, v = _qkv(len(name), b, sq, sk, h, kv, d)
    dout = np.random.default_rng(len(name) + 1).standard_normal(
        q.shape).astype(np.float32)
    qpos = np.arange(sq) if qpos is None else qpos
    kpos = np.arange(sk) if kpos is None else kpos
    return q, k, v, dout, qpos, kpos, causal, window


def _emulated_grads(q, k, v, dout, qpos, kpos, causal, window, **kw):
    q, k, v, dout = (_t(x) for x in (q, k, v, dout))
    qp, kp = _t(qpos, torch.int32), _t(kpos, torch.int32)
    if kw.get("round_bf16"):  # the kernels' bf16 inputs and output
        q, k, v, dout = (_bf16(x) for x in (q, k, v, dout))
        out = _bf16(fa.flash_attention_plain(q, k, v, qp, kp, causal, window))
    else:
        out = fa.flash_attention_plain(q, k, v, qp, kp, causal, window)
    lse = fa.flash_attention_lse_plain(q, k, qp, kp, causal, window)
    grads = _emulate_backward(q, k, v, dout, out, lse, qp, kp, causal,
                              window, **kw)
    return grads, (q, k, v, dout, qp, kp)


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(_bwd_cases()))
def test_wgmma_backward_emulation_matches_plain_and_jax(J, case, d):
    """The wgmma backward's loops against the plain backward and JAX's vjp
    of the oracle: exact arithmetic (no rounding) at BWD_TOL; with P and
    dS rounded to bf16 on bf16 inputs, within the card's bf16 bound (a
    relative L2 of 1e-2 per tensor against the plain backward on the same
    inputs)."""
    args = _bwd_inputs_at(case, d)
    q, k, v, dout, qpos, kpos, causal, window = args
    got, _ = _emulated_grads(*args)
    plain = _plain_grads(*args)
    b, sq, h, _ = q.shape
    g = h // k.shape[2]
    jnp = J.jnp

    def oracle(q, k, v):
        kr, vr = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        bhsd = lambda x: x.transpose(0, 2, 1, 3).reshape(  # noqa: E731
            b * h, x.shape[1], d)
        o = J.ref.flash_attention_ref(
            bhsd(q), bhsd(kr), bhsd(vr), jnp.asarray(qpos, jnp.int32),
            jnp.asarray(kpos, jnp.int32), causal=causal, window=window)
        return o.reshape(b, h, sq, d).transpose(0, 2, 1, 3)

    want = _jax_vjp(J, oracle, q, k, v, dout)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        np.testing.assert_allclose(a.numpy(), p, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), w, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)
    rounded, (qb, kb, vb, gb, qp, kp) = _emulated_grads(*args,
                                                        round_bf16=True)
    exact = fa.flash_attention_backward_plain(gb, qb, kb, vb, qp, kp, causal,
                                              window)
    for name, a, w in zip(("dq", "dk", "dv"), rounded, exact):
        rel = float(torch.linalg.vector_norm(a - w)
                    / torch.linalg.vector_norm(w))
        assert rel <= 1e-2, (name, rel)


def _skip_case(name):
    """A forward emulation case (`_emulation_cases`) at d = 64 with an
    output gradient."""
    b, sq, sk, h, kv, _, qpos, kpos, causal, window = \
        _emulation_cases()[name]
    q, k, v = _qkv(len(name), b, sq, sk, h, kv, 64)
    dout = np.random.default_rng(len(name)).standard_normal(
        q.shape).astype(np.float32)
    qpos = np.arange(sq) if qpos is None else qpos
    kpos = np.arange(sk) if kpos is None else kpos
    return q, k, v, dout, qpos, kpos, causal, window


@pytest.mark.parametrize("case,want", [
    # 2 heads of 600 causal rows: dQ items 0..4 see 1..5 of the 5 key
    # tiles (30 taken, 20 skipped); their warpgroups see 0, 2, 4, 6, 8
    # whole earlier tiles; dK/dV key tiles 0..4 see 10, 8, 6, 4, 2 of the
    # 10 query tiles (60 taken, 40 skipped), 45 warpgroup tiles a head
    # whole (keys 0..575 in 9 groups of 64)
    ("causal 600", dict(dq_tiles=30, dq_skipped=20, dq_unmasked=40,
                        dkv_tiles=60, dkv_skipped=40, dkv_kept_for_empty=0,
                        dkv_unmasked=90)),
    # rows 0-4 see no key: query tile 0 is kept against key tile 1 (keys
    # from 128), which no row of it sees; tile 1 (rows 64-127) is skipped;
    # keys 64-127 are whole for query tiles 2 and 3, keys 128-191 for 3
    ("padding", dict(dq_tiles=6, dq_skipped=2, dq_unmasked=0, dkv_tiles=14,
                     dkv_skipped=2, dkv_kept_for_empty=2, dkv_unmasked=6)),
    # reversed key positions: every tile's range overlaps, nothing skipped;
    # keys 64-127 (positions 65 down to 2) are whole for query tile 2 alone
    ("reversed keys", dict(dq_tiles=8, dq_skipped=0, dq_unmasked=0,
                           dkv_tiles=12, dkv_skipped=0, dkv_kept_for_empty=0,
                           dkv_unmasked=2)),
])
def test_wgmma_backward_skips_by_positions_and_keeps_empty_rows(case, want):
    """The skip rules of both kernels, the keeping of a query tile that
    holds a row with no visible key, and the tiles taken without a mask,
    counted; the result still equals the plain backward at BWD_TOL."""
    args = _skip_case(case)
    stats = {}
    got, _ = _emulated_grads(*args, stats=stats)
    for name, a, w in zip(("dq", "dk", "dv"), got, _plain_grads(*args)):
        np.testing.assert_allclose(a.numpy(), w, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)
    assert stats == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_bwd_cases()))
def test_cuda_backward_kernel_equals_plain(cuda_device, case, dtype):
    """The backward kernel against the plain backward on the card: fp32
    at 1e-4 x max |grad|, bf16 at a relative L2 of 1e-2 against the fp32
    plain backward on the same bf16 inputs; two runs bit-equal; one
    launch counted per backward through `ops.flash_attention`."""
    q, k, v, dout, qpos, kpos, causal, window = _bwd_inputs(case)
    dt = getattr(torch, dtype)
    q, k, v, dout = (_t(x, dt).to(cuda_device) for x in (q, k, v, dout))
    qpos, kpos = (_t(x, torch.int32).to(cuda_device) for x in (qpos, kpos))
    out, lse = fa.flash_attention_cuda(q, k, v, qpos, kpos, causal, window,
                                       return_lse=True)
    got = fa.flash_attention_backward_cuda(dout, q, k, v, out, qpos, kpos,
                                           causal, window, lse=lse)
    again = fa.flash_attention_backward_cuda(dout, q, k, v, out, qpos, kpos,
                                             causal, window, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_backward_plain(
        dout.float(), q.float(), k.float(), v.float(), qpos, kpos, causal,
        window)
    for a, w in zip(got, want):
        diff = (a.float() - w).abs()
        if dt == torch.float32:
            assert float(diff.max()) <= 1e-4 * float(w.abs().max())
        else:
            assert float(torch.linalg.vector_norm(diff)
                         / torch.linalg.vector_norm(w)) <= 1e-2
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = ops.launch_counts()["flash_attention_bwd"]
    res = ops.flash_attention(*leaves, causal=causal, window=window,
                              qpos=qpos, kpos=kpos)
    assert res.grad_fn is not None
    res.backward(dout)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    for x, a in zip(leaves, got):
        assert torch.equal(x.grad, a)


LSE_TOL = 1e-4  # atol = rtol: fp32 sums of exponentials in another order,
                # and the wgmma kernel's approximate exp2 and log2 units


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_cuda_cases()))
def test_cuda_forward_lse_equals_plain(cuda_device, case, dtype):
    """Every forward route writes each row's LSE, within LSE_TOL of
    `flash_attention_lse_plain` on the same inputs and +inf exactly where
    a row sees no key; asking for it leaves the output bit-equal."""
    b, sq, sk, h, kv, d, qpos, kpos, causal, window = _cuda_cases()[case]
    dt = getattr(torch, dtype)
    q, k, v = (_t(x, dt).to(cuda_device)
               for x in _qkv(len(case), b, sq, sk, h, kv, d))
    qpos = _t(np.arange(sq) if qpos is None else qpos,
              torch.int32).to(cuda_device)
    kpos = _t(np.arange(sk) if kpos is None else kpos,
              torch.int32).to(cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, qpos, kpos, causal, window,
                                       return_lse=True)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, qpos, kpos,
                                                    causal, window))
    want = fa.flash_attention_lse_plain(q, k, qpos, kpos, causal, window)
    assert lse.shape == want.shape == (b, h, sq)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(lse[fin], want[fin], atol=LSE_TOL,
                               rtol=LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("case", sorted(_bwd_cases()))
def test_cuda_wgmma_backward_at_its_head_dims(cuda_device, case, d):
    """The bf16 backward at the wgmma head dims: within a relative L2 of
    1e-2 per tensor of the fp32 plain backward on the same bf16 inputs,
    two runs bit-equal, one call counted under the wgmma route."""
    q, k, v, dout, qpos, kpos, causal, window = _bwd_inputs_at(case, d)
    q, k, v, dout = (_t(x, torch.bfloat16).to(cuda_device)
                     for x in (q, k, v, dout))
    qpos, kpos = (_t(x, torch.int32).to(cuda_device) for x in (qpos, kpos))
    out, lse = fa.flash_attention_cuda(q, k, v, qpos, kpos, causal, window,
                                       return_lse=True)
    before = dict(fa.bwd_launches)
    got = fa.flash_attention_backward_cuda(dout, q, k, v, out, qpos, kpos,
                                           causal, window, lse=lse)
    assert fa.bwd_launches["wgmma"] == before["wgmma"] + 1
    again = fa.flash_attention_backward_cuda(dout, q, k, v, out, qpos, kpos,
                                             causal, window, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_backward_plain(
        dout.float(), q.float(), k.float(), v.float(), qpos, kpos, causal,
        window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        rel = float(torch.linalg.vector_norm(a.float() - w)
                    / torch.linalg.vector_norm(w))
        assert rel <= 1e-2, (name, rel)
