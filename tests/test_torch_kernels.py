"""The port's kernels and sorts against the JAX package, on the CPU.

The plain versions of the ported kernels (`repro_torch.kernels`) are
held against the Pallas kernels run in interpret mode and against their
jnp oracles (the spmv's are in `tests/test_torch_spectral_probe.py`);
the port's radix sorts against `repro.core.sort` with both of its
engines (the argsorts' edge cases, and the radix kernels on the card,
are in `tests/test_torch_radix.py`). Every output is an integer or a
permutation: tolerance zero (exact equality). The CUDA legs (marker
`cuda`) need a card and skip here; on the card the JAX legs skip
instead, since JAX is imported only by the `J` fixture.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import _host as H
from repro_torch.core import sort as tsort
from repro_torch.core import lgrass_sparsify
from repro_torch.core.graph import random_connected_graph
from repro_torch.core.lca import LiftingTables
from repro_torch.core.marking import GroupLayout
from repro_torch.kernels import (bitmap_intersect, ops, phase1, radix_hist,
                                 ref, tree_dist)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The JAX package's sorts and kernels (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import sort
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return types.SimpleNamespace(jnp=jnp, sort=sort, ops=jops, ref=jref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


# -- radix_hist: the per-byte rank and histogram ---------------------------

def _digit_cases():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, 300),
        "all_equal": np.full(300, 17),
        "one": np.array([255]),
        "two_digits": rng.integers(0, 2, 300) * 255,
    }


@pytest.mark.parametrize("case", sorted(_digit_cases()))
def test_bucket_rank_hist_plain_matches_pallas_and_ref(J, case):
    d = _digit_cases()[case].astype(np.int32)
    rank, hist = ops.bucket_rank_hist(torch.from_numpy(d))
    assert rank.dtype == torch.int32 and hist.dtype == torch.int32
    jr, jh = J.ops.bucket_rank_hist(J.jnp.asarray(d), chunk=128,
                                    interpret=True)
    rr, rh = J.ref.bucket_rank_hist_ref(J.jnp.asarray(d))
    for want_r, want_h in ((jr, jh), (rr, rh)):
        assert np.array_equal(rank.numpy(), np.asarray(want_r))
        assert np.array_equal(hist.numpy(), np.asarray(want_h))


def test_bucket_rank_hist_plain_empty_and_chunk_invariant():
    rank, hist = ops.bucket_rank_hist(torch.zeros(0, dtype=torch.int32))
    assert rank.shape == (0,) and hist.tolist() == [0] * 256
    d = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, 2500).astype(np.int32))
    r1, h1 = radix_hist.bucket_rank_hist_plain(d, chunk=1024)
    r2, h2 = radix_hist.bucket_rank_hist_plain(d, chunk=7)
    assert torch.equal(r1, r2) and torch.equal(h1, h2)


def test_ops_route_by_device_and_never_count_cpu_calls():
    ops.reset_launch_counts()
    ops.bucket_rank_hist(torch.zeros(10, dtype=torch.int32))
    keys = torch.tensor([3, 1, 2], dtype=torch.int64)
    assert ops.radix_argsort_u32(keys).tolist() == [1, 2, 0]
    assert ops.radix_argsort_u64pair(keys, keys).tolist() == [1, 2, 0]
    ops.bitmap_intersect_any(torch.ones((3, 2), dtype=torch.int32),
                             torch.ones((3, 2), dtype=torch.int32))
    lgrass_sparsify(random_connected_graph(12, 10, seed=0), budget=3,
                    device="cpu")  # MARK and REC, plain
    assert ops.launch_counts() == {
        "radix_hist": 0, "tree_dist": 0, "mark": 0, "rec": 0,
        "laplacian_spmv": 0, "arc_sum": 0, "bitmap_intersect": 0,
        "flash_attention": 0, "flash_attention_bwd": 0}
    # a meta tensor takes the card's route to the operator's fake, which
    # gives the kernel's outputs and launches nothing; the launch itself
    # refuses it
    rank, hist = ops.bucket_rank_hist(torch.zeros(10, dtype=torch.int32,
                                                  device="meta"))
    assert rank.shape == (10,) and hist.shape == (256,) and rank.is_meta
    perm = ops.radix_argsort_u32(torch.zeros(4, dtype=torch.int64,
                                             device="meta"))
    assert perm.shape == (4,) and perm.dtype == torch.int64
    assert ops.launch_counts()["radix_hist"] == 0
    with pytest.raises(RuntimeError, match="fake or meta"):
        radix_hist._rank_launch(torch.zeros(10, dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(ValueError):  # the CUDA entries refuse CPU tensors
        radix_hist.bucket_rank_hist_cuda(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        radix_hist.radix_argsort_cuda(keys)
    with pytest.raises(ValueError):
        radix_hist.radix_argsort_cuda(keys, keys)
    up = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tree_dist.tree_dist_pairs_cuda(up, up[0], up[0], up[0])
    with pytest.raises(ValueError):
        bitmap_intersect.bitmap_intersect_any_cuda(up, up)
    lift = LiftingTables(up=up, depth=up[0])
    with pytest.raises(ValueError):
        phase1.mark_cuda(lift, up[0], up[0], up[0], GroupLayout(
            up[0], up[0], up[0], up[0].bool(), up[0, 0]), 2)
    with pytest.raises(ValueError):
        phase1.recover_cuda(lift, *[up[0]] * 9, budget=2, b_cap=8)


def test_build_signatures_name_every_c_entry_point():
    """Each `extern "C"` function of csrc/*.cu has its ctypes signature in
    `_build.SIGNATURES`, with its number of arguments, and nothing else is
    listed (a name missing from the library fails only at load time); a
    function returning `long long` has that restype in `_build.RESTYPES`."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    found, wide = {}, set()
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        for m in re.finditer(r'extern "C" (int|long long) (\w+)\(([^)]*)\)',
                             src):
            args = [a for a in m.group(3).split(",") if a.strip()]
            found[m.group(2)] = len(args)
            if m.group(1) == "long long":
                wide.add(m.group(2))
    assert found == {k: len(v) for k, v in _build.SIGNATURES.items()}
    assert "radix_argsort_launch" in found and "radix_rank_launch" in found
    assert _build.RESTYPES == {k: ctypes.c_longlong for k in wide}


# -- sorts: the port's radix engine against repro.core.sort ----------------

def _f32_keys(m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=m).astype(np.float32)
    if m >= 8:
        x[: m // 4] = rng.choice([0.0, -0.0, 1.5, -2.0], m // 4)  # ties, ±0
        x[m // 4: m // 4 + 3] = -np.inf
    return x


@pytest.mark.parametrize("m", [0, 1, 1000])
def test_radix_argsort_u32_matches_reference(J, m):
    rng = np.random.default_rng(m)
    keys = rng.integers(0, 2 ** 32, m, dtype=np.uint32)
    if m >= 8:
        keys[::3] = keys[0]  # heavy ties: stability decides
    tk = torch.from_numpy(keys.astype(np.int64))
    for jeng in ("radix", "xla"):
        want = np.asarray(J.sort.radix_argsort_u32(J.jnp.asarray(keys),
                                                   engine=jeng))
        got = tsort.radix_argsort_u32(tk).numpy()
        assert np.array_equal(got, want), jeng


@pytest.mark.parametrize("m", [1, 1000])
def test_radix_argsort_u64pair_matches_reference(J, m):
    rng = np.random.default_rng(10 + m)
    hi = rng.integers(0, 4, m, dtype=np.uint32)
    lo = rng.integers(0, 2 ** 32, m, dtype=np.uint32)
    lo[::2] = 7
    for jeng in ("radix", "xla"):
        want = np.asarray(J.sort.radix_argsort_u64pair(
            J.jnp.asarray(hi), J.jnp.asarray(lo), engine=jeng))
        got = tsort.radix_argsort_u64pair(
            torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64))).numpy()
        assert np.array_equal(got, want), jeng


@pytest.mark.parametrize("m", [0, 1, 1000])
def test_sort_f32_desc_stable_matches_reference(J, m):
    x = _f32_keys(m, seed=m)
    valid = np.random.default_rng(m + 1).random(m) < 0.8
    want = np.asarray(J.sort.sort_f32_desc_stable(J.jnp.asarray(x)))
    want_v = np.asarray(J.sort.sort_f32_desc_stable(J.jnp.asarray(x),
                                                    J.jnp.asarray(valid)))
    assert np.array_equal(want, H.desc_stable_order_np(x))
    tx, tv = torch.from_numpy(x), torch.from_numpy(valid)
    assert np.array_equal(tsort.sort_f32_desc_stable(tx).numpy(), want)
    assert np.array_equal(tsort.sort_f32_desc_stable(tx, tv).numpy(), want_v)


def test_float32_sort_key_matches_reference(J):
    x = _f32_keys(64, seed=3)
    x[-1] = np.inf
    want = np.asarray(J.sort.float32_sort_key(J.jnp.asarray(x)))
    got = tsort.float32_sort_key(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("nb", [3, 256, 1000])
def test_bucket_ranks_matches_reference(J, nb):
    keys = np.random.default_rng(nb).integers(0, nb, 500).astype(np.int32)
    want = np.asarray(J.sort.bucket_ranks(J.jnp.asarray(keys), nb))
    got = tsort.bucket_ranks(torch.from_numpy(keys), nb).numpy()
    assert np.array_equal(got, want)


def test_block_view_pads_the_ragged_tail():
    x = torch.arange(5)
    assert tsort.block_view(x, 2, -1).tolist() == [[0, 1], [2, 3], [4, -1]]
    assert tsort.block_view(x[:0], 4, 0).shape == (0, 4)


# -- tree_dist: binary-lifting distances -----------------------------------

def _random_lifting(n, extra, seed):
    g = random_connected_graph(n, extra, seed=seed)
    u64, v64 = g.u.astype(np.int64), g.v.astype(np.int64)
    root = H.select_root_np(u64, v64, g.n)
    depth, parent = H.bfs_np(u64, v64, g.n, root)
    return H.build_lifting_np(parent, depth, g.n), depth


@pytest.mark.parametrize("m", [300, 257, 1])
def test_tree_dist_plain_matches_pallas(J, m):
    n = 60
    up, depth = _random_lifting(n, 2 * n, seed=4)
    rng = np.random.default_rng(m)
    a = rng.integers(0, n, m).astype(np.int32)
    b = rng.integers(0, n, m).astype(np.int32)
    jnp = J.jnp
    want = np.asarray(J.ops.tree_dist_pairs(
        jnp.asarray(up), jnp.asarray(depth), jnp.asarray(a), jnp.asarray(b),
        block=128, interpret=True))
    got = ops.tree_dist_pairs(torch.from_numpy(up), torch.from_numpy(depth),
                              torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), H.tree_dist_np(up, depth, a, b))
    assert np.array_equal(ref.tree_dist_pairs_ref(
        torch.from_numpy(up), torch.from_numpy(depth), torch.from_numpy(a),
        torch.from_numpy(b)).numpy(), want)


# -- bitmap_intersect: per-row AND != 0 ----------------------------------

def _bitmaps(l, w):
    """Two (l, w) uint32 bitmaps, the second sparse, as in
    tests/test_kernels.py."""
    rng = np.random.default_rng(l + w)
    m1 = rng.integers(0, 2 ** 32, (l, w), dtype=np.uint32)
    m2 = (rng.integers(0, 2 ** 32, (l, w), dtype=np.uint32)
          * (rng.random((l, w)) < 0.2)).astype(np.uint32)
    return m1, m2


@pytest.mark.parametrize("l,w", [(100, 1), (1024, 2), (2000, 4), (1, 3),
                                 (0, 4)])
def test_bitmap_intersect_plain_matches_pallas_and_ref(J, l, w):
    m1, m2 = _bitmaps(l, w)
    got = ops.bitmap_intersect_any(torch.from_numpy(m1.view(np.int32)),
                                   torch.from_numpy(m2.view(np.int32)))
    assert got.dtype == torch.bool and got.shape == (l,)
    jm1, jm2 = J.jnp.asarray(m1), J.jnp.asarray(m2)
    want = np.asarray(J.ref.bitmap_intersect_any_ref(jm1, jm2))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.bitmap_intersect_any_ref(
        torch.from_numpy(m1.view(np.int32)),
        torch.from_numpy(m2.view(np.int32))).numpy(), want)
    if l:  # the Pallas entry cannot slice an empty array
        assert np.array_equal(got.numpy(), np.asarray(
            J.ops.bitmap_intersect_any(jm1, jm2, interpret=True)))


def test_bitmap_intersect_sign_bit_counts():
    """Only AND != 0 matters: a shared top bit (negative as int32) is an
    intersection; disjoint words are not."""
    top = np.array([[0x80000000, 0]], np.uint32)
    low = np.array([[0x7FFFFFFF, 1]], np.uint32)
    t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    assert ops.bitmap_intersect_any(t(top), t(top)).tolist() == [True]
    assert ops.bitmap_intersect_any(t(top), t(low)).tolist() == [False]


# -- the CUDA kernels against their plain versions (card only) -------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 300, 8192])
def test_tree_dist_cuda_equals_plain(cuda_device, m):
    up, depth = _random_lifting(200, 400, seed=m)
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(0, 200, m).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 200, m).astype(np.int32))
    args = [torch.from_numpy(x).to(cuda_device) for x in (up, depth)] + [
        a.to(cuda_device), b.to(cuda_device)]
    got = ops.tree_dist_pairs(*args)
    want = tree_dist.tree_dist_pairs_plain(*args)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("l,w", [(0, 4), (1, 4), (36036, 1), (36036, 26),
                                 (4096, 128), (100, 33)])
def test_bitmap_intersect_cuda_equals_plain(cuda_device, l, w):
    m1, m2 = (torch.from_numpy(x.view(np.int32)).to(cuda_device)
              for x in _bitmaps(l, w))
    got = ops.bitmap_intersect_any(m1, m2)
    assert torch.equal(got, bitmap_intersect.bitmap_intersect_any_plain(
        m1, m2))
