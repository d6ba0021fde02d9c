"""The port's radix argsort against the JAX package and on the card.

On the CPU, the plain argsort (`kernels/radix_hist.radix_argsort_plain`,
what `ops.radix_argsort_u32` / `_u64pair` run on CPU tensors) is held
against the Pallas argsort in interpret mode and `repro.core.sort`'s two
engines, at tile edges of the CUDA kernel (2,048 keys), with all-equal
keys and with keys mixed with the 0xFFFFFFFF sentinel. On the card
(marker `cuda`, skipped here) the onesweep kernels of
`csrc/radix_hist.cu` are held against `torch.sort(stable=True)` and the
plain version on a CPU copy, at those sizes and the main path's, and
called back to back and at changing sizes. Every output is a
permutation or an integer count: equality, no tolerance.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import sort as tsort
from repro_torch.kernels import ops, radix_hist

torch.set_num_threads(1)

UMAX = 0xFFFFFFFF
CPU_SIZES = [0, 1, 2047, 2048, 2049, 5000]
CARD_SIZES = CPU_SIZES + [36036, 72072, 639998]
KINDS = ["random", "all_equal", "umax_mixed"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's sorts and kernels (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import sort
    from repro.kernels import ops as jops

    return types.SimpleNamespace(jnp=jnp, sort=sort, ops=jops)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def _u32_keys(m, kind, seed):
    """(m,) uint32 keys: random with ties, one value, or random with
    about a third of them the UMAX sentinel."""
    rng = np.random.default_rng(seed)
    if kind == "all_equal":
        return np.full(m, 0x9A5A5A5A, np.uint32)
    keys = rng.integers(0, 2 ** 32, m, dtype=np.uint32)
    if kind == "random":
        keys[::5] = keys[:1]  # ties: stability decides
    else:
        keys[rng.random(m) < 0.35] = UMAX
    return keys


def _pair_keys(m, kind, seed):
    """(hi, lo) uint32 pairs, shaped as the Euler arc sort's: hi from a
    small range (or UMAX for invalid slots), lo random."""
    rng = np.random.default_rng(seed)
    lo = _u32_keys(m, kind, seed + 1)
    if kind == "all_equal":
        return np.full(m, 7, np.uint32), lo
    hi = rng.integers(0, 300, m).astype(np.uint32)
    if kind == "umax_mixed":
        hi[rng.random(m) < 0.35] = UMAX
    return hi, lo


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _torch_pair_order(hi, lo):
    """The stable order of (hi, lo) pairs from two stable torch.sorts."""
    first = torch.sort(lo, stable=True).indices
    return first[torch.sort(hi[first], stable=True).indices]


# -- the plain argsort against the JAX package (CPU) ----------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", CPU_SIZES)
def test_radix_argsort_plain_u32_matches_reference(J, m, kind):
    keys = _u32_keys(m, kind, seed=m)
    got = radix_hist.radix_argsort_plain(_t(keys))
    assert got.dtype == torch.int64
    assert torch.equal(ops.radix_argsort_u32(_t(keys)), got)
    assert torch.equal(tsort.radix_argsort_u32(_t(keys)), got)
    jk = J.jnp.asarray(keys)
    for eng in ("radix", "xla"):
        want = np.asarray(J.sort.radix_argsort_u32(jk, engine=eng))
        assert np.array_equal(got.numpy(), want), eng
    if m:  # the Pallas entry cannot slice an empty array
        want = np.asarray(J.ops.radix_argsort_u32(jk, interpret=True))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", CPU_SIZES)
def test_radix_argsort_plain_pair_matches_reference(J, m, kind):
    hi, lo = _pair_keys(m, kind, seed=m)
    got = radix_hist.radix_argsort_plain(_t(lo), _t(hi))
    assert torch.equal(ops.radix_argsort_u64pair(_t(hi), _t(lo)), got)
    assert torch.equal(tsort.radix_argsort_u64pair(_t(hi), _t(lo)), got)
    for eng in ("radix", "xla"):
        want = np.asarray(J.sort.radix_argsort_u64pair(
            J.jnp.asarray(hi), J.jnp.asarray(lo), engine=eng))
        assert np.array_equal(got.numpy(), want), eng


def test_radix_argsort_plain_reads_only_the_low_word_pair_order():
    """The pair sort orders by hi first and keeps lo's order among equal
    hi; a u32 sort of lo alone is its first four passes."""
    hi = _t(np.array([1, 0, 1, 0], np.uint32))
    lo = _t(np.array([5, 9, 2, 9], np.uint32))
    assert radix_hist.radix_argsort_plain(lo, hi).tolist() == [1, 3, 2, 0]
    assert radix_hist.radix_argsort_plain(lo).tolist() == [2, 0, 1, 3]


# -- the onesweep kernels on the card --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", CARD_SIZES)
def test_radix_argsort_cuda_u32_equals_torch_sort_and_plain(cuda_device, m,
                                                            kind):
    keys = _t(_u32_keys(m, kind, seed=m))
    got = ops.radix_argsort_u32(keys.to(cuda_device))
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert torch.equal(got, torch.sort(keys.to(cuda_device),
                                       stable=True).indices)
    assert torch.equal(got.cpu(), radix_hist.radix_argsort_plain(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", CARD_SIZES)
def test_radix_argsort_cuda_pair_equals_torch_sort_and_plain(cuda_device, m,
                                                             kind):
    hi, lo = (_t(x) for x in _pair_keys(m, kind, seed=m))
    got = ops.radix_argsort_u64pair(hi.to(cuda_device), lo.to(cuda_device))
    assert torch.equal(got, _torch_pair_order(hi.to(cuda_device),
                                              lo.to(cuda_device)))
    assert torch.equal(got.cpu(), radix_hist.radix_argsort_plain(lo, hi))


@pytest.mark.cuda
def test_radix_argsort_cuda_repeats_and_changing_sizes(cuda_device):
    """The scratch of one call is reused by the next from the caching
    allocator: back-to-back calls, and calls of other sizes in turn, give
    the first call's answer."""
    sizes = [72072, 5000, 639998, 2049, 36036]
    keys = {m: _t(_u32_keys(m, "umax_mixed", seed=m)).to(cuda_device)
            for m in sizes}
    pairs = {m: [_t(x).to(cuda_device) for x in _pair_keys(m, "random", m)]
             for m in sizes}
    first = {m: ops.radix_argsort_u32(keys[m]) for m in sizes}
    first_pair = {m: ops.radix_argsort_u64pair(*pairs[m]) for m in sizes}
    for m in sizes:
        assert torch.equal(first[m], torch.sort(keys[m], stable=True).indices)
        assert torch.equal(ops.radix_argsort_u32(keys[m]),
                           ops.radix_argsort_u32(keys[m]))
    for m in sizes[::-1] + sizes:
        assert torch.equal(ops.radix_argsort_u32(keys[m]), first[m])
        assert torch.equal(ops.radix_argsort_u64pair(*pairs[m]),
                           first_pair[m])


@pytest.mark.cuda
def test_radix_argsort_cuda_counts_one_launch_per_argsort(cuda_device):
    keys = _t(_u32_keys(5000, "random", 1)).to(cuda_device)
    ops.reset_launch_counts()
    ops.radix_argsort_u32(keys)
    ops.radix_argsort_u64pair(keys, keys)
    ops.radix_argsort_u32(keys[:0])
    assert ops.launch_counts()["radix_hist"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "all_equal"])
@pytest.mark.parametrize("m", [0, 1, 2047, 2048, 2049, 5000, 36036, 72072])
def test_radix_hist_cuda_equals_plain(cuda_device, m, kind):
    """The TPU kernel's own entry: rank in bucket and histogram."""
    rng = np.random.default_rng(m)
    d = (np.full(m, 200) if kind == "all_equal"
         else rng.integers(0, 256, m)).astype(np.int32)
    d = torch.from_numpy(d).to(cuda_device)
    rank, hist = ops.bucket_rank_hist(d)
    want_r, want_h = radix_hist.bucket_rank_hist_plain(d.cpu())
    assert torch.equal(rank.cpu(), want_r) and torch.equal(hist.cpu(), want_h)
