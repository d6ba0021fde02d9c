"""The port's solver-free quality tier against the JAX package, on the CPU.

`repro_torch.core.spectral_probe` runs the plain versions of its kernels
here. Tolerances, each with its reason:

  * the sqrt of the weights is rounded to nearest: equal to numpy's;
  * the plain spmv, the weighted degree and the probe lift are equal
    (`np.array_equal`) to the reference's default scatter path: the same
    float32 terms added in the same order;
  * the CSR row sums the CUDA kernels compute (emulated here in numpy, one
    rounding per operation, as the kernels' __f*_rn intrinsics) equal the
    plain version bit for bit: the arc order is the scatters' order;
  * the Pallas kernel in interpret mode: atol = rtol = 2e-4, the bound of
    `tests/test_kernels.py` (its one-hot matmuls sum in another order);
  * R̂ with the reference's own probes: rtol 1e-5 (XLA's fusion and the
    final sum over P round differently from torch's);
  * trace_similarity: rtol 1e-5 (one float32 sum in another order);
    probe_criticality: equal (one elementwise product);
  * the calibration contracts on the port's own probes are the
    reference's: Spearman(crit) ≥ 0.95 against the dense pinv;
  * the port's numpy calibration helpers (`core/resistance.py`) are
    copies of the reference's: equal on the same inputs.

The `cuda` legs need a card and skip here; on the card the JAX legs skip
instead, since JAX is imported only by the `J` fixture.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import resistance as TR
from repro_torch.core import lgrass_sparsify
from repro_torch.core import spectral_probe as T
from repro_torch.core.graph import feeder_like_graph, random_connected_graph
from repro_torch.core.resistance import probe_calibration_np
from repro_torch.core.sparsify import phase1_device
from repro_torch.kernels import ops, spmv

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The JAX package's estimator and spmv kernel (skips without JAX)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import spectral_probe
    from repro.kernels import ops as jops

    return types.SimpleNamespace(jax=jax, jnp=jnp, sp=spectral_probe,
                                 ops=jops)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def _padded(g, l_pad):
    """The graph's edges padded to l_pad with zero-weight (0, 0) slots."""
    pad = l_pad - g.m
    u = np.concatenate([g.u, np.zeros(pad, np.int32)])
    v = np.concatenate([g.v, np.zeros(pad, np.int32)])
    w = np.concatenate([g.w, np.zeros(pad, np.float32)])
    return u, v, w, np.arange(l_pad) < g.m


def _star(leaves):
    """A star: node 0 joined to nodes 1..leaves (one lane of
    `csrc/spmv.cu` walks all of the hub's arcs)."""
    w = np.random.default_rng(leaves).lognormal(0.0, 0.5, leaves)
    return (leaves + 1, np.zeros(leaves, np.int32),
            np.arange(1, leaves + 1, dtype=np.int32), w.astype(np.float32),
            None)


def _spmv_graphs():
    """(n, u, v, w, valid) of the spmv test graphs: valid is None or the
    mask of real edges (padding slots have zero weight)."""
    g1 = random_connected_graph(200, 400, seed=1)
    g2 = feeder_like_graph(256, 128, seed=2)
    g3 = random_connected_graph(150, 300, seed=3)
    u3, v3, w3, valid3 = _padded(g3, 512)
    w3 = np.where(np.arange(512) % 3 == 0, 0.0, w3).astype(np.float32)
    g5 = random_connected_graph(100, 200, seed=5)
    z = np.zeros(0, np.int32)
    return {
        "random": (g1.n, g1.u, g1.v, g1.w, None),
        "feeder": (g2.n, g2.u, g2.v, g2.w, None),
        "padded": (g3.n, u3, v3, w3, valid3),
        "star": _star(5000),
        "m0": (5, z, z, np.zeros(0, np.float32), None),
        # three isolated nodes after a random graph
        "isolated": (g5.n + 3, g5.u, g5.v, g5.w, None),
    }


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


# -- the spmv and its scatters --------------------------------------------

@pytest.mark.parametrize("name", ["random", "feeder", "padded"])
def test_plain_spmv_equals_reference(J, name):
    n, u, v, w, valid = _spmv_graphs()[name]
    x = np.random.default_rng(5).standard_normal((n, 8)).astype(np.float32)
    jnp = J.jnp
    want = np.asarray(J.sp.laplacian_spmv(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(x),
        edge_valid=None if valid is None else jnp.asarray(valid)))
    got = T.laplacian_spmv(_t(u, torch.int64), _t(v, torch.int64), _t(w),
                           _t(x), edge_valid=None if valid is None
                           else _t(valid))
    assert np.array_equal(got.numpy(), want)
    wm = w if valid is None else np.where(valid, w, 0.0).astype(np.float32)
    pallas = np.asarray(J.ops.laplacian_spmv_edges(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(wm), jnp.asarray(x),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-4, rtol=2e-4)
    # the port's ops entry (the kernel's plain version on a CPU tensor)
    got_ops = ops.laplacian_spmv_edges(_t(u, torch.int64),
                                       _t(v, torch.int64), _t(wm), _t(x))
    assert np.array_equal(got_ops.numpy(), want)
    deg = T.weighted_degree(_t(u, torch.int64), _t(v, torch.int64), _t(w),
                            n, None if valid is None else _t(valid))
    want_deg = np.asarray(J.sp.weighted_degree(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), n,
        None if valid is None else jnp.asarray(valid)))
    assert np.array_equal(deg.numpy(), want_deg)


def _csr_spmv_np(csr, x):
    """numpy emulation of `spmv_csr_kernel`: per node, in CSR order,
    acc = acc + w * (x[a] - x[b]), each operation rounded to float32.

    This is every lane's sum whatever the kernel's work split: a lane owns
    one (node, column vector) and adds its node's arcs one after another
    (a round loads its arcs' rows before adding them, in order), so the
    blocks, lanes, float4 vectors and rounds of `csrc/spmv.cu` change no
    result. The split itself is held to this order on the card by
    `test_spmv_kernels_equal_cpu_plain`."""
    rowptr, other = csr.rowptr.numpy(), csr.other.numpy()
    w_arc = csr.w_arc.numpy()
    deg = np.diff(rowptr)
    acc = np.zeros_like(x)
    for r in range(int(deg.max()) if len(deg) else 0):
        rows = np.nonzero(deg > r)[0]
        j = rowptr[rows] + r
        acc[rows] = acc[rows] + w_arc[j][:, None] * (x[rows] - x[other[j]])
    return acc


def _csr_arc_sum_np(csr, val, negate_v):
    """numpy emulation of `arc_sum_kernel` (val: (m, P))."""
    rowptr, arc = csr.rowptr.numpy(), csr.arc.numpy()
    deg = np.diff(rowptr)
    acc = np.zeros((csr.n, val.shape[1]), np.float32)
    for r in range(int(deg.max()) if len(deg) else 0):
        rows = np.nonzero(deg > r)[0]
        s = arc[rowptr[rows] + r]
        is_v = s >= csr.m
        vv = val[np.where(is_v, s - csr.m, s)]
        sub = (is_v & negate_v)[:, None]
        acc[rows] = np.where(sub, acc[rows] - vv, acc[rows] + vv)
    return acc


@pytest.mark.parametrize("name", ["random", "feeder", "padded", "star",
                                  "m0", "isolated"])
def test_csr_order_sums_equal_plain(name):
    """The arc CSR's order makes the kernels' sequential row sums equal
    to the plain scatters bit for bit: spmv and lift at every P of the
    card's checks (scalar and float4 lanes), and the degree."""
    n, u, v, w, valid = _spmv_graphs()[name]
    wm = w if valid is None else np.where(valid, w, 0.0).astype(np.float32)
    tu, tv, tw = _t(u, torch.int64), _t(v, torch.int64), _t(wm)
    csr = T.build_arc_csr(tu, tv, tw, n)
    assert csr.rowptr.dtype == torch.int32 and csr.rowptr[-1] == 2 * len(u)
    tails = np.concatenate([u, v])[csr.arc.numpy()]
    assert np.all(np.diff(tails) >= 0)
    rng = np.random.default_rng(6)
    for p in (1, 3, 4, 8, 16, 64):
        x = rng.standard_normal((n, p)).astype(np.float32)
        assert np.array_equal(_csr_spmv_np(csr, x),
                              spmv.laplacian_spmv_plain(tu, tv, tw,
                                                        _t(x)).numpy())
        s = rng.standard_normal((len(u), p)).astype(np.float32)
        assert np.array_equal(_csr_arc_sum_np(csr, s, True),
                              spmv.arc_sum_plain(tu, tv, _t(s), n,
                                                 True).numpy())
    assert np.array_equal(
        _csr_arc_sum_np(csr, wm[:, None], False)[:, 0],
        spmv.arc_sum_plain(tu, tv, tw, n, False).numpy())


def test_spmv_degenerate_edges_give_exact_zeros():
    """m == 0 with 5 isolated nodes, and all-zero weights: exact zeros,
    on the plain path and in the CSR emulation."""
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    z = torch.zeros(0, dtype=torch.int64)
    y = ops.laplacian_spmv_edges(z, z, torch.zeros(0), _t(x))
    assert np.array_equal(y.numpy(), np.zeros((5, 3), np.float32))
    csr = T.build_arc_csr(z, z, torch.zeros(0), 5)
    assert csr.rowptr.tolist() == [0] * 6
    assert np.array_equal(_csr_spmv_np(csr, x), np.zeros_like(x))
    u, v = torch.tensor([0, 1, 3]), torch.tensor([1, 2, 0])
    y = ops.laplacian_spmv_edges(u, v, torch.zeros(3), _t(x))
    assert np.array_equal(y.numpy(), np.zeros_like(x))


def test_weight_sqrt_is_rounded_to_nearest():
    """The probes' W^{1/2} is float32 sqrt rounded to nearest, as on the
    card: equal to numpy's float64 sqrt rounded to float32 (exact, since
    53 >= 2 * 24 + 2 bits) on the n = 160,000 graph's weights, where a CPU
    build's vector sqrt may be an ulp off, and on the edge values."""
    w = random_connected_graph(160000, 160000, seed=102).w
    edge = np.array([0.0, 1e-45, 1e-38, 1e-30, 0.25, 2.0, 3.0, 1e30,
                     3.4e38, np.inf], np.float32)
    for x in (w.astype(np.float32), edge):
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
        assert np.array_equal(T._sqrt_rn(torch.from_numpy(x)).numpy(), want)


# -- the estimator against the reference ----------------------------------

@pytest.mark.parametrize("method", ["cheby", "jacobi"])
def test_probe_er_matches_reference_with_its_probes(J, method):
    g = random_connected_graph(300, 600, seed=11)
    p, k = 16, 32
    key = J.jax.random.PRNGKey(11)
    xi = np.asarray(J.jax.random.rademacher(key, (g.m, p), J.jnp.float32))
    want = np.asarray(J.sp.probe_edge_resistance(
        g.u, g.v, g.w, g.n, n_probes=p, n_iters=k, method=method, key=key))
    got = T.probe_edge_resistance(g.u, g.v, g.w, g.n, n_iters=k,
                                  method=method, xi=xi, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (g.m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    # explicit queries, off the edge list
    qu = np.arange(0, 40, dtype=np.int32)
    qv = np.arange(100, 140, dtype=np.int32)
    want_q = np.asarray(J.sp.probe_edge_resistance(
        g.u, g.v, g.w, g.n, qu, qv, n_probes=p, n_iters=k, method=method,
        key=key))
    got_q = T.probe_edge_resistance(g.u, g.v, g.w, g.n, qu, qv, n_iters=k,
                                    method=method, xi=xi, device="cpu")
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=1e-5, atol=0)


def test_padded_probe_er_matches_reference(J):
    g = random_connected_graph(120, 200, seed=12)
    u, v, w, valid = _padded(g, 384)
    key = J.jax.random.PRNGKey(3)
    xi = np.asarray(J.jax.random.rademacher(key, (384, 8), J.jnp.float32))
    want = np.asarray(J.sp.probe_edge_resistance(
        u, v, w, g.n, n_probes=8, n_iters=24, key=key, edge_valid=valid))
    got = T.probe_edge_resistance(u, v, w, g.n, n_iters=24, xi=xi,
                                  edge_valid=valid, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.all(got[g.m:] == 0.0)  # padded queries: node 0 vs itself


def test_trace_similarity_and_criticality_match_reference(J):
    g = random_connected_graph(200, 500, seed=13)
    r = np.random.default_rng(1).random(g.m).astype(np.float32)
    mask = np.random.default_rng(2).random(g.m) < 0.5
    jnp = J.jnp
    tw, tr = _t(g.w), _t(r)
    assert np.array_equal(
        T.probe_criticality(tw, tr).numpy(),
        np.asarray(J.sp.probe_criticality(jnp.asarray(g.w), jnp.asarray(r))))
    for m in (None, mask):
        want = float(J.sp.trace_similarity(
            jnp.asarray(g.w), jnp.asarray(r),
            None if m is None else jnp.asarray(m)))
        got = T.trace_similarity(tw, tr, None if m is None else _t(m))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_auto_lam_min_and_masked_spmv_match_reference(J):
    for k in (1, 2, 8, 32, 64, 100):
        assert T.auto_lam_min(k) == J.sp.auto_lam_min(k)
    g = random_connected_graph(64, 128, seed=61)
    x = np.random.default_rng(0).standard_normal((g.n, 4)).astype(np.float32)
    valid = np.ones(g.m, bool)
    valid[::3] = False
    tu, tv = _t(g.u, torch.int64), _t(g.v, torch.int64)
    y_masked = T.laplacian_spmv(tu, tv, _t(g.w), _t(x),
                                edge_valid=_t(valid))
    y_zeroed = T.laplacian_spmv(
        tu, tv, _t(np.where(valid, g.w, 0.0).astype(np.float32)), _t(x))
    assert torch.equal(y_masked, y_zeroed)


def test_numpy_calibration_helpers_equal_reference(J):
    """The port's copies of the dense-oracle helpers give the reference's
    values on one graph, its spanning tree and its sparsifier."""
    from repro.core import resistance as R

    g = random_connected_graph(40, 90, seed=17)
    res = lgrass_sparsify(g, device="cpu")
    off = ~res.tree_mask
    r_hat = np.random.default_rng(3).random(int(off.sum()))
    for mask in (None, res.tree_mask, res.edge_mask):
        assert np.array_equal(TR.dense_laplacian_np(g.n, g.u, g.v, g.w, mask),
                              R.dense_laplacian_np(g.n, g.u, g.v, g.w, mask))
    l_full = R.dense_laplacian_np(g.n, g.u, g.v, g.w)
    l_sub = R.dense_laplacian_np(g.n, g.u, g.v, g.w, res.edge_mask)
    assert np.array_equal(
        TR.dense_effective_resistance_np(l_full, g.u, g.v),
        R.dense_effective_resistance_np(l_full, g.u, g.v))
    assert TR.spearman_np(g.w, g.u) == R.spearman_np(g.w, g.u)
    assert TR.spearman_np(np.ones(5), np.arange(5)) == 1.0
    got = TR.probe_calibration_np(g.n, g.u, g.v, g.w, g.u[off], g.v[off],
                                  g.w[off], r_hat)
    want = R.probe_calibration_np(g.n, g.u, g.v, g.w, g.u[off], g.v[off],
                                  g.w[off], r_hat)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    lo, hi = TR.spectral_bounds_np(l_full, l_sub)
    assert (lo, hi) == R.spectral_bounds_np(l_full, l_sub)
    assert 0.0 < lo <= hi <= 1.0 + 1e-9


def test_unknown_method_and_bad_probes_raise():
    g = random_connected_graph(10, 5, seed=0)
    with pytest.raises(ValueError):
        T.probe_edge_resistance(g.u, g.v, g.w, g.n, method="lanczos",
                                device="cpu")
    with pytest.raises(ValueError):
        T.probe_edge_resistance(g.u, g.v, g.w, g.n, xi=np.ones((3, 2)),
                                device="cpu")


def test_entry_point_raises_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    g = random_connected_graph(10, 5, seed=0)
    with pytest.raises(RuntimeError):
        T.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=4, n_iters=4)


# -- the reference's contracts, on the port's own probes -------------------

def _offtree(g):
    d = phase1_device(_t(g.u, torch.int64), _t(g.v, torch.int64), _t(g.w),
                      g.n)
    return ~d["tree_mask"].numpy().astype(bool), d


def _calibrate(g, off, n_probes, n_iters, seed, method="cheby"):
    r_hat = T.probe_edge_resistance(
        g.u, g.v, g.w, g.n, n_probes=n_probes, n_iters=n_iters, seed=seed,
        method=method, device="cpu").numpy()
    assert np.isfinite(r_hat).all()
    return probe_calibration_np(
        g.n, g.u, g.v, g.w, g.u[off], g.v[off], g.w[off], r_hat[off])


@pytest.mark.parametrize("seed,weight", [(0, "lognormal"), (1, "uniform")])
def test_calibration_random_family(seed, weight):
    g = random_connected_graph(768, 1536, seed=seed, weight=weight)
    off, _ = _offtree(g)
    cal = _calibrate(g, off, n_probes=256, n_iters=64, seed=seed)
    assert cal["spearman_crit"] >= 0.95
    assert cal["spearman_er"] >= 0.90
    assert cal["med_rel_err"] <= 0.12


def test_jacobi_filter_calibrates():
    g = random_connected_graph(768, 1536, seed=5)
    off, _ = _offtree(g)
    cal = _calibrate(g, off, n_probes=256, n_iters=64, seed=5,
                     method="jacobi")
    assert cal["spearman_crit"] >= 0.95


def test_trace_similarity_is_trace_identity():
    """Σ_e w_e R_G(e) = n − 1 on a connected graph, within the sketch's
    variance and the truncation's underestimate; monotone in the mask."""
    g = random_connected_graph(400, 900, seed=9)
    r_hat = T.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=256,
                                    n_iters=64, seed=9, device="cpu")
    full = float(T.trace_similarity(_t(g.w), r_hat))
    assert 0.85 * (g.n - 1) <= full <= 1.10 * (g.n - 1)
    rng = np.random.default_rng(0)
    small = rng.random(g.m) < 0.4
    big = small | (rng.random(g.m) < 0.4)
    t_small = float(T.trace_similarity(_t(g.w), r_hat, _t(small)))
    t_big = float(T.trace_similarity(_t(g.w), r_hat, _t(big)))
    assert 0.0 <= t_small <= t_big <= full + 1e-3


def test_batched_lanes_equal_padded_single_runs():
    gs = [random_connected_graph(48 + 16 * i, 90 + 30 * i, seed=20 + i)
          for i in range(3)]
    lanes = [_padded(g, 256) for g in gs]
    u, v, w, valid = (np.stack([lane[k] for lane in lanes])
                      for k in range(4))
    rb = T.probe_edge_resistance_batched(u, v, w, valid, 128, n_probes=32,
                                         n_iters=32, seed=40, device="cpu")
    assert rb.shape == (3, 256)
    for i, g in enumerate(gs):
        ri = T.probe_edge_resistance(u[i], v[i], w[i], 128, n_probes=32,
                                     n_iters=32, seed=40 + i,
                                     edge_valid=valid[i], device="cpu")
        assert torch.equal(rb[i], ri)
        assert torch.isfinite(rb[i]).all()
        off, _ = _offtree(g)
        cal = probe_calibration_np(g.n, g.u, g.v, g.w, g.u[off], g.v[off],
                                   g.w[off], rb[i, :g.m].numpy()[off])
        assert cal["spearman_er"] > 0.5  # tiny graph, tiny budget


def test_edgeless_and_isolated_nodes_give_exact_zeros():
    z = np.zeros(0, np.int32)
    r = T.probe_edge_resistance(z, z, np.zeros(0, np.float32), 1,
                                n_probes=8, n_iters=8, device="cpu")
    assert r.shape == (0,)
    assert float(T.trace_similarity(torch.zeros(0), r)) == 0.0
    qu = np.array([0, 1, 2], np.int32)
    qv = np.array([3, 4, 0], np.int32)
    r = T.probe_edge_resistance(z, z, np.zeros(0, np.float32), 5, qu, qv,
                                n_probes=8, n_iters=8, device="cpu")
    assert np.array_equal(r.numpy(), np.zeros(3, np.float32))


def test_disconnected_forest_stays_finite_and_calibrated():
    g1 = random_connected_graph(300, 600, seed=31)
    g2 = random_connected_graph(200, 400, seed=32)
    n = g1.n + g2.n
    u = np.concatenate([g1.u, g2.u + g1.n]).astype(np.int32)
    v = np.concatenate([g1.v, g2.v + g1.n]).astype(np.int32)
    w = np.concatenate([g1.w, g2.w]).astype(np.float32)
    r_hat = T.probe_edge_resistance(u, v, w, n, n_probes=256, n_iters=64,
                                    seed=33, device="cpu").numpy()
    assert np.isfinite(r_hat).all() and (r_hat > 0).all()
    cal = probe_calibration_np(n, u, v, w, u, v, w, r_hat)
    assert cal["spearman_er"] >= 0.95
    qu = np.arange(8, dtype=np.int32)
    qv = (g1.n + np.arange(8)).astype(np.int32)
    r_x = T.probe_edge_resistance(u, v, w, n, qu, qv, n_probes=64,
                                  n_iters=64, seed=34, device="cpu")
    assert torch.isfinite(r_x).all()


def test_float32_extreme_weights_no_nan():
    rng = np.random.default_rng(51)
    g = random_connected_graph(512, 1024, seed=51)
    g.w = np.float32(10.0) ** rng.uniform(-6, 6, g.m).astype(np.float32)
    off, d = _offtree(g)
    assert torch.isfinite(d["crit"][_t(off)]).all()
    r_hat = T.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=256,
                                    n_iters=64, seed=51, device="cpu")
    assert torch.isfinite(r_hat).all()
    assert torch.isfinite(T.probe_criticality(_t(g.w), r_hat)).all()
    cal = probe_calibration_np(g.n, g.u, g.v, g.w, g.u[off], g.v[off],
                               g.w[off], r_hat.numpy()[off])
    assert cal["spearman_crit"] >= 0.95


# -- the CUDA kernels (card only) ------------------------------------------

def _unaligned(t, dev):
    """A contiguous copy of t on dev, 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["padded", "star"])
@pytest.mark.parametrize("p", [1, 3, 4, 16, 64])
def test_spmv_kernels_equal_cpu_plain(cuda_device, p, graph):
    n, u, v, w, valid = _spmv_graphs()[graph]
    wm = w if valid is None else np.where(valid, w, 0.0).astype(np.float32)
    cpu = [_t(u, torch.int64), _t(v, torch.int64), _t(wm)]
    x = _t(np.random.default_rng(p).standard_normal((n + 3, p)).astype(
        np.float32))  # three isolated nodes at the end
    s = _t(np.random.default_rng(p + 1).standard_normal((len(u), p)).astype(
        np.float32))
    op = T.laplacian_operator(*[t.to(cuda_device) for t in cpu], n + 3)
    assert op.csr is not None
    want_op = T.laplacian_operator(*cpu, n + 3)
    assert torch.equal(op(x.to(cuda_device)).cpu(), want_op(x))
    assert torch.equal(op.lift(s.to(cuda_device)).cpu(), want_op.lift(s))
    assert torch.equal(op.degree().cpu(), want_op.degree())
    # a block off a 16-byte boundary: the kernels' scalar variant
    assert torch.equal(op(_unaligned(x, cuda_device)).cpu(), want_op(x))
    assert torch.equal(op.lift(_unaligned(s, cuda_device)).cpu(),
                       want_op.lift(s))


@pytest.mark.cuda
def test_estimator_is_deterministic_on_the_card(cuda_device):
    g = random_connected_graph(2000, 4000, seed=7)
    runs = [T.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=16,
                                    n_iters=32, seed=7, device=cuda_device)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    cpu = T.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=16,
                                  n_iters=32, seed=7, device="cpu")
    np.testing.assert_allclose(runs[0].cpu().numpy(), cpu.numpy(),
                               rtol=1e-5, atol=0)
