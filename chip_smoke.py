"""Drive the PyTorch/CUDA port of LGRASS on one GPU and check it.

    python3 chip_smoke.py                # the check: needs one CUDA device
    python3 chip_smoke.py --profile DIR  # also profiles one case3 call and
                                         # one estimator call at n = 160,000,
                                         # and writes the tables to DIR

Phases, in order; any failed check exits non-zero:

  1. the card's name and power limit (nvidia-smi), then the build of
     src/repro_torch/csrc/*.cu with nvcc for sm_90a, timed;
  2. kernels: the radix and tree-distance kernels against their plain
     PyTorch versions on the card, at the main path's shapes (outputs
     must be equal), then timed
     with CUDA events beside its plain version, the least time the card
     could take (bytes over 3.35 TB/s) and, for the radix pass, the full
     4-pass argsort beside torch.sort(stable=True) as a yardstick;
  3. pipeline: `repro_torch.core.lgrass_sparsify` on the CUDA device for
     the three IPCC cases and the 4K feeder, masks equal to the numpy
     baseline oracle (and to a CPU run of the port for case1), with the
     launch counts of the main path read around it; then case1 and case3
     with use_tree_kernel=True; steady-state wall time per case;
  4. quality: the spmv kernels (`csrc/spmv.cu`: the Laplacian product
     and the arc sum behind the probe lift and the degree) equal to their
     plain versions run on a CPU copy of the inputs (160k-node graph,
     case3 at P = 64 and 1, an edgeless graph, zero-weight slots), and
     timed beside the plain version on the card, torch.sparse.mm and the
     bound; then the estimator `probe_edge_resistance` at n = 160,000
     (P = 16, k = 32 and the defaults P = 64, k = 64: finite, bit-equal
     run to run, allclose to the CPU run), a Jacobi run on case3, the
     calibration against the dense pinv at n = 768, and the user's path
     (lgrass_sparsify on case3, then trace_similarity of tree, sparsifier
     and full graph); last, `bitmap_intersect_any` through its entry
     against its plain version.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. In the kernels line, `launches` counts the
wrapper's calls over the whole run of its path (the four graphs of the
default path for radix_hist; case1 and case3 under use_tree_kernel for
tree_dist; the quality path for laplacian_spmv; the entry's five shapes
for bitmap_intersect), `launches_per_graph` splits that count by graph
(by estimator call, or by shape), and `cuda_kernels_per_launch` says how
many CUDA kernels one wrapper call enqueues. Imports nothing of JAX or
of `repro`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor-core fp32/int32 rate
CASES = ("case1", "case2", "case3")
TIMED_CALLS = 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"CHECK FAILED: {msg}")


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_prefix: str, iters: int = 20) -> float:
    """Mean device time per call of the CUDA kernels whose names contain
    `kernel_prefix`, from a torch.profiler trace of `iters` calls: the
    card's own time, without the host's launch overhead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if kernel_prefix in e.key)
    check(total_us > 0, f"no device time traced for {kernel_prefix}")
    return total_us / iters / 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s "
          f"(radix tile {lib.radix_hist_tile_elems()} digits)")
    for line in _build.build_log().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())


def phase_kernels(dev, lifting):
    from repro_torch.core.sort import radix_argsort_u32
    from repro_torch.kernels import ops, radix_hist, tree_dist

    rng = np.random.default_rng(0)
    report = {}

    # -- radix_hist: every sort pass of the path ------------------------
    digit_cases = {
        "M=36036 random": rng.integers(0, 256, 36036),
        "M=72072 random": rng.integers(0, 256, 72072),
        "M=72072 all-equal": np.full(72072, 200),
        "M=1": np.array([7]),
        "M=5000 ragged": rng.integers(0, 256, 5000),
        "M=0": np.zeros(0),
    }
    err = 0
    for name, d in digit_cases.items():
        dt = torch.as_tensor(d.astype(np.int32), device=dev)
        rank, hist = radix_hist.bucket_rank_hist_cuda(dt)
        want_r, want_h = radix_hist.bucket_rank_hist_plain(dt)
        torch.cuda.synchronize()
        ok = torch.equal(rank, want_r) and torch.equal(hist, want_h)
        if rank.numel():
            err = max(err, int((rank - want_r).abs().max()))
        err = max(err, int((hist - want_h).abs().max()))
        print(f"radix_hist {name}: equal={ok}")
        check(ok, f"radix_hist differs from its plain version at {name}")
    m = 72072
    dt = torch.as_tensor(digit_cases["M=72072 random"].astype(np.int32),
                         device=dev)
    keys = torch.as_tensor(rng.integers(0, 2 ** 32, m, dtype=np.int64),
                           device=dev)
    perm = radix_argsort_u32(keys)
    check(torch.equal(perm, torch.sort(keys, stable=True).indices),
          "radix_argsort_u32 differs from torch.sort(stable=True)")
    b_ms, b_by = bound_ms(8 * m + 4 * 256, m)
    report["radix_hist"] = dict(
        name="radix_hist", route="cuda",
        source="src/repro_torch/csrc/radix_hist.cu",
        replaces="src/repro/kernels/radix_hist.py:56",
        max_abs_err=err,
        ms=time_cuda(lambda: radix_hist.bucket_rank_hist_cuda(dt)),
        device_ms=device_ms(lambda: radix_hist.bucket_rank_hist_cuda(dt),
                            "tile_"),
        plain_ms=time_cuda(lambda: radix_hist.bucket_rank_hist_plain(dt),
                           iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, at_m=m,
        cuda_kernels_per_launch=3,
        argsort_u32_ms=time_cuda(lambda: radix_argsort_u32(keys)),
        torch_sort_stable_ms=time_cuda(
            lambda: torch.sort(keys, stable=True)))

    # -- tree_dist: the cover tables under use_tree_kernel ---------------
    up = torch.as_tensor(lifting[0], device=dev)
    depth = torch.as_tensor(lifting[1].astype(np.int32), device=dev)
    log, n = up.shape
    err = 0
    for m in (8192, 16384, 135168):
        a = torch.as_tensor(rng.integers(0, n, m).astype(np.int32),
                            device=dev)
        b = torch.as_tensor(rng.integers(0, n, m).astype(np.int32),
                            device=dev)
        got = tree_dist.tree_dist_pairs_cuda(up, depth, a, b)
        want = tree_dist.tree_dist_pairs_plain(up, depth, a, b)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = max(err, int((got - want).abs().max()))
        print(f"tree_dist M={m} (case3 table {log}x{n}): equal={ok}")
        check(ok, f"tree_dist differs from its plain version at M={m}")
    b_ms, b_by = bound_ms(12 * m + 4 * log * n + 4 * n, 4 * log * m)
    report["tree_dist"] = dict(
        name="tree_dist", route="cuda",
        source="src/repro_torch/csrc/tree_dist.cu",
        replaces="src/repro/kernels/tree_dist.py:66",
        max_abs_err=err,
        ms=time_cuda(lambda: tree_dist.tree_dist_pairs_cuda(up, depth, a, b)),
        device_ms=device_ms(
            lambda: tree_dist.tree_dist_pairs_cuda(up, depth, a, b),
            "tree_dist_kernel"),
        plain_ms=time_cuda(
            lambda: tree_dist.tree_dist_pairs_plain(up, depth, a, b),
            iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, at_m=m,
        cuda_kernels_per_launch=1)
    ops.reset_launch_counts()  # the checks above are not the main path
    return report


def phase_pipeline(dev, graphs, oracles):
    from repro_torch.core import lgrass_sparsify
    from repro_torch.core.sparsify import phase1_device
    from repro_torch.kernels import ops

    # the main path: default engines, counts read around its run
    ops.reset_launch_counts()
    per_call = {}
    for name, g in graphs.items():
        before = ops.launch_counts()["radix_hist"]
        r = lgrass_sparsify(g, device=dev)
        per_call[name] = ops.launch_counts()["radix_hist"] - before
        check(np.array_equal(r.edge_mask, oracles[name]),
              f"{name}: CUDA mask differs from the numpy baseline")
        check(per_call[name] > 0, f"{name}: no radix_hist launch")
        print(f"pipeline {name}: n={g.n} L={g.m} mask == baseline, "
              f"accepted {r.n_accepted}, radix launches/call "
              f"{per_call[name]}")
    main_counts = ops.launch_counts()
    check(main_counts["tree_dist"] == 0, "tree_dist ran on the default path")

    # the use_tree_kernel path, counts read around its run
    ops.reset_launch_counts()
    tree_per_call = {}
    for name in ("case1", "case3"):
        before = ops.launch_counts()
        r = lgrass_sparsify(graphs[name], device=dev, use_tree_kernel=True)
        after = ops.launch_counts()
        tree_per_call[name] = after["tree_dist"] - before["tree_dist"]
        check(np.array_equal(r.edge_mask, oracles[name]),
              f"{name}: use_tree_kernel mask differs from the baseline")
        print(f"pipeline {name} use_tree_kernel: mask == baseline, "
              f"launches/call " + str({k: after[k] - before[k]
                                        for k in after}))
    tree_counts = ops.launch_counts()
    check(tree_counts["tree_dist"] > 0, "no tree_dist launch")
    print(f"launches: main path {main_counts}, "
          f"use_tree_kernel path {tree_counts}")

    # the port on the CPU gives the same bits as on the card
    g = graphs["case1"]
    r_cpu = lgrass_sparsify(g, device="cpu")
    check(np.array_equal(r_cpu.edge_mask, oracles["case1"]),
          "case1: CPU mask differs from the baseline")
    args = [torch.as_tensor(np.asarray(x, dt)) for x, dt in
            ((g.u, np.int64), (g.v, np.int64), (g.w, np.float32))]
    p_cpu = phase1_device(*args, g.n)
    p_gpu = phase1_device(*[x.to(dev) for x in args], g.n)
    for key in sorted(p_cpu):
        a, b = p_cpu[key], p_gpu[key].cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"case1 phase-1 {key}: CPU != CUDA")
    print("case1: CPU run == CUDA run (masks; phase-1 outputs bit-equal)")

    for name, g in graphs.items():
        ts = []
        for _ in range(TIMED_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lgrass_sparsify(g, device=dev)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"wall {name}: median {statistics.median(ts):.1f} ms over "
              f"{TIMED_CALLS} calls {[round(t, 1) for t in ts]}, radix "
              f"launches/call {per_call[name]}")
    return main_counts, tree_counts, per_call, tree_per_call


def _laplacian_csr(u, v, w, n):
    """L = D - W as a torch.sparse_csr_tensor on u's device: the input
    of the torch.sparse.mm yardstick (built once, untimed)."""
    nodes = torch.arange(n, device=u.device)
    deg = torch.zeros(n, device=u.device).index_add_(0, u, w).index_add_(
        0, v, w)
    idx = torch.stack([torch.cat([u, v, nodes]), torch.cat([v, u, nodes])])
    coo = torch.sparse_coo_tensor(idx, torch.cat([-w, -w, deg]), (n, n),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def _spmv_timings(dev, u, v, w, n, p, rng):
    """The spmv kernel at one shape: CUDA-event and device time beside
    the plain version on the card, torch.sparse.mm and the bound."""
    from repro_torch.core.spectral_probe import build_arc_csr
    from repro_torch.kernels import spmv

    x = torch.as_tensor(rng.standard_normal((n, p)).astype(np.float32),
                        device=dev)
    csr = build_arc_csr(u, v, w, n)
    lap = _laplacian_csr(u, v, w, n)
    arcs = 2 * u.shape[0]
    b_ms, b_by = bound_ms(4 * (n + 1) + 8 * arcs + 2 * 4 * n * p,
                          3 * arcs * p)
    got = spmv.spmv_csr_cuda(csr, x)
    lib = torch.sparse.mm(lap, x)
    torch.cuda.synchronize()
    return dict(
        ms=time_cuda(lambda: spmv.spmv_csr_cuda(csr, x)),
        device_ms=device_ms(lambda: spmv.spmv_csr_cuda(csr, x),
                            "spmv_csr_kernel"),
        plain_ms=time_cuda(lambda: spmv.laplacian_spmv_plain(u, v, w, x)),
        library_ms=time_cuda(lambda: torch.sparse.mm(lap, x)),
        library_max_abs_diff=float((lib - got).abs().max()),
        csr_build_ms=time_cuda(lambda: build_arc_csr(u, v, w, n),
                               iters=5),
        bound_ms=b_ms, bound_by=b_by, at_n=n, at_L=int(u.shape[0]), at_p=p)


def profile_estimator(dev, g, out_dir, p=16, k=32):
    """Where one estimator call's time goes: the host's draw of the
    probes alone, then the call under torch.profiler (kernel time summed
    over kernel events only, as in phase_profile); the table is written
    to DIR/profile_estimator.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spectral_probe as SP

    t0 = time.perf_counter()
    SP._rademacher(g.m, p, 102)
    draw_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        SP.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=p, n_iters=k,
                                 seed=102, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    with open(os.path.join(out_dir, "profile_estimator.txt"), "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=40))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    print(f"estimator profile n={g.n} P={p} k={k}: wall {wall_ms:.1f} ms "
          f"under the profiler, probe draw on the host {draw_ms:.1f} ms "
          f"(outside the profiler), kernels busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %)")


def _check_spmv_kernels(dev, cases, rng):
    """The spmv and arc-sum kernels against their plain versions run on
    a CPU copy of the same inputs (equal), and the spmv's distance from
    the plain version run on the card (atomics: allowed to differ).
    Returns the max abs errors (spmv, arc sums, vs the atomics)."""
    from repro_torch.core.spectral_probe import laplacian_operator
    from repro_torch.kernels import spmv

    err = err_arc = err_atomics = 0.0
    for name, ((u, v, w), n, p) in cases.items():
        x = torch.as_tensor(rng.standard_normal((n, p)).astype(np.float32))
        s = torch.as_tensor(rng.standard_normal((u.shape[0], p)).astype(
            np.float32))
        op = laplacian_operator(u.to(dev), v.to(dev), w.to(dev), n)
        check(op.csr is not None, "the CUDA operator has no CSR")
        y = op(x.to(dev)).cpu()
        want = spmv.laplacian_spmv_plain(u, v, w, x)
        lift, deg = op.lift(s.to(dev)).cpu(), op.degree().cpu()
        want_lift = spmv.arc_sum_plain(u, v, s, n, True)
        want_deg = spmv.arc_sum_plain(u, v, w, n, False)
        atomics = spmv.laplacian_spmv_plain(u.to(dev), v.to(dev), w.to(dev),
                                            x.to(dev)).cpu()
        ok = torch.equal(y, want)
        ok_arc = torch.equal(lift, want_lift) and torch.equal(deg, want_deg)
        d_atomics = float((y - atomics).abs().max())
        err = max(err, float((y - want).abs().max()))
        err_arc = max(err_arc, float((lift - want_lift).abs().max()),
                      float((deg - want_deg).abs().max()))
        err_atomics = max(err_atomics, d_atomics)
        print(f"laplacian_spmv {name}: equal to the CPU plain version={ok}, "
              f"lift and degree equal={ok_arc}, max |kernel - CUDA plain "
              f"(atomics)| {d_atomics}")
        check(ok, f"laplacian_spmv differs from the CPU plain at {name}")
        check(ok_arc, f"arc_sum differs from the CPU plain at {name}")
    return err, err_arc, err_atomics


def _time_arc_sum(dev, u, v, w, n, p, rng):
    """The arc-sum kernel (the probe lift) at one shape."""
    from repro_torch.core.spectral_probe import build_arc_csr
    from repro_torch.kernels import spmv

    m = u.shape[0]
    csr = build_arc_csr(u, v, w, n)
    sw = torch.as_tensor(rng.standard_normal((m, p)).astype(np.float32),
                         device=dev)
    b_ms, b_by = bound_ms(4 * (n + 1) + 4 * 2 * m + 4 * m * p + 4 * n * p,
                          2 * m * p)
    return dict(
        ms=time_cuda(lambda: spmv.arc_sum_cuda(csr, sw, True)),
        device_ms=device_ms(lambda: spmv.arc_sum_cuda(csr, sw, True),
                            "arc_sum_kernel"),
        plain_ms=time_cuda(lambda: spmv.arc_sum_plain(u, v, sw, n, True)),
        bound_ms=b_ms, bound_by=b_by, at_n=n, at_L=m, at_p=p)


def _time_bitmap(m1, m2):
    """The bitmap kernel at one shape."""
    from repro_torch.kernels import bitmap_intersect as bi

    l, wd = m1.shape
    b_ms, b_by = bound_ms(2 * 4 * l * wd + l, 2 * l * wd)
    return dict(
        ms=time_cuda(lambda: bi.bitmap_intersect_any_cuda(m1, m2)),
        device_ms=device_ms(lambda: bi.bitmap_intersect_any_cuda(m1, m2),
                            "bitmap_row"),
        plain_ms=time_cuda(lambda: bi.bitmap_intersect_any_plain(m1, m2)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, at_l=l, at_w=wd)


def _drive_estimator(dev, big, case3):
    """The estimator at n = 160,000 (P = 16, k = 32, then the defaults):
    finite, bit-equal run to run, k spmv launches per call, allclose to
    the CPU run at P = 16; then a Jacobi run on case3 against its CPU
    run. Returns (launches per call, wall medians) by configuration."""
    from repro_torch.core import spectral_probe as SP
    from repro_torch.kernels import ops

    per_call, walls = {}, {}
    for p, k in ((16, 32), (64, 64)):
        tag = f"n={big.n} P={p} k={k}"
        before = ops.launch_counts()
        r1 = SP.probe_edge_resistance(big.u, big.v, big.w, big.n,
                                      n_probes=p, n_iters=k, seed=102,
                                      device=dev)
        after = ops.launch_counts()
        per_call[tag] = {key: after[key] - before[key] for key in after}
        check(per_call[tag]["laplacian_spmv"] == k,
              f"{tag}: {per_call[tag]['laplacian_spmv']} spmv launches, "
              f"not {k}")
        check(bool(torch.isfinite(r1).all()), f"{tag}: R̂ not finite")
        ts, runs = [], []
        for _ in range(TIMED_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(SP.probe_edge_resistance(
                big.u, big.v, big.w, big.n, n_probes=p, n_iters=k, seed=102,
                device=dev))
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        check(all(torch.equal(r1, r) for r in runs),
              f"{tag}: two runs on the card differ")
        walls[tag] = statistics.median(ts)
        print(f"estimator {tag}: finite, {1 + TIMED_CALLS} runs bit-equal, "
              f"wall median {walls[tag]:.1f} ms over {TIMED_CALLS} calls "
              f"{[round(t, 1) for t in ts]}, launches/call {per_call[tag]}")
        if p == 16:
            t0 = time.perf_counter()
            r_cpu = SP.probe_edge_resistance(big.u, big.v, big.w, big.n,
                                             n_probes=p, n_iters=k, seed=102,
                                             device="cpu")
            cpu_s = time.perf_counter() - t0
            rel = float(((r1.cpu() - r_cpu).abs()
                         / r_cpu.abs().clamp_min(1e-30)).max())
            check(torch.allclose(r1.cpu(), r_cpu, rtol=1e-5, atol=0),
                  f"{tag}: CUDA R̂ not allclose (rtol 1e-5) to the CPU run")
            print(f"estimator {tag}: allclose to the CPU run (rtol 1e-5), "
                  f"max rel diff {rel:.3e}; CPU run {cpu_s:.2f} s")

    r_j = SP.probe_edge_resistance(case3.u, case3.v, case3.w, case3.n,
                                   n_probes=16, n_iters=32, method="jacobi",
                                   seed=3, device=dev)
    r_j_cpu = SP.probe_edge_resistance(case3.u, case3.v, case3.w, case3.n,
                                       n_probes=16, n_iters=32,
                                       method="jacobi", seed=3, device="cpu")
    check(torch.allclose(r_j.cpu(), r_j_cpu, rtol=1e-5, atol=0),
          "case3 jacobi: CUDA R̂ not allclose to the CPU run")
    print("estimator case3 jacobi P=16 k=32: allclose to the CPU run "
          "(rtol 1e-5)")
    return per_call, walls


def _drive_calibration_and_user_path(dev, case3):
    """Spearman(crit) >= 0.95 against the dense pinv at n = 768 (the
    off-tree edges from phase 1 on the card); then the user's path on
    case3: sparsify, R̂, trace_similarity of tree < LGRASS <= full."""
    from repro_torch.core import lgrass_sparsify, random_connected_graph
    from repro_torch.core import spectral_probe as SP
    from repro_torch.core.resistance import probe_calibration_np
    from repro_torch.core.sparsify import phase1_device

    g = random_connected_graph(768, 1536, seed=0)
    d = phase1_device(*[t.to(dev) for t in _edges(g)], g.n)
    off = ~d["tree_mask"].cpu().numpy()
    r_cal = SP.probe_edge_resistance(g.u, g.v, g.w, g.n, n_probes=256,
                                     n_iters=64, seed=0, device=dev)
    cal = probe_calibration_np(g.n, g.u, g.v, g.w, g.u[off], g.v[off],
                               g.w[off], r_cal.cpu().numpy()[off])
    check(cal["spearman_crit"] >= 0.95,
          f"calibration: Spearman(crit) {cal['spearman_crit']} < 0.95")
    print(f"calibration n=768 P=256 k=64: Spearman(crit) "
          f"{cal['spearman_crit']:.4f}, Spearman(R) {cal['spearman_er']:.4f}"
          f", median rel err {cal['med_rel_err']:.4f}")

    res = lgrass_sparsify(case3, device=dev)
    r3 = SP.probe_edge_resistance(case3.u, case3.v, case3.w, case3.n,
                                  n_probes=16, n_iters=32, seed=3, device=dev)
    w3 = torch.as_tensor(case3.w, device=dev)
    full = float(SP.trace_similarity(w3, r3))
    tree = float(SP.trace_similarity(w3, r3, res.tree_mask))
    spars = float(SP.trace_similarity(w3, r3, res.edge_mask))
    check(tree < spars <= full * (1 + 1e-3),
          f"case3 trace: tree {tree}, LGRASS {spars}, full {full}")
    print(f"user path case3: trace full {full:.2f} (n-1 = {case3.n - 1}), "
          f"trace_frac tree {tree / full:.4f}, LGRASS {spars / full:.4f}")


def _edges(g, w=None):
    """A graph's (u, v, w) as CPU tensors (int64, int64, float32)."""
    return (torch.as_tensor(g.u.astype(np.int64)),
            torch.as_tensor(g.v.astype(np.int64)),
            torch.as_tensor(g.w if w is None else w))


def _big_graph():
    """The largest cost point of benchmarks/bench_spectral.py."""
    from repro_torch.core import random_connected_graph

    return random_connected_graph(160000, 160000, seed=102)


def phase_quality(dev, graphs):
    """The solver-free quality tier: the spmv and bitmap kernels against
    their plain versions and timed, then the estimator's path and the
    bitmap entry, each with the launch counts read around it. Returns
    the spmv and bitmap entries of the kernels line, and the radix_hist
    launches of the quality path."""
    from repro_torch.kernels import bitmap_intersect, ops

    rng = np.random.default_rng(12)
    big = _big_graph()
    case1, case3 = graphs["case1"], graphs["case3"]
    half = case1.w.copy()
    half[::2] = 0.0  # the padding convention: zero-weight slots
    z = torch.zeros(0, dtype=torch.int64)
    err, err_arc, err_atomics = _check_spmv_kernels(dev, {
        f"n={big.n} P=16": (_edges(big), big.n, 16),
        "case3 P=64": (_edges(case3), case3.n, 64),
        "case3 P=1": (_edges(case3), case3.n, 1),
        "m=0 n=5 P=8": ((z, z, torch.zeros(0)), 5, 8),
        "case1 half zero-weight P=16": (_edges(case1, half), case1.n, 16),
    }, rng)

    def bitmap(l, wd, density):
        """(l, wd) int32 words, each nonzero with probability `density`."""
        words = rng.integers(-2 ** 31, 2 ** 31, (l, wd)).astype(np.int32)
        return torch.as_tensor(words * (rng.random((l, wd)) < density),
                               device=dev)

    bit_shapes = [(36036, 26), (36036, 1), (1, 4), (0, 4), (4096, 128)]
    bit_inputs = [(bitmap(l, wd, 1.0), bitmap(l, wd, 0.05))
                  for l, wd in bit_shapes]

    big_dev = [t.to(dev) for t in _edges(big)]
    big_t = _spmv_timings(dev, *big_dev, big.n, 16, rng)
    case3_t = _spmv_timings(dev, *[t.to(dev) for t in _edges(case3)],
                            case3.n, 64, rng)
    arc_t = _time_arc_sum(dev, *big_dev, big.n, 16, rng)
    bit_t = _time_bitmap(*bit_inputs[0])
    print(f"laplacian_spmv timings n={big.n} P=16: {big_t}")
    print(f"laplacian_spmv timings case3 P=64: {case3_t}")
    print(f"arc_sum (lift) timings n={big.n} P=16: {arc_t}")
    print(f"bitmap_intersect timings: {bit_t}")

    # the quality path, counts read around it
    ops.reset_launch_counts()
    per_call, walls = _drive_estimator(dev, big, case3)
    _drive_calibration_and_user_path(dev, case3)
    path_counts = ops.launch_counts()
    print(f"launches: quality path {path_counts}")
    for key in ("laplacian_spmv", "arc_sum", "radix_hist"):
        check(path_counts[key] > 0, f"no {key} launch on the quality path")

    # bitmap_intersect through its entry, counts read around each call
    ops.reset_launch_counts()
    bit_per_shape, bit_err = {}, 0
    for (l, wd), (a, b) in zip(bit_shapes, bit_inputs):
        before = ops.launch_counts()["bitmap_intersect"]
        out = ops.bitmap_intersect_any(a, b)
        bit_per_shape[f"{l}x{wd}"] = (ops.launch_counts()["bitmap_intersect"]
                                      - before)
        want = bitmap_intersect.bitmap_intersect_any_plain(a.cpu(), b.cpu())
        ok = torch.equal(out.cpu(), want)
        if l:
            bit_err = max(bit_err, int((out.cpu().to(torch.int32)
                                        - want.to(torch.int32)).abs().max()))
        print(f"bitmap_intersect (L, W) = ({l}, {wd}): equal={ok}, "
              f"{int(want.sum())} of {l} rows intersect, launches "
              f"{bit_per_shape[f'{l}x{wd}']}")
        check(ok, f"bitmap_intersect differs from its plain at ({l}, {wd})")
    bit_launches = ops.launch_counts()["bitmap_intersect"]
    check(bit_launches == len(bit_shapes) - 1,
          f"bitmap_intersect launched {bit_launches} times")

    spmv_entry = dict(
        name="laplacian_spmv", route="cuda",
        source="src/repro_torch/csrc/spmv.cu",
        replaces="src/repro/kernels/spmv.py:61",
        launches=path_counts["laplacian_spmv"],
        launches_per_graph={k: c["laplacian_spmv"]
                            for k, c in per_call.items()},
        cuda_kernels_per_launch=1, max_abs_err=err,
        max_abs_diff_cuda_plain_atomics=err_atomics,
        bound_assumes="x gathers hit L2", **big_t, case3_p64=case3_t,
        arc_sum=dict(launches=path_counts["arc_sum"], max_abs_err=err_arc,
                     **arc_t),
        estimator_wall_ms=walls)
    bit_entry = dict(
        name="bitmap_intersect", route="cuda",
        source="src/repro_torch/csrc/bitmap_intersect.cu",
        replaces="src/repro/kernels/bitmap_intersect.py:27",
        launches=bit_launches, launches_per_graph=bit_per_shape,
        cuda_kernels_per_launch=1, max_abs_err=bit_err, **bit_t)
    return spmv_entry, bit_entry, path_counts["radix_hist"]


def phase_profile(dev, g, out_dir):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import lgrass_sparsify

    os.makedirs(out_dir, exist_ok=True)

    lgrass_sparsify(g, device=dev)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lgrass_sparsify(g, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    with open(os.path.join(out_dir, "profile_case3.txt"), "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=40))
    # kernels only: operators carry their kernels' time again, and the
    # stage spans appear as device-side annotations over their duration
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"profile case3: wall {wall_ms:.1f} ms under the profiler, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{launches} kernel launches")
    stages = [e for e in events if e.key.isupper() and e.cpu_time_total > 0]
    for e in sorted(stages, key=lambda e: -e.cpu_time_total):
        print(f"profile case3 {e.key}: host {e.cpu_time_total / 1e3:.1f} ms,"
              f" device {e.device_time_total / 1e3:.1f} ms")


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one case3 call and one estimator call "
                             "at n = 160,000; write the tables to DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import (baseline_sparsify, feeder_like_graph,
                                  official_case)
    from repro_torch.core import _host as H

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    phase_build()

    graphs = {name: official_case(name) for name in CASES}
    graphs["feeder4k"] = feeder_like_graph(4096, 2048, seed=0)
    t0 = time.perf_counter()
    base = {name: baseline_sparsify(g) for name, g in graphs.items()}
    print(f"numpy baseline oracle: {time.perf_counter() - t0:.2f} s")
    b3 = base["case3"]
    lifting = (H.build_lifting_np(b3.parent_tree, b3.depth_tree,
                                  graphs["case3"].n), b3.depth_tree)

    report = phase_kernels(dev, lifting)
    main_counts, tree_counts, radix_per, tree_per = phase_pipeline(
        dev, graphs, {k: b.edge_mask for k, b in base.items()})
    report["radix_hist"]["launches"] = main_counts["radix_hist"]
    report["radix_hist"]["launches_per_graph"] = radix_per
    report["tree_dist"]["launches"] = tree_counts["tree_dist"]
    report["tree_dist"]["launches_per_graph"] = tree_per
    spmv_entry, bit_entry, radix_quality = phase_quality(dev, graphs)
    report["radix_hist"]["launches_quality_path"] = radix_quality
    if args.profile:
        phase_profile(dev, graphs["case3"], args.profile)
        profile_estimator(dev, _big_graph(), args.profile)

    print(f"card: {card}")
    print(json.dumps({"kernels": [report["radix_hist"], report["tree_dist"],
                                  spmv_entry, bit_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
