"""Drive the PyTorch/CUDA port of LGRASS on one GPU and check it.

    python3 chip_smoke.py                # the check: needs one CUDA device
    python3 chip_smoke.py --profile DIR  # also profiles one case3 call and
                                         # writes the table to DIR

Phases, in order; any failed check exits non-zero:

  1. the card's name and power limit (nvidia-smi), then the build of
     src/repro_torch/csrc/*.cu with nvcc for sm_90a, timed;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main path's shapes (outputs must be equal), then timed
     with CUDA events beside its plain version, the least time the card
     could take (bytes over 3.35 TB/s) and, for the radix pass, the full
     4-pass argsort beside torch.sort(stable=True) as a yardstick;
  3. pipeline: `repro_torch.core.lgrass_sparsify` on the CUDA device for
     the three IPCC cases and the 4K feeder, masks equal to the numpy
     baseline oracle (and to a CPU run of the port for case1), with the
     launch counts of the main path read around it; then case1 and case3
     with use_tree_kernel=True; steady-state wall time per case.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. In the kernels line, `launches` counts the
wrapper's calls over the whole run of its path (the four graphs of the
default path for radix_hist; case1 and case3 under use_tree_kernel for
tree_dist), `launches_per_graph` splits that count by graph, and
`cuda_kernels_per_launch` says how many CUDA kernels one wrapper call
enqueues. Imports nothing of JAX or of `repro`.
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
                        help="profile one case3 call; write the table to DIR")
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
    if args.profile:
        phase_profile(dev, graphs["case3"], args.profile)

    print(f"card: {card}")
    print(json.dumps({"kernels": [report["radix_hist"],
                                  report["tree_dist"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
