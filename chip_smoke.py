"""Drive the PyTorch/CUDA port of LGRASS on one GPU and check it.

    python3 chip_smoke.py                # the check: needs one CUDA device
    python3 chip_smoke.py --profile DIR  # also profiles one lgrass_sparsify
                                         # call on case3 and at n = 160,000
                                         # and one estimator call there, and
                                         # writes the tables to DIR
    python3 chip_smoke.py --flash-ab TREE
        # only the A/B: the flash forward at hubert's encode shape and
        # hubert's encode, timed on the checkout unpacked at TREE and on
        # this one in turns (TREE, this, this, TREE), each turn a process
        # of its own (--flash-time SRC) that imports that tree's package

Phases, in order; any failed check exits non-zero:

  1. the card's name and power limit (nvidia-smi), then the build of
     src/repro_torch/csrc/*.cu with nvcc for sm_90a, timed;
  2. kernels: the radix argsort (`csrc/radix_hist.cu`, onesweep), u32
     and (hi, lo) pair, equal to torch.sort(stable=True) and to its plain
     version on a CPU copy at tile edges and the main path's sizes, with
     random, all-equal and 0xFFFFFFFF-mixed keys, called back to back and
     at changing sizes; the radix rank entry and the standalone
     tree-distance kernel against their plain versions (outputs must be
     equal); then each timed with CUDA events and torch.profiler beside
     its plain version, the least time the card could take (bytes over
     3.35 TB/s) and, for the argsort at M = 36,036, 72,072 and 639,998,
     torch.sort(stable=True) on the same keys as a yardstick;
  3. pipeline: `repro_torch.core.lgrass_sparsify` on the CUDA device for
     the three IPCC cases and the 4K feeder, with the default (Euler)
     distance engine and with use_tree_kernel=True, masks equal to the
     numpy baseline oracle, with the launch counts read around each call
     (per call: mark 1, rec 1, tree_dist 0, radix_hist 5); the edge-case
     graphs (`core.graph.edge_case_graphs`: a forest with isolated nodes,
     multi-edges and self-loops, extreme weights, ties at k_cap = 2, a
     budget above the candidates) against the port's CPU run and the
     baseline; case1 against a CPU run of the port; steady-state wall time
     per case and engine;
  4. mark_rec: the MARK and REC kernels (`csrc/mark.cu`: a chain
     launch and a card-wide tail launch; `csrc/recover.cu`: one
     thread-block cluster, whose size is printed) against their plain
     loops run on the same CUDA tensors (phase-1 accept and
     group_overflow; accepted and n_accepted; the plain loops' lifting
     distances by `tree_dist_pairs_plain`, so that the climb the kernels
     inline is not on both sides) on case1-3 and feeder4k with both
     engines and on the n = 160,000 graph with the Euler engine; then
     each timed at case3 (both engines) and n = 160,000 beside its plain
     loop and the bytes bound: MARK's chain and tail launches apart, with
     the tail's blocks and the largest group's chain and tail slots, and
     MARK on its largest group alone; REC's chunk time split by its phase
     clocks (staging, classification, tests, the exchange with its
     cluster barrier, resolution); both with the cover test's
     depth-difference skip on and off, with the SM clock;
  5. quality: the spmv kernels (`csrc/spmv.cu`: the Laplacian product
     and the arc sum behind the probe lift and the degree) equal to their
     plain versions run on a CPU copy of the inputs (the 160k-node graph
     at P = 16 and 64; case3 and a star of 5,000 leaves at P = 1, 3, 4,
     8, 16 and 64; an edgeless graph, isolated nodes, zero-weight slots;
     every block with P % 4 == 0 also 4 bytes off a 16-byte boundary, the
     scalar variant), then the spmv timed at every (graph, P) of
     SPMV_SHAPES (the 160k-node graph at P = 1, 4, 16, 64, case3 and a
     400 x 400 grid at P = 16, 64) beside the plain version on the card,
     torch.sparse.mm, the bound, its share of the bound and the SM clock,
     and the arc sum as the lift (P = 16, 64) and the degree (P = 1) with
     theirs (torch.sparse.mm on the incidence matrix); each timed call
     finds L2 cold (`flush_l2`), as the HBM bytes of the bound assume,
     and the device time of back-to-back calls, inputs warm in L2 as in
     the estimator's loop, is printed beside it; then the estimator `probe_edge_resistance` at n = 160,000
     (P = 16, k = 32 and the defaults P = 64, k = 64: finite, bit-equal
     run to run, allclose to a CPU result that two CPU runs repeat bit
     for bit, `_cpu_reference`), a Jacobi run on case3, the
     calibration against the dense pinv at n = 768, twenty more card
     runs at P = 16, k = 32 against one CPU result (no miss at rtol
     1e-5), and the user's path
     (lgrass_sparsify on case3, then trace_similarity of tree, sparsifier
     and full graph); last, `bitmap_intersect_any` through its entry
     against its plain version;
  6. lm: the flash-attention kernels' registers and spills (`-Xptxas -v`)
     and the wgmma kernels' HGMMA and UTMALDG instructions (cuobjdump);
     each flash kernel against its plain version on the card, through the
     route `flash_attention.cuda_route` picks (bf16 at d = 64, 80, 96,
     128: `csrc/flash_attention_sm90.cu`, wgmma and TMA; bf16 at d = 16
     and 32: `csrc/flash_attention.cu`'s mma.sync kernel; fp32: its
     CUDA-core kernel) at the phi3-mini-3.8b prefill shape in bf16 and
     fp32, internlm2-20b's GQA ratio, granite's d = 64 GQA, hubert's
     d = 80 (the wgmma route, 16-column slabs), a window, ragged
     Sq != Sk, -1 padding with query rows that see no key (also over more
     work items than SMs), one query against a full and a ring cache, bf16
     at d = 32 with padding and a window and at d = 16 (the mma.sync
     route), and the served
     families' prefill shapes (minicpm3: 40 heads at d = 96, v
     zero-padded from 64; hymba: 25/5 GQA at d = 64, with a window of
     1,024 and without; granite: 24/8 at d = 64; dbrx: 48/8 at d = 128;
     hubert's encode: 16/16 at d = 80, bidirectional, 1,500 frames); the
     route's kernel timed at the phi3 prefill shape and at the families'
     six beside the plain version, F.scaled_dot_product_attention on the
     same tensors (GQA by `enable_gqa`, a window as a boolean mask, no
     mask where bidirectional) and the bound; the radix rank entry at the
     MoE dispatch's shapes (granite's and dbrx's prefill keys, a decode
     step's) equal to its plain version, timed beside it and the bound; then
     phi3-mini-3.8b at full width and depth 2 in fp32, the card against
     the CPU (prefill and three decode steps); then the serving run:
     phi3 at full width and depth in bf16, `generate` on 4 prompts of
     2,048 tokens with 32 new tokens, twice (equal tokens, bit-equal
     logits), 32 flash launches per prefill, all through the wgmma
     kernel, the serving contract (prefill + decode against the full
     forward) and prefill, decode and profile times; then the same
     depth-2 parity and serving run (one timed run of the serving steps)
     for minicpm3-4b (MLA, 62 flash launches per prefill), mamba2-370m
     (SSD, none), hymba-1.5b (GQA with windows in parallel with the
     SSM, 32), granite-moe-3b-a800m (32 MoE layers: 32 flash launches
     per prefill and one rank launch per MoE layer in the prefill and in
     each decode step, 32 x 32 a generate; the pairs the prefill dropped
     printed per layer) and dbrx-132b (a depth cut to 8 of its 40
     layers, which one card cannot hold; parity at depth 1; 8 flash and
     8 x 32 rank launches), each model freed before the next is built;
     then hubert-xlarge's encoder: a depth-2 fp32 encode, card against
     CPU, at 2 x 256 frames, then 48 layers in bf16 on 4 x 1,500 frames
     of random features (two encodes bit-equal, 48 flash launches on
     the wgmma route and no other kernel, the median encode ms, the
     device time by kernel kind, peak memory, and the bf16 logits
     against an fp32 encode of the same weights, rel. L2 <= 5e-2);
  7. train: the flash attention backward (`csrc/flash_attention_bwd.cu`,
     three kernels a call) against the plain backward (autograd of the
     plain version) at the families' flash shapes, Sq != Sk and -1
     padding with rows that see no key, in fp32 (max abs <= 1e-4 x max
     |grad| per tensor) and bf16 (rel. L2 <= 1e-2 per tensor against the
     fp32 plain backward on the same inputs), two runs bit-equal, timed
     at the families' shapes beside the plain backward, SDPA's backward
     and the bound; a CUDA `ops.flash_attention` output's grad_fn; one
     train step at full width and depth 2 in fp32, card against CPU, for
     phi3, minicpm3, mamba2, hymba, granite (cf = E / k and 1.25) and
     hubert's masked loss (loss, grad_norm, every moment and parameter,
     launches); phi3-mini-3.8b (16 of 32 layers) and
     granite-moe-3b-a800m (8 of 32) trained at full width, B = 4 x 2,048,
     bf16 activations, float32 state, remat on, 1 + 4 steps (ms a step,
     tokens/s, peak memory, busy share, device time by kind, launches a
     step: flash forward 2 x layers, backward 1 x layers, rank 2 x MoE
     layers); the `Trainer` on phi3's reduced config, 12 steps, a failure
     at step 9 (one restart, equal replayed losses);
  8. mesh_train: training on a mesh of the card (`models.sharding`,
     `launch.mesh`): phi3-mini-3.8b at full width, 2 of 32 layers
     (`MESH_DEPTH`: the cut keeps the script inside its time limit), B =
     4 x 2,048, bf16 activations, remat:
     one step from a fresh state unsharded, on 4 data shards of cuda:0
     and with the ZeRO accumulator (`grad_shard_specs=param_specs`),
     each against the unsharded step (loss rel. 1e-3, each gradient leaf
     (mu after the first step) and parameter rel. L2 2e-2), then 2 more
     steps of each timed (ms side by side, peak memory, busy share,
     launches a step: flash forward 4 / 16 / 16, backward 2 / 8 / 8);
     FSDP (the state laid out by `param_specs`: each entry its ('data',
     'model') block) on the 4 data shards, `torch.equal` to the ZeRO
     step (phi3 and granite), and on (2, 2) at `MESH_TP_LIMITS`, each
     entry holding a quarter of the state (`entry_bytes`, 2 %), and
     phi3's prefill and 8 decode steps on the FSDP model, logits
     `torch.equal` to its 'model' layout's;
     the depth-2 fp32 parity of the 4-shard step against the unsharded
     one on an uneven mask (1e-4 of each leaf's max); the same two for
     MoE, granite-moe-3b-a800m at 2 of 32 layers, capacity factor 1.25
     (launches a step: rank 4 / 16 / 16 beside the flash ones; the aux
     each step reports (`metrics["aux"]`; on the mesh assembled from the
     shards' router statistics) against the whole batch's, rel. 1e-5,
     and the mean of the shards' own auxes, which must lie outside that
     limit; device ms with the rank kernel's; the
     gradient distance printed, and held in fp32 at full width: each
     leaf within 1e-4 rel. L2, every token routed alike);
     the elastic
     restart at phi3's reduced config (6 steps on 4 data shards, a
     checkpoint, `restore(shardings=)`, `remesh_state` onto a (2, 2)
     ('data', 'model') mesh, 6 steps; 12 losses within 1e-5 of 12
     unsharded steps), and the same from an FSDP state remeshed by
     `param_specs`; `compressed_psum` over 8 shards of cuda:0 (equal
     to its CPU run, within 0.05 of the exact sum); the serve_lm twin;
  8b. dryrun: the dry-run tools (`launch/{graph_analysis,specs,dryrun}
     .py`) held to the card: the card's `total_memory`; each operator
     of `kernels/oplib.py` through the dispatcher against its raw ctypes
     launch, host µs a call in turns (a granite decode step's 32 rank
     calls may add at most 1 ms); each operator's fake (on meta copies)
     against the kernel's outputs, shape, dtype and stride, at the flash,
     MoE-rank, argsort and case3 MARK shapes; the dry-run's peak of the
     mesh_train phase's unsharded phi3 step and of a full-depth phi3
     prefill (B = 4 x 2,048) against `max_memory_allocated` above what
     was held (within 20 %), the step's FLOPs against `FlopCounterMode`
     on a second real step, apart from the peak (equal), beside the
     kernels' work (`flops_work`); `analyze_program` of the donated service
     program on CUDA tensors (an alias, no transfer); the records of
     phi3 train_4k (traced in a process of its own) and lgrass case3_16k
     on the 256-card mesh;
  9. engines: the reference's other engines of `lgrass_sparsify` on the
     card, on case1-3 and feeder4k: bfs_engine="levels", recovery="host",
     auto_lift_bound=True, use_euler_lca=False (the kernels' lifting
     engine) and schedule="scan", parallel=True (lockstep, no MARK kernel),
     then the basic scan on case1 and on more graphs while its time budget
     lasts, then levels and auto_lift_bound at n = 160,000: each mask equal
     to the baseline's, each call's wrapper launches counted, its wall and
     the scan engines' steps printed; then the quickstart twin
     (`repro_torch.examples.quickstart`);
  10. batch: `lgrass_sparsify_batch` over [case1, case2, case3, feeder4k]
     at the exact bucket and at the pow2 bucket (16,384, 65,536), and over
     [n = 160,000, case3], in both recovery modes: each lane's mask equal
     to its single-graph mask and the baseline's, launches per lane (mark
     1, rec 1, radix_hist 5; host recovery: rec 0, radix_hist 4), the
     batch's wall beside the sum of its single calls;
     `recover_device_batched` from `phase1_device_batched` outputs; REC's
     device time on case3 alone and on its two padded lanes;
 11. service: the serving plane, `SparsifyService`, on a stream of 24
     requests over 9 graphs (case1-3, feeder4k, a 1,600-node grid,
     random graphs of 3,000, 9,000 and 40,000 nodes, the last in the
     (65,536, 131,072) bucket past the reference's BFS and Euler switch
     points, and the trivial graph), repeats interleaved, budgets mixed,
     `max_batch_size=4`: sync, async, async+donate and a one-card mesh,
     two passes each after a warmup over the stream's sizes and chunk
     sizes; every result equal to its single `lgrass_sparsify` call
     (which equals the baseline at the default budget), 5 radix_hist, 1
     mark and 1 rec launches per dispatched lane (placeholder lanes
     included), no on-path compile, the pools grown by at most one set
     after the first pass; each pass's wall beside the sum of the single
     calls, its dispatch and drain time and the device work still
     pending at the first drain (what async could overlap), the
     `ServiceStats` padding split; the attention-mask planner at
     S = 1,024 (mask equal to the CPU's), `block_sparse_attention` on
     the card against its CPU run (fp32, rtol = atol = 1e-5) and both
     example twins (`repro_torch.examples.batch_sparsify`,
     `sparse_attention`); then `lgrass_phase1_distributed` over 4 shards
     of cuda:0 on case3 and at n = 160,000: accept equal to
     `phase1_device`'s, 1 + 4 MARK launches a call (its unsharded phase
     1, then one a shard), on case3 REC over its outputs equal to the
     baseline, its wall beside `phase1_device`'s;
 12. walls, last (a CPU+CUDA torch.profiler session disturbs the device
     times of later sessions): the case3 wall and device busy share with
     the MARK/REC kernels and with their plain loops on the card, in
     turns; one graph of n = 160,000 against its numpy baseline, with its
     wall and busy share;
 13. analysis: `python -m repro_torch.analysis --json` (the lint, and the
     graph audit of the standard programs at n = 64, L = 128, B = 2 on
     the card) exits 0; then on CUDA tensors one `audit_service` at that
     signature and `lgrass_sparsify` on case3: every call's host syncs
     by site beside its card budget; a site past its budget or outside
     it, or a plain MARK / REC loop syncing on the card, fails the run.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. In the kernels line, `launches` counts the
wrapper's calls over the whole run of its path (the four graphs of the
default path for radix_hist, mark and rec; the four graphs of the
use_tree_kernel path for tree_dist, 0 since MARK and REC run its climb
inside themselves; the quality path for laplacian_spmv; the entry's five shapes for
bitmap_intersect; one `generate` call of phi3's serving run for
flash_attention, whose `launches_per_prefill` also gives each served
family's and `launches_per_encode` the encoder's),
`launches_per_graph` splits that count by graph
(by estimator call, or by shape), and `cuda_kernels_per_launch` says how
many CUDA kernels one wrapper call enqueues. radix_hist, mark and rec
also carry `launches_engines_path`, `launches_batch_path` and
`launches_service_path`, each counted from 0 over its phase's user
calls, and mark `launches_sharded_path`, over the sharded phase 1's two
timed calls; radix_hist also `launches_moe_path`, the rank launches of
each MoE model's prefill, decode step and `generate` call, and
`rank_entry_moe`, the rank entry's times at the MoE shapes; flash_attention
and radix_hist also `launches_train_path`, their launches a step of each
full-width training run. `flash_attention_bwd` (no Pallas counterpart:
its `replaces` names the reference's plain attention that jax.grad
differentiates) counts its calls over phi3's five full-width steps, with
`launches_per_train_step` per model and 3 CUDA kernels a launch.
flash_attention and flash_attention_bwd also carry
`launches_mesh_train_path`: their launches a step of the mesh_train
phase's unsharded, 4-shard and ZeRO steps, and with radix_hist
`launches_mesh_moe_path`, the same for granite's MoE steps; and
`launches_dryrun_path`, their launches in the dryrun phase's real phi3
step and prefill (the meta traces launch nothing). Each phase prints
its wall time. Imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the H100 SXM data sheet's rates (this module loads no kernel)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_FP32 as FP32_OPS_PER_S  # noqa: E402
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


L2_FLUSH_FLOATS = 64 << 20  # 256 MB: five times the H100's 50 MB L2
_L2_FLUSH = []


def flush_l2() -> None:
    """Read a 256 MB buffer on the card, so that what a call timed next
    finds in L2 is clean lines of this buffer and none of its inputs
    (reads, not writes: no dirty line is written back inside the timed
    call)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(L2_FLUSH_FLOATS, device="cuda"))
    _L2_FLUSH[0].sum()


def cold(fn):
    """fn run after flush_l2: for a device time of fn's kernels alone
    that starts from a cold L2 (the flush's own kernel is not theirs)."""
    def run():
        flush_l2()
        return fn()
    run.after_flush = fn
    return run


def time_cold(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `iters` calls, each after flush_l2, CUDA
    events around each call alone."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


PROFILE_TRIES = 3        # traces of one device_profile before CUDA events
PROFILE_PAD_S = 0.005    # idle host time at each end of a traced window


def _traced_kernels(fn, prefixes, iters: int) -> tuple:
    """One torch.profiler trace of `iters` calls of fn: (busy us, {name:
    ms per call}, {name: records}) of the CUDA kernels whose names contain
    a prefix. The window is padded with idle host time at both ends, so
    that a kernel whose device timestamps sit a little off the host's
    clock still lands inside the trace's capture window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    spans, by_kernel, records = [], {}, {}
    for e in prof.events():
        hit = [p for p in prefixes if p in e.name]
        if e.device_type != DeviceType.CUDA or not hit:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name[e.name.index(hit[0]):].split("(")[0]
        by_kernel[name] = by_kernel.get(name, 0.0) + (t1 - t0) / iters / 1e3
        records[name] = records.get(name, 0) + 1
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy_us, by_kernel, records


def device_profile(fn, kernel_prefix, iters: int = 20,
                   required: bool = True, every_call: bool = False) -> tuple:
    """Device time of `iters` calls of fn, from a torch.profiler trace,
    for the CUDA kernels (and memsets) whose names contain
    `kernel_prefix` (a string, or a tuple of them): the card's own time,
    without the host's launch overhead. Returns (busy ms per call: the
    union of those kernels' intervals, so kernels that overlap count
    once; {name from the prefix on: ms per call of that kernel's own
    interval}). With required=False, (None, {}) when no such kernel ran.

    A trace can come back without the kernels that ran in it (CUPTI
    delivered none of their records), or, late in a full run, with only
    some of them (seen as a tenth of the time, one call's records of
    ten): a required one is traced again, up to PROFILE_TRIES times, and
    after that the CUDA-event time of the same calls is returned with {}
    and a line saying so. `every_call`, where each of fn's kernels runs
    the same number of times in every call, makes a trace that holds a
    kernel's records a number of times not a multiple of `iters` a
    failed one, traced again up to PROFILE_TRIES times even where not
    required. Whether the kernel ran at all is the launch counters' and
    the output checks' business, not this timer's."""
    prefixes = (kernel_prefix,) if isinstance(kernel_prefix, str) \
        else kernel_prefix
    fn()
    torch.cuda.synchronize()
    tries = PROFILE_TRIES if required or every_call else 1
    for attempt in range(1, tries + 1):
        busy_us, by_kernel, records = _traced_kernels(fn, prefixes, iters)
        whole = not every_call or all(n % iters == 0
                                      for n in records.values())
        if busy_us > 0 and whole:
            if attempt > 1:
                print(f"device_profile {kernel_prefix}: traced on try "
                      f"{attempt} of {PROFILE_TRIES}")
            return busy_us / iters / 1e3, by_kernel
    if not required:
        if every_call and busy_us > 0:
            print(f"device_profile {kernel_prefix}: no whole trace in "
                  f"{tries} (last try's records of {iters} calls: "
                  f"{records})")
        return None, {}
    ms = (time_cold(fn.after_flush, iters=iters, warmup=1)
          if hasattr(fn, "after_flush") else time_cuda(fn, iters=iters,
                                                       warmup=1))
    print(f"device_profile {kernel_prefix}: no whole trace in "
          f"{PROFILE_TRIES}; CUDA-event time {ms:.4f} ms used")
    return ms, {}


def device_ms(fn, kernel_prefix, iters: int = 20,
              every_call: bool = False) -> float:
    """The device ms of one call (device_profile's busy time)."""
    return device_profile(fn, kernel_prefix, iters,
                          every_call=every_call)[0]


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sm_clock() -> str:
    """The card's SM clock, its maximum and its power draw now
    (nvidia-smi), to print beside a time."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                          "power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "clock not read"


def busy_profile(fn) -> tuple:
    """(wall ms, device busy ms, launches) of one call of fn under
    torch.profiler: the kernels' own device time (operators carry their
    kernels' time again, and user spans appear as device-side
    annotations, so both are left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    return wall_ms, busy_ms, launches, events


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s "
          f"(radix tile {lib.radix_tile_elems()} keys, scratch "
          f"{lib.radix_scratch_bytes(72072, 4)} bytes at M = 72,072)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())


# the argsort's profile: its kernels and the memset of its scratch
RADIX_DEVICE = ("radix_onesweep", "Memset")
ARGSORT_SIZES = (0, 1, 2047, 2048, 2049, 5000, 36036, 72072, 639998)
PLAIN_CHECK_MAX_M = 72072  # larger sizes: the plain check on one kind
# one wrapper call per argsort of lgrass_sparsify: the eff order, the
# Euler arc sort, the crit order, the (hi, lo) pair sort, the recovery order
ARGSORTS_PER_CALL = 5


def _u32_keys(rng, m, kind):
    """(m,) int64 keys holding u32 values: random with ties, one value,
    or random with about a third of them the 0xFFFFFFFF sentinel."""
    if kind == "all-equal":
        return np.full(m, 0x9A5A5A5A, np.int64)
    keys = rng.integers(0, 2 ** 32, m, dtype=np.int64)
    if kind == "random":
        keys[::5] = keys[:1]
    else:
        keys[rng.random(m) < 0.35] = 0xFFFFFFFF
    return keys


def _pair_keys(rng, m, kind):
    """(hi, lo) as the Euler arc sort's: hi from a small range (UMAX for
    invalid slots), lo random."""
    lo = _u32_keys(rng, m, kind)
    if kind == "all-equal":
        return np.full(m, 7, np.int64), lo
    hi = rng.integers(0, 300, m).astype(np.int64)
    if kind == "umax-mixed":
        hi[rng.random(m) < 0.35] = 0xFFFFFFFF
    return hi, lo


def _pair_order(hi, lo):
    """The stable order of (hi, lo) pairs from two torch.sort(stable=True)."""
    first = torch.sort(lo, stable=True).indices
    return first[torch.sort(hi[first], stable=True).indices]


def _check_argsorts(dev, rng):
    """The argsort, u32 and pair, against torch.sort(stable=True) and the
    plain version on a CPU copy; back-to-back calls and changing sizes.
    Returns the max abs difference of any permutation from torch.sort's."""
    from repro_torch.kernels import ops, radix_hist

    err, firsts = 0, {}
    for m in ARGSORT_SIZES:
        for kind in ("random", "all-equal", "umax-mixed"):
            k = torch.as_tensor(_u32_keys(rng, m, kind))
            hi, lo = (torch.as_tensor(x) for x in _pair_keys(rng, m, kind))
            kd, hid, lod = k.to(dev), hi.to(dev), lo.to(dev)
            got = ops.radix_argsort_u32(kd)
            got_p = ops.radix_argsort_u64pair(hid, lod)
            want = torch.sort(kd, stable=True).indices
            want_p = _pair_order(hid, lod)
            torch.cuda.synchronize()
            if m:
                err = max(err, int((got - want).abs().max()),
                          int((got_p - want_p).abs().max()))
            ok = torch.equal(got, want) and torch.equal(got_p, want_p)
            plain = m <= PLAIN_CHECK_MAX_M or kind == "random"
            if plain:
                ok = ok and torch.equal(got.cpu(),
                                        radix_hist.radix_argsort_plain(k))
                ok = ok and torch.equal(
                    got_p.cpu(), radix_hist.radix_argsort_plain(lo, hi))
            again = torch.equal(ops.radix_argsort_u32(kd), got) and \
                torch.equal(ops.radix_argsort_u64pair(hid, lod), got_p)
            print(f"radix argsort M={m} {kind}: u32 and pair == torch.sort"
                  f"(stable=True){' and the CPU plain' if plain else ''}: "
                  f"{ok}; a second call equal: {again}")
            check(ok, f"radix argsort differs at M={m} {kind}")
            check(again, f"radix argsort: two calls differ at M={m} {kind}")
            if kind == "umax-mixed":
                firsts[m] = (kd, hid, lod, got, got_p)
    order = list(ARGSORT_SIZES[::-1]) + list(ARGSORT_SIZES)
    same = all(torch.equal(ops.radix_argsort_u32(firsts[m][0]), firsts[m][3])
               and torch.equal(ops.radix_argsort_u64pair(*firsts[m][1:3]),
                               firsts[m][4]) for m in order)
    print(f"radix argsort at changing sizes {order}: equal to the first "
          f"calls: {same}")
    check(same, "radix argsort: calls at changing sizes differ")
    return err


def _argsort_case(keys, hi=None) -> tuple:
    """(the argsort call, torch.sort(stable=True) on the same keys, the
    bound) at one shape. The bound: each int64 key read once and the int64
    permutation written once."""
    from repro_torch.kernels import ops

    if hi is None:
        fn = lambda: ops.radix_argsort_u32(keys)  # noqa: E731
        lib = lambda: torch.sort(keys, stable=True)  # noqa: E731
        n_bytes = 16 * keys.shape[0]
    else:
        fn = lambda: ops.radix_argsort_u64pair(hi, keys)  # noqa: E731
        lib = lambda: _pair_order(hi, keys)  # noqa: E731
        n_bytes = 24 * keys.shape[0]
    return fn, lib, bound_ms(n_bytes, 0)


def _host_us(keys, calls: int = 200) -> dict:
    """Host microseconds per call of the argsort wrapper's parts, each
    timed alone over `calls` calls on the host's clock (the card is
    synchronised before and after each loop)."""
    from repro_torch.kernels import _build, ops

    lib, dev, m = _build.library(), keys.device, keys.shape[0]

    def per_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / calls * 1e6

    scratch = torch.empty((lib.radix_scratch_bytes(m, 4),),
                          dtype=torch.uint8, device=dev)
    perm = torch.empty((m,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_call = lambda: lib.radix_argsort_launch(  # noqa: E731
        keys.data_ptr(), None, m, 4, perm.data_ptr(), scratch.data_ptr(),
        stream)
    return dict(
        wrapper=per_call(lambda: ops.radix_argsort_u32(keys)),
        c_call_alone=per_call(c_call),
        c_call_alone_cuda_event=time_cuda(c_call) * 1e3,
        torch_empty=per_call(lambda: torch.empty((m,), dtype=torch.int64,
                                                 device=dev)),
        current_stream=per_call(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        scratch_bytes_c_call=per_call(lambda: lib.radix_scratch_bytes(m, 4)))


def phase_kernels(dev, lifting):
    from repro_torch.kernels import ops, radix_hist, tree_dist

    rng = np.random.default_rng(0)
    report = {}

    # -- radix_hist: the argsort under every sort of the path -------------
    err = _check_argsorts(dev, rng)
    digit_cases = {
        "M=36036 random": rng.integers(0, 256, 36036),
        "M=72072 random": rng.integers(0, 256, 72072),
        "M=72072 all-equal": np.full(72072, 200),
        "M=1": np.array([7]),
        "M=2049 ragged": rng.integers(0, 256, 2049),
        "M=5000 ragged": rng.integers(0, 256, 5000),
        "M=0": np.zeros(0),
    }
    for name, d in digit_cases.items():
        dt = torch.as_tensor(d.astype(np.int32), device=dev)
        rank, hist = radix_hist.bucket_rank_hist_cuda(dt)
        want_r, want_h = radix_hist.bucket_rank_hist_plain(dt)
        torch.cuda.synchronize()
        ok = torch.equal(rank, want_r) and torch.equal(hist, want_h)
        if rank.numel():
            err = max(err, int((rank - want_r).abs().max()))
        err = max(err, int((hist - want_h).abs().max()))
        print(f"radix_hist rank entry {name}: equal={ok}")
        check(ok, f"radix_hist rank entry differs from its plain version "
                  f"at {name}")

    # CUDA-event times first: no profiler has traced this process yet
    cases = {}
    for m in (36036, 72072, 639998):
        keys = torch.as_tensor(rng.integers(0, 2 ** 32, m, dtype=np.int64),
                               device=dev)
        cases[f"u32 M={m}"] = _argsort_case(keys)
        if m == 72072:
            keys72 = keys
    # the estimator's arc sort at n = 160,000: node ids as keys
    tails = torch.as_tensor(rng.integers(0, 160000, 639998), device=dev)
    cases["u32 M=639998 node ids < 160000"] = _argsort_case(tails)
    hi, lo = (torch.as_tensor(x, device=dev)
              for x in _pair_keys(rng, 36036, "random"))
    cases["pair M=36036"] = _argsort_case(lo, hi)
    timings = {name: dict(ms=time_cuda(fn, iters=50),
                          library_ms=time_cuda(lib, iters=50),
                          bound_ms=b[0], bound_by=b[1])
               for name, (fn, lib, b) in cases.items()}
    m = 72072
    host = _host_us(keys72)
    dt = torch.as_tensor(digit_cases["M=72072 random"].astype(np.int32),
                         device=dev)
    rank_call = lambda: radix_hist.bucket_rank_hist_cuda(dt)  # noqa: E731
    r_ms, r_by = bound_ms(8 * m + 4 * 256, 0)
    rank_entry = dict(
        ms=time_cuda(rank_call, iters=50),
        plain_ms=time_cuda(lambda: radix_hist.bucket_rank_hist_plain(dt),
                           iters=5),
        bound_ms=r_ms, bound_by=r_by, at_m=m)
    plain_ms = time_cuda(lambda: radix_hist.radix_argsort_plain(keys72),
                         iters=3, warmup=1)
    # then device times from the profiler
    for name, (fn, _, _) in cases.items():
        busy, by_kernel = device_profile(fn, RADIX_DEVICE)
        timings[name].update(device_ms=busy, device_ms_by_kernel=by_kernel)
        print(f"radix argsort {name}: {timings[name]}")
    print(f"radix argsort host us per call at M={m}: {host}")
    rank_entry["device_ms"] = device_ms(rank_call, RADIX_DEVICE)
    print(f"radix_hist rank entry timings: {rank_entry}")
    at = timings[f"u32 M={m}"]
    report["radix_hist"] = dict(
        name="radix_hist", route="cuda",
        source="src/repro_torch/csrc/radix_hist.cu",
        replaces="src/repro/kernels/radix_hist.py:56",
        max_abs_err=err, at_m=m, what="u32 argsort, random keys",
        ms=at["ms"], device_ms=at["device_ms"],
        plain_ms=plain_ms, bound_ms=at["bound_ms"], bound_by=at["bound_by"],
        library_ms=at["library_ms"], library="torch.sort(stable=True)",
        cuda_kernels_per_launch={"argsort_u32": 5, "argsort_pair": 9,
                                 "rank": 2, "memsets_per_launch": 1},
        argsort=timings, host_us_at_72072=host, rank_entry=rank_entry)

    # -- tree_dist: the lifting climb, standalone ------------------------
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
        cuda_kernels_per_launch=1, sm_clock=sm_clock())
    ops.reset_launch_counts()  # the checks above are not the main path
    return report


# per lgrass_sparsify call, on both engines: one MARK call (its chain and
# tail kernels) and one REC launch with the distances inside them (no
# tree_dist launch), one radix call per argsort
PER_CALL = {"radix_hist": ARGSORTS_PER_CALL, "mark": 1, "rec": 1,
            "tree_dist": 0}
ENGINES = (("euler", False), ("lifting", True))  # use_tree_kernel


def _diff(before, after) -> dict:
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def plain_distances():
    """The plain loops' lifting distances through `tree_dist_pairs_plain`
    on the CUDA tensors, not the tree_dist kernel: MARK and REC inline its
    climb (csrc/tree_dist.cuh), so a comparison with the kernel on the
    plain side would hold the climb against itself."""
    from repro_torch.kernels import ops, tree_dist

    saved = ops.tree_dist_pairs
    ops.tree_dist_pairs = tree_dist.tree_dist_pairs_plain
    try:
        yield
    finally:
        ops.tree_dist_pairs = saved


@contextlib.contextmanager
def plain_loops():
    """MARK and REC through their plain loops on the CUDA tensors, with
    plain distances (a comparison only: the package has no such
    switch)."""
    from repro_torch.kernels import ops, phase1

    saved = ops.mark, ops.recover
    ops.mark, ops.recover = phase1.mark_plain, phase1.recover_plain
    try:
        with plain_distances():
            yield
    finally:
        ops.mark, ops.recover = saved


def _walls(fn, calls: int = TIMED_CALLS) -> list:
    ts = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def _case3_kernels_vs_plain(dev, g, want):
    """The case3 wall with the MARK/REC kernels and with the plain loops
    on the card, in turns, in this one process, and the busy share of
    each under the profiler on its first turn: the plain loops' ~97,000
    launches take the profiler a minute or more to sum, once is enough."""
    from repro_torch.core import lgrass_sparsify

    call = lambda: lgrass_sparsify(g, device=dev)  # noqa: E731
    out = {}
    for label in ("kernels", "plain", "plain", "kernels"):
        ctx = plain_loops() if label == "plain" else contextlib.nullcontext()
        first = label not in out
        with ctx:
            check(np.array_equal(call().edge_mask, want),
                  f"case3 with the {label}: mask differs from the baseline")
            ts = _walls(call)
            if first:
                wall, busy, launches, _ = busy_profile(call)
        clock = sm_clock()
        run = dict(walls_ms=ts, sm_clock=clock)
        if first:
            run.update(profiled_wall_ms=wall, busy_ms=busy,
                       busy_share=busy / wall, launches=launches)
        out.setdefault(label, []).append(run)
        print(f"case3 wall with the {label}: median "
              f"{statistics.median(ts):.1f} ms of {[round(t, 1) for t in ts]}"
              + (f"; profiled {wall:.1f} ms, device busy {busy:.2f} ms "
                 f"({100 * busy / wall:.1f} %), {launches} launches"
                 if first else "") + f" [clock {clock}]")
    return out


def phase_pipeline(dev, graphs, oracles):
    from repro_torch.core import baseline_sparsify, lgrass_sparsify
    from repro_torch.core.graph import edge_case_graphs
    from repro_torch.core.sparsify import phase1_device
    from repro_torch.kernels import ops

    # the path on each engine: the four graphs, counts read around each call
    counts, per_call = {}, {}
    for engine, utk in ENGINES:
        ops.reset_launch_counts()
        for name, g in graphs.items():
            before = ops.launch_counts()
            r = lgrass_sparsify(g, device=dev, use_tree_kernel=utk)
            got = _diff(before, ops.launch_counts())
            per_call.setdefault(engine, {})[name] = got
            check(np.array_equal(r.edge_mask, oracles[name]),
                  f"{name} {engine}: CUDA mask differs from the numpy "
                  f"baseline")
            for k, want in PER_CALL.items():
                check(got[k] == want, f"{name} {engine}: {got[k]} {k} "
                                      f"launches per call, not {want}")
            print(f"pipeline {name} {engine}: n={g.n} L={g.m} mask == "
                  f"baseline, accepted {r.n_accepted}, launches/call {got}")
        counts[engine] = ops.launch_counts()
        print(f"launches: {engine} path {counts[engine]}")

    # the edge cases: the card against the port's CPU run, and against the
    # baseline where its mask is the answer
    for name, (g, kw, baseline) in edge_case_graphs().items():
        r = lgrass_sparsify(g, device=dev, **kw)
        r_cpu = lgrass_sparsify(g, device="cpu", **kw)
        ok = np.array_equal(r.edge_mask, r_cpu.edge_mask) and all(
            getattr(r, k) == getattr(r_cpu, k) for k in
            ("n_accepted", "n_groups", "n_overflow_groups", "n_dirty"))
        if baseline:
            ok = ok and np.array_equal(
                r.edge_mask, baseline_sparsify(g, budget=kw["budget"])
                .edge_mask)
        print(f"edge case {name} {kw}: CUDA == CPU run"
              f"{' == baseline' if baseline else ''}: {ok} "
              f"(accepted {r.n_accepted})")
        check(ok, f"edge case {name}: the CUDA run differs")

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

    walls = {}
    for engine, utk in ENGINES:
        for name, g in graphs.items():
            ts = _walls(lambda: lgrass_sparsify(g, device=dev,
                                                use_tree_kernel=utk))
            walls[f"{name} {engine}"] = statistics.median(ts)
            print(f"wall {name} {engine}: median "
                  f"{statistics.median(ts):.1f} ms over {TIMED_CALLS} calls "
                  f"{[round(t, 1) for t in ts]} [clock {sm_clock()}]")
    return counts, per_call, walls


def phase_walls(dev, case3, case3_oracle, big, big_oracle):
    """The walls under torch.profiler, last: a CPU+CUDA session disturbs
    the device times of later sessions. case3 with the kernels and with
    the plain loops, in turns; then one graph of n = 160,000 against its
    numpy baseline."""
    from repro_torch.core import lgrass_sparsify

    case3_runs = _case3_kernels_vs_plain(dev, case3, case3_oracle)
    r = lgrass_sparsify(big, device=dev)
    check(np.array_equal(r.edge_mask, big_oracle),
          f"n={big.n}: CUDA mask differs from the numpy baseline")
    ts = _walls(lambda: lgrass_sparsify(big, device=dev))
    wall, busy, launches, _ = busy_profile(
        lambda: lgrass_sparsify(big, device=dev))
    big_run = dict(walls_ms=ts, profiled_wall_ms=wall, busy_ms=busy,
                   busy_share=busy / wall, launches=launches,
                   n_accepted=r.n_accepted, sm_clock=sm_clock())
    print(f"pipeline n={big.n} L={big.m}: mask == baseline, accepted "
          f"{r.n_accepted}; wall median {statistics.median(ts):.1f} ms of "
          f"{[round(t, 1) for t in ts]}; profiled {wall:.1f} ms, busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %) "
          f"[clock {big_run['sm_clock']}]")
    return dict(case3=case3_runs, n160000=big_run)


# -- the other engines and the batched pipeline ---------------------------
# (name, lgrass_sparsify options) of the engines phase; the default path's
# per-call launches hold for each but host recovery (no REC, no REC sort)
# and the scan schedule (no MARK)
ENGINE_RUNS = (("levels", dict(bfs_engine="levels")),
               ("host", dict(recovery="host")),
               ("lift_bound", dict(auto_lift_bound=True)),
               ("lifting", dict(use_euler_lca=False)),
               ("scan_parallel", dict(schedule="scan", parallel=True)))
SCAN_BASIC_BUDGET_S = 45.0  # the basic scan's share of the run, after case1
PATH_KERNELS = ("radix_hist", "mark", "rec")


def _path_diff(before, after) -> dict:
    """The launches of the path's kernels (and tree_dist) between two
    `launch_counts` reads."""
    return {k: after[k] - before[k] for k in (*PATH_KERNELS, "tree_dist")}


def _per_call(opts: dict, programs: int = 1) -> dict:
    """The wrapper launches one lgrass_sparsify call with `opts` makes,
    with `programs` runs of its program (2 after an auto_lift_bound
    redo)."""
    host = opts.get("recovery") == "host"
    return {"radix_hist": (4 if host else 5) * programs,
            "mark": 0 if opts.get("schedule") == "scan" else programs,
            "rec": 0 if host else programs, "tree_dist": 0}


def _scan_steps(g, dev) -> dict:
    """The scan engines' trip counts on g: the basic engine's (its
    crossing slots) and the lockstep engine's (its longest crossing
    group), from one chunked phase 1 on the card."""
    from repro_torch.core.sparsify import phase1_device

    d = phase1_device(*[x.to(dev) for x in _edges(g)], g.n)
    active = d["crossing"][d["perm"]]
    sizes = torch.bincount(d["gidx"][active])
    return dict(basic=int(active.sum()),
                parallel=int(sizes.max()) if sizes.numel() else 0)


def _engine_call(g, dev, name, opts, oracle, programs_ok=(1,)):
    """One lgrass_sparsify call with `opts` on the card: its mask against
    the baseline's, its wrapper launches against _per_call, its wall."""
    from repro_torch.core import lgrass_sparsify
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = lgrass_sparsify(g, device=dev, **opts)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = _path_diff(before, ops.launch_counts())
    check(np.array_equal(r.edge_mask, oracle),
          f"{name} {opts}: CUDA mask differs from the numpy baseline")
    check(any(all(got[k] == want for k, want in _per_call(opts, p).items())
              for p in programs_ok),
          f"{name} {opts}: launches {got}, not {_per_call(opts)} per run")
    return r, wall, got


def phase_engines(dev, graphs, oracles, big, big_oracle):
    """The reference's other engines on the card: levels BFS, host
    recovery, auto_lift_bound, the lifting climb (use_euler_lca=False) and
    the lockstep scan on the four graphs, the basic scan on case1 (and on
    more while SCAN_BASIC_BUDGET_S lasts), levels and auto_lift_bound at
    n = 160,000; each mask equal to the baseline's, each call's wrapper
    launches counted (a scan call launches no MARK kernel); then the
    quickstart twin. The launch counts start at 0 here and are read at the
    end: the path's own. Returns (counts, per-call rows)."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops

    rows = {f"{name} steps": _scan_steps(g, dev)
            for name, g in graphs.items()}
    ops.reset_launch_counts()
    for name, g in graphs.items():
        steps = rows[f"{name} steps"]
        for ename, opts in ENGINE_RUNS:
            # an auto_lift_bound run whose tree is deeper than its guess
            # runs its program again at full depth
            _, wall, got = _engine_call(
                g, dev, name, opts, oracles[name],
                (1, 2) if opts.get("auto_lift_bound") else (1,))
            row = dict(wall_ms=wall, launches=got)
            if opts.get("schedule") == "scan":
                row.update(steps=steps["parallel"],
                           ms_per_step=wall / max(steps["parallel"], 1))
            rows[f"{name} {ename}"] = row
            print(f"engines {name} {ename}: mask == baseline, "
                  f"{wall:.1f} ms, launches/call {got}"
                  + (f", {steps['parallel']} lockstep steps"
                     if "steps" in row else "")
                  + f" [clock {sm_clock()}]")
    spent, basic = 0.0, dict(schedule="scan", parallel=False)
    for name in ("case1", "case2", "feeder4k", "case3"):
        g, steps = graphs[name], rows[f"{name} steps"]
        per_step = rows.get("case1 scan_basic", {}).get("ms_per_step")
        if per_step and spent + per_step * steps["basic"] / 1e3 > \
                SCAN_BASIC_BUDGET_S:
            print(f"engines {name} scan_basic: not run ({steps['basic']} "
                  f"steps at ~{per_step:.2f} ms would pass "
                  f"{SCAN_BASIC_BUDGET_S:.0f} s)")
            continue
        _, wall, got = _engine_call(g, dev, name, basic, oracles[name])
        spent += wall / 1e3
        rows[f"{name} scan_basic"] = dict(
            wall_ms=wall, launches=got, steps=steps["basic"],
            ms_per_step=wall / max(steps["basic"], 1))
        print(f"engines {name} scan_basic: mask == baseline, {wall:.1f} ms "
              f"for {steps['basic']} steps, launches/call {got} "
              f"[clock {sm_clock()}]")
    for ename, opts in (("levels", dict(bfs_engine="levels")),
                        ("lift_bound", dict(auto_lift_bound=True))):
        _, wall, got = _engine_call(big, dev, f"n={big.n}", opts, big_oracle,
                                    (1, 2))
        rows[f"n={big.n} {ename}"] = dict(wall_ms=wall, launches=got)
        print(f"engines n={big.n} {ename}: mask == baseline, {wall:.1f} ms, "
              f"launches/call {got} [clock {sm_clock()}]")
    before = ops.launch_counts()
    t0 = time.perf_counter()
    check(quickstart.main([]), "the quickstart twin's masks differ")
    rows["quickstart"] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                              launches=_path_diff(before, ops.launch_counts()))
    counts = ops.launch_counts()
    for k in PATH_KERNELS:
        check(counts[k] > 0, f"engines path: no {k} launch")
    print(f"launches: engines path {counts}")
    return counts, rows


BATCH_BUCKETS = {"exact": None, "pow2": (16384, 65536)}


def _single_walls(g, dev, recovery, calls: int = 1) -> float:
    from repro_torch.core import lgrass_sparsify

    return statistics.median(_walls(
        lambda: lgrass_sparsify(g, device=dev, recovery=recovery), calls))


def _padded_rec_ms(g, dev, bucket) -> tuple:
    """REC's device ms on g's lane padded to bucket (n_max, L_max), and
    whether every node of that lane is reachable (REC's lemma filter)."""
    from repro_torch.core import GraphBatch
    from repro_torch.core.baseline import default_budget
    from repro_torch.core.bfs import INF
    from repro_torch.core.sparsify import (_bucket_b_cap, _phase1_program,
                                           _rec_inputs)
    from repro_torch.kernels import phase1

    b = GraphBatch.from_graphs([g], *bucket)
    u, v = (torch.as_tensor(x[0].astype(np.int64), device=dev)
            for x in (b.u, b.v))
    w = torch.as_tensor(b.w[0], device=dev)
    valid = torch.as_tensor(b.edge_valid[0], device=dev)
    d, euler, _ = _phase1_program(u, v, w, b.n_max, 32, edge_valid=valid)
    rec = _rec_inputs(d, u, v, valid)
    budget = default_budget(g.n)
    ms = device_ms(lambda: phase1.recover_cuda(
        *rec, budget, _bucket_b_cap([budget]), euler),
        MARK_REC_KERNELS["rec"], iters=10)
    return ms, bool((d["depth_t"] != INF).all())


def phase_batch(dev, graphs, oracles, big, big_oracle, single_ms):
    """`lgrass_sparsify_batch` on the card over three batches (the four
    graphs at the exact and the pow2 bucket, n = 160,000 with case3), in
    both recovery modes: each lane's mask equal to its graph's own
    `lgrass_sparsify` mask and to the baseline's (on the card those are
    one: the pipeline phase held every single call to the baseline), its
    launches per lane (mark 1, rec 1 with device recovery, radix_hist 5,
    4 with host recovery), its wall beside the sum of single calls
    (`single_ms`: recovery -> graph -> ms); `recover_device_batched` from
    `phase1_device_batched` outputs; REC's device time on case3 alone and
    on its padded lanes. The counts start at 0 here: the path's own.
    Returns (counts, rows)."""
    from repro_torch.core import (GraphBatch, lgrass_sparsify_batch,
                                  phase1_device_batched,
                                  recover_device_batched)
    from repro_torch.core.baseline import default_budget
    from repro_torch.core.sparsify import _bucket_b_cap, phase1_views_np
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    four = list(graphs)
    batches = {f"ipcc {k}": (four, bucket)
               for k, bucket in BATCH_BUCKETS.items()}
    batches[f"n={big.n} + case3"] = ([f"n={big.n}", "case3"], None)
    every = dict(graphs, **{f"n={big.n}": big})
    masks = dict(oracles, **{f"n={big.n}": big_oracle})
    rows, results = {}, {}
    for bname, (names, bucket) in batches.items():
        batch = GraphBatch.from_graphs([every[k] for k in names],
                                       *(bucket or (None, None)))
        for recovery in ("device", "host"):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = lgrass_sparsify_batch(batch, recovery=recovery,
                                        device=dev)
            wall = (time.perf_counter() - t0) * 1e3
            got = _path_diff(before, ops.launch_counts())
            lanes = len(names)
            want = {k: v * lanes for k, v in
                    _per_call(dict(recovery=recovery)).items()}
            check(got == want, f"batch {bname} {recovery}: launches {got}, "
                               f"not {want}")
            for k, r in zip(names, res):
                check(np.array_equal(r.edge_mask, masks[k]),
                      f"batch {bname} {recovery}: lane {k} differs from "
                      f"its single-graph mask")
            singles = sum(single_ms[recovery][k] for k in names)
            rows[f"{bname} {recovery}"] = dict(
                bucket=(batch.n_max, batch.L_max), wall_ms=wall,
                sum_single_ms=singles, launches=got,
                launches_per_lane={k: v // lanes for k, v in got.items()})
            results[(bname, recovery)] = res
            print(f"batch {bname} ({batch.n_max}, {batch.L_max}) "
                  f"{recovery}: every lane == single == baseline; wall "
                  f"{wall:.1f} ms against {singles:.1f} ms for the single "
                  f"calls; launches/lane "
                  f"{rows[f'{bname} {recovery}']['launches_per_lane']} "
                  f"[clock {sm_clock()}]")

    # the standalone replay from batched phase-1 outputs
    batch = GraphBatch.from_graphs([graphs[k] for k in four])
    t = [torch.as_tensor(x, device=dev) for x in
         (batch.u.astype(np.int64), batch.v.astype(np.int64), batch.w,
          batch.edge_valid)]
    d = {k: x.cpu().numpy() for k, x in
         phase1_device_batched(*t, batch.n_max).items()}
    views = [phase1_views_np({k: x[i] for k, x in d.items()}, batch.L_max)
             for i in range(len(four))]
    tree, crossing, accept, group, dirty0, order = (
        np.stack(col) for col in zip(*views))
    budgets = [default_budget(graphs[k].n) for k in four]
    before = ops.launch_counts()
    acc, cnt = recover_device_batched(
        d["up"], d["depth_t"], batch.u, batch.v, d["beta"], tree, crossing,
        order, accept, group, dirty0, budgets, _bucket_b_cap(budgets),
        edge_valid=batch.edge_valid, device=dev)
    got = _path_diff(before, ops.launch_counts())
    check(got["rec"] == len(four), f"recover_device_batched: {got}")
    for i, (k, r) in enumerate(zip(four, results[("ipcc exact", "device")])):
        check(np.array_equal(acc[i, :graphs[k].m].cpu().numpy(),
                             r.accepted_mask) and int(cnt[i]) == r.n_accepted,
              f"recover_device_batched lane {k} differs from the batch")
    print(f"recover_device_batched from phase1_device_batched (ipcc exact): "
          f"every lane == lgrass_sparsify_batch's; launches {got}")
    counts = ops.launch_counts()
    for k in PATH_KERNELS:
        check(counts[k] > 0, f"batch path: no {k} launch")
    print(f"launches: batch path {counts}")

    # REC on case3 alone and on its padded lanes (not the path's launches)
    rec_ms = {}
    for label, bucket in (("alone", (None, None)),
                          ("pow2", BATCH_BUCKETS["pow2"]),
                          (f"n={big.n} + case3", (big.n, big.m))):
        ms, connected = _padded_rec_ms(graphs["case3"], dev, bucket)
        rec_ms[label] = dict(device_ms=ms, connected=connected)
        print(f"rec case3 lane {label}: {ms:.4f} ms device, every node "
              f"reachable: {connected} [clock {sm_clock()}]")
    rows["rec case3 lanes"] = rec_ms
    return counts, rows


# -- the serving plane, the sharded phase 1 and the mask planner ----------

SERVICE_MAX_BATCH = 4
SERVICE_MODES = (("sync", {}), ("async", dict(async_dispatch=True)),
                 ("async+donate", dict(async_dispatch=True, donate=True)),
                 ("mesh", dict(mesh="batch_mesh")))
SERVICE_PASSES = 2
# the stream's distinct graphs and how often each is requested (24 in all)
SERVICE_COUNTS = (("case1", 3), ("rand3k", 3), ("case3", 3), ("pg40", 3),
                  ("rand40k", 3), ("case2", 2), ("feeder4k", 2),
                  ("rand9k", 3), ("trivial", 2))
SHARDS = 4  # shards of cuda:0 for the group-sharded phase 1


def _service_stream(graphs):
    """24 requests, repeats interleaved: round-robin over SERVICE_COUNTS,
    each graph's first request at its default budget (None), later ones
    at explicit budgets below it (so that b_cap stays the bucket's
    default and warmup covers every signature). Returns (distinct
    graphs, request names, request budgets)."""
    from repro_torch.core import (default_budget, powergrid_like_graph,
                                  random_connected_graph, trivial_graph)

    distinct = {k: graphs[k] for k in ("case1", "case2", "case3",
                                       "feeder4k")}
    distinct.update(pg40=powergrid_like_graph(40, 0.3, seed=1),
                    rand3k=random_connected_graph(3000, 6000, seed=11),
                    rand9k=random_connected_graph(9000, 18000, seed=12),
                    rand40k=random_connected_graph(40000, 40000, seed=13),
                    trivial=trivial_graph())
    left = dict(SERVICE_COUNTS)
    names, budgets, seen = [], [], {}
    while any(left.values()):
        for name, _ in SERVICE_COUNTS:
            if not left[name]:
                continue
            left[name] -= 1
            k = seen[name] = seen.get(name, -1) + 1
            names.append(name)
            budgets.append(None if k == 0 else max(
                1, default_budget(distinct[name].n) // (k + 1)))
    return distinct, names, budgets


def _timed_service(svc, graphs, budgets) -> tuple:
    """One `sparsify` pass with its dispatch and drain calls timed on the
    host clock (the wrappers only read the clock): (results, wall ms,
    dispatch ms, drain ms, device ms still pending when the first drain
    began, dispatched lanes)."""
    acc = dict(dispatch=0.0, drain=0.0, pending=None, lanes=0)
    dispatch, drain = svc._dispatch, svc._drain

    def timed_dispatch(*a):
        t0 = time.perf_counter()
        out = dispatch(*a)
        acc["dispatch"] += (time.perf_counter() - t0) * 1e3
        acc["lanes"] += a[4]  # B_pad
        return out

    def timed_drain(*a):
        t0 = time.perf_counter()
        if acc["pending"] is None:
            torch.cuda.synchronize()  # the drain's first copy waits so too
            acc["pending"] = (time.perf_counter() - t0) * 1e3
        drain(*a)
        acc["drain"] += (time.perf_counter() - t0) * 1e3

    svc._dispatch, svc._drain = timed_dispatch, timed_drain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = svc.sparsify(graphs, budget=budgets)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del svc._dispatch, svc._drain
    return res, wall, acc["dispatch"], acc["drain"], acc["pending"], \
        acc["lanes"]


def _serve_modes(dev, distinct, names, budgets, singles, single_ms):
    """The stream through SparsifyService in every mode, SERVICE_PASSES
    passes each after a warmup over the stream's sizes and chunk sizes:
    results in request order equal to the single calls, launches per
    dispatched lane (radix_hist 5, mark 1, rec 1), no on-path compile,
    the pools' growth after the first pass. Returns rows by mode."""
    from repro_torch.core.distributed import batch_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve.sparsify_service import SparsifyService

    graphs = [distinct[k] for k in names]
    sum_single = sum(single_ms[(k, b)] for k, b in zip(names, budgets))
    probe = SparsifyService(max_batch_size=SERVICE_MAX_BATCH, device=dev)
    by_bucket = {}
    for g in graphs:
        key = probe.bucket_key(g)
        by_bucket.setdefault(key, [0, g])[0] += 1
    rows = {}
    for mode, kw in SERVICE_MODES:
        kw = dict(kw)
        if kw.get("mesh") == "batch_mesh":
            kw["mesh"] = batch_mesh()
        svc = SparsifyService(max_batch_size=SERVICE_MAX_BATCH, device=dev,
                              **kw)
        before = ops.launch_counts()
        for count, g in by_bucket.values():
            sizes = {min(SERVICE_MAX_BATCH, count - lo)
                     for lo in range(0, count, SERVICE_MAX_BATCH)}
            svc.warmup([(g.n, g.m)], batch_sizes=sorted(sizes))
        warm = _path_diff(before, ops.launch_counts())
        warm_lanes = sum(s[2] for s in svc._warmed)
        check(all(warm[k] == PER_CALL[k] * warm_lanes for k in PATH_KERNELS),
              f"service {mode} warmup: launches {warm} for {warm_lanes} "
              f"lanes")
        passes, pools = [], []
        for p in range(SERVICE_PASSES):
            before = ops.launch_counts()
            res, wall, t_disp, t_drain, pending, lanes = _timed_service(
                svc, graphs, budgets)
            got = _path_diff(before, ops.launch_counts())
            check(all(got[k] == PER_CALL[k] * lanes for k in PATH_KERNELS),
                  f"service {mode} pass {p}: launches {got} for {lanes} "
                  f"lanes")
            for i, (k, b, r) in enumerate(zip(names, budgets, res)):
                one = singles[(k, b)]
                check(np.array_equal(r.edge_mask, one.edge_mask)
                      and np.array_equal(r.tree_mask, one.tree_mask)
                      and np.array_equal(r.accepted_mask, one.accepted_mask)
                      and r.n_accepted == one.n_accepted,
                      f"service {mode} pass {p}: request {i} ({k}, budget "
                      f"{b}) differs from its single call")
            pools.append((svc._pool.n_buffer_sets,
                          svc._device_pool.n_buffer_sets))
            passes.append(dict(wall_ms=wall, dispatch_ms=t_disp,
                               drain_ms=t_drain,
                               pending_at_first_drain_ms=pending,
                               lanes=lanes,
                               launches_per_lane={k: v / lanes for k, v
                                                  in got.items()}))
        check(svc.stats.n_on_path_compiles == 0,
              f"service {mode}: {svc.stats.n_on_path_compiles} on-path "
              f"compiles after warmup")
        check(all(b - a <= 1 for a, b in zip(pools[0], pools[-1])),
              f"service {mode}: pools grew {pools}")
        s = svc.stats
        rows[mode] = dict(
            passes=passes, sum_single_ms=sum_single,
            warmup_dispatches=s.n_warmup_dispatches,
            warmup_ms=s.warmup_seconds * 1e3, dispatches=s.n_dispatches,
            buckets={f"{k[0]}x{k[1]}": c for k, c in
                     sorted(s.bucket_counts.items())},
            padding_overhead=s.padding_overhead,
            batch_pad_overhead=s.batch_pad_overhead,
            shape_pad_overhead=s.shape_pad_overhead,
            on_path_compiles=s.n_on_path_compiles, pool_sets=pools)
        walls = ", ".join(f"{x['wall_ms']:.1f}" for x in passes)
        print(f"service {mode}: {len(graphs)} requests == single calls; "
              f"walls {walls} ms against {sum_single:.1f} ms for the single "
              f"calls; dispatch {passes[-1]['dispatch_ms']:.1f} ms, drain "
              f"{passes[-1]['drain_ms']:.1f} ms, device work pending at the "
              f"first drain {passes[-1]['pending_at_first_drain_ms']:.3f} ms;"
              f" {s.n_dispatches // SERVICE_PASSES} dispatches, "
              f"{passes[-1]['lanes']} lanes a pass, launches/lane "
              f"{passes[-1]['launches_per_lane']}; padding "
              f"{s.padding_overhead:.4f} (batch {s.batch_pad_overhead:.4f}, "
              f"shape {s.shape_pad_overhead:.4f}); warmup "
              f"{s.n_warmup_dispatches} dispatches {s.warmup_seconds:.2f} s; "
              f"pool sets {pools} [clock {sm_clock()}]")
    return rows


def _sharded_phase1(dev, g, name, oracle):
    """`lgrass_phase1_distributed` over SHARDS shards of cuda:0: accept
    equal to `phase1_device`'s, 1 + SHARDS MARK launches (the unsharded
    phase 1 it starts from, then one a shard); with `oracle`, the REC
    kernel over its outputs gives the baseline's mask. Returns a row."""
    from repro_torch.core import (default_budget, lgrass_phase1_distributed,
                                  phase1_device, recover_device)
    from repro_torch.core.distributed import batch_mesh
    from repro_torch.core.sparsify import _bucket_b_cap, phase1_views_np
    from repro_torch.kernels import ops

    mesh = batch_mesh(SHARDS, device="cuda:0")
    edges = [x.to(dev) for x in _edges(g)]
    lgrass_phase1_distributed(g, mesh)  # warm
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, dirty, d = lgrass_phase1_distributed(g, mesh)
    wall = (time.perf_counter() - t0) * 1e3
    got = _path_diff(before, ops.launch_counts())
    check(got["mark"] == 1 + SHARDS,
          f"sharded phase 1 {name}: {got['mark']} MARK launches, not "
          f"1 + {SHARDS}")
    p1_ms = statistics.median(_walls(lambda: phase1_device(*edges, g.n)))
    ref = phase1_device(*edges, g.n)
    want = np.zeros(g.m, bool)
    want[ref["perm"].cpu().numpy()] = ref["accept_sorted"].cpu().numpy()
    check(np.array_equal(acc, want),
          f"sharded phase 1 {name}: accept differs from phase1_device's")
    tree, crossing, _, group, dirty0, order = phase1_views_np(d, g.m)
    check(np.array_equal(dirty, dirty0),
          f"sharded phase 1 {name}: dirty set differs from phase1_device's")
    if oracle is not None:
        budget = default_budget(g.n)
        accepted, _ = recover_device(
            d["up"], d["depth_t"], g.u, g.v, d["beta"], tree, crossing,
            order, acc, group, dirty, budget, _bucket_b_cap([budget]),
            device=dev)
        check(np.array_equal(tree | accepted.cpu().numpy(), oracle),
              f"sharded phase 1 {name}: REC over its outputs differs from "
              f"the baseline")
    print(f"sharded phase 1 {name} ({SHARDS} shards of cuda:0): accept == "
          f"phase1_device's"
          + (", REC over it == baseline" if oracle is not None else "")
          + f"; wall {wall:.1f} ms against phase1_device {p1_ms:.1f} ms; "
          f"MARK launches {got['mark']} [clock {sm_clock()}]")
    return dict(wall_ms=wall, phase1_device_ms=p1_ms, launches=got)


def _planner(dev):
    """The attention-mask planner and both example twins on the card:
    the plan equal to the CPU's, block_sparse_attention allclose to its
    CPU run (fp32, rtol = atol = 1e-5). Returns a row."""
    from repro_torch.examples import batch_sparsify, sparse_attention
    from repro_torch.sparse import block_sparse_attention, plan_block_mask

    rng = np.random.default_rng(0)
    B, S, H, D, block = 1, 1024, 4, 64, 32
    nb = S // block
    x = rng.standard_normal((B, S, H * D)).astype(np.float32)
    x[:, 700:732] += x[:, 100:132] * 2.0
    feats = x[0].reshape(nb, block, -1).mean(1)
    plan_ms = statistics.median(_walls(
        lambda: plan_block_mask(feats, keep_frac=0.3, device=dev)))
    plan = plan_block_mask(feats, keep_frac=0.3, device=dev)
    check(np.array_equal(plan.mask, plan_block_mask(
        feats, keep_frac=0.3, device="cpu").mask),
        "planner: the card's mask differs from the CPU's")
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, D)),
                               dtype=torch.float32) for _ in range(3))
    got = block_sparse_attention(q, k, v, plan.mask, block, device=dev)
    want = block_sparse_attention(q, k, v, plan.mask, block, device="cpu")
    err = float((got.cpu() - want).abs().max())
    check(torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5),
          f"block_sparse_attention: card vs CPU max abs err {err:.3e}")
    attn_ms = time_cuda(lambda: block_sparse_attention(
        q, k, v, plan.mask, block, device=dev), iters=10)
    t0 = time.perf_counter()
    check(batch_sparsify.main([]), "batch_sparsify twin failed")
    twin_b = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = sparse_attention.main([])
    twin_s = (time.perf_counter() - t0) * 1e3
    check(out["connected"] and bool(torch.isfinite(out["out"]).all()),
          "sparse_attention twin: disconnected mask or non-finite output")
    print(f"planner S={S} block={block}: mask == CPU's ({plan.kept_edges}/"
          f"{plan.total_edges} edges kept), {plan_ms:.1f} ms a plan; "
          f"block_sparse_attention card vs CPU max abs err {err:.3e}, "
          f"{attn_ms:.3f} ms (events); twins batch_sparsify {twin_b:.1f} ms, "
          f"sparse_attention {twin_s:.1f} ms [clock {sm_clock()}]")
    return dict(plan_ms=plan_ms, attention_ms=attn_ms,
                attention_max_abs_err=err, batch_sparsify_twin_ms=twin_b,
                sparse_attention_twin_ms=twin_s)


def phase_service(dev, graphs, oracles, big):
    """The layer above the batch: the request stream through
    SparsifyService in every mode, the planner and the example twins,
    with the path's launches counted from 0; then the group-sharded
    phase 1 on case3 and n = 160,000, its MARK launches counted from 0.
    Returns (service counts, sharded counts, rows)."""
    from repro_torch.core import baseline_sparsify, lgrass_sparsify
    from repro_torch.kernels import ops

    distinct, names, budgets = _service_stream(graphs)
    t0 = time.perf_counter()
    masks = dict(oracles)
    for k, g in distinct.items():
        if k not in masks and g.m:
            masks[k] = baseline_sparsify(g).edge_mask
    base_s = time.perf_counter() - t0
    singles, single_ms = {}, {}
    for k, b in dict.fromkeys(zip(names, budgets)):
        g = distinct[k]
        [single_ms[(k, b)]] = _walls(
            lambda: singles.__setitem__((k, b), lgrass_sparsify(
                g, budget=b, device=dev)), 1)
        if b is None and g.m:
            check(np.array_equal(singles[(k, b)].edge_mask, masks[k]),
                  f"service stream: {k}'s single call differs from the "
                  f"baseline")
    print(f"service stream: {len(names)} requests over {len(distinct)} "
          f"graphs, every distinct graph's single call == baseline "
          f"(new baselines {base_s:.1f} s)")
    ops.reset_launch_counts()
    rows = dict(modes=_serve_modes(dev, distinct, names, budgets, singles,
                                   single_ms))
    rows["planner"] = _planner(dev)
    counts = ops.launch_counts()
    for k in PATH_KERNELS:
        check(counts[k] > 0, f"service path: no {k} launch")
    print(f"launches: service path {counts}")
    rows["sharded case3"] = _sharded_phase1(dev, graphs["case3"], "case3",
                                            oracles["case3"])
    rows[f"sharded n={big.n}"] = _sharded_phase1(dev, big, f"n={big.n}",
                                                 None)
    # the path's own launches: the two timed calls, not their comparisons
    sharded = {k: sum(rows[f"sharded {x}"]["launches"][k]
                      for x in ("case3", f"n={big.n}"))
               for k in rows["sharded case3"]["launches"]}
    print(f"launches: sharded path {sharded}")
    return counts, sharded, rows


# -- MARK and REC: the greedy loops as kernels ----------------------------

MARK_REC_SOURCES = {"mark": "mark.cu", "rec": "recover.cu"}
# the CUDA kernels of each wrapper call, as torch.profiler names them
MARK_REC_KERNELS = {"mark": ("mark_chain_kernel", "mark_tail_kernel"),
                    "rec": ("rec_kernel",)}
MARK_CHAIN = 32   # slots per chunk of MARK's chain
REC_PHASES = ("staging", "classify", "tests", "exchange", "resolution")


def _mark_rec_inputs(g, dev, use_tree_kernel, k_cap=32):
    """MARK's and REC's inputs from the port's phase 1 on the card, as the
    pipeline hands them over."""
    import types

    from repro_torch.core.baseline import default_budget
    from repro_torch.core.sparsify import (_bucket_b_cap, _phase1_program,
                                           _rec_inputs)

    u, v, w = (x.to(dev) for x in _edges(g))
    d, euler, layout = _phase1_program(u, v, w, g.n, k_cap,
                                       use_tree_kernel=use_tree_kernel)
    rec, budget = _rec_inputs(d, u, v), default_budget(g.n)
    return types.SimpleNamespace(
        t=rec[0], euler=euler, layout=layout, su=u[layout.perm],
        sv=v[layout.perm], sbeta=d["beta"][layout.perm], k_cap=k_cap,
        rec=rec, budget=budget, b_cap=_bucket_b_cap([budget]))


def _mark_rec_bounds(x, accepted) -> dict:
    """Bytes at 3.35 TB/s: each input the function needs read once, each
    output written once. MARK reads the slots (u, v, radius, group start:
    16 B, the active flag: 1 B) and writes accept and group_overflow
    (2 B); REC reads the edges its walk reaches (order, u, v, radius,
    group: 20 B; crossing, phase-1 accept, dirty0: 3 B) and writes the
    (L,) mask. Both need the tree, counted as its parent and depth (8 B
    a node): the Euler table and the lifting table are structures built
    to speed the distances up, not inputs of the function. Also the
    largest group (one block walks its chain; its tail goes to the tail
    launch over the whole card) and REC's walked edges (one cluster
    walks them all, chunk by chunk)."""
    from repro_torch.kernels.phase1 import walk_order

    m, n = x.su.shape[0], x.t.depth.shape[0]
    sizes = torch.bincount(x.layout.gidx[x.layout.active], minlength=1)
    walk, n_walk = walk_order(x.rec[4], x.rec[6])
    hit = torch.nonzero(accepted[walk[:int(n_walk)].long()])
    walked = int(hit[-1]) + 1 if len(hit) and int(
        accepted.sum()) >= min(x.budget, x.b_cap) else int(n_walk)
    mark_b, _ = bound_ms(17 * m + 2 * m + 8 * n, 0)
    rec_b, _ = bound_ms(23 * walked + m + 8 * n, 0)
    return dict(
        mark=dict(bound_ms=mark_b, bound_by="bytes",
                  largest_group=int(sizes.max()),
                  largest_group_id=int(sizes.argmax())),
        rec=dict(bound_ms=rec_b, bound_by="bytes", walked_edges=walked,
                 walked_chunks=-(-walked // 32)))


def _largest_group_alone(x, gid):
    """MARK's inputs cut to the one group `gid`: its slot range, its
    slots and a one-group layout (the tables stay). The kernel's time on
    it is the serial walk of that group with the card otherwise idle."""
    import types

    lay = x.layout
    s0 = int(lay.group_start[gid])
    s1 = int(lay.group_start[gid + 1]) if gid + 1 < lay.group_start.shape[0] \
        else x.su.shape[0]
    m = s1 - s0
    start = torch.full((m,), m, dtype=lay.group_start.dtype,
                       device=lay.group_start.device)
    start[0] = 0
    one = types.SimpleNamespace(
        group_start=start, active=lay.active[s0:s1],
        gidx=torch.zeros_like(lay.gidx[s0:s1]),
        n_groups=torch.ones((), dtype=torch.int64, device=start.device))
    return (s0, s1), (x.su[s0:s1], x.sv[s0:s1], x.sbeta[s0:s1], one)


def _chain_and_tail(accept, layout, gid, k_cap) -> dict:
    """The slots of group `gid` that MARK's chain walks (up to the end of
    the 32-slot chunk in which its k_cap-th entry is stored) and those
    its tail launch decides, from the kernel's accept mask."""
    s0 = int(layout.group_start[gid])
    n = int((layout.gidx[s0:] == gid).sum())
    hits = torch.nonzero(accept[s0:s0 + n]).flatten()
    chain = n if len(hits) < k_cap else min(
        n, -(-(int(hits[k_cap - 1]) + 1) // MARK_CHAIN) * MARK_CHAIN)
    return dict(slots=n, chain_slots=chain, tail_slots=n - chain)


def _sm_mhz() -> float:
    """The SM clock now, in MHz (nvidia-smi)."""
    try:
        return float(sm_clock().split()[0])
    except ValueError:
        return float("nan")


def _rec_phase_split(x, reps: int = 3) -> dict:
    """REC's chunk time split by the kernel's own phase clocks (block 0's
    thread 0, SM cycles over the SM clock read after the runs): µs per
    chunk of staging, classification, tests, the exchange of cover bits
    with its cluster barrier, and resolution; with the chunks, the pairs
    per chunk and the whole run's µs."""
    from repro_torch.kernels import phase1

    clocks = torch.zeros((phase1.rec_clock_count(),), dtype=torch.int64,
                         device=x.t.depth.device)
    for _ in range(reps):
        phase1.recover_cuda(*x.rec, x.budget, x.b_cap, x.euler,
                            clocks=clocks)
    torch.cuda.synchronize()
    mhz = _sm_mhz()
    c = [v / reps for v in clocks.cpu().tolist()]
    chunks = max(c[len(REC_PHASES)], 1)
    return dict(per_chunk_us={k: c[i] / chunks / mhz
                              for i, k in enumerate(REC_PHASES)},
                chunks=c[len(REC_PHASES)],
                pairs_per_chunk=c[len(REC_PHASES) + 1] / chunks,
                kernel_us=c[len(REC_PHASES) + 2] / mhz, sm_mhz=mhz)


def _depth_skip_ab(mark_call, rec_call, plain) -> dict:
    """Each kernel's device ms with the depth-difference skip of
    csrc/ball_pair.cuh on and off, in the order on, off, off, on (outputs
    equal either way)."""
    out = {}
    for kname, call in (("mark", mark_call), ("rec", rec_call)):
        got = call(False)
        want = plain[kname]
        ok = all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                 for a, b in zip(got, want))
        check(ok, f"{kname} without the depth skip differs from its plain "
                  f"loop")
        runs = {True: [], False: []}
        for skip in (True, False, False, True):
            runs[skip].append(device_profile(lambda: call(skip),
                                             MARK_REC_KERNELS[kname],
                                             iters=5)[0])
        out[kname] = dict(device_ms_skip_on=runs[True],
                          device_ms_skip_off=runs[False],
                          sm_clock=sm_clock())
    return out


def phase_mark_rec(dev, graphs, big):
    """Each kernel against its plain loop run on the same CUDA tensors
    (with plain lifting distances, `plain_distances`), on case1-3 and
    feeder4k with both engines and on the n = 160,000 graph with the
    default engine, every output equal; then timed at case3 (both
    engines) and n = 160,000 beside the plain loop and the bound, MARK's
    chain and tail apart and on its largest group alone, REC's chunk
    split by its phase clocks, and both with the depth skip on and
    off."""
    from repro_torch.core.pow2 import auto_chunk
    from repro_torch.kernels import ops, phase1

    cases = [(name, g, engine, utk) for name, g in graphs.items()
             for engine, utk in ENGINES]
    cases.append((f"n={big.n}", big, "euler", False))
    err, timings = 0, {}
    cluster = {engine: phase1.rec_cluster_size(utk) for engine, utk in ENGINES}
    check(min(cluster.values()) >= 2, f"REC cluster sizes {cluster}")
    print(f"rec cluster size (blocks of 1024 threads, one per SM): {cluster}")
    for name, g, engine, utk in cases:
        x = _mark_rec_inputs(g, dev, utk)

        def mark_call(skip=True):
            return phase1.mark_cuda(x.t, x.su, x.sv, x.sbeta, x.layout,
                                    x.k_cap, x.euler, depth_skip=skip)

        def rec_call(skip=True):
            return phase1.recover_cuda(*x.rec, x.budget, x.b_cap, x.euler,
                                       depth_skip=skip)

        acc, ovf = mark_call()
        got, n_got = rec_call()
        with plain_distances():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_acc, p_ovf = phase1.mark_plain(
                x.t, x.su, x.sv, x.sbeta, x.layout, x.k_cap,
                auto_chunk(x.su.shape[0]), x.euler)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want, n_want = phase1.recover_plain(*x.rec, x.budget, x.b_cap,
                                                32, x.euler)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        ok_m = torch.equal(acc, p_acc) and torch.equal(ovf, p_ovf)
        ok_r = torch.equal(got, want) and n_got == n_want
        err = max(err, int((acc != p_acc).any()), int((ovf != p_ovf).any()),
                  int((got != want).any()), abs(n_got - n_want))
        print(f"mark/rec {name} {engine}: mark == plain (accept, "
              f"group_overflow): {ok_m}; rec == plain (accepted, "
              f"n_accepted {n_got}): {ok_r}; plain loops on the card "
              f"{(t1 - t0) * 1e3:.1f} / {(t2 - t1) * 1e3:.1f} ms")
        check(ok_m, f"{name} {engine}: the MARK kernel differs from "
                    f"phase1_chunked")
        check(ok_r, f"{name} {engine}: the REC kernel differs from "
                    f"_recover_scan")
        if name not in ("case3", f"n={big.n}"):
            continue
        bounds = _mark_rec_bounds(x, got)
        for kname, fn, plain_s in (("mark", mark_call, t1 - t0),
                                   ("rec", rec_call, t2 - t1)):
            ms = time_cuda(fn, iters=10, warmup=2)
            dev_ms, by_kernel = device_profile(fn, MARK_REC_KERNELS[kname],
                                               iters=10)
            row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_s * 1e3,
                       device_ms_by_kernel=by_kernel, sm_clock=sm_clock(),
                       **bounds[kname])
            timings[f"{kname} {name} {engine}"] = row
            print(f"{kname} timings {name} {engine}: {row}")
        mrow = timings[f"mark {name} {engine}"]
        gid = mrow["largest_group_id"]
        mrow["largest_group_split"] = _chain_and_tail(acc, x.layout, gid,
                                                      x.k_cap)
        by_kernel = mrow["device_ms_by_kernel"]
        for part in MARK_REC_KERNELS["mark"]:
            # None where device_profile fell back to CUDA-event time
            mrow[part.split("_")[1] + "_device_ms"] = sum(
                v for k, v in by_kernel.items()
                if k.startswith(part)) if by_kernel else None
        tail_threads = phase1.MARK_TAIL_THREADS
        mrow["tail_blocks"] = -(-x.su.shape[0] // tail_threads)
        # the largest group's tail blocks, and the SMs they need at least
        # (2,048 threads a SM)
        blocks = -(-mrow["largest_group_split"]["tail_slots"] // tail_threads)
        mrow["largest_group_tail_blocks"] = blocks
        mrow["largest_group_tail_min_sms"] = -(-blocks
                                               // (2048 // tail_threads))
        split_ms = ("not traced (CUDA-event time only)" if not by_kernel
                    else f"chain {mrow['chain_device_ms']:.4f} ms, tail "
                         f"{mrow['tail_device_ms']:.4f} ms (device)")
        print(f"mark {name} {engine}: {split_ms}; the tail launch ran on "
              f"{mrow['tail_blocks']} blocks of {tail_threads} threads; "
              f"the largest group {mrow['largest_group_split']}, its tail "
              f"over {blocks} of them, so on >= "
              f"{mrow['largest_group_tail_min_sms']} SMs")
        split = _rec_phase_split(x)
        timings[f"rec {name} {engine}"].update(
            phase_split=split, cluster_blocks=cluster[engine])
        print(f"rec {name} {engine}: cluster of {cluster[engine]} blocks; "
              f"chunk split {split}")
        # MARK on its largest group alone: how much of the launch is it?
        (s0, s1), cut = _largest_group_alone(x, gid)
        cut_call = lambda: phase1.mark_cuda(  # noqa: E731
            x.t, *cut, x.k_cap, x.euler)
        check(torch.equal(cut_call()[0], acc[s0:s1]),
              f"{name} {engine}: MARK on its largest group alone differs")
        alone = device_profile(cut_call, MARK_REC_KERNELS["mark"],
                               iters=10)[0]
        timings[f"mark {name} {engine}"]["largest_group_alone_device_ms"] \
            = alone
        ab = _depth_skip_ab(mark_call, rec_call,
                            {"mark": (p_acc, p_ovf), "rec": (want, n_want)})
        for kname in ab:
            timings[f"{kname} {name} {engine}"]["depth_skip_ab"] = ab[kname]
        print(f"mark {name} {engine}: largest group "
              f"({timings[f'mark {name} {engine}']['largest_group']} slots)"
              f" alone {alone:.4f} ms; depth skip A/B {ab}")
    ops.reset_launch_counts()  # the checks above are not the main path
    return err, timings


# the P values of the spmv and arc-sum checks against the CPU, as in the
# tests; a star of STAR_LEAVES leaves: one lane walks the hub's 5,000 arcs
SPMV_CHECK_PS = (1, 3, 4, 8, 16, 64)
STAR_LEAVES = 5000


def _star_edges(leaves):
    """A star: node 0 joined to nodes 1..leaves, lognormal weights."""
    w = np.random.default_rng(leaves).lognormal(0.0, 0.5, leaves)
    return (torch.zeros(leaves, dtype=torch.int64),
            torch.arange(1, leaves + 1, dtype=torch.int64),
            torch.as_tensor(w.astype(np.float32)))


# the spmv's timed shapes: (graph, P values); the degree is P = 1 and the
# estimator's probe blocks P = 16 and 64
SPMV_SHAPES = (("n=160000", (1, 4, 16, 64)), ("case3", (16, 64)),
               ("grid400", (16, 64)))


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


def _spmv_timings(dev, u, v, w, n, p, rng, lap=None):
    """The spmv kernel at one shape: CUDA-event and device time from a
    cold L2 (flush_l2 before each call: the bound's bytes come from HBM)
    beside the plain version on the card and torch.sparse.mm (on `lap`,
    built here if not given), timed the same way; the bound and the
    kernel's share of it; the device time of back-to-back calls, whose
    inputs stay in L2 as in the estimator's loop (warm_device_ms, no
    share: L2 serves it faster than the HBM bound allows); the SM
    clock."""
    from repro_torch.core.spectral_probe import build_arc_csr
    from repro_torch.kernels import spmv

    x = torch.as_tensor(rng.standard_normal((n, p)).astype(np.float32),
                        device=dev)
    csr = build_arc_csr(u, v, w, n)
    lap = _laplacian_csr(u, v, w, n) if lap is None else lap
    arcs = 2 * u.shape[0]
    b_ms, b_by = bound_ms(4 * (n + 1) + 8 * arcs + 2 * 4 * n * p,
                          3 * arcs * p)
    got = spmv.spmv_csr_cuda(csr, x)
    lib = torch.sparse.mm(lap, x)
    torch.cuda.synchronize()
    def run():
        return spmv.spmv_csr_cuda(csr, x)

    dev_ms = device_ms(cold(run), "spmv_csr_kernel")
    return dict(
        ms=time_cold(run), device_ms=dev_ms,
        warm_device_ms=device_ms(run, "spmv_csr_kernel"),
        plain_ms=time_cold(lambda: spmv.laplacian_spmv_plain(u, v, w, x)),
        library_ms=time_cold(lambda: torch.sparse.mm(lap, x)),
        library_max_abs_diff=float((lib - got).abs().max()),
        csr_build_ms=time_cuda(lambda: build_arc_csr(u, v, w, n),
                               iters=5),
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / dev_ms,
        sm_clock=sm_clock(), at_n=n, at_L=int(u.shape[0]), at_p=p)


def _spmv_sweep(dev, graphs, rng):
    """The spmv kernel timed at every (graph, P) of SPMV_SHAPES (graphs:
    name -> Graph), one line each. Returns {"<name> P=<p>": timings}."""
    out = {}
    for name, ps in SPMV_SHAPES:
        g = graphs[name]
        u, v, w = (t.to(dev) for t in _edges(g))
        lap = _laplacian_csr(u, v, w, g.n)
        for p in ps:
            t = _spmv_timings(dev, u, v, w, g.n, p, rng, lap)
            out[f"{name} P={p}"] = t
            print(f"laplacian_spmv {name} P={p}: L2 cold: device "
                  f"{t['device_ms']:.5f} ms, event {t['ms']:.5f} ms, bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']}), "
                  f"{100 * t['share_of_bound']:.1f} % of the bound; "
                  f"torch.sparse.mm {t['library_ms']:.5f} ms, plain "
                  f"{t['plain_ms']:.5f} ms; L2 warm: device "
                  f"{t['warm_device_ms']:.5f} ms [clock {t['sm_clock']}]")
    return out


def _spmv_graphs(graphs):
    """The graphs of SPMV_SHAPES: the n = 160,000 random graph, case3 and
    a 400 x 400 grid (n = 160,000, no chords)."""
    from repro_torch.core.graph import powergrid_like_graph

    return {"n=160000": _big_graph(), "case3": graphs["case3"],
            "grid400": powergrid_like_graph(400, chord_frac=0.0, seed=400)}


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


def _unaligned(t, dev):
    """A contiguous copy of t on dev whose data starts 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


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
        if n and p % 4 == 0:
            # a block 4 bytes off a 16-byte boundary: the scalar variant
            ok = ok and torch.equal(op(_unaligned(x, dev)).cpu(), want)
            ok_arc = ok_arc and torch.equal(
                op.lift(_unaligned(s, dev)).cpu(), want_lift)
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


def _incidence_csr(u, v, n, signed):
    """Bᵀ as an (n, m) torch.sparse_csr_tensor on u's device: 1 at (u_e,
    e), -1 (signed) or 1 at (v_e, e). Bᵀ s is the lift and |B|ᵀ w the
    degree: the torch.sparse.mm yardstick of the arc sum (built once,
    untimed)."""
    m = u.shape[0]
    e = torch.arange(m, device=u.device)
    ones = torch.ones(m, device=u.device)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat([u, v]), torch.cat([e, e])]),
        torch.cat([ones, -ones if signed else ones]), (n, m),
        check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def _time_arc_sum(dev, u, v, w, n, p, rng, negate_v=True):
    """The arc-sum kernel at one shape: the probe lift (negate_v) on an
    (m, p) block, or the degree (p = 1, the weights as the values), timed
    as _spmv_timings times the spmv, beside its plain version and
    torch.sparse.mm on the incidence matrix, with its bound, its share of
    it and the SM clock."""
    from repro_torch.core.spectral_probe import build_arc_csr
    from repro_torch.kernels import spmv

    m = u.shape[0]
    csr = build_arc_csr(u, v, w, n)
    sw = w[:, None].contiguous() if not negate_v else torch.as_tensor(
        rng.standard_normal((m, p)).astype(np.float32), device=dev)
    inc = _incidence_csr(u, v, n, negate_v)
    b_ms, b_by = bound_ms(4 * (n + 1) + 4 * 2 * m + 4 * m * p + 4 * n * p,
                          2 * m * p)

    def run():
        return spmv.arc_sum_cuda(csr, sw, negate_v)

    got = run()
    lib = torch.sparse.mm(inc, sw)
    torch.cuda.synchronize()
    dev_ms = device_ms(cold(run), "arc_sum_kernel")
    return dict(
        ms=time_cold(run), device_ms=dev_ms,
        warm_device_ms=device_ms(run, "arc_sum_kernel"),
        plain_ms=time_cold(lambda: spmv.arc_sum_plain(u, v, sw, n,
                                                      negate_v)),
        library_ms=time_cold(lambda: torch.sparse.mm(inc, sw)),
        library_max_abs_diff=float((lib - got).abs().max()),
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / dev_ms,
        sm_clock=sm_clock(), at_n=n, at_L=m, at_p=p)


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
            r_cpu, n_cpu = _cpu_reference(
                lambda: SP.probe_edge_resistance(
                    big.u, big.v, big.w, big.n, n_probes=p, n_iters=k,
                    seed=102, device="cpu"), tag,
                lambda first: _estimator_diagnosis(dev, big, p, k,
                                                   first))
            cpu_s = (time.perf_counter() - t0) / n_cpu
            rel = float(((r1.cpu() - r_cpu).abs()
                         / r_cpu.abs().clamp_min(1e-30)).max())
            if not torch.allclose(r1.cpu(), r_cpu, rtol=1e-5, atol=0):
                _estimator_diagnosis(dev, big, p, k, r_cpu)
            check(torch.allclose(r1.cpu(), r_cpu, rtol=1e-5, atol=0),
                  f"{tag}: CUDA R̂ not allclose (rtol 1e-5) to the CPU run, "
                  f"max rel diff {rel:.3e}")
            print(f"estimator {tag}: allclose to the CPU run (rtol 1e-5), "
                  f"max rel diff {rel:.3e}; CPU reference from {n_cpu} runs, "
                  f"{cpu_s:.2f} s each")
            _probe_estimator(dev, big, p, k, r_cpu)

    r_j = SP.probe_edge_resistance(case3.u, case3.v, case3.w, case3.n,
                                   n_probes=16, n_iters=32, method="jacobi",
                                   seed=3, device=dev)
    r_j_cpu, _ = _cpu_reference(
        lambda: SP.probe_edge_resistance(
            case3.u, case3.v, case3.w, case3.n, n_probes=16, n_iters=32,
            method="jacobi", seed=3, device="cpu"), "case3 jacobi")
    check(torch.allclose(r_j.cpu(), r_j_cpu, rtol=1e-5, atol=0),
          "case3 jacobi: CUDA R̂ not allclose to the CPU run")
    print("estimator case3 jacobi P=16 k=32: allclose to the CPU run "
          "(rtol 1e-5)")
    return per_call, walls


ESTIMATOR_PROBE_RUNS = 20
CPU_REFERENCE_RUNS = 3


def _stage_log(run) -> tuple:
    """(the result, [(stage, sha1 of its bytes, float64 checksum)]) of one
    CPU run of the estimator, each stage's output hashed as the run makes
    it: the edge arrays the operator holds (the CPU path has no arc CSR:
    its plain products scatter in edge order), the probes, the sqrt of
    the weights, the lift, the degree, every spmv round in order, the
    solve and the result. The stages are wrapped for the run alone."""
    import hashlib

    from repro_torch.core import spectral_probe as SP
    from repro_torch.kernels import spmv as KS

    log = []

    def note(stage, t):
        h = t.detach().contiguous().cpu()
        log.append((stage, hashlib.sha1(h.numpy().tobytes()).hexdigest()[:16],
                    float(h.double().sum())))
        return t

    def noted(stage, fn):
        return lambda *a, **k: note(stage, fn(*a, **k))

    real = dict(rad=SP._rademacher, sqrt=SP._sqrt_rn,
                cheby=SP._solve_cheby, jacobi=SP._solve_jacobi,
                op=SP.laplacian_operator, call=KS.LaplacianOperator.__call__,
                lift=KS.LaplacianOperator.lift,
                degree=KS.LaplacianOperator.degree)
    rounds = []

    def operator(u, v, w, n):
        op = real["op"](u, v, w, n)
        for name in ("u", "v", "w"):
            note(f"operator.{name}", getattr(op, name))
        return op

    def call(self, x):
        rounds.append(1)
        return note(f"spmv {len(rounds)}", real["call"](self, x))

    SP._rademacher = noted("probes", real["rad"])
    SP._sqrt_rn = noted("sqrt", real["sqrt"])
    SP._solve_cheby = noted("solve", real["cheby"])
    SP._solve_jacobi = noted("solve", real["jacobi"])
    SP.laplacian_operator = operator
    KS.LaplacianOperator.__call__ = call
    KS.LaplacianOperator.lift = lambda self, val: note(
        "lift", real["lift"](self, val))
    KS.LaplacianOperator.degree = lambda self: note(
        "degree", real["degree"](self))
    try:
        r = run()
    finally:
        (SP._rademacher, SP._sqrt_rn, SP._solve_cheby, SP._solve_jacobi,
         SP.laplacian_operator) = (real["rad"], real["sqrt"], real["cheby"],
                                   real["jacobi"], real["op"])
        KS.LaplacianOperator.__call__ = real["call"]
        KS.LaplacianOperator.lift = real["lift"]
        KS.LaplacianOperator.degree = real["degree"]
    note("result", r)
    return r, log


def _first_parting(a, b) -> str:
    """Where two stage logs of CPU runs first differ, in words."""
    for (sa, ha, ca), (sb, hb, cb) in zip(a, b):
        if sa != sb:
            return f"the stages' order differs at {sa!r} / {sb!r}"
        if ha != hb:
            return (f"stage {sa!r} (sha1 {ha} vs {hb}, checksum {ca!r} vs "
                    f"{cb!r}); every stage before it equal")
    if len(a) != len(b):
        return f"one run has {len(a)} stages, the other {len(b)}"
    return "no stage (every stage's hash equal)"


def _cpu_reference(run, tag, on_disagreement=None):
    """The CPU result the card is held against: one that two CPU runs give
    bit for bit, from at most CPU_REFERENCE_RUNS runs. The port's CPU
    estimator is deterministic in a fresh process, but late in this
    script's process a first CPU run has several times not been repeated
    by the next (ROADMAP Queue 3 item 1), so a reference is taken only
    once a second run repeats it. Each run logs a hash and a checksum of
    every stage's output (`_stage_log`); a run that disagrees is printed
    with the first stage at which it parts from run 1 (and
    on_disagreement called with the first run); no two runs agreeing
    fails. Returns (the result, the number of runs made)."""
    runs, logs = [], []
    while len(runs) < CPU_REFERENCE_RUNS:
        r, log = _stage_log(run)
        if any(torch.equal(r, q) for q in runs):
            if len(runs) > 1:
                print(f"estimator {tag}: CPU runs disagreed; the reference "
                      f"is the one that two of {len(runs) + 1} runs gave")
            else:
                print(f"estimator {tag}: CPU runs 1 and 2 equal, every "
                      f"stage's hash equal: "
                      f"{all(x == y for x, y in zip(log, logs[0]))} "
                      f"({len(log)} stages)")
            return r, len(runs) + 1
        if runs:
            rel = float(((r - runs[0]).abs()
                         / runs[0].abs().clamp_min(1e-30)).max())
            print(f"estimator {tag}: CPU run {len(runs) + 1} differs from "
                  f"run 1, max rel diff {rel:.3e} (CPU threads "
                  f"{torch.get_num_threads()}, torch {torch.__version__}); "
                  f"they part first at {_first_parting(logs[0], log)}")
            if on_disagreement is not None:
                on_disagreement(runs[0])
        runs.append(r)
        logs.append(log)
    check(False, f"{tag}: no two of {CPU_REFERENCE_RUNS} CPU runs agree")


def _probe_estimator(dev, big, p, k, r_cpu):
    """The estimator run ESTIMATOR_PROBE_RUNS times on the card against one
    fixed CPU result (a probe for the one miss ever seen, ROADMAP Queue 3
    item 1): the largest relative difference and the misses at rtol 1e-5;
    a miss fails."""
    from repro_torch.core import spectral_probe as SP

    worst, misses = 0.0, 0
    for _ in range(ESTIMATOR_PROBE_RUNS):
        r = SP.probe_edge_resistance(big.u, big.v, big.w, big.n,
                                     n_probes=p, n_iters=k, seed=102,
                                     device=dev).cpu()
        worst = max(worst, float(((r - r_cpu).abs()
                                  / r_cpu.abs().clamp_min(1e-30)).max()))
        misses += not torch.allclose(r, r_cpu, rtol=1e-5, atol=0)
    print(f"estimator probe n={big.n} P={p} k={k}: {ESTIMATOR_PROBE_RUNS} "
          f"card runs against one CPU result: max rel diff {worst:.3e}, "
          f"misses at rtol 1e-5: {misses}")
    if misses:
        _estimator_diagnosis(dev, big, p, k, r_cpu)
    check(misses == 0, f"estimator probe: {misses} of "
                       f"{ESTIMATOR_PROBE_RUNS} runs not allclose to the "
                       f"CPU result (max rel diff {worst:.3e})")


def _estimator_diagnosis(dev, big, p, k, r_cpu):
    """Where a card run of the estimator leaves its CPU run, printed
    before the failed check: a second CPU run, the arc CSR's order against
    a stable sort on the CPU, the lift, the degree, one product on a fixed
    block, and the solve, each card against CPU; also the sqrt of the
    weights, the port's rounded one and torch's own."""
    from repro_torch.core import spectral_probe as SP

    again = SP.probe_edge_resistance(big.u, big.v, big.w, big.n,
                                     n_probes=p, n_iters=k, seed=102,
                                     device="cpu")
    print(f"diagnosis: a second CPU run equals the first: "
          f"{torch.equal(again, r_cpu)}")
    xi = SP._rademacher(big.m, p, 102)
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (big.n, p)).astype(np.float32))
    out = {}
    for d in (dev, "cpu"):
        u, v, w = (t.to(d) for t in _edges(big))
        op = SP.laplacian_operator(u, v, w, big.n)
        y = op.lift(SP._sqrt_rn(w)[:, None] * xi.to(d))
        deg = op.degree()
        dinv = torch.where(deg > 0.0, 1.0 / deg, torch.zeros_like(deg))
        out[str(d)] = dict(
            sqrt=SP._sqrt_rn(w).cpu(), torch_sqrt=torch.sqrt(w).cpu(),
            lift=y.cpu(), degree=deg.cpu(), product=op(x0.to(d)).cpu(),
            solve=SP._solve_cheby(op, dinv, y, k, SP.auto_lam_min(k)).cpu())
        if op.csr is not None:
            tail = torch.cat([u, v]).cpu()
            want = torch.sort(tail, stable=True).indices
            print(f"diagnosis: card arc CSR order == stable CPU sort: "
                  f"{torch.equal(op.csr.arc.cpu().long(), want)}")
    card, cpu = out[str(dev)], out["cpu"]
    for key in card:
        diff = float((card[key] - cpu[key]).abs().max())
        print(f"diagnosis: {key} card == CPU: "
              f"{torch.equal(card[key], cpu[key])}, max abs diff {diff:.3e}")


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
    sweep_graphs = _spmv_graphs(graphs)
    big = sweep_graphs["n=160000"]
    case1, case3 = graphs["case1"], graphs["case3"]
    half = case1.w.copy()
    half[::2] = 0.0  # the padding convention: zero-weight slots
    z = torch.zeros(0, dtype=torch.int64)
    star = _star_edges(STAR_LEAVES)
    cases = {
        f"n={big.n} P=16": (_edges(big), big.n, 16),
        f"n={big.n} P=64": (_edges(big), big.n, 64),
        "m=0 n=5 P=8": ((z, z, torch.zeros(0)), 5, 8),
        "case1 half zero-weight P=16": (_edges(case1, half), case1.n, 16),
        "case1 + 3 isolated nodes P=3": (_edges(case1), case1.n + 3, 3),
    }
    for p in SPMV_CHECK_PS:
        cases[f"case3 P={p}"] = (_edges(case3), case3.n, p)
        cases[f"star of {STAR_LEAVES} leaves P={p}"] = (
            star, STAR_LEAVES + 1, p)
    err, err_arc, err_atomics = _check_spmv_kernels(dev, cases, rng)

    def bitmap(l, wd, density):
        """(l, wd) int32 words, each nonzero with probability `density`."""
        words = rng.integers(-2 ** 31, 2 ** 31, (l, wd)).astype(np.int32)
        return torch.as_tensor(words * (rng.random((l, wd)) < density),
                               device=dev)

    bit_shapes = [(36036, 26), (36036, 1), (1, 4), (0, 4), (4096, 128)]
    bit_inputs = [(bitmap(l, wd, 1.0), bitmap(l, wd, 0.05))
                  for l, wd in bit_shapes]

    sweep = _spmv_sweep(dev, sweep_graphs, rng)
    big_dev = [t.to(dev) for t in _edges(big)]
    arc_t = {f"{what} P={p}": _time_arc_sum(dev, *big_dev, big.n, p, rng,
                                            negate_v)
             for what, p, negate_v in (("lift", 16, True),
                                       ("lift", 64, True),
                                       ("degree", 1, False))}
    bit_t = _time_bitmap(*bit_inputs[0])
    for key, t in arc_t.items():
        print(f"arc_sum ({key}) n={big.n}: L2 cold: device "
              f"{t['device_ms']:.5f} ms, event {t['ms']:.5f} ms, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}), "
              f"{100 * t['share_of_bound']:.1f} % of the bound; "
              f"torch.sparse.mm {t['library_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms; L2 warm: device "
              f"{t['warm_device_ms']:.5f} ms [clock {t['sm_clock']}]")
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
        bound_assumes="each input read once from HBM (L2 flushed before "
        "each timed call; x's rows gathered again hit L2)",
        **sweep[f"n={big.n} P=16"],
        timings=sweep,
        arc_sum=dict(launches=path_counts["arc_sum"], max_abs_err=err_arc,
                     **arc_t["lift P=16"], timings=arc_t),
        estimator_wall_ms=walls)
    bit_entry = dict(
        name="bitmap_intersect", route="cuda",
        source="src/repro_torch/csrc/bitmap_intersect.cu",
        replaces="src/repro/kernels/bitmap_intersect.py:27",
        launches=bit_launches, launches_per_graph=bit_per_shape,
        cuda_kernels_per_launch=1, max_abs_err=bit_err, **bit_t)
    return spmv_entry, bit_entry, path_counts["radix_hist"]


# -- phase 6: the LM serving path -----------------------------------------

LM_ARCH = "phi3-mini-3.8b"
# the MLA, SSM, hybrid and MoE families, served after phi3
LM_FAMILIES = ("minicpm3-4b", "mamba2-370m", "hymba-1.5b",
               "granite-moe-3b-a800m", "dbrx-132b")
FAMILY_TIMED_CALLS = 1   # their timed runs of the serving steps
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
PARITY_DEPTH, PARITY_BATCH, PARITY_PROMPT = 2, 2, 256
# depth cuts: dbrx-132b's 40 layers (264 GB in bf16) do not fit one
# card's 80 GB; 8 layers at full width are 54.6 GB. Its fp32 parity runs
# at depth 1: about 18 GB of fp32 weights on each side
SERVE_DEPTH = {"dbrx-132b": 8}
PARITY_DEPTHS = {"dbrx-132b": 1}
# the encoder: 4 clips of 30 s at hubert's 20 ms frame stride
ENCODER_ARCH = "hubert-xlarge"
ENCODE_BATCH, ENCODE_FRAMES, ENCODE_TIMED = 4, 1500, 3
F32_TOL = 2e-5  # atol = rtol, the reference's own kernel tests


def _ring(slots: int, last: int) -> np.ndarray:
    """Slot positions of a ring cache after writing 0..last (-1 empty)."""
    kpos = np.full(slots, -1, np.int32)
    p = np.arange(last + 1)
    kpos[p % slots] = p  # later positions overwrite earlier ones
    return kpos


def _flash_cases():
    """(b, sq, sk, h, kv, d, dtype, qpos, kpos, causal, window) per name;
    positions None mean 0..S-1."""
    bf, f32 = torch.bfloat16, torch.float32
    pad_q, pad_k = np.arange(512, dtype=np.int32), np.arange(
        512, dtype=np.int32)
    pad_q[:4], pad_q[4] = -1, 1     # rows 0-4 see no key
    pad_k[:2], pad_k[-7:] = -1, -1
    full_cache = np.full(2081, -1, np.int32)
    full_cache[:2049] = np.arange(2049)
    return {
        "phi3 prefill bf16": (4, 2048, 2048, 32, 32, 96, bf, None, None,
                              True, None),
        "phi3 prefill fp32": (4, 2048, 2048, 32, 32, 96, f32, None, None,
                              True, None),
        "internlm2 GQA 48/8 d128 bf16": (1, 1024, 1024, 48, 8, 128, bf,
                                         None, None, True, None),
        "window 1024 S=3072 bf16": (1, 3072, 3072, 32, 32, 96, bf, None,
                                    None, True, 1024),
        "ragged Sq=1000 Sk=1537 fp32": (2, 1000, 1537, 32, 32, 96, f32,
                                        np.arange(537, 1537), None, True,
                                        None),
        "padding, empty rows fp32": (2, 512, 512, 8, 8, 128, f32, pad_q,
                                     pad_k, True, None),
        "padding, empty rows bf16": (2, 512, 512, 8, 8, 128, bf, pad_q,
                                     pad_k, True, None),
        "padding, empty rows, 512 items bf16": (4, 512, 512, 32, 32, 96, bf,
                                                pad_q, pad_k, True, None),
        "Sq=1, full cache bf16": (4, 1, 2081, 32, 32, 96, bf,
                                  np.array([2048]), full_cache, True, None),
        "Sq=1, ring of 1024 bf16": (4, 1, 1024, 32, 32, 96, bf,
                                    np.array([3000]), _ring(1024, 3000),
                                    True, 1024),
        "granite GQA 24/8 d64 bf16": (2, 2048, 2048, 24, 8, 64, bf, None,
                                      None, True, None),
        "hubert d80 bidirectional bf16": (2, 1000, 1000, 16, 16, 80, bf,
                                          None, None, False, None),
        # the mma.sync route's head dims in bf16
        "d32 padding, window 100 bf16": (2, 512, 512, 8, 4, 32, bf, pad_q,
                                         pad_k, True, 100),
        "d16 causal bf16": (2, 1024, 1024, 8, 8, 16, bf, None, None, True,
                            None),
        # the served families' prefill shapes: MLA's q/k head dim 64 + 32
        # with v zero-padded from 64 (FLASH_V_DIM); hymba's 25/5 GQA at
        # d = 64 on its windowed layers and on its global ones
        "minicpm3 prefill bf16": (4, 2048, 2048, 40, 40, 96, bf, None, None,
                                  True, None),
        "hymba prefill bf16 window 1024": (4, 2048, 2048, 25, 5, 64, bf,
                                           None, None, True, 1024),
        "hymba prefill bf16 global": (4, 2048, 2048, 25, 5, 64, bf, None,
                                      None, True, None),
        # MoE's prefill shapes (granite 24/8 at d = 64, dbrx 48/8 at
        # d = 128) and hubert's encode (16/16 at d = 80, bidirectional,
        # 1,500 frames: no multiple of a tile)
        "granite prefill bf16": (4, 2048, 2048, 24, 8, 64, bf, None, None,
                                 True, None),
        "dbrx prefill bf16": (4, 2048, 2048, 48, 8, 128, bf, None, None,
                              True, None),
        "hubert encode bf16": (4, 1500, 1500, 16, 16, 80, bf, None, None,
                               False, None),
    }


# cases whose v holds zeros past this column, as MLA pads it
FLASH_V_DIM = {"minicpm3 prefill bf16": 64}
# the served families' flash shapes, timed beside SDPA and the bound
FAMILY_FLASH_CASES = ("minicpm3 prefill bf16",
                      "hymba prefill bf16 window 1024",
                      "hymba prefill bf16 global", "granite prefill bf16",
                      "dbrx prefill bf16", "hubert encode bf16")


def _flash_inputs(dev, name, seed):
    b, sq, sk, h, kv, d, dt, qpos, kpos, causal, window = \
        _flash_cases()[name]
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    if name in FLASH_V_DIM:
        v[..., FLASH_V_DIM[name]:] = 0
    qp = torch.as_tensor(np.arange(sq) if qpos is None else qpos,
                         dtype=torch.int32, device=dev)
    kp = torch.as_tensor(np.arange(sk) if kpos is None else kpos,
                         dtype=torch.int32, device=dev)
    return q, k, v, qp, kp, causal, window


def _visible_pairs(q, k, qpos, kpos, causal, window) -> int:
    """The (query, key) pairs that this run's positions leave visible. At
    the model's own positions 0..S-1 it must equal
    `flash_attention.visible_pairs`, the count of the dry-run's
    `flops_work`: the bounds and the dry-run count one work."""
    from repro_torch.kernels import flash_attention as fa

    visible = int(fa.visible_mask(qpos, kpos, causal, window).sum())
    sq, sk = q.shape[1], k.shape[1]
    if (torch.equal(qpos.cpu().long(), torch.arange(sq))
            and torch.equal(kpos.cpu().long(), torch.arange(sk))):
        check(visible == fa.visible_pairs(sq, sk, causal, window),
              f"flash visible pairs {visible} != visible_pairs")
    return visible


def _flash_bound(q, k, v, qpos, kpos, causal, window) -> tuple:
    """Bytes: q, k, v read once and out written once; operations: the two
    products over the visible (query, key) pairs of this run's positions
    (`flash_attention.pair_flops` at FWD_PRODUCTS), at the dtype's peak
    rate."""
    from repro_torch.kernels import flash_attention as fa

    visible = _visible_pairs(q, k, qpos, kpos, causal, window)
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    return bound_ms(n_bytes, fa.pair_flops(q.shape, visible,
                                           fa.FWD_PRODUCTS), rate)


LSE_TOL = 1e-4  # atol = rtol of the forward's LSE against its plain one


def _check_flash(dev):
    """The kernel its route picks against the plain version on the card at
    every case, and the LSE it writes when asked against
    `flash_attention_lse_plain` (within LSE_TOL, +inf exactly where a row
    sees no key, the output unchanged); returns ({case: max abs error},
    {case: the LSE's max abs error})."""
    from repro_torch.kernels import flash_attention as fa

    errors, lse_errors = {}, {}
    for i, (name, case) in enumerate(_flash_cases().items()):
        args = _flash_inputs(dev, name, seed=100 + i)
        route = fa.cuda_route(case[6], case[5])
        got = fa.flash_attention_cuda(*args)
        torch.cuda.synchronize()
        if got.dtype == torch.bfloat16:
            # one ulp of the output plus what rounding p to bf16 can move
            # it (fa.bf16_agreement), and a relative L2 limit
            res = fa.bf16_agreement(got, *args)
            ok, err = res.pop("ok"), res["max_abs_err"]
            how = (f"worst err / its bound {res['worst']:.3f}, relative L2 "
                   f"{res['rel_l2']:.3e} (limit {fa.BF16_REL_L2:g}), mean "
                   f"|want| {res['mean_abs_want']:.3e}")
        else:
            want = fa.flash_attention_plain(*args)
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
            how = f"atol = rtol = {F32_TOL:g}"
        errors[name] = err
        print(f"flash_attention {name} ({fa.ROUTES[route]}): max abs err "
              f"{err:.3e}, {how}, within {ok}")
        check(ok, f"flash_attention differs from its plain version at {name}")
        check(torch.equal(got, fa.flash_attention_cuda(*args)),
              f"flash_attention: two launches differ at {name}")
        with_lse, lse = fa.flash_attention_cuda(*args, return_lse=True)
        want = fa.flash_attention_lse_plain(*args[:2], *args[3:])
        fin = torch.isfinite(want)
        lse_errors[name] = float((lse[fin] - want[fin]).abs().max()) \
            if fin.any() else 0.0
        empty = int((~fin).sum())
        print(f"flash_attention lse {name} ({fa.ROUTES[route]}): max abs err "
              f"{lse_errors[name]:.3e} (atol = rtol = {LSE_TOL:g}), "
              f"{empty} rows +inf")
        check(torch.equal(with_lse, got),
              f"flash_attention: writing the LSE changed the output at {name}")
        check(torch.equal(torch.isinf(lse), ~fin) and torch.allclose(
            lse[fin], want[fin], atol=LSE_TOL, rtol=LSE_TOL),
              f"flash_attention: the LSE differs from its plain version at "
              f"{name}")
        del with_lse, lse, want
    return errors, lse_errors


def _time_flash(dev, name):
    """The kernel its route picks at one case: CUDA-event and device time
    beside the plain version, F.scaled_dot_product_attention on the same
    tensors (GQA by `enable_gqa`, a window as a boolean mask, no mask for
    a bidirectional case) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, causal, window = args = _flash_inputs(dev, name, seed=7)
    check(torch.equal(qp, kp), "the SDPA yardstick takes a square case")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is not None:
        how = dict(attn_mask=fa.visible_mask(qp, kp, causal, window))
    else:
        how = dict(is_causal=True) if causal else {}
    if k.shape[2] != q.shape[2]:
        how["enable_gqa"] = True
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, **how)
    lib_diff = float((sdpa().transpose(1, 2).float()
                      - fa.flash_attention_cuda(*args).float()).abs().max())
    b_ms, b_by = _flash_bound(*args)
    route = fa.cuda_route(q.dtype, q.shape[3])
    run = lambda: fa.flash_attention_cuda(*args)  # noqa: E731
    t = dict(
        # CUDA-event time first: a profiler session skews later ones
        ms=time_cuda(run, iters=10),
        device_ms=device_ms(run, fa.ROUTES[route], iters=10,
                            every_call=True),
        plain_ms=time_cuda(lambda: fa.flash_attention_plain(*args), iters=3,
                           warmup=1),
        library_ms=time_cuda(sdpa, iters=10),
        library_max_abs_diff=lib_diff,
        bound_ms=b_ms, bound_by=b_by, kernel_route=route,
        cuda_kernel=f"{fa.ROUTES[route]}<{q.shape[3]}>",
        at=f"B={q.shape[0]} S={q.shape[1]} H={q.shape[2]} Kv={k.shape[2]} "
           f"d={q.shape[3]} {str(q.dtype).replace('torch.', '')} "
           + ("causal" if causal else "bidirectional")
           + ("" if window is None else f" window {window}"),
        library_call=("F.scaled_dot_product_attention("
                      + ", ".join(sorted(how) or ["no mask"]) + ")"))
    # SDPA's kernel (cuDNN's, PyTorch's own flash or memory-efficient
    # kernel) by the same method; None where the trace names none
    t["library_device_ms"], lib_kernels = device_profile(
        sdpa, ("sdpa", "flash_fwd", "fmha", "efficient_attention"),
        iters=10, required=False, every_call=True)
    t["library_kernels"] = sorted(lib_kernels)
    return t


def _time_flash_lse(dev, name) -> dict:
    """The forward at one case without and with its LSE written, in turns
    (without, with, with, without): the CUDA-event and device ms of each
    turn."""
    from repro_torch.kernels import flash_attention as fa

    args = _flash_inputs(dev, name, seed=7)
    kernel = fa.ROUTES[fa.cuda_route(args[0].dtype, args[0].shape[3])]
    runs = {"no_lse": lambda: fa.flash_attention_cuda(*args),
            "lse": lambda: fa.flash_attention_cuda(*args, return_lse=True)}
    t = {}
    for key in ("no_lse", "lse", "lse", "no_lse"):
        t.setdefault(f"{key}_ms", []).append(time_cuda(runs[key], iters=10))
        t.setdefault(f"{key}_device_ms", []).append(
            device_ms(runs[key], kernel, iters=10, every_call=True))
    return t


def _parity_depth2(dev, arch=LM_ARCH):
    """`arch` at full width and depth 2 (PARITY_DEPTHS: less) in fp32,
    weights drawn on a CPU generator: the card against the CPU, prefill's
    last logits and three decode steps fed the same (the CPU's greedy)
    tokens. Returns the max abs difference and the card run's flash
    launches (one per attention layer); an MoE layer makes one rank launch
    in the prefill and one in each decode step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM

    depth = PARITY_DEPTHS.get(arch, PARITY_DEPTH)
    cfg = dataclasses.replace(get_arch(arch), n_layers=depth,
                              dtype="float32")
    if depth != PARITY_DEPTH:
        print(f"lm parity {arch}: depth cut to {depth}, not "
              f"{PARITY_DEPTH} (fp32 weights "
              f"{cfg.n_params() * 4 / 1e9:.1f} GB on each side)")
    cpu = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = LM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT)), dtype=torch.int32)
    max_len = PARITY_PROMPT + 4
    ops.reset_launch_counts()
    with torch.inference_mode():
        c_cpu = cpu.init_caches(PARITY_BATCH, max_len)
        c_gpu = gpu.init_caches(PARITY_BATCH, max_len)
        l_cpu, c_cpu = cpu.prefill(prompt, c_cpu)
        l_gpu, c_gpu = gpu.prefill(prompt.to(dev), c_gpu)
        pairs = [("prefill", l_cpu, l_gpu)]
        for i in range(3):
            tok = torch.argmax(l_cpu, dim=-1).to(torch.int32)[:, None]
            pos = PARITY_PROMPT + i
            l_cpu, c_cpu = cpu.decode_step(tok, pos, c_cpu)
            l_gpu, c_gpu = gpu.decode_step(tok.to(dev), pos, c_gpu)
            pairs.append((f"decode {pos}", l_cpu, l_gpu))
    counts = ops.launch_counts()
    launches = counts["flash_attention"]
    worst = 0.0
    for what, a, b in pairs:
        b = b.cpu()
        diff = float((a - b).abs().max())
        worst = max(worst, diff)
        ok = torch.allclose(b, a, atol=1e-4, rtol=1e-4)
        print(f"lm parity {arch} depth {depth} fp32 {what}: max abs "
              f"diff card vs CPU {diff:.3e} (|logit| max "
              f"{float(a.abs().max()):.2f}), allclose 1e-4 {ok}")
        check(ok, f"lm parity: card and CPU differ at {what}")
    want = depth if cfg.has_attention else 0
    check(launches == want, f"lm parity {arch}: {launches} flash launches "
          f"on the card's prefill, not {want}")
    want = 4 * depth if cfg.is_moe else 0
    check(counts["radix_hist"] == want, f"lm parity {arch}: "
          f"{counts['radix_hist']} rank launches, not {want}")
    return worst, launches


def _run_steps(model, prompt, max_len):
    """`generate`'s loop through the serving steps, keeping what generate
    drops: the (B, new) tokens, the (B, new, V) logits that chose them,
    the prefill's ms and each decode step's ms (host clock around work
    that ends in a synchronize), and the port's kernel launches of the
    prefill and of each decode step (the counts set to 0 before each, read
    after it)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.serve_step import make_decode_step, \
        make_prefill_step

    prefill, decode = make_prefill_step(model), make_decode_step(model)
    b, s = prompt.shape
    with torch.inference_mode():
        caches = model.init_caches(b, max_len)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, caches = prefill(prompt, caches)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        pre_launches = ops.launch_counts()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks, all_logits, dec_ms, dec_launches = [tok], [logits], [], []
        for i in range(SERVE_NEW - 1):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            tok, logits, caches = decode(tok, s + i, caches)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            dec_launches.append(ops.launch_counts())
            toks.append(tok)
            all_logits.append(logits)
    return torch.cat(toks, dim=1), torch.stack(all_logits, dim=1), \
        pre_ms, dec_ms, (pre_launches, dec_launches)


def _profile(fn):
    """Device time of one call of fn by kind of kernel, from torch.profiler;
    the device's busy share of its wall time and its kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds = {"flash": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "radix": 0.0,
             "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.key == "cudaLaunchKernel":
            launches += e.count
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        key = e.key.lower()
        if "fa_bwd_" in key:
            kind = "flash_bwd"
        elif "flash_attention_" in key:
            kind = "flash"
        elif "radix_" in key:
            kind = "radix"
        elif any(t in key for t in ("gemm", "xmma", "cutlass", "nvjet")):
            kind = "gemm"
        else:
            kind = "other"
        kinds[kind] += e.self_device_time_total / 1e3
    busy = sum(kinds.values())
    return dict(kinds, wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                launches=launches)


def _profile_serving(model, prompt, max_len):
    """One prefill and one decode step under the profiler."""
    caches = model.init_caches(prompt.shape[0], max_len)
    s = prompt.shape[1]
    tok = prompt[:, -1:]
    with torch.inference_mode():
        prefill = _profile(lambda: model.prefill(prompt, caches))
        decode = _profile(lambda: model.decode_step(tok, s, caches))
    return prefill, decode


def _flash_on_path_inputs(model, prompt, max_len):
    """The flash kernel alone on the inputs the path gives it: those of
    the first layer's call in one prefill, caught by wrapping
    ops.flash_attention for that prefill. Device time per launch from
    torch.profiler, beside the inputs' strides."""
    from repro_torch.kernels import ops

    wrapped, seen = ops.flash_attention, []

    def catch(*args, **kwargs):
        if not seen:  # holding every layer's inputs would raise the peak
            seen.append((args, kwargs))
        return wrapped(*args, **kwargs)

    ops.flash_attention = catch
    try:
        with torch.inference_mode():
            model.prefill(prompt, model.init_caches(prompt.shape[0],
                                                    max_len))
    finally:
        ops.flash_attention = wrapped
    args, kwargs = seen[0]
    with torch.inference_mode():
        ms, by_kernel = device_profile(lambda: wrapped(*args, **kwargs),
                                       "flash_attention_", iters=10,
                                       every_call=True)
    return dict(isolated_device_ms=ms, cuda_kernels=sorted(by_kernel),
                strides=[list(x.stride()) for x in args[:3]])


def _moe_drops(model, run) -> tuple:
    """run() with every MoE layer's dispatch counted: returns (run's
    result, the (token, choice) pairs each layer dropped past its
    expert's capacity, those of the last position). A forward hook on
    each layer's `moe.MoE` module routes the input the path gave it once
    more, for that run only; its rank launches are not the main path's."""
    from repro_torch.models import moe

    drops, last = [], []

    def count(module, args, _out):
        cfg, x = args
        _, _, idx = moe.route(module, cfg, x)
        pos = moe.dispatch_ranks(idx, cfg.n_experts)
        dropped = pos >= _capacity(cfg, x.shape[1])
        drops.append(int(dropped.sum()))
        last.append(int(dropped.reshape(*idx.shape)[:, -1].sum()))

    hooks = [blk.mlp.register_forward_hook(count) for blk in model.layers
             if isinstance(blk.mlp, moe.MoE)]
    try:
        with torch.inference_mode():
            out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, drops, last


def _rel_l2(want, got) -> tuple:
    a, b = want.float(), got.float()
    rel = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a))
    return rel, (f"max abs {float((a - b).abs().max()):.4e}, greedy tokens "
                 f"equal {bool(torch.equal(a.argmax(-1), b.argmax(-1)))}")


def _dropless_contract(model, prompt, tok, max_len) -> tuple:
    """The serving contract of an MoE model where no pair is dropped, as
    the reference's own serving test holds it (its reduced configs' cf 8):
    at capacity factor E / k every expert's capacity exceeds the tokens of
    a row, the most pairs a row can send it. A prefill, one decode step
    at position S and the full forward over S + 1 tokens, all at that
    factor (a dispatch setting, not a weight), through a shallow copy of
    the model that shares its layers and weights and holds that config;
    returns the relative L2 of decode's logits against the full
    forward's, and how they differ."""
    import copy
    import dataclasses

    s = prompt.shape[1]
    dropless = copy.copy(model)   # model itself keeps its config
    dropless.cfg = dataclasses.replace(
        model.cfg, capacity_factor=model.cfg.n_experts / model.cfg.moe_top_k)
    check(all(_capacity(dropless.cfg, t) > t for t in (1, s, s + 1)),
          "the dropless capacity factor leaves a pair to drop")
    torch.cuda.empty_cache()
    with torch.inference_mode():
        _, caches = dropless.prefill(prompt, dropless.init_caches(
            prompt.shape[0], max_len))
        got, _ = dropless.decode_step(tok, s, caches)
        del caches
        want = dropless(torch.cat([prompt, tok], dim=1))[:, -1]
    return _rel_l2(want, got)


def _serve(dev, arch=LM_ARCH, timed=TIMED_CALLS):
    """The serving run of `arch` at full width in bf16 (at full depth, or
    SERVE_DEPTH's cut), weights drawn on the card. Returns the flash
    launches of one `generate` call (one per attention layer, all through
    the route of the bf16 head dim) and the run's numbers. An MoE model
    also makes one rank launch per MoE layer in the prefill and in each
    decode step, and no other kernel of the port runs."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.serve.serve_step import generate

    cfg = get_arch(arch)
    cut = None
    if arch in SERVE_DEPTH:
        cut = f"{SERVE_DEPTH[arch]} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
        print(f"lm serve {arch}: depth cut to {cut} (a cut: "
              f"{get_arch(arch).n_params() / 1e9:.1f} B params do not fit "
              f"one card; full width)")
    per_prefill = cfg.n_layers if cfg.has_attention else 0
    moe_layers = cfg.n_layers if cfg.is_moe else 0
    rank_per_generate = moe_layers * SERVE_NEW   # the prefill, 31 steps
    head_dim = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                if cfg.attn_type == "mla" else cfg.resolved_head_dim)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), dtype=torch.int32,
        device=dev)
    max_len = SERVE_PROMPT + SERVE_NEW + 1

    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks = generate(model, prompt, SERVE_NEW, max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        print(f"lm serve {arch} B={SERVE_BATCH} S={SERVE_PROMPT} new="
              f"{SERVE_NEW}: generate {wall:.2f} s, launches {counts}")
        check(counts["flash_attention"] == per_prefill,
              f"{arch}: generate made {counts['flash_attention']} flash "
              f"launches, not {per_prefill} (one per attention layer of the "
              f"prefill)")
        check(counts["radix_hist"] == rank_per_generate,
              f"{arch}: generate made {counts['radix_hist']} rank launches, "
              f"not {rank_per_generate} (one per MoE layer in the prefill "
              f"and in each of {SERVE_NEW - 1} decode steps)")
        check(sum(counts.values()) == counts["flash_attention"]
              + counts["radix_hist"],
              f"{arch}: generate launched another kernel of the port")
        routes = dict(fa.launches)
        if per_prefill:
            want = fa.cuda_route(torch.bfloat16, head_dim)
            check(routes[want] == per_prefill,
                  f"{arch}: generate's flash launches by route {routes}, not "
                  f"{per_prefill} through {want}")
        runs.append((toks, wall, counts, routes))
    (toks, gen_s, gen_counts, routes), (toks2, gen2_s, _, _) = runs
    launches = gen_counts["flash_attention"]
    check(toks.shape == (SERVE_BATCH, SERVE_NEW), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a token outside the vocabulary")
    check(torch.equal(toks, toks2), f"{arch}: two generate runs differ")

    # the same loop through the serving steps, for its logits and times:
    # a warm-up run, then `timed` runs; each the tokens of generate
    # and the launches of each prefill and decode step, counted apart:
    # flash and one rank launch per MoE layer in the prefill, rank
    # launches alone in a decode step
    steps = []
    for _ in range(1 + timed):
        steps.append(_run_steps(model, prompt, max_len))
    for st in steps:
        pre, dec = st[4]
        for what, got, flash in [("the prefill", pre, per_prefill)] + [
                (f"decode step {i}", c, 0) for i, c in enumerate(dec)]:
            check(got["flash_attention"] == flash,
                  f"{arch}: {what} made {got['flash_attention']} flash "
                  f"launches, not {flash}")
            check(got["radix_hist"] == moe_layers,
                  f"{arch}: {what} made {got['radix_hist']} rank launches, "
                  f"not {moe_layers} (one per MoE layer)")
            check(sum(got.values()) == flash + moe_layers,
                  f"{arch}: {what} launched another kernel of the port")
    pre_ranks = [st[4][0]["radix_hist"] for st in steps]
    dec_ranks = [c["radix_hist"] for st in steps for c in st[4][1]]
    if moe_layers:
        print(f"lm serve {arch}: rank launches per prefill {pre_ranks} "
              f"(each of {len(steps)} runs), per decode step "
              f"{sorted(set(dec_ranks))} (each of {len(dec_ranks)} steps)")
    logits = steps[0][1]
    check(bool(torch.isfinite(logits).all()), "serving logits not finite")
    for st_toks, st_logits, _, _, _ in steps:
        check(torch.equal(st_toks, toks), "the serving steps chose other "
              "tokens than generate")
        check(torch.equal(st_logits, logits), "two runs' logits differ")
    prefill_ms = statistics.median(st[2] for st in steps[1:])
    decode_ms = statistics.median(t for st in steps[1:] for t in st[3])

    # the serving runs' peak; the contract's runs below (an MoE model's
    # at a capacity where nothing drops) are checks, not serving
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    # the serving contract: decode's logits at position S against the full
    # forward over the prompt and the first generated token
    full_toks = torch.cat([prompt, toks[:, :1]], dim=1)
    where, drops, published = "", None, None
    if moe_layers:
        _, drops, _ = _moe_drops(model, lambda: model.prefill(
            prompt, model.init_caches(SERVE_BATCH, max_len)))
        full, _, last = _moe_drops(model, lambda: model(full_toks)[:, -1])
        rel, how = _rel_l2(full, logits[:, 1])
        print(f"lm serve {arch}: (token, choice) pairs the prefill dropped "
              f"past capacity, per MoE layer, of {SERVE_PROMPT} x "
              f"{cfg.moe_top_k} a row ({SERVE_BATCH} rows): {drops} "
              f"(total {sum(drops)})")
        print(f"lm serve {arch} at the config's capacity factor "
              f"{cfg.capacity_factor:g}: decode logits at position "
              f"{SERVE_PROMPT} vs the full forward over {SERVE_PROMPT + 1} "
              f"tokens: relative L2 {rel:.4e}, {how} (not the contract: "
              f"the full forward drops {sum(last)} of the last token's "
              f"{SERVE_BATCH * cfg.moe_top_k * moe_layers} pairs past "
              f"capacity, per layer {last}, which decode, capacity "
              f"{_capacity(cfg, 1)} for one token a row, never drops)")
        published = dict(rel_l2=rel, last_token_dropped_per_layer=last)
        del full
        rel, how = _dropless_contract(model, prompt, toks[:, :1], max_len)
        where = (f", both with no pair dropped (capacity factor E / k = "
                 f"{cfg.n_experts / cfg.moe_top_k:g})")
    else:
        with torch.inference_mode():
            full = model(full_toks)[:, -1]
        rel, how = _rel_l2(full, logits[:, 1])
    print(f"lm serve contract {arch}: decode logits at position "
          f"{SERVE_PROMPT} vs the full forward over {SERVE_PROMPT + 1} "
          f"tokens{where}: relative L2 {rel:.4e} (limit 5e-2), {how}")
    check(rel <= 5e-2, f"serving contract {arch}: relative L2 {rel}")
    contract_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof_prefill, prof_decode = _profile_serving(model, prompt, max_len)
    on_path = None
    if per_prefill:
        on_path = _flash_on_path_inputs(model, prompt, max_len)
        on_path["profile_prefill_ms_per_launch"] = (prof_prefill["flash"]
                                                    / per_prefill)
        print(f"lm flash per launch {arch}: {on_path}")
    numbers = dict(
        arch=arch, depth_cut=cut, params=n_params, batch=SERVE_BATCH,
        prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, init_s=init_s,
        generate_s=[gen_s, gen2_s], prefill_ms=prefill_ms,
        prefill_tok_per_s=SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
        decode_ms_per_step=decode_ms,
        decode_tok_per_s=SERVE_BATCH / decode_ms * 1e3,
        contract_rel_l2=rel, peak_memory_gb=peak_gb,
        contract_peak_memory_gb=contract_peak_gb, flash_on_path=on_path,
        prefill_profile_ms=prof_prefill, decode_profile_ms=prof_decode)
    numbers["flash_launches_by_route"] = routes
    if moe_layers:
        numbers["moe"] = dict(
            rank_launches_per_prefill=pre_ranks[-1],
            rank_launches_per_decode_step=dec_ranks[-1],
            rank_launches_per_generate=gen_counts["radix_hist"],
            capacity_prefill=_capacity(cfg, SERVE_PROMPT),
            capacity_decode=_capacity(cfg, 1),
            dropped_pairs_per_layer=drops,
            contract_at_config_capacity_factor=published,
            contract_capacity_factor=cfg.n_experts / cfg.moe_top_k)
    print(f"lm serve {arch}: {n_params / 1e9:.3f} B params, prefill "
          f"{prefill_ms:.1f} ms ({numbers['prefill_tok_per_s']:.0f} tok/s), "
          f"decode {decode_ms:.2f} ms a step "
          f"({numbers['decode_tok_per_s']:.1f} tok/s), peak memory "
          f"{peak_gb:.2f} GB (the contract's runs {contract_peak_gb:.2f} GB)"
          + (f" (depth cut: {cut})" if cut else ""))
    print(f"lm serve numbers: {json.dumps(numbers)}")
    return launches, numbers


# the MoE dispatch's rank calls: keys row·E + expert over B rows of
# S·k pairs (granite's prefill: 65,536 keys < 160; dbrx's: 32,768 < 64;
# a granite decode step: 32 keys < 160)
MOE_RANK_CASES = {"granite prefill": (4, 2048 * 8, 40),
                  "dbrx prefill": (4, 2048 * 4, 16),
                  "granite decode step": (4, 8, 40)}


def _moe_rank_entry(dev) -> dict:
    """The rank entry of csrc/radix_hist.cu at the MoE dispatch's shapes
    against its plain version (torch.equal, rank and histogram), then
    timed: CUDA events, then device time, beside the plain version and
    the bound by bytes (M int32 read, M int32 and the 256-bin histogram
    written). No single PyTorch call computes a rank within buckets."""
    from repro_torch.kernels import radix_hist

    rng = np.random.default_rng(23)
    out, calls = {}, {}
    for name, (b, pairs, e) in MOE_RANK_CASES.items():
        keys = (rng.integers(0, e, (b, pairs))
                + np.arange(b)[:, None] * e).reshape(-1)
        dt = torch.as_tensor(keys.astype(np.int32), device=dev)
        rank, hist = radix_hist.bucket_rank_hist_cuda(dt)
        want_r, want_h = radix_hist.bucket_rank_hist_plain(dt)
        torch.cuda.synchronize()
        ok = torch.equal(rank, want_r) and torch.equal(hist, want_h)
        print(f"radix_hist rank entry at MoE {name} (M={dt.numel()}, keys "
              f"< {b * e}): equal={ok}")
        check(ok, f"radix_hist rank entry differs from its plain version "
                  f"at MoE {name}")
        calls[name] = call = (
            lambda dt=dt: radix_hist.bucket_rank_hist_cuda(dt))
        b_ms, b_by = bound_ms(8 * dt.numel() + 4 * radix_hist.NB, 0)
        out[name] = dict(
            m=dt.numel(), buckets=b * e, ms=time_cuda(call, iters=50),
            plain_ms=time_cuda(lambda dt=dt: radix_hist.bucket_rank_hist_plain(
                dt), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for name, call in calls.items():
        out[name]["device_ms"] = device_ms(call, RADIX_DEVICE)
        print(f"radix_hist rank entry at MoE {name}: {out[name]}")
    return out


def _encode_parity(dev, arch=ENCODER_ARCH):
    """The encoder at full width and depth 2 in fp32, weights drawn on a
    CPU generator: the card's encode of PARITY_BATCH x PARITY_PROMPT
    frames against the CPU's. Returns the max abs difference and the card
    run's flash launches (one per layer, the only kernel of the port)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_arch(arch), n_layers=PARITY_DEPTH,
                              dtype="float32")
    cpu = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = LM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    feats = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (PARITY_BATCH, PARITY_PROMPT, cfg.feat_dim)), dtype=torch.float32)
    ops.reset_launch_counts()
    with torch.inference_mode():
        want = cpu.encode(feats)
        got = gpu.encode(feats.to(dev)).cpu()
    counts = ops.launch_counts()
    diff = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    print(f"lm parity {arch} depth {PARITY_DEPTH} fp32 encode of "
          f"{PARITY_BATCH} x {PARITY_PROMPT} frames: max abs diff card vs "
          f"CPU {diff:.3e} (|logit| max {float(want.abs().max()):.2f}), "
          f"allclose 1e-4 {ok}, launches {counts}")
    check(ok, f"lm parity {arch}: card and CPU encodes differ")
    check(counts["flash_attention"] == sum(counts.values()) == PARITY_DEPTH,
          f"lm parity {arch}: launches {counts}, not {PARITY_DEPTH} flash")
    return diff, counts["flash_attention"]


def _encode(dev, arch=ENCODER_ARCH):
    """The encoder at full width and depth in bf16, weights drawn on the
    card, on ENCODE_BATCH x ENCODE_FRAMES random frame features: two
    encodes bit-equal, one flash launch per layer (the route of the bf16
    head dim) and no other kernel of the port, finite logits, the median
    encode ms, the device time by kernel kind, peak memory, and the
    contract: the bf16 logits against an fp32 encode of the same weights
    on the card, relative L2 <= 5e-2. Returns the flash launches of one
    encode and the run's numbers."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM

    cfg = get_arch(arch)
    route = fa.cuda_route(torch.bfloat16, cfg.resolved_head_dim)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    feats = torch.randn((ENCODE_BATCH, ENCODE_FRAMES, cfg.feat_dim),
                        generator=torch.Generator(dev).manual_seed(3),
                        device=dev)
    outs = []
    for _ in range(2):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs.append(model.encode(feats))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes = ops.launch_counts(), dict(fa.launches)
        print(f"lm encode {arch} B={ENCODE_BATCH} T={ENCODE_FRAMES}: "
              f"{wall * 1e3:.1f} ms, launches {counts}, flash by route "
              f"{routes}")
        check(counts["flash_attention"] == cfg.n_layers,
              f"{arch}: encode made {counts['flash_attention']} flash "
              f"launches, not {cfg.n_layers}")
        check(sum(counts.values()) == counts["flash_attention"],
              f"{arch}: encode launched another kernel of the port")
        check(routes[route] == cfg.n_layers,
              f"{arch}: flash launches by route {routes}, not "
              f"{cfg.n_layers} through {route}")
    logits = outs[0]
    check(torch.equal(outs[0], outs[1]), f"{arch}: two encodes differ")
    del outs
    check(logits.shape == (ENCODE_BATCH, ENCODE_FRAMES, cfg.vocab_size),
          f"encode logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "encode logits not finite")
    walls = []
    for _ in range(ENCODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.encode(feats)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    encode_ms = statistics.median(walls)
    with torch.inference_mode():
        prof = _profile(lambda: model.encode(feats))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the contract: the same weights in fp32 on the card (the fp32 route)
    m32 = LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
    m32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = m32.encode(feats)
    del m32
    a, b = want, logits.float()
    rel = float(torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(a))
    print(f"lm encode contract {arch}: bf16 logits vs an fp32 encode of the "
          f"same weights on the card: relative L2 {rel:.4e} (limit 5e-2), "
          f"max abs {float((a - b).abs().max()):.4e}, argmax equal "
          f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.4f} of "
          f"frames")
    check(rel <= 5e-2, f"encode contract {arch}: relative L2 {rel}")
    numbers = dict(
        arch=arch, params=n_params, batch=ENCODE_BATCH, frames=ENCODE_FRAMES,
        init_s=init_s, encode_ms=encode_ms, encode_ms_runs=walls,
        frames_per_s=ENCODE_BATCH * ENCODE_FRAMES / encode_ms * 1e3,
        contract_rel_l2=rel, peak_memory_gb=peak_gb,
        encode_profile_ms=prof, flash_launches_by_route=routes)
    print(f"lm encode {arch}: {n_params / 1e9:.3f} B params, encode "
          f"{encode_ms:.1f} ms ({numbers['frames_per_s']:.0f} frames/s), "
          f"peak memory {peak_gb:.2f} GB")
    print(f"lm encode numbers: {json.dumps(numbers)}")
    return counts["flash_attention"], numbers


def _capacity(cfg, tokens: int) -> int:
    from repro_torch.models import moe

    return moe.capacity(tokens, cfg.moe_top_k, cfg.n_experts,
                        cfg.capacity_factor)


def _flash_build_report() -> list:
    """Registers, spills and shared memory of each flash kernel, from the
    build's `-Xptxas -v` report; fails on a spill of the wgmma kernel or
    on a `setmaxnreg` that ptxas ignored (C7508)."""
    import re

    from repro_torch.kernels import _build

    log = _build.build_log()
    check("C7508" not in log, "ptxas ignored setmaxnreg (C7508)")
    rows, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        k = name and re.search(
            r"(flash_attention_\w+?_kernel|fa_bwd_\w+?)ILi(\d+)E", name)
        if m and k:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows.append(dict(kernel=f"{k.group(1)}<{k.group(2)}>",
                             registers=int(m.group(1)),
                             spill_stores=spill[0], spill_loads=spill[1],
                             static_smem=int(smem.group(1)) if smem else 0))
    for row in rows:
        print(f"build {row['kernel']}: {row['registers']} registers, spill "
              f"stores {row['spill_stores']} B, loads {row['spill_loads']} "
              f"B, static smem {row['static_smem']} B")
        if "wgmma" in row["kernel"]:
            check(row["spill_stores"] == row["spill_loads"] == 0,
                  f"{row['kernel']} spills registers")
    check(sum("flash_attention_wgmma" in r["kernel"] for r in rows) == 4,
          "the build report lists no wgmma kernel for d = 64, 80, 96, 128")
    check(sum(r["kernel"].startswith(fa_bwd) for r in rows
              for fa_bwd in ("fa_bwd_dq_wgmma<", "fa_bwd_dkv_wgmma<")) == 8,
          "the build report lists no wgmma backward for d = 64, 80, 96, "
          "128")
    return rows


def _flash_sass() -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the wgmma
    kernels' SASS (the forward's, and the backward's two), from cuobjdump
    of the built library."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        head = fn.splitlines()[0]
        for kind in ("flash_attention_wgmma_kernel", "fa_bwd_dq_wgmma",
                     "fa_bwd_dkv_wgmma"):
            if kind in head:
                got = counts.setdefault(kind, {})
                for op in ("HGMMA", "UTMALDG"):
                    got[op] = got.get(op, 0) + fn.count(op)
    print(f"cuobjdump -sass, wgmma kernels: {counts}")
    check(len(counts) == 3 and all(
        c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0
        for c in counts.values()),
          "a wgmma kernel's SASS holds no HGMMA or no UTMALDG")
    return counts


def phase_lm(dev):
    """Kernel checks and times (the flash shapes, the rank entry at the MoE
    dispatch's shapes), the depth-2 parity, then the serving run; then
    each of LM_FAMILIES: its depth-2 parity and its serving run; then the
    encoder's depth-2 parity and its encode run; each model freed before
    the next is built. Returns the flash_attention entry of the kernels
    line and what the radix_hist entry gains on the MoE path."""
    from repro_torch.kernels import ops

    build_report = _flash_build_report()
    sass = _flash_sass()
    errors, lse_errors = _check_flash(dev)
    timing = _time_flash(dev, "phi3 prefill bf16")
    timing32 = _time_flash(dev, "phi3 prefill fp32")
    print(f"flash_attention timings {timing['at']}: {timing}")
    print(f"flash_attention timings {timing32['at']}: {timing32}")
    lse_timing = _time_flash_lse(dev, "phi3 prefill bf16")
    print(f"flash_attention with and without the LSE, phi3 prefill bf16: "
          f"{json.dumps(lse_timing)}")
    t0 = time.perf_counter()
    family_timings = {}
    for name in FAMILY_FLASH_CASES:
        family_timings[name] = _time_flash(dev, name)
        print(f"flash_attention timings {name} "
              f"{family_timings[name]['at']}: {family_timings[name]}")
    print(f"lm family flash timings: {time.perf_counter() - t0:.1f} s")
    moe_rank = _moe_rank_entry(dev)
    ops.reset_launch_counts()  # the checks above are not the main path
    parity_diff, parity_launches = _parity_depth2(dev)
    launches, numbers = _serve(dev)
    families = {}
    for arch in LM_FAMILIES:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        diff, par_launches = _parity_depth2(dev, arch)
        print(f"lm parity {arch} wall: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fam_launches, fam_numbers = _serve(dev, arch, FAMILY_TIMED_CALLS)
        print(f"lm serve {arch} wall: {time.perf_counter() - t0:.1f} s")
        families[arch] = dict(launches_per_prefill=fam_launches,
                              parity_depth2_max_abs_diff=diff,
                              parity_depth2_launches=par_launches,
                              parity_depth=PARITY_DEPTHS.get(arch,
                                                             PARITY_DEPTH),
                              serve=fam_numbers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    enc_diff, enc_par_launches = _encode_parity(dev)
    enc_launches, enc_numbers = _encode(dev)
    check(enc_numbers["flash_launches_by_route"]["wgmma"] == enc_launches,
          f"{ENCODER_ARCH}: flash launches by route "
          f"{enc_numbers['flash_launches_by_route']}, not all wgmma")
    print(f"lm encode {ENCODER_ARCH} wall: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    bf16_errs = [e for n, e in errors.items() if "fp32" not in n]
    per_prefill = {LM_ARCH: launches}
    per_prefill.update({a: f["launches_per_prefill"]
                        for a, f in families.items()})
    radix_moe = dict(
        rank_entry_moe=moe_rank,
        launches_moe_path={a: f["serve"]["moe"] for a, f in families.items()
                           if "moe" in f["serve"]})
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        sources=["src/repro_torch/csrc/flash_attention_sm90.cu",
                 "src/repro_torch/csrc/flash_attention.cu"],
        prefill_cuda_kernel=timing["cuda_kernel"],
        launches_by_route=numbers["flash_launches_by_route"],
        build=build_report, sass=sass,
        replaces="src/repro/kernels/flash_attention.py:72",
        launches=launches, launches_per_graph={"prefill": launches},
        launches_per_prefill=per_prefill,
        cuda_kernels_per_launch=1, max_abs_err=max(bf16_errs),
        max_abs_err_fp32=max(e for n, e in errors.items() if "fp32" in n),
        max_abs_err_per_case=errors, max_abs_err_lse_per_case=lse_errors,
        lse_timing=lse_timing, **timing, fp32=timing32,
        family_shapes=family_timings,
        parity_depth2_max_abs_diff=parity_diff,
        parity_depth2_launches=parity_launches, serve=numbers,
        families=families,
        launches_per_encode={ENCODER_ARCH: enc_launches},
        encoder=dict(parity_depth2_max_abs_diff=enc_diff,
                     parity_depth2_launches=enc_par_launches,
                     encode=enc_numbers)), radix_moe


# ------------------------------------------------------------------ train
# the flash shapes on which the backward kernel is checked, each in fp32
# and in bf16 (the case's own dtype is replaced): phi3, granite, dbrx,
# hubert (bidirectional, d = 80), hymba's window and global layers,
# minicpm3 (v zero-padded), Sq != Sk, -1 padding with rows that see no key
BWD_CASES = ("phi3 prefill bf16", "granite prefill bf16",
             "dbrx prefill bf16", "hubert encode bf16",
             "hymba prefill bf16 window 1024", "hymba prefill bf16 global",
             "minicpm3 prefill bf16", "ragged Sq=1000 Sk=1537 fp32",
             "padding, empty rows bf16")
BWD_TIMED = BWD_CASES[:7]   # the families' shapes, timed in bf16
BWD_F32_TOL = 1e-4          # fp32: max abs err <= this x max |grad|
BWD_BF16_REL_L2 = 1e-2      # bf16: per tensor, against the fp32 plain
SDPA_BWD_KERNELS = ("flash_bwd", "fmha", "efficient_attention", "cudnn",
                    "sdpa", "attention_backward")


def _bwd_inputs(dev, name, dtype, seed):
    """A flash case's q, k, v in `dtype`, its positions and mask, and an
    output gradient (zero past FLASH_V_DIM, as MLA's slice gives it)."""
    q, k, v, qp, kp, causal, window = _flash_inputs(dev, name, seed)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(
        seed + 1), device=dev).to(dtype)
    if name in FLASH_V_DIM:
        dout[..., FLASH_V_DIM[name]:] = 0
    return q, k, v, qp, kp, causal, window, dout


def _flash_bwd_bound(q, k, v, qpos, kpos, causal, window) -> tuple:
    """Bytes: q, k, v, out and dout read once, dq, dk and dv written once;
    operations: the gradient's five products (S, dP, dV, dK, dQ) over the
    visible (query, key) pairs of this run's positions
    (`flash_attention.pair_flops` at BWD_PRODUCTS), at the dtype's peak
    rate. The products that the kernels compute twice (S and dP, in the
    dQ and the dK/dV kernel) are not the function's work and are left out
    (`_flash_bwd_floor`)."""
    from repro_torch.kernels import flash_attention as fa

    visible = _visible_pairs(q, k, qpos, kpos, causal, window)
    n_bytes = 4 * (q.numel() + k.numel()) * q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    return bound_ms(n_bytes, fa.pair_flops(q.shape, visible,
                                           fa.BWD_PRODUCTS), rate)


def _flash_bwd_floor(q, k, qpos, kpos, causal, window) -> float:
    """The two-kernel design's own floor in ms: its seven products (S and
    dP in both kernels, dQ, dK, dV), 14·d FLOP per visible pair and query
    head, at the bf16 tensor-core rate."""
    from repro_torch.kernels import flash_attention as fa

    visible = _visible_pairs(q, k, qpos, kpos, causal, window)
    return fa.pair_flops(q.shape, visible, 7) / BF16_OPS_PER_S * 1e3


def _check_flash_bwd(dev) -> dict:
    """The backward kernel against the plain backward on the card at every
    BWD_CASES shape: fp32 within BWD_F32_TOL x max |grad| per tensor,
    bf16 within a relative L2 of BWD_BF16_REL_L2 per tensor against the
    plain backward in fp32 on the same bf16 inputs; two runs bit-equal.
    Returns {case dtype: max abs error}."""
    from repro_torch.kernels import flash_attention as fa

    errors = {}
    for i, name in enumerate(BWD_CASES):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, qp, kp, causal, window, dout = _bwd_inputs(
                dev, name, dt, 300 + i)
            out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, causal,
                                               window, return_lse=True)
            route = fa.cuda_bwd_route(dt, q.shape[3])
            before = fa.bwd_launches[route]
            got = fa.flash_attention_backward_cuda(dout, q, k, v, out, qp,
                                                   kp, causal, window,
                                                   lse=lse)
            again = fa.flash_attention_backward_cuda(dout, q, k, v, out, qp,
                                                     kp, causal, window,
                                                     lse=lse)
            torch.cuda.synchronize()
            check(fa.bwd_launches[route] == before + 2,
                  f"flash backward: not counted under its route {route}")
            tag = f"{name.replace(' bf16', '').replace(' fp32', '')} " \
                  f"{'fp32' if dt == torch.float32 else 'bf16'}"
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash backward: two runs differ at {tag}")
            del again
            want = fa.flash_attention_backward_plain(
                dout.float(), q.float(), k.float(), v.float(), qp, kp,
                causal, window)
            parts, worst = [], 0.0
            for tname, a, w in zip(("dq", "dk", "dv"), got, want):
                diff = (a.float() - w).abs()
                err, top = float(diff.max()), float(w.abs().max())
                worst = max(worst, err)
                if dt == torch.float32:
                    ok = err <= BWD_F32_TOL * top
                    parts.append(f"{tname} max abs {err:.3e} (max |grad| "
                                 f"{top:.3e}, limit {BWD_F32_TOL:g} x)")
                else:
                    rel = float(torch.linalg.vector_norm(diff)
                                / torch.linalg.vector_norm(w))
                    ok = rel <= BWD_BF16_REL_L2
                    parts.append(f"{tname} rel L2 {rel:.3e} (limit "
                                 f"{BWD_BF16_REL_L2:g}), max abs {err:.3e}")
                check(ok and bool(torch.isfinite(a).all()),
                      f"flash backward {tag}: {tname} off its plain "
                      f"backward: {parts[-1]}")
            errors[tag] = worst
            print(f"flash_attention_bwd {tag} ({route}: "
                  f"{', '.join(fa.BWD_ROUTES[route])}): {'; '.join(parts)}; "
                  f"two runs bit-equal")
            del got, want, out, lse, q, k, v, dout
            torch.cuda.empty_cache()
    return errors


def _time_flash_bwd(dev, name) -> dict:
    """The backward kernels at one case in bf16, the LSE from the forward:
    CUDA-event and device time (each of its kernels too, which must be the
    route's and no other: no row-stats pass) beside the plain backward,
    SDPA's backward alone on the same function (GQA by `enable_gqa`, a
    window as a boolean mask, no mask where bidirectional), the bound and
    the seven-product floor."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, causal, window, dout = _bwd_inputs(
        dev, name, torch.bfloat16, seed=9)
    check(torch.equal(qp, kp), "the SDPA yardstick takes a square case")
    out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, causal, window,
                                       return_lse=True)
    run = lambda: fa.flash_attention_backward_cuda(  # noqa: E731
        dout, q, k, v, out, qp, kp, causal, window, lse=lse)
    if window is not None:
        how = dict(attn_mask=fa.visible_mask(qp, kp, causal, window))
    else:
        how = dict(is_causal=True) if causal else {}
    if k.shape[2] != q.shape[2]:
        how["enable_gqa"] = True
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, **how)
    gt = dout.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        o, (qt, kt, vt), gt, retain_graph=True)
    b_ms, b_by = _flash_bwd_bound(q, k, v, qp, kp, causal, window)
    t = dict(
        ms=time_cuda(run, iters=10),
        plain_ms=time_cuda(lambda: fa.flash_attention_backward_plain(
            dout, q, k, v, qp, kp, causal, window), iters=2, warmup=1),
        library_ms=time_cuda(sdpa_bwd, iters=10),
        bound_ms=b_ms, bound_by=b_by,
        floor7_ms=_flash_bwd_floor(q, k, qp, kp, causal, window),
        at=f"B={q.shape[0]} S={q.shape[1]} H={q.shape[2]} Kv={k.shape[2]} "
           f"d={q.shape[3]} bfloat16 "
           + ("causal" if causal else "bidirectional")
           + ("" if window is None else f" window {window}"),
        library_call=("backward of F.scaled_dot_product_attention("
                      + ", ".join(sorted(how) or ["no mask"]) + ")"))
    t["device_ms"], by_kernel = device_profile(run, "fa_bwd_", iters=10,
                                               every_call=True)
    t["device_ms_by_kernel"] = by_kernel
    names = fa.BWD_ROUTES[fa.cuda_bwd_route(q.dtype, q.shape[3])]
    check(not by_kernel or sorted(n.split("<")[0] for n in by_kernel)
          == sorted(names),
          f"flash backward at {name}: kernels {sorted(by_kernel)}, not "
          f"{names}")
    t["library_device_ms"], lib_kernels = device_profile(
        sdpa_bwd, SDPA_BWD_KERNELS, iters=10, required=False,
        every_call=True)
    t["library_kernels"] = sorted(lib_kernels)
    del o
    return t


def _check_grad_fn(dev) -> None:
    """A CUDA `ops.flash_attention` output whose inputs require grad has a
    grad_fn, and its backward reaches q, k and v through the kernel."""
    from repro_torch.kernels import ops

    g = torch.Generator(dev).manual_seed(5)
    q, k, v = (torch.randn((2, 96, 4, 64), generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    before = ops.launch_counts()["flash_attention_bwd"]
    out = ops.flash_attention(q, k, v, causal=True)
    check(out.grad_fn is not None, "a CUDA flash output has no grad_fn")
    out.float().square().sum().backward()
    check(ops.launch_counts()["flash_attention_bwd"] == before + 1,
          "the CUDA flash output's backward did not launch the kernel")
    check(all(x.grad is not None and float(x.grad.float().abs().max()) > 0
              for x in (q, k, v)), "zero gradient through CUDA flash")
    print(f"flash_attention grad_fn on the card: "
          f"{type(out.grad_fn).__name__}; q, k, v gradients non-zero")


# the card-vs-CPU train step: families at full width and depth 2, fp32
# (granite at cf = E / k, where no pair drops, and at its own 1.25)
TRAIN_PARITY = (("phi3-mini-3.8b", {}), ("minicpm3-4b", {}),
                ("mamba2-370m", {}), ("hymba-1.5b", {}),
                ("granite-moe-3b-a800m", {"capacity_factor": "E/k"}),
                ("granite-moe-3b-a800m", {}), ("hubert-xlarge", {}))
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 128
# card vs CPU, fp32: the loss at rtol 1e-4 (the lm parity's); grad_norm,
# mu and nu within TRAIN_GRAD_TOL of their leaf's max (cuBLAS and the
# CPU sum the full-width products in other orders, and the backward
# adds those of two more products per matmul); params within the
# gradient tolerance carried through AdamW's first step (see
# _close_params)
TRAIN_GRAD_TOL = 1e-3
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
# the full-width training runs: layers kept of each model
TRAIN_DEPTH = {"phi3-mini-3.8b": 16, "granite-moe-3b-a800m": 8}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_TIMED = 4, 2048, 1, 4


def _path_counts(cfg) -> dict:
    """The kernel launches one train step must make with cfg.remat on:
    the flash forward twice per attention layer (the forward and its
    recompute), its backward once, the rank kernel twice per MoE layer."""
    attn = cfg.n_layers if cfg.has_attention else 0
    moe_layers = cfg.n_layers if cfg.is_moe else 0
    k = 2 if cfg.remat else 1
    return dict(flash_attention=k * attn, flash_attention_bwd=attn,
                radix_hist=k * moe_layers)


def _check_step_counts(arch, counts, cfg, what):
    want = _path_counts(cfg)
    got = {k: counts[k] for k in want}
    check(got == want, f"train {arch} {what}: launches {got}, not {want}")
    check(sum(counts.values()) == sum(want.values()),
          f"train {arch} {what}: another kernel of the port launched: "
          f"{counts}")


def _close_leaves(got, want, what, tol=TRAIN_GRAD_TOL) -> float:
    """Each leaf within tol of its max (compared on got's device);
    returns the worst |diff| / max over leaves."""
    worst = 0.0
    for name, w in want.items():
        g = got[name].detach().float()
        w = w.to(g.device)
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        worst = max(worst, err / max(top, 1e-30))
        check(err <= tol * top + 1e-9,
              f"{what} {name}: max abs diff {err:.3e} of max {top:.3e}")
    return worst


def _close_params(got, want, mu, lr, b1=0.9, eps=1e-8,
                  tol=TRAIN_GRAD_TOL) -> int:
    """Params after one step from zero moments: within 1e-6 + 1e-4·lr +
    lr·swing, swing being the most that AdamW's first-step mhat /
    sqrt(vhat) = g / (|g| + eps) moves over [g - δ, g + δ] (g the
    reference side's clipped gradient, mu / (1 - b1); δ = tol (max |g| +
    |g|)): an entry with |g| near eps may move by up to 2·lr. Compared on
    got's device. Returns how many entries moved by more than 1e-6 +
    1e-4·lr."""
    swung = 0
    for name, w in want.items():
        g = got[name].detach()
        gc = mu[name].detach().to(g.device).double() / (1 - b1)
        top = float(gc.abs().max())
        delta = tol * (top + gc.abs())
        r = lambda x: x / (x.abs() + eps)  # noqa: E731
        swing = torch.maximum((r(gc + delta) - r(gc)).abs(),
                              (r(gc - delta) - r(gc)).abs())
        diff = (g.double() - w.detach().to(g.device).double()).abs()
        check(bool((diff <= 1e-6 + 1e-4 * lr + lr * swing).all()),
              f"train parity params {name}: max abs diff "
              f"{float(diff.max()):.3e}")
        swung += int((diff > 1e-6 + 1e-4 * lr).sum())
    return swung


def _train_parity(dev, arch, changes) -> dict:
    """One train step of `arch` at full width and depth 2 in fp32 on the
    card against the same step on the CPU (weights drawn on a CPU
    generator, the batch from the port's pipeline): the loss, grad_norm,
    lr and every parameter and moment after the step, and the card's
    launches (remat on there, off on the CPU, where it changes nothing)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    base = get_arch(arch)
    if changes.get("capacity_factor") == "E/k":
        changes = dict(capacity_factor=base.n_experts / base.moe_top_k)
    cfg = dataclasses.replace(base, n_layers=2, dtype="float32", **changes)
    tag = arch + "".join(f" {k}={v:g}" for k, v in changes.items())
    t0 = time.perf_counter()
    cpu = LM(dataclasses.replace(cfg, remat=False),
             generator=torch.Generator().manual_seed(0), device="cpu",
             param_dtype=torch.float32)
    gpu = LM(cfg, device=dev, param_dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_PARITY_SEQ,
                      global_batch=TRAIN_PARITY_BATCH, seed=11,
                      is_encoder=cfg.is_encoder, feat_dim=cfg.feat_dim)
    opt = OptConfig(**TRAIN_OPT)
    s_gpu = make_train_state(gpu)
    batch = TokenPipeline(data, device=dev).batch(0)
    ops.reset_launch_counts()
    s_gpu, m_gpu = make_train_step(gpu, opt)(s_gpu, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _check_step_counts(tag, counts, cfg, "parity step")
    s_cpu = make_train_state(cpu)
    s_cpu, m_cpu = make_train_step(cpu, opt)(
        s_cpu, TokenPipeline(data, device="cpu").batch(0))
    loss_c, loss_g = float(m_cpu["loss"]), float(m_gpu["loss"])
    gn_c, gn_g = float(m_cpu["grad_norm"]), float(m_gpu["grad_norm"])
    check(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c),
          f"train parity {tag}: loss {loss_g} on the card, {loss_c} on the "
          f"CPU")
    check(abs(gn_g - gn_c) <= TRAIN_GRAD_TOL * gn_c,
          f"train parity {tag}: grad_norm {gn_g} vs {gn_c}")
    check(float(m_gpu["lr"]) == float(m_cpu["lr"]), "train parity: lr")
    worst = max(_close_leaves(s_gpu["opt"][k], s_cpu["opt"][k], k)
                for k in ("mu", "nu"))
    swung = _close_params(s_gpu["params"], s_cpu["params"],
                          s_cpu["opt"]["mu"], float(m_cpu["lr"]))
    n = sum(p.numel() for p in cpu.parameters())
    wall = time.perf_counter() - t0
    print(f"train parity {tag} depth 2 fp32 B={TRAIN_PARITY_BATCH} "
          f"S={TRAIN_PARITY_SEQ}: loss card {loss_g:.6f} CPU {loss_c:.6f}, "
          f"grad_norm {gn_g:.6f} vs {gn_c:.6f}, mu/nu worst diff / max "
          f"{worst:.3e} (limit {TRAIN_GRAD_TOL:g}), params past 1e-4 lr: "
          f"{swung} of {n} (all within the carried tolerance); launches "
          f"per step {counts}; {wall:.1f} s")
    del cpu, gpu, s_cpu, s_gpu
    torch.cuda.empty_cache()
    return dict(loss=loss_g, loss_cpu=loss_c, grad_norm=gn_g,
                grad_norm_cpu=gn_c, moment_worst_rel=worst,
                params_swung=swung, params=n, launches_per_step=counts)


def _train_full(dev, arch) -> dict:
    """`arch` at full width, cut to TRAIN_DEPTH layers, bf16 activations,
    float32 state, remat on: TRAIN_WARMUP + TRAIN_TIMED steps of
    TRAIN_BATCH x TRAIN_SEQ tokens through make_train_state /
    make_train_step, each step's launches checked; then one step under
    the profiler. Returns the run's numbers."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=TRAIN_DEPTH[arch])
    check(cfg.remat and cfg.dtype == "bfloat16",
          f"{arch}: the training run wants remat and bf16 activations")
    cut = f"{cfg.n_layers} of {full.n_layers} layers"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev, param_dtype=torch.float32)
    state = make_train_state(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    state_gb = 16 * n / 1e9   # params, grads, mu, nu: float32 each
    print(f"train {arch}: depth cut to {cut} (full width), {n / 1e9:.3f} B "
          f"params, {state_gb:.1f} GB of float32 params, grads and "
          f"moments; built in {init_s:.1f} s")
    step = make_train_step(model, OptConfig(peak_lr=3e-4, warmup_steps=2,
                                            total_steps=100))
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=5),
                         device=dev)
    walls, losses, norms, counts = [], [], [], None
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        batch = data.batch(i)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        _check_step_counts(arch, counts, cfg, f"step {i}")
        check(np.isfinite(loss), f"train {arch}: loss {loss} at step {i}")
        check(np.isfinite(gnorm) and gnorm > 0,
              f"train {arch}: grad_norm {gnorm} at step {i}")
        losses.append(loss)
        norms.append(gnorm)
    timed = walls[TRAIN_WARMUP:]
    step_ms = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = data.batch(TRAIN_WARMUP + TRAIN_TIMED)
    prof = _profile(lambda: step(state, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # matmul FLOP of the step from the shapes: 6·N·tokens (forward and
    # backward) plus 2·N·tokens for the recompute, N the non-embedding
    # params of the layers and the lm head
    layer_params = n - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    head = cfg.vocab_size * cfg.d_model
    if cfg.is_moe:
        d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.moe_top_k
        per_expert = (3 if cfg.act == "swiglu" else 2) * d * f
        layer_params -= cfg.n_layers * (e - k) * per_expert  # active only
    gemm_flop = 8 * layer_params * tokens + 6 * head * tokens
    numbers = dict(
        arch=arch, cut=cut, params=n, state_gb=state_gb, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, init_s=init_s, step_ms=step_ms, step_ms_runs=walls,
        tokens_per_s=tokens / step_ms * 1e3, losses=losses,
        grad_norms=norms, peak_memory_gb=peak_gb,
        busy_share=prof["busy_share"], profile_ms=prof,
        launches_per_step=counts, gemm_flop_per_step=gemm_flop,
        gemm_tflop_per_s_of_step=gemm_flop / step_ms / 1e9)
    print(f"train {arch} B={TRAIN_BATCH} S={TRAIN_SEQ} ({cut}): step "
          f"{step_ms:.1f} ms (median of {TRAIN_TIMED}; warm-up "
          f"{walls[0]:.1f} ms), {numbers['tokens_per_s']:.0f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB, busy share "
          f"{prof['busy_share']:.3f}, device ms by kind: gemm "
          f"{prof['gemm']:.1f}, flash fwd {prof['flash']:.1f}, flash bwd "
          f"{prof['flash_bwd']:.1f}, rank {prof['radix']:.1f}, other "
          f"{prof['other']:.1f}; launches per step {counts}; losses "
          f"{[round(x, 4) for x in losses]}")
    del model, state, step
    torch.cuda.empty_cache()
    return numbers


def _train_trainer(dev) -> dict:
    """The fault-tolerant Trainer on the card at phi3-mini-3.8b's reduced
    config: 12 steps, a checkpoint every 4, a failure injected at step 9:
    one restart from step 8, and the replayed steps' losses equal to the
    first run's within 1e-4."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.ft.elastic import FailureInjector, FaultConfig
    from repro_torch.models.model import LM
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch("phi3-mini-3.8b").reduced()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        model = LM(cfg, device=dev, param_dtype=torch.float32)
        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=4, seed=1),
                             device=dev)
        t0 = time.perf_counter()
        out = Trainer(
            model, data, OptConfig(peak_lr=5e-3, warmup_steps=3,
                                   total_steps=12),
            TrainerConfig(total_steps=12, log_every=100), ckpt_dir,
            fault_cfg=FaultConfig(ckpt_every=4, max_restarts=3),
            failure_injector=FailureInjector((9,))).run()
        wall = time.perf_counter() - t0
    steps = [h["step"] for h in out["history"]]
    check(out["restarts"] == 1, f"trainer: {out['restarts']} restarts")
    check(steps == list(range(9)) + list(range(8, 12)),
          f"trainer: steps {steps}")
    by_step = {}
    for h in out["history"]:
        by_step.setdefault(h["step"], []).append(h["loss"])
    replay = {s: ls for s, ls in by_step.items() if len(ls) > 1}
    diff = max(abs(ls[0] - ls[1]) for ls in replay.values())
    check(diff < 1e-4, f"trainer: replayed losses differ by {diff}")
    print(f"train Trainer {cfg.name} reduced on the card: 12 steps, "
          f"checkpoint every 4, failure at step 9: restarts "
          f"{out['restarts']}, steps {steps}, replayed step 8 losses "
          f"{replay[8]} (max diff {diff:.3e}), {wall:.2f} s")
    return dict(restarts=out["restarts"], steps=steps,
                replay_max_diff=diff, wall_s=wall)


def phase_train(dev) -> tuple:
    """The training path on the card: the flash backward against its plain
    backward at every BWD_CASES shape and timed at the families' shapes,
    a CUDA flash output's grad_fn; the card-vs-CPU train step of each
    TRAIN_PARITY family; the full-width runs of TRAIN_DEPTH; the reduced
    Trainer with a restart. Returns the flash_attention_bwd entry of the
    kernels line and the train-path launches that the flash_attention and
    radix_hist entries gain."""
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    _check_grad_fn(dev)
    errors = _check_flash_bwd(dev)
    timings = {}
    for name in BWD_TIMED:
        timings[name] = _time_flash_bwd(dev, name)
        print(f"flash_attention_bwd timings {name} "
              f"{timings[name]['at']}: {json.dumps(timings[name])}")
    print(f"train backward checks and timings: "
          f"{time.perf_counter() - t0:.1f} s")
    parity = {}
    for arch, changes in TRAIN_PARITY:
        res = _train_parity(dev, arch, changes)
        parity[arch + "".join(f" {k}" for k in changes)] = res
    runs = {arch: _train_full(dev, arch) for arch in TRAIN_DEPTH}
    trainer = _train_trainer(dev)
    print(f"train numbers: {json.dumps(dict(runs=runs, parity=parity, trainer=trainer))}")
    at = timings["phi3 prefill bf16"]
    per_step = {a: r["launches_per_step"] for a, r in runs.items()}
    main = "phi3-mini-3.8b"
    entry = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
        sources=["src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                 "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "src/repro_torch/csrc/sm90.cuh"],
        replaces="src/repro/models/attention.py:144",
        replaces_note="no Pallas counterpart: the reference differentiates "
                      "its plain jnp attention (gqa_attention's "
                      "use_flash=False path) with jax.grad",
        cuda_kernels=list(fa.BWD_KERNELS),
        cuda_kernels_per_launch=len(fa.BWD_KERNELS),
        cuda_kernels_by_route={r: list(n) for r, n in fa.BWD_ROUTES.items()},
        launches=(TRAIN_WARMUP + TRAIN_TIMED)
        * per_step[main]["flash_attention_bwd"],
        launches_per_train_step={a: c["flash_attention_bwd"]
                                 for a, c in per_step.items()},
        max_abs_err=max(e for n, e in errors.items() if "bf16" in n),
        max_abs_err_fp32=max(e for n, e in errors.items() if "fp32" in n),
        max_abs_err_per_case=errors,
        ms=at["ms"], device_ms=at["device_ms"], plain_ms=at["plain_ms"],
        bound_ms=at["bound_ms"], bound_by=at["bound_by"],
        floor7_ms=at["floor7_ms"], device_ms_by_kernel=at[
            "device_ms_by_kernel"],
        library_ms=at["library_ms"], library_call=at["library_call"],
        at=at["at"], family_shapes=timings)
    gains = dict(
        flash_attention={a: c["flash_attention"]
                         for a, c in per_step.items()},
        radix_hist={a: c["radix_hist"] for a, c in per_step.items()})
    return entry, gains


MESH_ARCH = "phi3-mini-3.8b"
MESH_MOE_ARCH = "granite-moe-3b-a800m"
MESH_DEPTH = 2              # of the 32 layers of each, at full width: 2
#   keeps the whole script inside its time limit (at 4 the mesh phase
#   took 108.5 s against 47.5 and a slow host took the run to 1,091 s)
MESH_SHARDS = 4             # data shards of cuda:0
MESH_BATCH, MESH_SEQ, MESH_TIMED = 4, 2048, 2
MESH_LOSS_RTOL = 1e-3       # bf16 activations: the sharded GEMMs round
# the assembled MoE aux against the whole batch's: the shards route alike
# and the counts are exact, so only the order of the float32 gate sums
# differs; the mean of the shards' own auxes must lie outside it
MESH_AUX_RTOL = 1e-5
MESH_REL_L2 = 2e-2          # in other orders than the whole batch's
MESH_PARITY_TOL = 1e-4      # fp32, depth 2: of each leaf's max
MESH_FP32_REL_L2 = 1e-4     # fp32 at full width: each leaf, rel. L2
MESH_PARITY_BATCH, MESH_PARITY_SEQ = 4, 128
PSUM_SHARDS, PSUM_SIZE = 8, 1 << 16
# tensor parallelism on 'model': ('data', 'model') meshes of cuda:0
MESH_TP = {"tp4": (1, 4), "data2 tp2": (2, 2)}
# the bf16 TP steps against the unsharded one, per arch: the worst
# leaf's gradient and updated parameter (rel. L2) and the MoE aux (rel.).
# The forward's sums round once (float32 partials,
# `sharding.partial_product`), and so does a replicated input's gradient
# (float32 partials, `sharding.column_product`), but the unsharded step
# rounds each product's input gradient and their sum to bf16, which no
# split of the columns reproduces: every leaf moves, the norms too (the
# data shards, which round as it does, move the weights' gradients
# alone). granite's combine rounds per add unsharded and once under TP,
# so a few routings flip and their experts' gradients move. Read on an
# NVIDIA H100 80GB HBM3 (700 W) at MESH_DEPTH = 2 (the same in every
# run): phi3 1.10e-2 and 1.18e-3 on (1, 4), 9.46e-3 and 1.06e-3 since the
# float32 input gradients ((2, 2): 9.39e-3, 1.03e-3); granite 8.48e-2,
# 1.92e-3 and 3.35e-5. Each limit is the reading before the float32 input
# gradients times the ratio the limit had to the 4-layer reading (phi3 4e-2 / 1.69e-2 and 5e-3 /
# 1.55e-3; granite 0.3 / 0.136, 1e-2 / 2.46e-3), rounded down; granite's
# aux keeps 1e-4 (its 4-layer reading was 2.85e-5). The data shards read
# 2.35e-3 for phi3: the TP readings did not come near it, so the limits
# stay as they were
MESH_TP_LIMITS = {MESH_ARCH: dict(grad=2.5e-2, param=3.8e-3),
                  MESH_MOE_ARCH: dict(grad=0.18, param=7.8e-3, aux=1e-4)}
# FSDP over 'data' (the state laid out by `param_specs`): on MESH_SHARDS
# data shards of the card (None: `make_host_mesh`'s), and on (2, 2)
MESH_FSDP = {f"data{MESH_SHARDS} fsdp": None, "data2 tp2 fsdp": (2, 2)}
FSDP_SERVE_PROMPT, FSDP_SERVE_NEW = 512, 8   # the FSDP serving check
TP_SERVE_NEW = 32            # decode steps after the prefill
TP_SERVE_FP32_TOL = 1e-4     # of the logits' largest magnitude, fp32
TP_SERVE_BF16_REL_L2 = 5e-2  # the serving contract's, bf16


def _uneven_mask(b, s, dev, seed=0):
    """A (b, s) mask whose density differs by row (the first row nearly
    empty, the last full), so the data shards' token counts differ."""
    rng = np.random.default_rng(seed)
    keep = rng.random((b, s)) < np.linspace(0.05, 1.0, b)[:, None]
    keep[-1] = True
    return torch.from_numpy(keep).to(dev)


def _whole(x):
    """A leaf of a train state as a whole tensor on its device (a Placed
    one gathered; a copy either way)."""
    from repro_torch.models.sharding import Placed

    return x.full() if isinstance(x, Placed) else x.detach().clone()


def _train_snapshot(state) -> dict:
    """A copy of a train state's params and moments (no "err"), whole
    leaves."""
    def copy(tree):
        return {n: _whole(t) for n, t in tree.items()}

    opt = state["opt"]
    return dict(params=copy(state["params"]),
                opt=dict(mu=copy(opt["mu"]), nu=copy(opt["nu"]),
                         step=opt["step"].clone()))


def _rel_l2_by_leaf(got, want, base=None) -> dict:
    """{leaf: relative L2 distance of got's leaf to want's}, each compared
    on got's device (a Placed leaf gathered there); with `base`, of got -
    base against want - base (the updates)."""
    out = {}
    for name, w in want.items():
        g = _whole(got[name])
        w = w.detach().to(g.device)
        if base is not None:
            b = base[name].to(g.device)
            g, w = g - b, w - b
        g, w = g.double(), w.double()
        out[name] = float(torch.linalg.vector_norm(g - w)
                          / max(float(torch.linalg.vector_norm(w)), 1e-30))
    return out


def _rel_l2_leaves(got, want, base=None) -> float:
    """The worst relative L2 distance over the leaves (`_rel_l2_by_leaf`)."""
    return max(_rel_l2_by_leaf(got, want, base).values(), default=0.0)


def _mesh_variants(mesh, tp=(), fsdp=()):
    """(name, mesh, ZeRO accumulator, FSDP state) of the steps compared:
    unsharded, on the data shards of `mesh`, with ZeRO, then FSDP there
    (right after the ZeRO step it is held to), the ('data', 'model')
    meshes of the card named in `tp` (MESH_TP), then the other FSDP
    steps named in `fsdp` (MESH_FSDP: the state laid out by
    `param_specs`, the ZeRO accumulator's tiles its blocks)."""
    from repro_torch.core.distributed import Mesh

    dev = mesh.devices[0]

    def of(shape):
        return (mesh if shape is None else
                Mesh((dev,) * int(np.prod(shape)), ("data", "model"), shape))

    data = [n for n in fsdp if MESH_FSDP[n] is None]
    return (("unsharded", None, False, False),
            (f"data{MESH_SHARDS}", mesh, False, False),
            (f"data{MESH_SHARDS} zero", mesh, True, False)) + tuple(
        (name, mesh, True, True) for name in data) + tuple(
        (name, of(MESH_TP[name]), False, False) for name in tp) + tuple(
        (name, of(MESH_FSDP[name]), True, True) for name in fsdp
        if name not in data)


def _tree_bytes(tree) -> int:
    """The bytes of the tensors of a tree of dicts."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _fsdp_equal(arch, name, metrics, state, zero_first) -> None:
    """The FSDP step's loss, grad_norm, aux and every parameter, mu and nu
    `torch.equal` to the ZeRO step's on the same data shards."""
    check(zero_first is not None, f"mesh_train {name}: no ZeRO step to "
                                  f"hold it to")
    zm, zs = zero_first
    bad = [k for k in ("loss", "grad_norm", "aux") if k in zm
           and not torch.equal(metrics[k], zm[k])]
    for part, tree, want in (
            ("params", state["params"], zs["params"]),
            ("mu", state["opt"]["mu"], zs["opt"]["mu"]),
            ("nu", state["opt"]["nu"], zs["opt"]["nu"])):
        bad += [f"{part} {n}" for n in want
                if not torch.equal(_whole(tree[n]), want[n])]
    check(not bad, f"mesh_train {arch} {name}: differs from the ZeRO step "
                   f"in {bad[:8]} ({len(bad)} in all)")
    print(f"mesh_train {arch} {name}: loss, grad_norm"
          + (", aux" if "aux" in zm else "") + f" and all {len(zs['params'])}"
          f" parameters, mu and nu torch.equal to the ZeRO step's")


def _fsdp_serve(dev, card, model) -> dict:
    """phi3's serving steps on the model laid out FSDP on (2, 2) (as the
    "data2 tp2 fsdp" step left it: each entry its ('data', 'model')
    blocks, a layer's gathered per step), then on the same weights in the
    'model' layout: one prefill of B = MESH_BATCH x FSDP_SERVE_PROMPT
    and FSDP_SERVE_NEW decode steps fed the same tokens, every step's
    logits `torch.equal`; the ms of each."""
    from repro_torch.core.distributed import Mesh
    from repro_torch.kernels import ops
    from repro_torch.models.sharding import (gather_model, is_fsdp,
                                             lay_out_model, named_leaves,
                                             param_specs, use_mesh)
    from repro_torch.serve import serve_step as ss

    mesh = Mesh((dev,) * 4, ("data", "model"), MESH_FSDP["data2 tp2 fsdp"])
    prompt = torch.randint(0, model.cfg.vocab_size,
                           (MESH_BATCH, FSDP_SERVE_PROMPT), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(22)).to(dev)
    max_len = FSDP_SERVE_PROMPT + FSDP_SERVE_NEW + 1

    def run(feed=None):
        with use_mesh(mesh), torch.no_grad():
            caches = ss.init_caches(model, MESH_BATCH, max_len)
            prefill, decode = (ss.make_prefill_step(model),
                               ss.make_decode_step(model))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, caches = prefill(prompt, caches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = ops.launch_counts()
            steps = [logits]
            toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
            for i in range(FSDP_SERVE_NEW):
                tok = toks[-1] if feed is None else feed[i]
                nxt, logits, caches = decode(tok, FSDP_SERVE_PROMPT + i,
                                             caches)
                steps.append(logits)
                toks.append(nxt)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return dict(steps=steps, toks=toks, launches=launches,
                    prefill_ms=(t1 - t0) * 1e3,
                    decode_ms=(t2 - t1) * 1e3 / FSDP_SERVE_NEW)

    with use_mesh(mesh):
        lay_out_model(model, param_specs(model))
    fsdp_leaves = sum(is_fsdp(x) for _, x in named_leaves(model))
    check(fsdp_leaves > 0, "fsdp serve: the model is not laid out FSDP")
    got = run()
    gather_model(model)     # the steps lay it out anew: the 'model' blocks
    want = run(feed=got["toks"])
    same = [torch.equal(a, b) for a, b in zip(got["steps"], want["steps"])]
    check(all(bool(torch.isfinite(a).all()) for a in got["steps"]),
          "fsdp serve: logits not finite")
    check(all(same), f"fsdp serve: logits of steps "
                     f"{[i for i, s in enumerate(same) if not s]} differ from "
                     f"the 'model' layout's")
    out = dict(steps_equal=len(same), prefill_ms=got["prefill_ms"],
               decode_ms=got["decode_ms"],
               prefill_ms_model_layout=want["prefill_ms"],
               decode_ms_model_layout=want["decode_ms"],
               launches_prefill=got["launches"], fsdp_leaves=fsdp_leaves)
    print(f"mesh_train fsdp serve {model.cfg.name} bf16 ({model.cfg.n_layers}"
          f" layers, B={MESH_BATCH} prefill S={FSDP_SERVE_PROMPT}, "
          f"{FSDP_SERVE_NEW} decode steps) on (2, 2) of {dev}: logits of all "
          f"{len(same)} steps torch.equal to the 'model' layout's; "
          f"{json.dumps(out)}; card {card}")
    return out


def _mesh_launches(cfg, m) -> dict:
    """A step's launches on mesh `m` (None: unsharded): the flash kernels
    once per 'model' entry of each data shard, the rank entry once per
    data shard (the MoE layer routes once there)."""
    from repro_torch.launch.mesh import data_shards
    from repro_torch.models.sharding import tp_family

    base = _path_counts(cfg)
    if m is None:
        return base
    n_data = len(data_shards(m, MESH_BATCH)[1])
    tp = m.shape.get("model", 1) if tp_family(cfg) else 1
    return {k: v * n_data * (1 if k == "radix_hist" else tp)
            for k, v in base.items()}


def _mesh_full(dev, card, arch=MESH_ARCH, grad_limit=MESH_REL_L2,
               tp=tuple(MESH_TP), fsdp=tuple(MESH_FSDP)) -> dict:
    """`arch` (phi3, or granite's MoE) at full width, MESH_DEPTH layers,
    bf16 activations, remat, B = MESH_BATCH x MESH_SEQ: one step from a
    fresh state unsharded, on MESH_SHARDS data shards of the card, and
    with the ZeRO accumulator; the loss, each gradient leaf (mu after a
    first step from zero moments is 0.1 x the clipped gradient) and each
    updated parameter against the unsharded step (for MoE also the aux
    each step reports, on the mesh the one assembled from the shards'
    router statistics, against `loss_fn`'s on the whole batch within
    MESH_AUX_RTOL, and the mean of the shards' own auxes outside it);
    then per variant MESH_TIMED
    more steps timed and one profiled, with each step's launches. With
    `grad_limit` None the data-shard steps' gradient and parameter
    distances are printed, not checked (granite's: `_mesh_moe`). The
    steps on the ('data', 'model') meshes named in `tp` are tensor
    parallel: their loss is held as above, their gradients, parameters
    and aux at `arch`'s MESH_TP_LIMITS, and each leaf's gradient and
    parameter distance is printed beside the data shards'. The FSDP steps
    named in `fsdp` (MESH_FSDP) start from the state laid out by
    `param_specs`: on the data shards their loss, grad_norm, aux and
    every parameter, mu and nu after the step are `torch.equal` to the
    ZeRO step's, on (2, 2) they are held as the TP steps are; with phi3
    the bf16 serving steps follow (`_tp_serve`), and the FSDP model's
    prefill and decode logits against its 'model' layout's
    (`_fsdp_serve`)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import (gather_model, param_specs,
                                             use_mesh)
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import (entry_bytes, lay_out_state,
                                              load_train_state,
                                              make_train_state,
                                              make_train_step)

    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=MESH_DEPTH)
    check(cfg.remat and cfg.dtype == "bfloat16",
          f"{arch}: the mesh step wants remat and bf16 activations")
    cut = f"{cfg.n_layers} of {full.n_layers} layers"
    torch.cuda.empty_cache()
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev, param_dtype=torch.float32)
    state = make_train_state(model)
    n = sum(p.numel() for p in model.parameters())
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=MESH_SEQ,
                                     global_batch=MESH_BATCH, seed=7),
                          device=dev).batch(0)
    mesh = make_host_mesh(MESH_SHARDS, device=dev)
    opt = OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    print(f"mesh_train {arch}: depth cut to {cut} (full width; the "
          f"cut keeps the script inside its time limit), "
          f"{n / 1e9:.3f} B params, "
          f"{16 * n / 1e9:.1f} GB of float32 params, grads and moments, "
          f"B={MESH_BATCH} S={MESH_SEQ}, bf16 activations, remat"
          + (f", capacity factor {cfg.capacity_factor}" if cfg.is_moe
             else "") + f"; {MESH_SHARDS} data shards of {dev}")
    aux_whole = aux_own = None
    if cfg.is_moe:      # the start state's aux: the whole batch's, and
        # the mean of the shards' own (the mistake the mesh step avoids)
        per = MESH_BATCH // MESH_SHARDS
        with torch.no_grad():
            aux_whole = float(model.loss_fn(batch)[1]["aux"])
            own = []
            for j in range(MESH_SHARDS):
                stats = []
                model.loss_fn({k: x[j * per:(j + 1) * per]
                               for k, x in batch.items()}, None, stats)
                own.append(float(tmoe.aux_from_stats(
                    cfg, stats, per * MESH_SEQ, cfg.n_layers)))
        aux_own = sum(own) / MESH_SHARDS
        own_rel = abs(aux_own - aux_whole) / abs(aux_whole)
        print(f"mesh_train {arch}: aux of the whole batch {aux_whole!r}, "
              f"mean of the {MESH_SHARDS} shards' own {aux_own!r} (rel. "
              f"{own_rel:.3e}; the assembled aux's limit "
              f"{MESH_AUX_RTOL:g}, the loss's {MESH_LOSS_RTOL:g})")
        check(own_rel > MESH_AUX_RTOL, f"mesh_train {arch}: the mean of "
              f"the shards' auxes is within {MESH_AUX_RTOL:g} of the whole "
              f"batch's ({own_rel:.3e}): the aux check cannot tell them "
              f"apart")
    # the start and the unsharded step's result (`first`), both made
    # before any row: every row holds them, and their bytes (`harness`)
    # come off each row's held and peak bytes, which are then its state's
    base = _held_bytes(dev)
    start = _train_snapshot(state)
    first_loss = float(make_train_step(model, opt)(state, batch)[1]["loss"])
    snap = _train_snapshot(state)
    first = dict(loss=first_loss, mu=snap["opt"]["mu"], params=snap["params"])
    del snap
    harness = _held_bytes(dev) - base
    rows, zero_first, by_leaf, snap = {}, None, {}, 0
    for name, m, zero, fsdp_state in _mesh_variants(mesh, tp, fsdp):
        t_row = time.perf_counter()
        # each variant's layout (a TP mesh: every entry its blocks; FSDP:
        # its ('data', 'model') blocks) before its held bytes are read
        with use_mesh(m):
            if not fsdp_state:
                gather_model(model)
            specs = param_specs(model) if zero else None
            lay_out_state(model, state, specs if fsdp_state else None)
        load_train_state(state, start)
        held_gb = (_held_bytes(dev) - harness - snap) / 1e9
        with use_mesh(m):
            per_entry = entry_bytes(model, state, MESH_BATCH, specs)
        if fsdp_state:      # each entry its share of every part
            share = rows["unsharded"]["state_bytes_per_entry"][0][
                "params"] / len(m.devices)
            off = [(j, k, v) for j, e in enumerate(per_entry)
                   for k, v in e.items() if abs(v - share) > 0.02 * share]
            check(not off, f"mesh_train {arch} {name}: entries hold "
                           f"{off[:4]}, not {share / 1e9:.4f} GB each")
        torch.cuda.reset_peak_memory_stats()
        want = _mesh_launches(cfg, m)
        with use_mesh(m):
            step = make_train_step(model, opt, grad_shard_specs=specs)
            walls, losses = [], []
            for i in range(1 + MESH_TIMED):
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                counts = ops.launch_counts()
                got = {k: counts[k] for k in want}
                check(got == want and sum(counts.values()) == sum(
                    want.values()), f"mesh_train {name} step {i}: "
                    f"launches {counts}, not {want}")
                check(np.isfinite(loss), f"mesh_train {name}: loss {loss}")
                losses.append(loss)
                if i:
                    continue
                aux = aux_cmp = None
                tp_step = m is not None and "model" in m.axis_names
                lim = (MESH_TP_LIMITS[arch] if tp_step else
                       dict(grad=grad_limit, param=grad_limit))
                aux_limit = lim.get("aux", MESH_AUX_RTOL)
                if cfg.is_moe:
                    aux = float(metrics["aux"])
                    aux_rel = abs(aux - aux_whole) / abs(aux_whole)
                    check(aux_rel <= aux_limit,
                          f"mesh_train {arch} {name}: the step's aux {aux} "
                          f"vs the whole batch's {aux_whole} (rel "
                          f"{aux_rel:.2e}, limit {aux_limit:g})")
                    aux_cmp = dict(aux=aux, aux_whole_batch=aux_whole,
                                   aux_rel=aux_rel,
                                   aux_mean_of_shards=aux_own,
                                   aux_mean_of_shards_rel=own_rel)
                if zero and not fsdp_state and m is mesh and fsdp:
                    # held until the FSDP row that follows has checked
                    # against it; its bytes come off both rows' numbers
                    zero_first = (metrics, _train_snapshot(state))
                    snap = _tree_bytes(zero_first[1])
                if fsdp_state and m is mesh:
                    _fsdp_equal(arch, name, metrics, state, zero_first)
                    zero_first = None
                rel = abs(loss - first["loss"]) / abs(first["loss"])
                leaf_l2 = dict(
                    grad=_rel_l2_by_leaf(state["opt"]["mu"], first["mu"]),
                    param=_rel_l2_by_leaf(state["params"], first["params"]))
                grad_l2 = max(leaf_l2["grad"].values())
                param_l2 = max(leaf_l2["param"].values())
                if name == f"data{MESH_SHARDS}" or tp_step:
                    by_leaf[name] = leaf_l2
                update_l2 = _rel_l2_leaves(state["params"], first["params"],
                                           start["params"])
                check(rel <= MESH_LOSS_RTOL, f"mesh_train {name}: loss "
                      f"{loss} vs unsharded {first['loss']} (rel {rel:.2e})")
                check(lim["grad"] is None or (
                    grad_l2 <= lim["grad"] and param_l2 <= lim["param"]),
                      f"mesh_train {arch} {name}: gradient rel. L2 "
                      f"{grad_l2:.3e}, params {param_l2:.3e} (limits "
                      f"{lim['grad']}, {lim['param']})")
                cmp = dict(loss_rel=rel, grad_rel_l2_worst=grad_l2,
                           param_rel_l2_worst=param_l2,
                           update_rel_l2_worst=update_l2)
                cmp.update(aux_cmp or {})
            prof = _profile(lambda: step(state, batch))
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - harness - snap) / 1e9
        if zero_first is None:
            snap = 0
        step_ms = statistics.median(walls[1:])
        rows[name] = dict(step_ms=step_ms, step_ms_runs=walls,
                          tokens_per_s=MESH_BATCH * MESH_SEQ / step_ms * 1e3,
                          losses=losses, peak_memory_gb=peak_gb,
                          held_before_gb=held_gb,
                          state_bytes_per_entry=per_entry,
                          busy_share=prof["busy_share"], profile_ms=prof,
                          launches_per_step=counts, **cmp)
        rows[name]["row_s"] = time.perf_counter() - t_row
        entry_gb = [round(sum(e.values()) / 1e9, 4) for e in per_entry]
        print(f"mesh_train {arch} {name} state per entry (params / mu / nu "
              f"/ accumulator GB): " + "; ".join(
                  f"{j}: " + " / ".join(f"{v / 1e9:.4f}" for v in e.values())
                  for j, e in enumerate(per_entry))
              + f"; all {entry_gb} GB; held before the step "
              f"{held_gb:.2f} GB, peak {peak_gb:.2f} GB (the card's less "
              f"this phase's snapshots, {harness / 1e9:.2f} GB)"
              + ("" if name == "unsharded" else
                 f" (unsharded: state " + " / ".join(
                     f"{v / 1e9:.4f}" for v in
                     rows["unsharded"]["state_bytes_per_entry"][0].values())
                 + f" GB, held {rows['unsharded']['held_before_gb']:.2f} GB, "
                 f"peak {rows['unsharded']['peak_memory_gb']:.2f} GB)")
              + f"; card {card}")
        print(f"mesh_train {arch} {name} ({cut}): step {step_ms:.1f} ms "
              f"(median of {MESH_TIMED}; warm-up {walls[0]:.1f} ms), peak "
              f"memory {peak_gb:.2f} GB ({held_gb:.2f} GB held before the "
              f"step), busy share {prof['busy_share']:.3f}, device ms: "
              f"gemm {prof['gemm']:.1f}, flash fwd {prof['flash']:.1f}, "
              f"flash bwd {prof['flash_bwd']:.1f}, rank "
              f"{prof['radix']:.1f}, other {prof['other']:.1f}; launches "
              f"per step {counts}; against the unsharded step "
              f"{json.dumps(cmp)}; card {card}")
        del step
    print(f"mesh_train {arch} seconds by row: " + ", ".join(
        f"{k} {r['row_s']:.1f}" for k, r in rows.items()))
    print(f"mesh_train {arch} step ms side by side ({cut}, B={MESH_BATCH} "
          f"S={MESH_SEQ}): " + ", ".join(
              f"{k} {r['step_ms']:.1f}" for k, r in rows.items())
          + f"; card {card}")
    for part in ("grad", "param"):
        print(f"mesh_train {arch} bf16 {part} rel. L2 to the unsharded step "
              f"per leaf ({cut}): " + json.dumps(
                  {k: {n: float(f"{v:.3e}") for n, v in d[part].items()}
                   for k, d in by_leaf.items()}) + f"; card {card}")
    if not cfg.is_moe:
        rows["serve"] = _tp_serve(dev, card, model, fp32=False)
        if "data2 tp2 fsdp" in fsdp:
            t_serve = time.perf_counter()
            rows["fsdp_serve"] = _fsdp_serve(dev, card, model)
            rows["fsdp_serve"]["wall_s"] = time.perf_counter() - t_serve
            print(f"mesh_train {arch} fsdp serve: "
                  f"{rows['fsdp_serve']['wall_s']:.1f} s")
    del model, state, start, first
    torch.cuda.empty_cache()
    return rows


def _mesh_parity(dev, arch=MESH_ARCH) -> dict:
    """`arch` at full width, depth 2, fp32, on an uneven mask: the step on
    MESH_SHARDS data shards of the card against the unsharded step on the
    card, from the same state: the loss, grad_norm, mu, nu within
    MESH_PARITY_TOL of each leaf's max, the params within that tolerance
    carried through AdamW's first step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import (load_train_state,
                                              make_train_state,
                                              make_train_step)

    cfg = dataclasses.replace(get_arch(arch), n_layers=2, dtype="float32")
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(1),
               device=dev, param_dtype=torch.float32)
    state = make_train_state(model)
    start = _train_snapshot(state)
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=MESH_PARITY_SEQ,
                                     global_batch=MESH_PARITY_BATCH,
                                     seed=13), device=dev).batch(0)
    batch["mask"] = _uneven_mask(MESH_PARITY_BATCH, MESH_PARITY_SEQ, dev)
    opt = OptConfig(**TRAIN_OPT)
    mesh = make_host_mesh(MESH_SHARDS, device=dev)
    shards = len(mesh.devices)
    out = []
    for m in (None, mesh):
        load_train_state(state, start)
        ops.reset_launch_counts()
        with use_mesh(m):
            _, metrics = make_train_step(model, opt)(state, batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {k: v * (1 if m is None else shards)
                for k, v in _path_counts(cfg).items()}
        check({k: counts[k] for k in want} == want,
              f"mesh_train parity: launches {counts}, not {want}")
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    _train_snapshot(state), counts))
    (l0, g0, s0, _), (l1, g1, s1, counts) = out
    check(abs(l1 - l0) <= 1e-5 * abs(l0),
          f"mesh_train parity: loss {l1} on the mesh, {l0} unsharded")
    check(abs(g1 - g0) <= MESH_PARITY_TOL * g0,
          f"mesh_train parity: grad_norm {g1} vs {g0}")
    worst = max(_close_leaves(s1["opt"][k], s0["opt"][k],
                              f"mesh_train parity {k}", MESH_PARITY_TOL)
                for k in ("mu", "nu"))
    swung = _close_params(s1["params"], s0["params"], s0["opt"]["mu"],
                          TRAIN_OPT["peak_lr"], tol=MESH_PARITY_TOL)
    print(f"mesh_train parity {arch} depth 2 fp32 B="
          f"{MESH_PARITY_BATCH} S={MESH_PARITY_SEQ} (uneven mask, "
          f"{int(batch['mask'].sum())} tokens): {shards} shards vs "
          f"unsharded on the card: loss {l1:.7f} vs {l0:.7f}, grad_norm "
          f"{g1:.6f} vs {g0:.6f}, mu/nu worst diff / max {worst:.3e} "
          f"(limit {MESH_PARITY_TOL:g}), params past 1e-4 lr: {swung}; "
          f"launches per mesh step {counts}")
    del model, state, start, out
    torch.cuda.empty_cache()
    return dict(loss=l1, loss_unsharded=l0, grad_norm=g1,
                grad_norm_unsharded=g0, moment_worst_rel=worst,
                params_swung=swung, launches_per_step=counts)


def _mesh_elastic(dev, fsdp: bool = False) -> dict:
    """tests/test_distributed.py:137-183 on the card at phi3's reduced
    config: 6 steps on MESH_SHARDS data shards of the card, a checkpoint,
    restore(shardings=) onto that mesh, a fresh model, `remesh_state`
    onto a (2, 2) ('data', 'model') mesh, 6 more steps (the first lays
    the state out there: each entry its blocks); the 12 losses against
    12 unsharded steps on the card within 1e-5, the optimizer's step at
    12. With `fsdp`, both states are laid out by `param_specs` (FSDP on
    'data', and the 'model' blocks on (2, 2)), and so are the restore
    and the remesh."""
    import tempfile

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import Mesh
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.ft.elastic import remesh_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import (P, Placed, is_fsdp, param_specs,
                                             use_mesh)
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import (load_train_state,
                                              make_train_state,
                                              make_train_step)

    cfg = get_arch(MESH_ARCH).reduced()
    opt = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=8, seed=3), device=dev)

    def fresh(mesh=None):
        model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
                   device=dev, param_dtype=torch.float32)
        with use_mesh(mesh):
            state = make_train_state(model, specs=param_specs(model)
                                     if fsdp and mesh else None)
        return model, state, make_train_step(model, opt)

    tag = "elastic fsdp" if fsdp else "elastic"
    t0 = time.perf_counter()
    _, state, step = fresh()
    want = [float(step(state, data.batch(i))[1]["loss"]) for i in range(12)]
    mesh4 = make_host_mesh(MESH_SHARDS, device=dev)
    mesh22 = Mesh((dev,) * 4, ("data", "model"), (2, 2))
    model, state, step = fresh(mesh4)
    losses = []
    with use_mesh(mesh4):
        for i in range(6):
            losses.append(float(step(state, data.batch(i))[1]["loss"]))
    names = list(state["params"])

    def tree(fn):
        """The state's structure: fn(name) at each leaf, fn(None) at the
        step."""
        leaves = {n: fn(n) for n in names}
        return {"params": leaves, "opt": {"mu": leaves, "nu": leaves,
                                          "step": fn(None)}}

    def specs_on(mesh):
        """Each leaf's spec on `mesh`: `param_specs` with `fsdp`, else
        replicated (P())."""
        with use_mesh(mesh):
            ps = param_specs(model)
        return lambda n: ps[n] if fsdp and n is not None else P()

    on4, on22 = specs_on(mesh4), specs_on(mesh22)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ck = Checkpointer(ckpt_dir, async_save=False)
        ck.save(6, state)
        del model, state, step
        restored = ck.restore(6, tree(lambda n: None),
                              shardings=tree(lambda n: (mesh4, on4(n))))
    placed = remesh_state(restored, tree(on22), mesh22)
    check(placed["params"]["embedding"].mesh.shape["data"] == 2,
          f"mesh_train {tag}: remeshed onto the wrong mesh")
    model, state, step = fresh(mesh22)
    load_train_state(state, placed)
    with use_mesh(mesh22):
        for i in range(6, 12):
            losses.append(float(step(state, data.batch(i))[1]["loss"]))
    diff = max(abs(a - b) for a, b in zip(losses, want))
    opt_step = int(state["opt"]["step"])
    check(isinstance(state["params"]["embedding"], Placed)
          and is_fsdp(state["params"]["embedding"]) == fsdp,
          f"mesh_train {tag}: the state on (2, 2) is not laid out as asked")
    check(diff <= 1e-5 and opt_step == 12,
          f"mesh_train {tag}: losses differ by {diff} from the unsharded "
          f"run, opt step {opt_step}")
    wall = time.perf_counter() - t0
    print(f"mesh_train {tag} {cfg.name} reduced on the card: 6 steps on "
          f"{MESH_SHARDS} data shards, checkpoint, restore(shardings=), "
          f"remesh onto (2, 2) ('data', 'model'), 6 steps"
          + (", each state laid out by param_specs (FSDP)" if fsdp else "")
          + f": 12 losses within {diff:.3e} of 12 unsharded steps, opt "
          f"step {opt_step}, {wall:.2f} s")
    return dict(max_loss_diff=diff, opt_step=opt_step, losses=losses,
                wall_s=wall)


def _mesh_psum(dev) -> dict:
    """compressed_psum over PSUM_SHARDS shards of the card: equal to its
    CPU run, within 0.05 of the exact sum (of its max)."""
    from repro_torch.optim.compression import compressed_psum

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((PSUM_SHARDS, PSUM_SIZE)).astype(np.float32)
    xs[3] *= 40.0
    got = compressed_psum([torch.from_numpy(x).to(dev) for x in xs])
    cpu = compressed_psum([torch.from_numpy(x) for x in xs])
    check(all(g.device.type == "cuda" for g in got),
          "compressed_psum: a result off the card")
    equal = all(torch.equal(g.cpu(), cpu[0]) for g in got)
    exact = xs.sum(0)
    err = float(np.abs(got[0].cpu().numpy() - exact).max()
                / np.abs(exact).max())
    check(equal, "compressed_psum: the card's sum differs from the CPU's")
    check(err < 0.05, f"compressed_psum: {err} of the exact sum's max")
    print(f"mesh_train compressed_psum {PSUM_SHARDS} shards of {dev} x "
          f"{PSUM_SIZE}: equal to the CPU run {equal}, max error / max of "
          f"the exact sum {err:.4f} (limit 0.05)")
    return dict(equal_to_cpu=equal, rel_err=err)


def _mesh_serve_twin() -> dict:
    """The serve_lm twin (`repro_torch.examples.serve_lm`) on the card,
    its defaults: hymba-1.5b reduced, batch 4, prompt 24, 16 new tokens."""
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = serve_lm.main([])
    counts = ops.launch_counts()
    check(out.device.type == "cuda" and tuple(out.shape) == (4, 16),
          f"serve_lm twin: {tuple(out.shape)} on {out.device}")
    check(bool(((out >= 0) & (out < 97)).all()),
          "serve_lm twin: a token outside the vocab")
    check(counts["flash_attention"] == 2,
          f"serve_lm twin: launches {counts} (one flash launch per layer "
          f"of the prefill)")
    print(f"mesh_train serve_lm twin on the card: launches {counts}")
    return dict(launches=counts)


def _mesh_fp32(dev, arch, data=True, tp=("tp4",), card="") -> dict:
    """`arch` at full width, MESH_DEPTH layers, fp32 activations, remat,
    B = MESH_BATCH x MESH_SEQ, one step from one state unsharded, then
    (with `data`) on MESH_SHARDS data shards and with the ZeRO
    accumulator, and tensor parallel on the meshes named in `tp`: the
    loss within 1e-5 and each gradient leaf (mu) and parameter within
    MESH_FP32_REL_L2 rel. L2 of the unsharded step's; for MoE also the
    router's top-k of every token in every layer's forward, equal on
    both, and the step's aux within MESH_AUX_RTOL of the unsharded
    step's. With phi3 the fp32 serving steps follow (`_tp_serve`)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import param_specs, use_mesh
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import (load_train_state,
                                              make_train_state,
                                              make_train_step)

    cfg = dataclasses.replace(get_arch(arch), n_layers=MESH_DEPTH,
                              dtype="float32")
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev, param_dtype=torch.float32)
    state = make_train_state(model)
    start = _train_snapshot(state)
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=MESH_SEQ,
                                     global_batch=MESH_BATCH, seed=7),
                          device=dev).batch(0)
    routes = []

    def hook(mod, args):
        with torch.no_grad():
            routes.append(tmoe.route(mod, args[0], args[1])[2])

    hooks = [blk.mlp.register_forward_pre_hook(hook)
             for blk in model.layers if cfg.is_moe]
    opt = OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    mesh = make_host_mesh(MESH_SHARDS, device=dev)
    out, first = {}, None
    variants = [v for v in _mesh_variants(mesh, tp)
                if data or v[1] is None or "model" in v[1].axis_names]
    for name, m, zero, _ in variants:
        load_train_state(state, start)
        routes.clear()
        with use_mesh(m):
            _, met = make_train_step(model, opt, grad_shard_specs=(
                param_specs(model) if zero else None))(state, batch)
        loss = float(met["loss"])
        aux = float(met["aux"]) if cfg.is_moe else None
        from repro_torch.launch.mesh import data_shards

        shards = 1 if m is None else len(data_shards(m, MESH_BATCH)[1])
        # each shard's forward routes, then the recompute's: the forward's
        # by layer over the rows
        fwd = [torch.cat([routes[j * cfg.n_layers + l]
                          for j in range(shards)])
               for l in range(cfg.n_layers)] if hooks else []
        if first is None:
            snap = _train_snapshot(state)
            first = (loss, snap["opt"]["mu"], fwd, snap["params"], aux)
            del snap
            continue
        rel = abs(loss - first[0]) / abs(first[0])
        aux_rel = None if aux is None else abs(aux - first[4]) / abs(first[4])
        check(aux is None or aux_rel <= MESH_AUX_RTOL,
              f"mesh_train fp32 {arch} {name}: aux {aux!r} vs the unsharded "
              f"step's {first[4]!r} (rel {aux_rel}, limit {MESH_AUX_RTOL:g})")
        grad_l2 = _rel_l2_leaves(state["opt"]["mu"], first[1])
        param_l2 = _rel_l2_leaves(state["params"], first[3])
        flips = sum(int((torch.sort(a, -1).values
                         != torch.sort(b, -1).values).any(-1).sum())
                    for a, b in zip(fwd, first[2]))
        check(rel <= 1e-5 and grad_l2 <= MESH_FP32_REL_L2
              and param_l2 <= MESH_FP32_REL_L2 and flips == 0,
              f"mesh_train fp32 {arch} {name}: loss rel {rel:.2e}, "
              f"gradient rel. L2 {grad_l2:.3e}, params {param_l2:.3e} "
              f"(limit {MESH_FP32_REL_L2:g}), tokens routed otherwise "
              f"{flips}")
        out[name] = dict(loss_rel=rel, grad_rel_l2_worst=grad_l2,
                         param_rel_l2_worst=param_l2,
                         tokens_routed_otherwise=flips, aux_rel=aux_rel)
    for h in hooks:
        h.remove()
    print(f"mesh_train fp32 {arch} ({cfg.n_layers} layers, full width, "
          f"B={MESH_BATCH} S={MESH_SEQ}) against the unsharded step: "
          f"{json.dumps(out)}")
    if not cfg.is_moe:
        out["serve"] = _tp_serve(dev, card, model, fp32=True)
    del model, state, start, first
    torch.cuda.empty_cache()
    return out


def _tp_serve(dev, card, model, fp32: bool) -> dict:
    """`model`'s serving steps unsharded, then tensor parallel on (1, 4)
    (`MESH_TP["tp4"]`) fed the unsharded run's tokens (so a near-tie
    cannot make the runs part): the prefill of B = MESH_BATCH x MESH_SEQ,
    then TP_SERVE_NEW decode steps. Every step's logits held to the
    unsharded ones: in fp32 within TP_SERVE_FP32_TOL of their largest
    magnitude, in bf16 within the serving contract's rel. L2
    TP_SERVE_BF16_REL_L2. Prefill ms, decode ms a step, launches."""
    from repro_torch.core.distributed import Mesh
    from repro_torch.kernels import ops
    from repro_torch.models.sharding import use_mesh
    from repro_torch.serve import serve_step as ss

    tag = "fp32" if fp32 else "bf16"
    # the steps lay the model out: whole leaves unsharded, placed on (1, 4)
    prompt = torch.randint(0, model.cfg.vocab_size, (MESH_BATCH, MESH_SEQ),
                           dtype=torch.int32,
                           generator=torch.Generator().manual_seed(21)).to(dev)
    max_len = MESH_SEQ + TP_SERVE_NEW + 1
    mesh = Mesh((dev,) * 4, ("data", "model"), MESH_TP["tp4"])

    def run(m, feed=None):
        with use_mesh(m), torch.no_grad():
            caches = ss.init_caches(model, MESH_BATCH, max_len)
            prefill, decode = (ss.make_prefill_step(model),
                               ss.make_decode_step(model))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, caches = prefill(prompt, caches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = ops.launch_counts()
            steps = [logits.float()]
            toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
            for i in range(TP_SERVE_NEW):
                tok = toks[-1] if feed is None else feed[i]
                nxt, logits, caches = decode(tok, MESH_SEQ + i, caches)
                steps.append(logits.float())
                toks.append(nxt)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return dict(steps=steps, toks=toks, launches=launches,
                    prefill_ms=(t1 - t0) * 1e3,
                    decode_ms=(t2 - t1) * 1e3 / TP_SERVE_NEW)

    base = run(None)
    tp = run(mesh, feed=base["toks"])
    worst = 0.0
    for i, (a, b) in enumerate(zip(base["steps"], tp["steps"])):
        check(bool(torch.isfinite(b).all()), f"tp serve {tag}: step {i} "
                                             f"logits not finite")
        if fp32:
            d = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        else:
            d = _rel_l2(a, b)[0]
        worst = max(worst, d)
    limit = TP_SERVE_FP32_TOL if fp32 else TP_SERVE_BF16_REL_L2
    want_flash = model.cfg.n_layers * int(np.prod(MESH_TP["tp4"]))
    check(tp["launches"]["flash_attention"] == want_flash,
          f"tp serve {tag}: prefill launches {tp['launches']}, not "
          f"{want_flash} flash")
    check(worst <= limit, f"tp serve {tag}: logits {worst:.3e} from the "
                          f"unsharded ones (limit {limit:g})")
    out = dict(worst=worst, limit=limit, measure=(
        "max |diff| / max |logit|" if fp32 else "rel. L2"),
        prefill_ms=tp["prefill_ms"], decode_ms=tp["decode_ms"],
        prefill_ms_unsharded=base["prefill_ms"],
        decode_ms_unsharded=base["decode_ms"],
        launches_prefill=tp["launches"],
        launches_prefill_unsharded=base["launches"])
    print(f"mesh_train tp serve {model.cfg.name} {tag} ({model.cfg.n_layers}"
          f" layers, B={MESH_BATCH} prefill S={MESH_SEQ}, {TP_SERVE_NEW} "
          f"decode steps fed the unsharded tokens) on (1, 4) of {dev}: "
          f"{json.dumps(out)}; card {card}")
    return out


def _mesh_moe(dev, card) -> tuple:
    """MoE on the mesh: granite's full-width bf16 step (`_mesh_full`: one
    step each unsharded, on MESH_SHARDS data shards, with the ZeRO
    accumulator; the step's aux against the whole batch's and the mean
    of the shards' own; the gradient distance printed: bf16 rounding at
    M = 2,048 rather than 8,192 moves granite's attention leaves by ~2.5
    %, past phi3's limit); the same steps in fp32, each leaf within
    MESH_FP32_REL_L2 and every token routed alike (`_mesh_fp32`); and
    the depth-2 fp32 parity (`_mesh_parity`)."""
    t0 = time.perf_counter()
    rows = _mesh_full(dev, card, MESH_MOE_ARCH, grad_limit=None,
                      tp=("tp4",), fsdp=(f"data{MESH_SHARDS} fsdp",))
    t1 = time.perf_counter()
    fp32 = _mesh_fp32(dev, MESH_MOE_ARCH)
    t2 = time.perf_counter()
    parity = _mesh_parity(dev, MESH_MOE_ARCH)
    t3 = time.perf_counter()
    print(f"mesh_train {MESH_MOE_ARCH}: {t3 - t0:.1f} s (bf16 steps "
          f"{t1 - t0:.1f}, fp32 steps {t2 - t1:.1f}, parity {t3 - t2:.1f})")
    return rows, dict(parity, fp32_full_width=fp32)


def phase_mesh_train(dev, card) -> dict:
    """Training on a mesh of the card (after phase_train): phi3's
    full-width step unsharded, on MESH_SHARDS data shards, with the ZeRO
    accumulator, tensor parallel on (1, 4) and (2, 2), and FSDP on the
    data shards and on (2, 2), then its bf16 serving steps on (1, 4) and
    on the FSDP model (`_mesh_full`); its fp32 step on (1, 4) and the
    fp32 serving steps (`_mesh_fp32`); the depth-2 fp32 parity
    (`_mesh_parity`); the same for granite's MoE, its TP step on (1, 4)
    with its experts over 'model' and its FSDP step (`_mesh_moe`); the
    elastic restart, from a replicated and from an FSDP state
    (`_mesh_elastic`), compressed_psum (`_mesh_psum`) and the serve_lm
    twin. Returns per kernel its launches a step on the dense mesh path
    ({variant: count}), on the MoE one ({"moe": {variant: count}}) and on
    the tensor-parallel one ({"tp": {variant: count}})."""
    t0, parts = time.perf_counter(), {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        parts[name] = time.perf_counter() - t
        return out

    rows = timed(f"{MESH_ARCH} bf16", _mesh_full, dev, card)
    tp_fp32 = timed(f"{MESH_ARCH} fp32", _mesh_fp32, dev, MESH_ARCH,
                    data=False, card=card)
    parity = timed(f"{MESH_ARCH} parity", _mesh_parity, dev)
    moe_rows, moe_parity = timed(MESH_MOE_ARCH, _mesh_moe, dev, card)
    elastic = timed("elastic", _mesh_elastic, dev)
    elastic_fsdp = timed("elastic fsdp", _mesh_elastic, dev, fsdp=True)
    psum = timed("psum", _mesh_psum, dev)
    twin = timed("serve twin", _mesh_serve_twin)
    wall = time.perf_counter() - t0
    print("mesh_train seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    serve = rows.pop("serve")
    fsdp_serve = rows.pop("fsdp_serve")
    print(f"mesh_train numbers: {json.dumps(dict(runs=rows, tp_fp32=tp_fp32, tp_serve_bf16=serve, fsdp_serve_bf16=fsdp_serve, parity=parity, moe_runs=moe_rows, moe_parity=moe_parity, elastic=elastic, elastic_fsdp=elastic_fsdp, psum=psum, serve_twin=twin, wall_s=wall, card=card))}")
    out = {}
    tp_names = set(MESH_TP) | {"data2 tp2 fsdp"}
    for kernel in ("flash_attention", "flash_attention_bwd", "radix_hist"):
        out[kernel] = {k: r["launches_per_step"][kernel]
                       for k, r in rows.items() if k not in tp_names}
        out[kernel]["moe"] = {k: r["launches_per_step"][kernel]
                              for k, r in moe_rows.items()
                              if k not in tp_names}
        out[kernel]["tp"] = {
            **{f"phi3 {k}": rows[k]["launches_per_step"][kernel]
               for k in sorted(tp_names)},
            "granite tp4": moe_rows["tp4"]["launches_per_step"][kernel],
            "phi3 tp4 prefill": serve["launches_prefill"][kernel],
            "phi3 tp4 fp32 prefill":
                tp_fp32["serve"]["launches_prefill"][kernel]}
    return out


AUDIT_SIGNATURE = dict(n=64, L=128, B=2)  # the CLI's standard programs


# ------------------------------------------------------------- dryrun
# the flash shapes whose kernel outputs the operators' fakes are held to
DRYRUN_FLASH_CASES = ("phi3 prefill bf16", "granite prefill bf16",
                      "hubert encode bf16", "phi3 prefill fp32")
DRYRUN_PEAK_RTOL = 0.2      # the dry-run's peak against the card's
DRYRUN_DECODE_RANK_CALLS = 32   # rank calls of a granite decode step
DRYRUN_HOST_BUDGET_US = 1000.0  # the op layer's host time per such step
DRYRUN_PROD_OUT = os.path.join(ROOT, "build", "dryrun_smoke")


def _layout(x) -> tuple:
    return tuple(x.shape), str(x.dtype), tuple(x.stride())


def _on_meta(x):
    """x as a meta tensor of its layout (anything else as it is)."""
    if not torch.is_tensor(x):
        return x
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")


def _same_as_fake(name, real, fake) -> None:
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    want, got = [_layout(x) for x in real], [_layout(x) for x in fake]
    print(f"dryrun fake {name}: kernel {want}, fake {got}")
    check(want == got, f"dryrun: the fake of {name} differs from the "
          f"kernel's outputs")


def _dryrun_fakes(dev, case3) -> None:
    """Each operator's fake (on meta copies of the inputs) against the
    kernel's outputs on the card: shape, dtype and stride, at the flash
    shapes, the MoE rank shapes, the argsort of case3's size and case3's
    MARK."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import phase1, radix_hist

    for name in DRYRUN_FLASH_CASES:
        q, k, v, qp, kp, causal, window = _flash_inputs(dev, name, 0)
        args = (q, k, v, qp, kp, causal, window)
        meta = tuple(_on_meta(x) for x in args)
        _same_as_fake(f"flash_fwd {name}", fa.FWD_OP(*args),
                      fa.FWD_OP(*meta))
        out, lse = fa.FWD_LSE_OP(*args)
        _same_as_fake(f"flash_fwd_lse {name}", (out, lse),
                      fa.FWD_LSE_OP(*meta))
        bargs = (out, q, k, v, out, qp, kp, lse, causal, window)
        _same_as_fake(f"flash_bwd {name}", fa.BWD_OP(*bargs),
                      fa.BWD_OP(*(_on_meta(x) for x in bargs)))
    rng = np.random.default_rng(29)
    for name, (b, pairs, e) in MOE_RANK_CASES.items():
        keys = (rng.integers(0, e, (b, pairs))
                + np.arange(b)[:, None] * e).reshape(-1)
        dt = torch.as_tensor(keys.astype(np.int32), device=dev)
        _same_as_fake(f"bucket_rank_hist MoE {name}", radix_hist.RANK_OP(dt),
                      radix_hist.RANK_OP(_on_meta(dt)))
    keys = torch.as_tensor(rng.integers(0, 2 ** 32, case3.m), device=dev)
    for hi in (None, keys.flip(0).contiguous()):
        _same_as_fake(f"radix_argsort M={case3.m} "
                      f"{'u32' if hi is None else 'pair'}",
                      radix_hist.ARGSORT_OP(keys, hi),
                      radix_hist.ARGSORT_OP(_on_meta(keys), _on_meta(hi)))
    x = _mark_rec_inputs(case3, dev, False)
    real = phase1.mark_cuda(x.t, x.su, x.sv, x.sbeta, x.layout, x.k_cap,
                            x.euler)
    fake = phase1.mark_cuda(
        type(x.t)(*map(_on_meta, x.t)), _on_meta(x.su), _on_meta(x.sv),
        _on_meta(x.sbeta), type(x.layout)(*map(_on_meta, x.layout)),
        x.k_cap, type(x.euler)(*map(_on_meta, x.euler)))
    _same_as_fake(f"mark case3 (L={case3.m})", real, fake)
    torch.cuda.synchronize()


def _op_host_us(fn, calls: int) -> float:
    """Host µs per call of `calls` back-to-back calls, after one call and
    a sync; the device work they enqueue is drained after the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _dryrun_host_time(dev, card, case3) -> dict:
    """The operator layer's host time: each operator called through the
    dispatcher against its CUDA implementation (the raw ctypes launch)
    called directly on the same arguments, in 12 turns (op, raw, raw, op,
    three times), host µs a call: the rank entry at M = 32 (a granite
    decode step's call), the argsort at M = 32, phi3's flash forward with
    and without LSE and its backward, and case3's MARK. The guard at each
    launch (`oplib.check_launchable`) is in both; the added time a call
    is the median op less the median raw, and its spread the range of
    op - raw over the six pairs of turns in order."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import phase1, radix_hist

    d = torch.zeros(32, dtype=torch.int32, device=dev)
    keys = torch.arange(32, dtype=torch.int64, device=dev)
    q, k, v, qp, kp, causal, window = _flash_inputs(dev, "phi3 prefill bf16",
                                                    0)
    fwd = (q, k, v, qp, kp, causal, window)
    out, lse = fa.FWD_LSE_OP(*fwd)
    bwd = (out, q, k, v, out, qp, kp, lse, causal, window)
    x = _mark_rec_inputs(case3, dev, False)
    engine, tabs, _, _ = phase1._engine(x.t, x.euler)
    i32 = phase1._i32
    mark = (engine, *tabs, i32(x.su), i32(x.sv), i32(x.sbeta),
            i32(x.layout.group_start), i32(x.layout.gidx),
            x.layout.active.contiguous(),
            x.layout.n_groups.to(torch.int64).contiguous(),
            (x.t.depth != phase1.INF).all(), x.k_cap, True)
    cases = {
        "bucket_rank_hist M=32": (radix_hist.RANK_OP, radix_hist._rank_launch,
                                  (d,), 400),
        "radix_argsort M=32": (radix_hist.ARGSORT_OP,
                               radix_hist._argsort_launch, (keys, None),
                               400),
        "flash_fwd phi3": (fa.FWD_OP, lambda *a: fa._forward_launch(
            *a, False)[0], fwd, 20),
        "flash_fwd_lse phi3": (fa.FWD_LSE_OP, lambda *a: fa._forward_launch(
            *a, True), fwd, 20),
        "flash_bwd phi3": (fa.BWD_OP, fa._backward_launch, bwd, 10),
        "mark case3": (phase1.MARK_OP, phase1._mark_launch, mark, 20)}
    res = {}
    for name, (op, raw, args, calls) in cases.items():
        runs = {"op": [], "raw": []}
        for which in ("op", "raw", "raw", "op") * 3:
            fn = op if which == "op" else raw
            runs[which].append(_op_host_us(lambda: fn(*args), calls))
        op_us, raw_us = (statistics.median(runs[w]) for w in ("op", "raw"))
        pairs = [o - r for o, r in zip(runs["op"], runs["raw"])]
        res[name] = dict(op_us=op_us, raw_us=raw_us,
                         added_us=op_us - raw_us,
                         added_range_us=[min(pairs), max(pairs)],
                         runs_us=runs)
    step = DRYRUN_DECODE_RANK_CALLS * max(
        res["bucket_rank_hist M=32"]["added_us"], 0.0)
    res["granite decode step added_us"] = step
    print(f"dryrun host time per call (operator vs its raw ctypes launch, "
          f"in turns): {json.dumps(res)}; a granite decode step's "
          f"{DRYRUN_DECODE_RANK_CALLS} rank calls add {step:.1f} us; "
          f"card {card}")
    check(step <= DRYRUN_HOST_BUDGET_US, f"dryrun: the op layer adds "
          f"{step:.1f} us to a granite decode step (limit "
          f"{DRYRUN_HOST_BUDGET_US:g})")
    return res


def _held_bytes(dev) -> int:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def _dryrun_vs_card(dev, card) -> dict:
    """The dry-run's peak and FLOPs of the mesh_train phase's unsharded
    phi3 step (MESH_DEPTH of 32 layers, B = MESH_BATCH x MESH_SEQ, fp32
    state, bf16 activations, remat) and the peak of a full-depth phi3
    prefill at B = 4 x 2,048 (bf16 weights, its caches), each traced on
    meta tensors, against the card: `max_memory_allocated` over what was
    held before the model was built, and the step's FLOPs by
    `FlopCounterMode` on the real step."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.graph_analysis import analyze_program
    from repro_torch.models.model import LM
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.train_step import (make_train_state,
                                              make_train_step)

    cfg = dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_DEPTH)
    opt = OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                      global_batch=MESH_BATCH, seed=7)
    cpu_batch = TokenPipeline(data, device="cpu").batch(0)
    launches = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    meta = LM(cfg, device="meta", param_dtype=torch.float32)
    dry = analyze_program(make_train_step(meta, opt), make_train_state(meta),
                          {k: _on_meta(x) for k, x in cpu_batch.items()})
    dry_s = time.perf_counter() - t0
    check(sum(ops.launch_counts().values()) == 0,
          "dryrun: a meta trace launched a kernel")
    base = _held_bytes(dev)
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev, param_dtype=torch.float32)
    state = make_train_state(model)
    batch = {k: x.to(dev) for k, x in cpu_batch.items()}
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    launches["step"] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    # the FLOPs of a second step: FlopCounterMode's module tracker holds
    # activations in reference cycles, so it runs apart from the peak
    with FlopCounterMode(display=False) as counter:
        state, metrics = step(state, batch)
    flops = counter.get_total_flops()
    tp = _dryrun_tp_entry(dev, card, cfg, opt, cpu_batch, model, step,
                          state, batch)
    tp["unsharded_card_flops"] = flops
    del model, state, batch, step, metrics
    rel = dry["peak_bytes"] / peak - 1
    row = dict(step=dict(
        config=f"{MESH_ARCH} {MESH_DEPTH} of 32 layers, B={MESH_BATCH} "
               f"S={MESH_SEQ}", dry_peak_bytes=dry["peak_bytes"],
        card_peak_bytes=peak, peak_rel=rel, dry_flops=dry["flops"],
        dry_flops_work=dry["flops_work"], card_flops=flops, trace_s=dry_s,
        loss=loss), tp_entry=tp)
    print(f"dryrun {MESH_ARCH} step ({MESH_DEPTH} layers, B={MESH_BATCH} "
          f"S={MESH_SEQ}): peak dry-run {dry['peak_bytes'] / 1e9:.3f} GB, "
          f"card {peak / 1e9:.3f} GB (rel. {rel:+.4f}); FLOPs dry-run "
          f"{dry['flops']:.6e}, card {flops:.6e} (kernels' work "
          f"{dry['flops_work']:.6e}); traced in {dry_s:.1f} s; "
          f"launches {launches['step']}; card {card}")
    check(np.isfinite(loss), f"dryrun: step loss {loss}")
    check(abs(rel) <= DRYRUN_PEAK_RTOL, f"dryrun: step peak {rel:+.3f}")
    check(dry["flops"] == flops, "dryrun: step FLOPs differ from the card's")

    full = get_arch(LM_ARCH)
    b, s = 4, 2048
    tokens = torch.randint(0, full.vocab_size, (b, s), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5))
    t0 = time.perf_counter()
    meta = LM(full, device="meta")
    with torch.no_grad():
        dry = analyze_program(lambda p, t, c: meta.prefill(t, c),
                              dict(meta.named_parameters()),
                              _on_meta(tokens), meta.init_caches(b, s))
    dry_s = time.perf_counter() - t0
    base = _held_bytes(dev)
    model = LM(full, generator=torch.Generator(dev).manual_seed(0),
               device=dev)
    caches = model.init_caches(b, s)
    tokens = tokens.to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _ = model.prefill(tokens, caches)
    torch.cuda.synchronize()
    launches["prefill"] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    finite = bool(torch.isfinite(logits).all())
    del model, caches, logits
    _held_bytes(dev)
    rel = dry["peak_bytes"] / peak - 1
    row["prefill"] = dict(config=f"{LM_ARCH} {full.n_layers} layers, "
                                 f"B={b} S={s}",
                          dry_peak_bytes=dry["peak_bytes"],
                          card_peak_bytes=peak, peak_rel=rel,
                          dry_flops=dry["flops"], trace_s=dry_s)
    print(f"dryrun {LM_ARCH} prefill ({full.n_layers} layers, B={b} "
          f"S={s}): peak "
          f"dry-run {dry['peak_bytes'] / 1e9:.3f} GB, card "
          f"{peak / 1e9:.3f} GB (rel. {rel:+.4f}); traced in {dry_s:.1f} s; "
          f"launches {launches['prefill']}; card {card}")
    check(finite, "dryrun: prefill logits not finite")
    check(abs(rel) <= DRYRUN_PEAK_RTOL, f"dryrun: prefill peak {rel:+.3f}")
    row["launches"] = launches
    return row


def _dryrun_tp_entry(dev, card, cfg, opt, cpu_batch, model, step, state,
                     batch) -> dict:
    """One traced entry of the (1, 4) ('data', 'model') mesh
    (`sharding.entry_model`, `place_model` for entry 0 alone, +
    `traced_entry` on meta tensors) of the mesh_train phase's phi3 step
    against that step on (1, 4) of the card, on the state placed there
    (`lay_out_state`), by `FlopCounterMode` count; the traced entry's
    leaves are entry 0's blocks of the card's placed model. With remat's
    early stop off on both sides, the four entries' traced FLOPs summed
    equal the card step's.
    With it on (the real path), the one process that drives the four
    entries recomputes the last products of the first three, which a
    lone entry (and an entry on a card of its own) skips: the card step
    then counts three entries with early stop off and one with it on.
    Both are held. (With bf16 activations the two traced counts are
    equal: a float32 partial product, `sharding.partial_product`, saves
    its inputs once it has run, so the recompute runs it.) Replicated
    work is counted per entry in the trace and once per data shard on
    the card: here only the norms and the embedding lookup, which count
    no FLOPs (phi3's 32 kv heads shard, and it has no router)."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.distributed import Mesh
    from repro_torch.launch.graph_analysis import analyze_program
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import LM
    from repro_torch.train.train_step import (lay_out_state,
                                              make_train_state,
                                              make_train_step)

    shape = MESH_TP["tp4"]
    n = int(np.prod(shape))
    mesh = Mesh((dev,) * n, ("data", "model"), shape)
    with sh.use_mesh(mesh):
        lay_out_state(model, state)
    t0 = time.perf_counter()
    dry, on_card = {}, {}
    for early in (False, True):
        meta = sh.entry_model(LM(cfg, device="meta",
                                 param_dtype=torch.float32), n)
        with sh.use_entries(sh.traced_entry(n, "meta")), \
                set_checkpoint_early_stop(early):
            dry[early] = analyze_program(
                make_train_step(meta, opt), make_train_state(meta),
                {k: _on_meta(x) for k, x in cpu_batch.items()})
    dry_s = time.perf_counter() - t0
    traced = dict(sh.named_leaves(meta))
    for name, leaf in sh.named_leaves(model):
        local = leaf.shards[0] if isinstance(leaf, sh.Placed) else leaf
        other = traced[name]
        other = other.shards[0] if isinstance(other, sh.Placed) else other
        check(local.shape == other.shape, f"dryrun: the traced entry's "
              f"{name} {tuple(other.shape)} is not entry 0's block "
              f"{tuple(local.shape)} of the card's placed model")
    for early in (False, True):
        with sh.use_mesh(mesh), set_checkpoint_early_stop(early):
            with FlopCounterMode(display=False) as counter:
                step(state, batch)
        on_card[early] = counter.get_total_flops()
    entry, entry_es = dry[False]["flops"], dry[True]["flops"]
    out = dict(mesh=list(shape), entry_flops=entry,
               entries_flops=n * entry, card_flops=on_card[False],
               entry_flops_early_stop=entry_es,
               card_flops_early_stop=on_card[True],
               entry_peak_bytes=dry[True]["peak_bytes"],
               model_collective_bytes=dry[True]["model_collective_bytes"],
               model_collective_counts=dry[True]["model_collective_counts"],
               trace_s=dry_s)
    print(f"dryrun tp entry {MESH_ARCH} step ({cfg.n_layers} layers, "
          f"B={MESH_BATCH} S={MESH_SEQ}) on {tuple(shape)}: early stop "
          f"off, one traced entry {entry:.6e} FLOPs x {n} = "
          f"{n * entry:.6e}, the card's TP step {on_card[False]:.6e}; "
          f"early stop on (the real path), {n - 1} entries off + one on "
          f"= {(n - 1) * entry + entry_es:.6e}, the card's "
          f"{on_card[True]:.6e} (replicated work counted per entry in the "
          f"trace, once per data shard on the card: norms and the lookup, "
          f"no FLOPs); its 'model' reductions "
          f"{json.dumps(out['model_collective_counts'])}, "
          f"{out['model_collective_bytes'] / 1e9:.3f} GB an entry; traced "
          f"in {dry_s:.1f} s; card {card}")
    check(n * entry == on_card[False],
          "dryrun: the traced TP entries' FLOPs differ from the card's")
    check((n - 1) * entry + entry_es == on_card[True],
          "dryrun: with early stop, the traced TP entries' FLOPs differ "
          "from the card's")
    return out


def _dryrun_donation(dev) -> dict:
    """`analyze_program` of the donated service program on CUDA tensors:
    the tree mask handed back in `edge_valid`'s storage, and no copy from
    the host."""
    from repro_torch.analysis.graph_audit import audit_graphs
    from repro_torch.launch.graph_analysis import analyze_program
    from repro_torch.serve.sparsify_service import SparsifyService

    svc = SparsifyService(donate=True, device=dev)
    spec = svc.program_specs([(64, 128)], batch_sizes=(2,))[0]
    (b, length), _ = spec.args[0]
    args = audit_graphs(spec.static_kwargs["n"], length, b, device=dev) + (
        torch.full((b,), spec.signature[3], dtype=torch.int32, device=dev),)
    rep = analyze_program(spec.fn, *args, static_kwargs=spec.static_kwargs)
    torch.cuda.synchronize()
    keep = ("output_alias", "transfer_count", "transfer_sites",
            "sync_count", "sync_sites", "flops", "mem_bytes", "peak_bytes",
            "n_ops")
    out = {k: rep[k] for k in keep}
    print(f"dryrun donated program {spec.name} on {dev}: {json.dumps(out)}")
    check(len(rep["output_alias"]) >= 1 and rep["transfer_count"] == 0,
          "dryrun: the donated program reports no alias, or a transfer")
    return out


def phase_dryrun(dev, card, case3) -> dict:
    """The dry-run tools on the card (launch/{graph_analysis,specs,
    dryrun}.py): the operators' host time (first, before anything else
    runs beside it), then the production record of phi3 train_4k on 256
    cards traced in a process of its own while the fakes are held to the
    kernels' outputs, the dry-run's peaks and FLOPs to the card's, the
    donated program's alias; then lgrass case3_16k's record on the 256-card mesh
    and phi3's. Returns the phase's numbers."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M

    props = torch.cuda.get_device_properties(0)
    print(f"dryrun card memory: total_memory {props.total_memory} B "
          f"(launch/mesh.HBM_BYTES {M.HBM_BYTES}); card {card}")
    out = dict(total_memory=props.total_memory,
               host=_dryrun_host_time(dev, card, case3))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi3-mini-3.8b", "--shape", "train_4k", "--mesh", "single",
         "--force", "--out", DRYRUN_PROD_OUT], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _dryrun_fakes(dev, case3)
        out.update(_dryrun_vs_card(dev, card))
        out["donation"] = _dryrun_donation(dev)
        lg = dryrun.run_lgrass_cell("case3_16k", False, DRYRUN_PROD_OUT,
                                    force=True)
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"dryrun phi3 train_4k: {log[-3000:]}")
    with open(os.path.join(DRYRUN_PROD_OUT,
                           "phi3-mini-3.8b_train_4k_h100x256.json")) as f:
        phi3 = json.load(f)
    for rec in (phi3, lg):
        print(f"dryrun record {rec['cell']}: {json.dumps(rec)}")
    out["records"] = {r["cell"]: r for r in (phi3, lg)}
    return out


def phase_analysis(dev, card) -> dict:
    """The static-analysis package on the card: `python -m
    repro_torch.analysis --json` (the lint, the derived constants and
    `standard_program_audits` on the card) must exit 0; its report gives
    the standard programs' host syncs by site. Then on CUDA tensors one
    `audit_service` at AUDIT_SIGNATURE and `lgrass_sparsify` on case3.
    Prints every call's host syncs by site beside its budget; fails where
    a site syncs past its card budget, outside the budget, or where a
    site of a plain loop (MARK's, REC's) syncs on the card."""
    import tempfile

    from repro_torch.analysis import graph_audit as ga
    from repro_torch.core import official_case
    from repro_torch.serve.sparsify_service import SparsifyService

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "analysis.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--device",
             str(dev), "--json", out],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        cli = json.load(open(out)) if os.path.exists(out) else {}
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print(f"analysis cli: exit {proc.returncode}; {tail[0]}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0, f"python -m repro_torch.analysis exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    audits = cli.get("audits", [])
    check(len(audits) == 12 and all(a["device"] == "cuda" for a in audits),
          f"analysis cli: {len(audits)} audits, on "
          f"{sorted({a['device'] for a in audits})}, not 12 on the card")
    sig = AUDIT_SIGNATURE
    svc = SparsifyService(device=dev)
    reports = ga.audit_service(svc, sizes=[(sig["n"], sig["L"])],
                               batch_sizes=(sig["B"],))
    reports.append(ga.audit_sparsify(official_case("case3"), device=dev))
    torch.cuda.synchronize()
    audits += [r.as_dict() for r in reports]
    rows = {}
    for a in audits:
        rows[a["name"]] = dict(n_syncs=a["n_syncs"], by_site=a["by_site"],
                               bounds=a["bounds"], by_line=a["syncs"],
                               kinds=a["kinds"], findings=a["findings"])
        print(f"analysis syncs {a['name']} on {a['device']}: "
              f"{a['n_syncs']} host syncs; by site (count / card budget) "
              + ", ".join(f"{k} {c}/{a['bounds'].get(k)}"
                          for k, c in sorted(a["by_site"].items())))
    bad = {a["name"]: a["findings"] for a in audits if not a["ok"]}
    check(not bad, f"analysis: audits over their card budget: "
          f"{json.dumps(bad)}")
    wall = time.perf_counter() - t0
    print(f"analysis numbers: {json.dumps(dict(audits=rows, cli_lint_suppressed=cli.get('suppressed'), wall_s=wall, card=card))}")
    return rows


def phase_profile(dev, graphs, out_dir):
    """One profiled lgrass_sparsify call per graph (name -> graph): the
    busy share and each stage's host and device time; the table goes to
    DIR/profile_<name>.txt."""
    from repro_torch.core import lgrass_sparsify

    os.makedirs(out_dir, exist_ok=True)
    for name, g in graphs.items():
        lgrass_sparsify(g, device=dev)  # warm
        wall_ms, busy_ms, launches, events = busy_profile(
            lambda: lgrass_sparsify(g, device=dev))
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(events.table(sort_by="cpu_time_total", row_limit=40))
        print(f"profile {name}: wall {wall_ms:.1f} ms under the profiler, "
              f"device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f} %), {launches} kernel "
              f"launches [clock {sm_clock()}]")
        stages = [e for e in events
                  if e.key.isupper() and e.cpu_time_total > 0]
        for e in sorted(stages, key=lambda e: -e.cpu_time_total):
            print(f"profile {name} {e.key}: host "
                  f"{e.cpu_time_total / 1e3:.1f} ms, device "
                  f"{e.device_time_total / 1e3:.1f} ms")


# the A/B of the flash forward against another commit (--flash-ab)
FLASH_AB_CASE = "hubert encode bf16"


def flash_ab(other: str) -> None:
    """FLASH_AB_CASE timed (`_time_flash`: events, whole-trace device time,
    SDPA, the bound), then hubert's encode (`_encode`: the median encode
    ms, the device time by kind), on the checkout at `other` (an unpacked
    tree of another commit, its own kernels built there) and on this one
    in turns: other, this, this, other, each turn a process of its own
    that imports that tree's `repro_torch`. One `flash ab` JSON line per
    turn."""
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        src = os.path.join(os.path.abspath(tree), "src")
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--flash-time", src],
            capture_output=True, text=True, timeout=900)
        check(out.returncode == 0, f"flash ab turn on {src}: "
              f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
        t = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"flash ab {label} ({tree}): {json.dumps(t)}", flush=True)


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one lgrass_sparsify call on case3 and "
                             "at n = 160,000 and one estimator call there; "
                             "write the tables to DIR")
    parser.add_argument("--flash-ab", metavar="TREE",
                        help="only time the flash forward at "
                             f"{FLASH_AB_CASE!r} and hubert's encode on the "
                             "checkout at TREE and on this one in turns "
                             "(TREE, this, this, TREE)")
    parser.add_argument("--flash-time", metavar="SRC",
                        help="only time the flash forward at "
                             f"{FLASH_AB_CASE!r} and hubert's encode with "
                             "the repro_torch under SRC; print one JSON "
                             "line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.flash_ab:
        flash_ab(args.flash_ab)
        return 0
    if args.flash_time:
        for name in [m for m in sys.modules
                     if m == "repro_torch" or m.startswith("repro_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, args.flash_time)
        from repro_torch.kernels import flash_attention as fa

        check(fa.__file__.startswith(args.flash_time),
              f"repro_torch imported from {fa.__file__}")
        dev = torch.device("cuda")
        t = _time_flash(dev, FLASH_AB_CASE)
        _, enc = _encode(dev)
        t.update(encode={k: enc[k] for k in (
            "encode_ms", "encode_ms_runs", "encode_profile_ms",
            "flash_launches_by_route")}, source=fa.__file__, clock=sm_clock())
        print(json.dumps(t))
        return 0
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
    big = _big_graph()
    t0 = time.perf_counter()
    big_oracle = baseline_sparsify(big).edge_mask
    print(f"numpy baseline oracle n={big.n}: "
          f"{time.perf_counter() - t0:.2f} s")
    b3 = base["case3"]
    lifting = (H.build_lifting_np(b3.parent_tree, b3.depth_tree,
                                  graphs["case3"].n), b3.depth_tree)

    t0 = time.perf_counter()
    report = phase_kernels(dev, lifting)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, per_call, walls = phase_pipeline(
        dev, graphs, {k: b.edge_mask for k, b in base.items()})
    print(f"phase pipeline: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mr_err, mr_t = phase_mark_rec(dev, graphs, big)
    print(f"phase mark_rec: {time.perf_counter() - t0:.1f} s")
    main = counts["euler"]
    # tree_dist's path is use_tree_kernel, where MARK and REC now run its
    # climb inside themselves: its launches there, and on the default path
    report["tree_dist"].update(
        launches=counts["lifting"]["tree_dist"],
        launches_per_graph={e: {k: c["tree_dist"] for k, c in per_call[e]
                                .items()} for e in per_call})
    report["radix_hist"]["launches"] = main["radix_hist"]
    report["radix_hist"]["launches_per_graph"] = {
        k: c["radix_hist"] for k, c in per_call["euler"].items()}
    for kname, loop in (("mark", "src/repro/core/marking.py:508"),
                        ("rec", "src/repro/core/recovery.py:264")):
        at = mr_t[f"{kname} case3 euler"]
        report[kname] = dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/csrc/{MARK_REC_SOURCES[kname]}",
            sources=["src/repro_torch/csrc/ball_pair.cuh",
                     "src/repro_torch/csrc/euler_lca.cuh",
                     "src/repro_torch/csrc/tree_dist.cuh"],
            replaces="src/repro/kernels/tree_dist.py:66",
            replaces_loop=loop, launches=main[kname],
            launches_per_graph={e: {k: c[kname] for k, c in per_call[e]
                                    .items()} for e in per_call},
            cuda_kernels_per_launch=len(MARK_REC_KERNELS[kname]),
            cuda_kernels=list(MARK_REC_KERNELS[kname]),
            max_abs_err=mr_err, ms=at["ms"],
            device_ms=at["device_ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
            library_ms=None, at="case3, Euler engine",
            timings={k.split(" ", 1)[1]: v for k, v in mr_t.items()
                     if k.startswith(kname + " ")})
    t0 = time.perf_counter()
    spmv_entry, bit_entry, radix_quality = phase_quality(dev, graphs)
    print(f"phase quality: {time.perf_counter() - t0:.1f} s")
    report["radix_hist"]["launches_quality_path"] = radix_quality
    t0 = time.perf_counter()
    flash_entry, radix_moe = phase_lm(dev)
    report["radix_hist"].update(radix_moe)
    print(f"phase lm: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bwd_entry, train_gains = phase_train(dev)
    flash_entry["launches_train_path"] = train_gains["flash_attention"]
    report["radix_hist"]["launches_train_path"] = train_gains["radix_hist"]
    print(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_gains = phase_mesh_train(dev, card)
    for entry in (flash_entry, bwd_entry):
        moe = mesh_gains[entry["name"]].pop("moe")
        entry["launches_tp_path"] = mesh_gains[entry["name"]].pop("tp")
        entry["launches_mesh_train_path"] = mesh_gains[entry["name"]]
        entry["launches_mesh_moe_path"] = moe
    report["radix_hist"]["launches_mesh_moe_path"] = \
        mesh_gains["radix_hist"]["moe"]
    report["radix_hist"]["launches_tp_path"] = mesh_gains["radix_hist"]["tp"]
    print(f"phase mesh_train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = phase_dryrun(dev, card, graphs["case3"])
    for entry, key in ((flash_entry, "flash_attention"),
                       (bwd_entry, "flash_attention_bwd"),
                       (report["radix_hist"], "radix_hist")):
        entry["launches_dryrun_path"] = {
            part: dry["launches"][part][key] for part in ("step", "prefill")}
    print("dryrun numbers: " + json.dumps(
        {k: v for k, v in dry.items() if k != "records"}))
    print(f"phase dryrun: {time.perf_counter() - t0:.1f} s")
    masks = {k: b.edge_mask for k, b in base.items()}
    t0 = time.perf_counter()
    eng_counts, eng_rows = phase_engines(dev, graphs, masks, big, big_oracle)
    print(f"phase engines: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    single_ms = {"device": {k: walls[f"{k} euler"] for k in graphs},
                 "host": {k: eng_rows[f"{k} host"]["wall_ms"]
                          for k in graphs}}
    for recovery, calls in (("device", TIMED_CALLS), ("host", 1)):
        single_ms[recovery][f"n={big.n}"] = _single_walls(big, dev, recovery,
                                                          calls)
    batch_counts, batch_rows = phase_batch(dev, graphs, masks, big,
                                           big_oracle, single_ms)
    print(f"phase batch: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    svc_counts, sharded_counts, svc_rows = phase_service(dev, graphs, masks,
                                                         big)
    print(f"phase service: {time.perf_counter() - t0:.1f} s")
    for k in PATH_KERNELS:
        report[k].update(launches_engines_path=eng_counts[k],
                         launches_batch_path=batch_counts[k],
                         launches_service_path=svc_counts[k])
    report["mark"]["launches_sharded_path"] = sharded_counts["mark"]
    print(f"engine and batch numbers: "
          f"{json.dumps(dict(engines=eng_rows, batch=batch_rows))}")
    print(f"service numbers: {json.dumps(svc_rows)}")
    t0 = time.perf_counter()
    profiled = phase_walls(dev, graphs["case3"], base["case3"].edge_mask,
                           big, big_oracle)
    print(f"phase walls: {time.perf_counter() - t0:.1f} s")
    if args.profile:
        phase_profile(dev, {"case3": graphs["case3"], f"n{big.n}": big},
                      args.profile)
        profile_estimator(dev, _big_graph(), args.profile)
    print(f"pipeline numbers: {json.dumps(dict(walls_ms=walls, **profiled))}")
    t0 = time.perf_counter()
    phase_analysis(dev, card)
    print(f"phase analysis: {time.perf_counter() - t0:.1f} s")

    print(f"card: {card}")
    print(json.dumps({"kernels": [report["radix_hist"], report["tree_dist"],
                                  report["mark"], report["rec"], spmv_entry,
                                  bit_entry, flash_entry, bwd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
