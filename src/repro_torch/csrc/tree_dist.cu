// Tree hop distance of (a, b) query pairs by a binary-lifting climb.
//
// Replaces the TPU kernel `tree_dist_pairs` (src/repro/kernels/tree_dist.py,
// body `_tree_dist_kernel`). The Pallas kernel keeps the (LOG, n) lifting
// table in VMEM and turns every gather into a one-hot contraction on the
// VPU/MXU, because a data-dependent gather is not a native TPU shape. On
// Hopper a gather is native, so the kernel is one thread per pair with plain
// loads from the table, and the climb is the reference's: lift the deeper
// endpoint to the shallower one's depth, then descend in lockstep from the
// top level to just below the LCA.
//
// What bounds it: each pair costs up to ~3·LOG dependent 4-byte loads at
// random addresses of the table. The table is LOG·n·4 B (~0.9 MB at
// n = 16,129, LOG = 14), so it stays resident in the 50 MB L2 and the loads
// are L2 latency-bound, not HBM-bound; the HBM floor is the 12 B per pair of
// the a, b reads and the out write (~0.5 us at M = 135,168). The design
// relies on many pairs in flight per SM (256-thread blocks, M/256 blocks) to
// hide that latency; no shared-memory copy of the table is made, since a
// per-block copy would cost more than the whole climb at these M. The climb
// is `tree_dist_climb` (tree_dist.cuh), which MARK and REC also run.

#include <cuda_runtime.h>

#include "tree_dist.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void tree_dist_kernel(const int* __restrict__ up,
                                 const int* __restrict__ depth, int log,
                                 int n, const int* __restrict__ a,
                                 const int* __restrict__ b, int m,
                                 int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int x = __ldg(a + i);
  const int y = __ldg(b + i);
  out[i] = tree_dist_climb(up, depth, log, n, x, __ldg(depth + x), y,
                           __ldg(depth + y));
}

}  // namespace

// up: (log, n) int32 row-major; depth: (n,) int32; a, b, out: (m,) int32.
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int tree_dist_launch(const int* up, const int* depth, int log,
                                int n, const int* a, const int* b, int m,
                                int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0) {
    const int blocks = (m + THREADS - 1) / THREADS;
    tree_dist_kernel<<<blocks, THREADS, 0, s>>>(up, depth, log, n, a, b, m,
                                                out);
  }
  return static_cast<int>(cudaGetLastError());
}
