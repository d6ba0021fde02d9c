// Laplacian spmv y = L x as an ordered CSR row sum, and the estimator's
// other scatters (the probe lift and the weighted degree) as the same sum.
//
// Replaces the TPU kernel `laplacian_spmv` (src/repro/kernels/spmv.py, body
// `_spmv_kernel`). The Pallas kernel builds a (C, n) signed one-hot incidence
// slab per block of C edges and does the gather and the scatter as two MXU
// contractions, carrying the (n, P) sum in VMEM along a sequential grid. The
// slab exists because a data-dependent gather or scatter is not a native TPU
// shape. On Hopper both are native, and a scatter with float atomics would sum
// in an order that changes from run to run. So the edge list is turned once
// per graph into a CSR of arcs (kernels/spmv.py builds it with the port's
// stable radix sort), and each output element is a sequential sum over
// its node's arcs:
//
//   spmv_csr:  y[a, p] = sum_j w_arc[j] * (x[a, p] - x[other[j], p])
//   arc_sum:   y[a, p] = sum_j (+/-) val[eid(j), p]
//
// one thread per (node, column), starting from 0.0, in CSR order. The arcs of
// a node are its u-arcs in edge order, then its v-arcs in edge order: the
// order of the reference's two scatter-adds (`.at[u].add(c).at[v].add(-c)`).
// A u-arc's term is exactly +c and a v-arc's exactly -c (IEEE subtraction and
// multiplication are sign-symmetric), so the sums equal the plain version's
// bit for bit. The arithmetic is written with __fsub_rn / __fmul_rn /
// __fadd_rn so that nvcc cannot contract `acc + w * d` into an FMA, which
// would round once instead of twice.
//
// What bounds it: per call it must read rowptr (4(n+1) B), the arcs' other
// and weight (8 B per arc, 2L arcs) and x once, and write y (4nP B each); the
// gathers x[other[j], :] hit L2 while x fits its 50 MB. At n = 160,000,
// L = 320,000, P = 16 that is ~26 MB, ~7.8 us at 3.35 TB/s; the 3 flops per
// arc and column are far below the fp32 rate. The design keeps neighbouring
// threads on neighbouring columns of one node, so each gather of a row of x
// is P consecutive floats, and the arc's index and weight are one broadcast
// load per warp and node. Offsets into x and y are 64-bit; arc indices are
// int32 (the wrapper requires 2L < 2^31).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void spmv_csr_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ other,
                                const float* __restrict__ w_arc,
                                const float* __restrict__ x, long long total,
                                int p, float* __restrict__ y) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long a = t / p;
  const int col = (int)(t - a * p);
  const float xa = __ldg(x + t);
  const int end = __ldg(rowptr + a + 1);
  float acc = 0.0f;
  for (int j = __ldg(rowptr + a); j < end; ++j) {
    const long long b = __ldg(other + j);
    const float d = __fsub_rn(xa, __ldg(x + b * p + col));
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w_arc + j), d));
  }
  y[t] = acc;
}

// arc[j] is the arc's index in [0, 2m): below m a u-arc of edge arc[j],
// from m on a v-arc of edge arc[j] - m, subtracted when `negate_v`.
__global__ void arc_sum_kernel(const int* __restrict__ rowptr,
                               const int* __restrict__ arc, int m,
                               const float* __restrict__ val, long long total,
                               int p, int negate_v, float* __restrict__ y) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long a = t / p;
  const int col = (int)(t - a * p);
  const int end = __ldg(rowptr + a + 1);
  float acc = 0.0f;
  for (int j = __ldg(rowptr + a); j < end; ++j) {
    const int s = __ldg(arc + j);
    const bool is_v = s >= m;
    const long long e = is_v ? s - m : s;
    const float vv = __ldg(val + e * p + col);
    acc = (is_v && negate_v) ? __fsub_rn(acc, vv) : __fadd_rn(acc, vv);
  }
  y[t] = acc;
}

int blocks_for(long long total) {
  return (int)((total + THREADS - 1) / THREADS);
}

}  // namespace

// rowptr: (n + 1,) int32; other: (2m,) int32; w_arc: (2m,) float32;
// x, y: (n, p) float32 row-major. Launches on `stream`; returns the CUDA
// error code of the launch (0 on success).
extern "C" int spmv_csr_launch(const int* rowptr, const int* other,
                               const float* w_arc, const float* x, int n,
                               int p, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * p;
  if (total > 0) {
    spmv_csr_kernel<<<blocks_for(total), THREADS, 0, s>>>(rowptr, other,
                                                          w_arc, x, total, p,
                                                          y);
  }
  return static_cast<int>(cudaGetLastError());
}

// rowptr: (n + 1,) int32; arc: (2m,) int32 in [0, 2m); val: (m, p) float32;
// y: (n, p) float32. Launches on `stream`; returns the CUDA error code.
extern "C" int arc_sum_launch(const int* rowptr, const int* arc, int m,
                              const float* val, int n, int p, int negate_v,
                              float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * p;
  if (total > 0) {
    arc_sum_kernel<<<blocks_for(total), THREADS, 0, s>>>(rowptr, arc, m, val,
                                                         total, p, negate_v,
                                                         y);
  }
  return static_cast<int>(cudaGetLastError());
}
