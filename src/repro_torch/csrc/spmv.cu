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
// starting from 0.0, in CSR order. The arcs of a node are its u-arcs in edge
// order, then its v-arcs in edge order: the order of the reference's two
// scatter-adds (`.at[u].add(c).at[v].add(-c)`). A u-arc's term is exactly +c
// and a v-arc's exactly -c (IEEE subtraction and multiplication are
// sign-symmetric), so the sums equal the plain version's bit for bit. The
// arithmetic is written with __fsub_rn / __fmul_rn / __fadd_rn so that nvcc
// cannot contract `acc + w * d` into an FMA, which would round once instead
// of twice. No sum is split across threads: one lane owns a (node, column
// vector) and adds its arcs one after another.
//
// What bounds it: per call it must read rowptr (4(n+1) B), the arcs' other
// and weight (8 B per arc, 2L arcs) and x once, and write y (4nP B each); the
// gathers x[other[j], :] after a row's first hit L2 while x fits its 50 MB.
// At n = 160,000, L = 320,000, P = 16 that is ~26 MB, ~7.8 us at 3.35 TB/s
// of HBM, a floor for a call that finds L2 cold; the 3 flops per
// arc and column are far below the fp32 rate. What costs is the gathers: 2L
// rows of 4P bytes from random places, each behind two dependent loads
// (rowptr, then other). The design, chosen by measurement (PERF.md):
//
//   * lane t owns node t / (P / VEC) and that node's column vector
//     t % (P / VEC), so a warp holds 32 consecutive (node, vector) pairs
//     and the one 32-bit division is the only work before the first load.
//     A vector is VEC = 4 floats (a float4: one 16-byte load per gather,
//     store and own row) when P % 4 == 0, P >= 8 and x and y are 16-byte
//     aligned, else VEC = 1 (the scalar variant of the same kernel; at P =
//     4 four scalar lanes a node beat one float4 lane, whose warp would
//     wait on the largest degree of 32 nodes);
//   * a float4 lane walks its node's arcs in rounds of UNROLL: the round's
//     indices and weights are loaded, then its UNROLL gathers issued, and
//     only then added in CSR order. A scalar lane (P < 8 on the main path:
//     P scalar lanes a node) runs the plain loop, which nvcc unrolls
//     itself; at P = 4 rounds of 2 were slower (PERF.md);
//   * y is stored evict-first (__stcs): it is written once, and x, gathered
//     up to 21 times per row, keeps more of L2.
//
// Staging a block's arcs in shared memory (with and without a cp.async
// pipeline across persistent blocks) and gathering a block's rows into
// shared memory before the sums were built and measured slower at every
// shape (PERF.md): the barriers and the lost occupancy cost more than
// the one global hop they save.
//
// Offsets into x and y are 64-bit; arc indices are int32 (the wrapper
// requires 2L < 2^31) and lane indices 32-bit (the wrapper requires
// nP < 2^32).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
// arcs a lane has in flight per round
constexpr int UNROLL = 2;
// the least P that takes float4 lanes and rounds of UNROLL arcs; scalar
// lanes (below it, P % 4 != 0 or an unaligned block) take the plain loop
constexpr int VEC4_MIN_P = 8;

template <int VEC>
struct Lanes;
template <>
struct Lanes<1> {
  using T = float;
};
template <>
struct Lanes<4> {
  using T = float4;
};

__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// acc + w * (xa - xb), each operation rounded once
__device__ __forceinline__ float term(float acc, float w, float xa, float xb) {
  return __fadd_rn(acc, __fmul_rn(w, __fsub_rn(xa, xb)));
}
__device__ __forceinline__ float4 term(float4 acc, float w, float4 xa,
                                       float4 xb) {
  return make_float4(term(acc.x, w, xa.x, xb.x), term(acc.y, w, xa.y, xb.y),
                     term(acc.z, w, xa.z, xb.z), term(acc.w, w, xa.w, xb.w));
}

__device__ __forceinline__ float add_or_sub(float acc, float v, bool sub) {
  return sub ? __fsub_rn(acc, v) : __fadd_rn(acc, v);
}
__device__ __forceinline__ float4 add_or_sub(float4 acc, float4 v, bool sub) {
  return make_float4(add_or_sub(acc.x, v.x, sub), add_or_sub(acc.y, v.y, sub),
                     add_or_sub(acc.z, v.z, sub), add_or_sub(acc.w, v.w, sub));
}

// Lanes: VEC, column vectors per node (cpn), lanes (total = n * cpn).
struct Shape {
  int vec, cpn;
  unsigned total;
};

Shape shape_for(int n, int p, bool aligned) {
  Shape s;
  s.vec = (p % 4 == 0 && p >= VEC4_MIN_P && aligned) ? 4 : 1;
  s.cpn = p / s.vec;
  s.total = static_cast<unsigned>(n) * static_cast<unsigned>(s.cpn);
  return s;
}

int blocks_for(const Shape& s) {
  return static_cast<int>((s.total + THREADS - 1) / THREADS);
}

// The lane's (node a, column vector c), or false for a lane past the rows.
__device__ __forceinline__ bool lane_item(const Shape& s, int& a, int& c) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= s.total) return false;
  const unsigned cpn = s.cpn;
  a = static_cast<int>(t / cpn);
  c = static_cast<int>(t - a * cpn);
  return true;
}

// U = 1: the plain loop; U > 1: rounds of U arcs, loads before adds.
template <int VEC, int U>
__global__ void __launch_bounds__(THREADS)
    spmv_csr_kernel(const int* __restrict__ rowptr,
                    const int* __restrict__ other,
                    const float* __restrict__ w_arc,
                    const float* __restrict__ x, Shape s,
                    float* __restrict__ y) {
  using T = typename Lanes<VEC>::T;
  int a, c;
  if (!lane_item(s, a, c)) return;
  const T* xv = reinterpret_cast<const T*>(x);
  const long long row = (long long)a * s.cpn + c;
  const T xa = __ldg(xv + row);
  const int first = __ldg(rowptr + a), end = __ldg(rowptr + a + 1);
  T acc;
  zero(acc);
  if (U == 1) {
    for (int j = first; j < end; ++j)
      acc = term(acc, __ldg(w_arc + j), xa,
                 __ldg(xv + (long long)__ldg(other + j) * s.cpn + c));
  } else {
#pragma unroll 1
    for (int j = first; j < end; j += U) {
      int b[U];
      float w[U];
      T xb[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        b[k] = 0;
        w[k] = 0.0f;
        if (j + k < end) {
          b[k] = __ldg(other + j + k);
          w[k] = __ldg(w_arc + j + k);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        zero(xb[k]);
        if (j + k < end) xb[k] = __ldg(xv + (long long)b[k] * s.cpn + c);
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (j + k < end) acc = term(acc, w[k], xa, xb[k]);
    }
  }
  __stcs(reinterpret_cast<T*>(y) + row, acc);
}

// arc[j] is the arc's index in [0, 2m): below m a u-arc of edge arc[j],
// from m on a v-arc of edge arc[j] - m, subtracted when `negate_v`.
template <int VEC, int U>
__global__ void __launch_bounds__(THREADS)
    arc_sum_kernel(const int* __restrict__ rowptr,
                   const int* __restrict__ arc, int m,
                   const float* __restrict__ val, Shape s,
                   int negate_v, float* __restrict__ y) {
  using T = typename Lanes<VEC>::T;
  int a, c;
  if (!lane_item(s, a, c)) return;
  const T* vv = reinterpret_cast<const T*>(val);
  const int first = __ldg(rowptr + a), end = __ldg(rowptr + a + 1);
  T acc;
  zero(acc);
  if (U == 1) {
    for (int j = first; j < end; ++j) {
      const int e = __ldg(arc + j);
      const bool is_v = e >= m;
      const long long row = is_v ? e - m : e;
      acc = add_or_sub(acc, __ldg(vv + row * s.cpn + c), negate_v && is_v);
    }
  } else {
#pragma unroll 1
    for (int j = first; j < end; j += U) {
      int e[U];
      T v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) e[k] = j + k < end ? __ldg(arc + j + k) : 0;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        zero(v[k]);
        const long long row = e[k] >= m ? e[k] - m : e[k];
        if (j + k < end) v[k] = __ldg(vv + row * s.cpn + c);
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (j + k < end) acc = add_or_sub(acc, v[k], negate_v && e[k] >= m);
    }
  }
  __stcs(reinterpret_cast<T*>(y) + (long long)a * s.cpn + c, acc);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace

// rowptr: (n + 1,) int32; other: (2m,) int32; w_arc: (2m,) float32;
// x, y: (n, p) float32 row-major, n * p < 2^32. Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
extern "C" int spmv_csr_launch(const int* rowptr, const int* other,
                               const float* w_arc, const float* x, int n,
                               int p, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0) {
    const Shape s = shape_for(n, p, aligned16(x, y));
    if (s.vec == 4)
      spmv_csr_kernel<4, UNROLL><<<blocks_for(s), THREADS, 0, st>>>(
          rowptr, other, w_arc, x, s, y);
    else
      spmv_csr_kernel<1, 1><<<blocks_for(s), THREADS, 0, st>>>(
          rowptr, other, w_arc, x, s, y);
  }
  return static_cast<int>(cudaGetLastError());
}

// rowptr: (n + 1,) int32; arc: (2m,) int32 in [0, 2m); val: (m, p) float32;
// y: (n, p) float32, n * p < 2^32. Launches on `stream`; returns the CUDA
// error code.
extern "C" int arc_sum_launch(const int* rowptr, const int* arc, int m,
                              const float* val, int n, int p, int negate_v,
                              float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0) {
    const Shape s = shape_for(n, p, aligned16(val, y));
    if (s.vec == 4)
      arc_sum_kernel<4, UNROLL><<<blocks_for(s), THREADS, 0, st>>>(
          rowptr, arc, m, val, s, negate_v, y);
    else
      arc_sum_kernel<1, 1><<<blocks_for(s), THREADS, 0, st>>>(
          rowptr, arc, m, val, s, negate_v, y);
  }
  return static_cast<int>(cudaGetLastError());
}
