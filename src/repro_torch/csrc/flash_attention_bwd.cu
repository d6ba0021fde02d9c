// The gradient of forward attention with masks from positions (flash
// attention backward), for Hopper.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel. It
// trains through `gqa_attention`'s plain jnp path (src/repro/models/
// attention.py:144-188, `_masked_softmax_attend` or `_banded_swa`), which
// jax.grad differentiates. The port's attention on the card is the forward
// kernel of csrc/flash_attention.cu / csrc/flash_attention_sm90.cu, whose
// output autograd cannot see through; this file is its backward
// (kernels/flash_attention.py, `FlashAttention`).
//
// The function differentiated is the forward's, for each query row i of head
// h (kv head h / (H / Kv)):
//
//   s_ij = (q_i . k_j) * d^-0.5 in fp32;  s_ij = -1e30 where not visible;
//   P = softmax_j(s);  o_i = sum_j P_ij v_j,
//
// visible_ij = kpos_j >= 0 && (!causal || kpos_j <= qpos_i)
//              && (!window || kpos_j > qpos_i - window).
// Its gradient, given dO:
//
//   dV_j = sum_i P_ij dO_i;  dP_ij = dO_i . v_j;  Delta_i = dO_i . o_i;
//   dS_ij = P_ij (dP_ij - Delta_i), and 0 where not visible (the mask's own
//   gradient);  dQ_i = d^-0.5 sum_j dS_ij k_j;  dK_j = d^-0.5 sum_i dS_ij q_i.
//
// A row with no visible key has s = -1e30 at every key, so P = 1/Sk at every
// key (the forward's mean of v): it gives 1/Sk dO_i to every dV_j, and
// nothing to dQ or dK (dS = 0 on every masked entry).
//
// P comes from the forward's LSE (lse_i = m_i + log l_i in natural log
// units, +inf for a row with no visible key), written by the forward kernel
// itself: P_ij = exp(s_ij - lse_i). Nothing here recomputes it.
//
// This file serves float32 at every head dim and bfloat16 at d = 16 and 32;
// bfloat16 at d = 64, 80, 96 and 128 is csrc/flash_attention_bwd_sm90.cu's
// (wgmma and TMA). Three kernels, launched in order by one call:
//
//   1. Delta, one block per (b, h, 64-query tile): Delta = dO . o in fp32
//      from the given o;
//   2. dK / dV, one block per (b, kv head, 64-key tile): loop over the G
//      query heads of the group and over the query tiles that may see the
//      tile (by the ranges of positions, as the forward skips tiles; a
//      query tile holding a row with no visible key is never skipped, since
//      that row's P reaches every key), recompute S and P = exp(S - LSE),
//      accumulate dV += P^T dO and dK += dS^T Q;
//   3. dQ, one block per (b, h, 64-query tile): loop over the key tiles the
//      block may see, recompute S, P and dP, accumulate dQ += dS K.
//
// No atomics: every output element is written once, by one thread, so two
// runs are bit-equal.
//
// bfloat16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulators),
// with the forward's mma.sync helpers (csrc/flash_attention.cu) copied here:
// four warps own 16 rows each (query rows in kernel 3, key rows in kernel
// 2); the score-shaped products keep their first operand in registers and
// read the second from shared memory by ldmatrix; P and dS go from the
// score fragments to the next product's A fragments in registers, rounded
// to bf16 as the forward rounds P. Tiles move by plain 16-byte loads.
// float32 runs on the CUDA cores in full fp32 (no TF32): 16 x 16 threads
// over 64 x 64 tiles in shared memory, for the parity checks against the
// plain backward.
//
// What bounds it: the work is five products over the visible pairs (S and
// dP twice: in kernels 2 and 3; dV, dK, dQ once) against q, k, v, o, dO,
// dq, dk, dv read or written once: at the shapes it serves (d 16 and 32 in
// bf16, checks in fp32) the tensor cores or, in fp32, the CUDA cores'
// 67 TFLOP/s.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace {

constexpr float MASKED = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* qpos;
  const int* kpos;
  const float* lse;  // (B, H, Sq): the forward's, +inf for an empty row
  float* delta;      // (B, H, Sq)
  void* dq;      // contiguous (B, Sq, H, d)
  void* dk;      // contiguous (B, Sk, Kv, d)
  void* dv;      // contiguous (B, Sk, Kv, d)
  int h, kv, sq, sk;
  long long qsb, qss, qsh;  // element strides: batch, seq, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long osb, oss, osh;
  long long dsb, dss, dsh;  // dout
  int causal, has_window, window;
  float scale, inv_sk;
};

__device__ __forceinline__ bool visible(const Params& p, int kp, int qp) {
  bool vis = kp >= 0;
  if (p.causal) vis = vis && kp <= qp;
  if (p.has_window) vis = vis && (long long)kp > (long long)qp - p.window;
  return vis;
}

// Whether some query with a position in [qmin, qmax] may see some valid key
// with a position in [kmin, kmax] (kmax == INT_MIN: the tile has no valid
// key): the forward's tile skip.
__device__ __forceinline__ bool may_see(const Params& p, int qmin, int qmax,
                                        int kmin, int kmax) {
  if (kmax == INT_MIN) return false;
  if (p.causal && kmin > qmax) return false;
  if (p.has_window && (long long)kmax <= (long long)qmin - p.window)
    return false;
  return true;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Delta = dO . o for rows [q0, q0 + nrows) of head h in batch b; two threads
// a row (the block has at least 2 * 64 threads), each half of d.
template <typename T, int D>
__device__ __forceinline__ void row_delta(const Params& p, int b, int h,
                                          int q0, int nrows) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const T* o = static_cast<const T*>(p.o) + b * p.osb + h * p.osh;
  const T* g = static_cast<const T*>(p.dout) + b * p.dsb + h * p.dsh;
  float acc = 0.f;
  if (row < nrows) {
    const T* orow = o + (long long)(q0 + row) * p.oss;
    const T* grow = g + (long long)(q0 + row) * p.dss;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      acc = fmaf(to_f(grow[c]), to_f(orow[c]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (row < nrows && half == 0)
    p.delta[((long long)b * p.h + h) * p.sq + q0 + row] = acc;
}

// Delta for 64 rows of one (b, h): 128 threads, two a row.
template <typename T, int D>
__global__ void __launch_bounds__(128) fa_bwd_delta_kernel(const Params p) {
  const int bh = blockIdx.x, b = bh / p.h, h = bh - b * p.h;
  const int q0 = blockIdx.y * 64;
  row_delta<T, D>(p, b, h, q0, min(64, p.sq - q0));
}

// The min and max of the valid positions among n entries of pos (shared
// memory), the same on every warp; n <= 64.
__device__ __forceinline__ void pos_range(const int* pos, int n, int& lo,
                                          int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = lane + 32 * s;
    const int x = i < n ? pos[i] : -1;
    if (x >= 0) {
      lo = min(lo, x);
      hi = max(hi, x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// The min and max of all n query positions in pos (shared memory; padding
// rows included, as the forward takes them), and whether any of the n rows'
// LSE marks a row with no visible key; the same on every warp; n <= 64.
__device__ __forceinline__ void query_range(const int* pos, const float* lse,
                                            int n, int& lo, int& hi,
                                            bool& empty) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
  int e = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = lane + 32 * s;
    if (i < n) {
      lo = min(lo, pos[i]);
      hi = max(hi, pos[i]);
      e |= isinf(lse[i]) ? 1 : 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    e |= __shfl_xor_sync(0xffffffffu, e, off);
  }
  empty = e != 0;
}

// ===========================================================================
// float32 on the CUDA cores: 16 x 16 threads, 64 x 64 tiles (rows padded to
// D + 1 floats) in shared memory; thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j of each tile.

constexpr int T32 = 64;        // rows of a tile
constexpr int THREADS = 256;   // 16 x 16

// rows [0, n) of a (64 x D) tile from global memory (row stride ld) into
// shared memory (row stride D + 1), zeros past n
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long ld, int n) {
  for (int i = threadIdx.x; i < T32 * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] = r < n ? src[(long long)r * ld + c] : 0.f;
  }
}

template <int D>
constexpr int dq_f32_smem() {
  return (4 * T32 * (D + 1) + T32 * (T32 + 1)) * 4 + 4 * T32 * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dq_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, LP = T32 + 1, DJ = D / 16;
  float* Qs = smem;
  float* Gs = Qs + T32 * LD;  // dO
  float* Ks = Gs + T32 * LD;
  float* Vs = Ks + T32 * LD;
  float* Ss = Vs + T32 * LD;  // dS
  int* kp_s = reinterpret_cast<int*>(Ss + T32 * LP);
  int* qp_s = kp_s + T32;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / p.h, h = bh - b * p.h;
  const int hk = h / (p.h / p.kv);
  const int q0 = blockIdx.y * T32, nrows = min(T32, p.sq - q0);
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* g =
      static_cast<const float*>(p.dout) + b * p.dsb + h * p.dsh;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;
  const long long row0 = ((long long)b * p.h + h) * p.sq + q0;

  load_f32<D>(Qs, q + (long long)q0 * p.qss, p.qss, nrows);
  load_f32<D>(Gs, g + (long long)q0 * p.dss, p.dss, nrows);
  for (int i = tid; i < T32; i += THREADS)
    qp_s[i] = i < nrows ? p.qpos[q0 + i] : 0;
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < nrows; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }
  int qp[4];
  float lse[4], dl[4];
  bool live[4];  // a real row with a visible key
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    qp[i] = qp_s[r];
    lse[i] = r < nrows ? p.lse[row0 + r] : INFINITY;
    dl[i] = r < nrows ? p.delta[row0 + r] : 0.f;
    live[i] = !isinf(lse[i]);
  }
  float acc[4][DJ] = {};
  for (int k0 = 0; k0 < p.sk; k0 += T32) {
    const int nk = min(T32, p.sk - k0);
    __syncthreads();  // the previous tile is read
    for (int i = tid; i < T32; i += THREADS)
      kp_s[i] = i < nk ? p.kpos[k0 + i] : -1;
    __syncthreads();
    int kmin, kmax;
    pos_range(kp_s, nk, kmin, kmax);
    if (!may_see(p, qmin, qmax, kmin, kmax)) continue;
    load_f32<D>(Ks, k + (long long)k0 * p.kss, p.kss, nk);
    load_f32<D>(Vs, v + (long long)k0 * p.vss, p.vss, nk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + c];
        gv[i] = Gs[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + c];
        vv[j] = Vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        float ds = 0.f;
        if (kk < nk && live[i] && visible(p, kp_s[kk], qp[i])) {
          const float pr = expf(s[i][j] * p.scale - lse[i]);
          ds = pr * (dp[i][j] - dl[i]);
        }
        Ss[(ty + 16 * i) * LP + kk] = ds;
      }
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
      }
    }
  }
  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    float* row = dq + (((long long)b * p.sq + q0 + r) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j] * p.scale;
  }
}

template <int D>
constexpr int dkv_f32_smem() {
  return (4 * T32 * (D + 1) + 2 * T32 * (T32 + 1)) * 4 + 4 * T32 * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkv_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, LP = T32 + 1, DJ = D / 16;
  float* Ks = smem;
  float* Vs = Ks + T32 * LD;
  float* Qs = Vs + T32 * LD;
  float* Gs = Qs + T32 * LD;  // dO
  float* Ps = Gs + T32 * LD;  // P^T: (key, query)
  float* Ss = Ps + T32 * LP;  // dS^T
  int* kp_s = reinterpret_cast<int*>(Ss + T32 * LP);
  int* qp_s = kp_s + T32;
  float* lse_s = reinterpret_cast<float*>(qp_s + T32);
  float* dl_s = lse_s + T32;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bk = blockIdx.x, b = bk / p.kv, hk = bk - b * p.kv;
  const int grp = p.h / p.kv;
  const int k0 = blockIdx.y * T32, nk = min(T32, p.sk - k0);
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;

  load_f32<D>(Ks, k + (long long)k0 * p.kss, p.kss, nk);
  load_f32<D>(Vs, v + (long long)k0 * p.vss, p.vss, nk);
  for (int i = tid; i < T32; i += THREADS)
    kp_s[i] = i < nk ? p.kpos[k0 + i] : -1;
  __syncthreads();
  int kmin, kmax;
  pos_range(kp_s, nk, kmin, kmax);
  int kp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kp[i] = kp_s[ty + 16 * i];
  float dk[4][DJ] = {}, dv[4][DJ] = {};
  for (int hg = 0; hg < grp; ++hg) {
    const int h = hk * grp + hg;
    const float* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
    const float* g =
        static_cast<const float*>(p.dout) + b * p.dsb + h * p.dsh;
    const long long rows = ((long long)b * p.h + h) * p.sq;
    for (int q0 = 0; q0 < p.sq; q0 += T32) {
      const int nq = min(T32, p.sq - q0);
      __syncthreads();  // the previous tile is read
      for (int i = tid; i < T32; i += THREADS) {
        qp_s[i] = i < nq ? p.qpos[q0 + i] : 0;
        lse_s[i] = i < nq ? p.lse[rows + q0 + i] : 0.f;
        dl_s[i] = i < nq ? p.delta[rows + q0 + i] : 0.f;
      }
      __syncthreads();
      int qmin, qmax;
      bool empty;
      query_range(qp_s, lse_s, nq, qmin, qmax, empty);
      if (!empty && !may_see(p, qmin, qmax, kmin, kmax)) continue;
      load_f32<D>(Qs, q + (long long)q0 * p.qss, p.qss, nq);
      load_f32<D>(Gs, g + (long long)q0 * p.dss, p.dss, nq);
      __syncthreads();
      // S^T and dP^T: keys ty + 16 i, queries tx + 16 j
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + c];
          vv[i] = Vs[(ty + 16 * i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + c];
          gv[j] = Gs[(tx + 16 * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ty + 16 * i, qc = tx + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (kr < nk && qc < nq) {
            const float lse = lse_s[qc];
            if (isinf(lse)) {
              pr = p.inv_sk;  // a row with no visible key: the mean of v
            } else if (visible(p, kp[i], qp_s[qc])) {
              pr = expf(s[i][j] * p.scale - lse);
              ds = pr * (dp[i][j] - dl_s[qc]);
            }
          }
          Ps[kr * LP + qc] = pr;
          Ss[kr * LP + qc] = ds;
        }
      __syncthreads();
      for (int qc = 0; qc < nq; ++qc) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LP + qc];
          sv[i] = Ss[(ty + 16 * i) * LP + qc];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float gv = Gs[qc * LD + tx + 16 * j];
          const float qv = Qs[qc * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(pv[i], gv, dv[i][j]);
            dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }
  float* dko = static_cast<float*>(p.dk);
  float* dvo = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
    const long long at = (((long long)b * p.sk + k0 + r) * p.kv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dko[at + tx + 16 * j] = dk[i][j] * p.scale;
      dvo[at + tx + 16 * j] = dv[i][j];
    }
  }
}

// ===========================================================================
// bfloat16 on the tensor cores. The fragment layouts of mma.sync m16n8k16
// (g = lane / 4, t = lane % 4): A (16 x 16) a0 = A[g][2t, 2t+1], a1 =
// A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8) b0 =
// B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; C (16 x 8) c0, c1 = C[g][2t, 2t+1],
// c2, c3 = C[g+8][2t, 2t+1].

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MB = 16 * MMA_WARPS;  // rows a block owns: 64
constexpr int KT = 64;              // keys per tile of kernel 3
constexpr int QT = 32;              // queries per tile of kernel 2

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lane 8 i + r gives the address of row r of
// matrix i, and register i receives matrix i's fragment (its transpose's
// with TRANS)
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [0, n) of a (rows x D) bf16 tile from global memory (row stride ld
// elements) into shared memory (row stride D + 8), zeros past n; 16 bytes a
// thread per step
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int rows, int n) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * C; i += MMA_THREADS) {
    const int r = i / C, c = i - r * C;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) w = reinterpret_cast<const uint4*>(src + r * ld)[c];
    reinterpret_cast<uint4*>(dst + r * (D + 8))[c] = w;
  }
}

// The A fragment of rows r0 .. r0 + 15, columns 16 kt .. 16 kt + 15 of a
// row-major tile in shared memory (row stride LD).
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int kt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* x = tile + (r0 + g) * LD + kt * 16 + 2 * t;
  a[0] = ld32(x);
  a[1] = ld32(x + 8 * LD);
  a[2] = ld32(x + 8);
  a[3] = ld32(x + 8 * LD + 8);
}

// C (16 x N) += A (16 x D, fragments af) . B^T, B (N x D) row-major in
// shared memory from row n0: N / 8 score-shaped blocks. Blocks nt and nt + 1
// share one ldmatrix.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4],
                                        const uint32_t (&af)[D / 16][4],
                                        const __nv_bfloat16* B, int n0) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int nt = 0; nt < N / 8; nt += 2)
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      uint32_t bb[4];
      ldsm_x4<false>(bb, B + (n0 + (nt + (mi >> 1)) * 8 + mr) * LD +
                             kt * 16 + (mi & 1) * 8);
      mma_bf16(c[nt], af[kt], bb[0], bb[1]);
      mma_bf16(c[nt + 1], af[kt], bb[2], bb[3]);
    }
}

// acc (16 x D) += X (16 x N, score-shaped fragments x, rounded to bf16) .
// B, B (N x D) row-major in shared memory from row n0; the output blocks j
// and j + 1 share one ldmatrix.trans.
template <int D, int N>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4],
                                       const float (&x)[N / 8][4],
                                       const __nv_bfloat16* B, int n0) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    const uint32_t a[4] = {pack_bf16(x[2 * kt][0], x[2 * kt][1]),
                           pack_bf16(x[2 * kt][2], x[2 * kt][3]),
                           pack_bf16(x[2 * kt + 1][0], x[2 * kt + 1][1]),
                           pack_bf16(x[2 * kt + 1][2], x[2 * kt + 1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t bb[4];
      ldsm_x4<true>(bb, B + (n0 + kt * 16 + (mi & 1) * 8 + mr) * LD +
                            (j + (mi >> 1)) * 8);
      mma_bf16(acc[j], a, bb[0], bb[1]);
      mma_bf16(acc[j + 1], a, bb[2], bb[3]);
    }
  }
}

template <int D>
constexpr int dq_bf16_smem() {
  return (2 * MB + 2 * KT) * (D + 8) * 2 + (MB + KT) * 4;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    fa_bwd_dq_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  using bf16 = __nv_bfloat16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + MB * LD;  // dO
  bf16* Ks = Gs + MB * LD;
  bf16* Vs = Ks + KT * LD;
  int* kp_s = reinterpret_cast<int*>(Vs + KT * LD);
  int* qp_s = kp_s + KT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.h, h = bh - b * p.h;
  const int hk = h / (p.h / p.kv);
  const int q0 = blockIdx.y * MB, nrows = min(MB, p.sq - q0);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* gd = static_cast<const bf16*>(p.dout) + b * p.dsb + h * p.dsh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;
  const long long row0 = ((long long)b * p.h + h) * p.sq + q0;

  load_tile<D>(Qs, q + (long long)q0 * p.qss, p.qss, MB, nrows);
  load_tile<D>(Gs, gd + (long long)q0 * p.dss, p.dss, MB, nrows);
  for (int i = tid; i < MB; i += MMA_THREADS)
    qp_s[i] = i < nrows ? p.qpos[q0 + i] : 0;
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < nrows; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }
  const int r0 = warp * 16;
  int qp[2];
  float lse[2], dl[2];
  bool live[2];  // a real row with a visible key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    qp[r] = qp_s[row];
    lse[r] = row < nrows ? p.lse[row0 + row] : INFINITY;
    dl[r] = row < nrows ? p.delta[row0 + row] : 0.f;
    live[r] = !isinf(lse[r]);
  }
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    a_frag<LD>(qf[kt], Qs, r0, kt);
    a_frag<LD>(gf[kt], Gs, r0, kt);
  }
  float acc[D / 8][4] = {};
  for (int k0 = 0; k0 < p.sk; k0 += KT) {
    const int nk = min(KT, p.sk - k0);
    __syncthreads();  // the previous tile is read
    if (tid < KT) kp_s[tid] = tid < nk ? p.kpos[k0 + tid] : -1;
    __syncthreads();
    int kmin, kmax;
    pos_range(kp_s, nk, kmin, kmax);
    if (!may_see(p, qmin, qmax, kmin, kmax)) continue;
    load_tile<D>(Ks, k + (long long)k0 * p.kss, p.kss, KT, nk);
    load_tile<D>(Vs, v + (long long)k0 * p.vss, p.vss, KT, nk);
    __syncthreads();
    // two halves of 32 keys, to hold fewer score fragments
#pragma unroll 1
    for (int n0 = 0; n0 < KT; n0 += 32) {
      float s[4][4] = {}, dp[4][4] = {};
      mma_abt<D, 32>(s, qf, Ks, n0);
      mma_abt<D, 32>(dp, gf, Vs, n0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kk = n0 + nt * 8 + 2 * t + c;
          const int kp = kk < nk ? kp_s[kk] : -1;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float ds = 0.f;
            if (kk < nk && live[r] && visible(p, kp, qp[r])) {
              const float pr = __expf(s[nt][2 * r + c] * p.scale - lse[r]);
              ds = pr * (dp[nt][2 * r + c] - dl[r]);
            }
            s[nt][2 * r + c] = ds;
          }
        }
      mma_xb<D, 32>(acc, s, Ks, n0);
    }
  }
  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= nrows) continue;
    bf16* o = dq + (((long long)b * p.sq + q0 + row) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + j * 8 + 2 * t) = pack_bf16(
          acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
  }
}

template <int D>
constexpr int dkv_bf16_smem() {
  return (2 * MB + 2 * QT) * (D + 8) * 2 + (MB + 3 * QT) * 4;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    fa_bwd_dkv_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  using bf16 = __nv_bfloat16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + MB * LD;
  bf16* Qs = Vs + MB * LD;
  bf16* Gs = Qs + QT * LD;  // dO
  int* kp_s = reinterpret_cast<int*>(Gs + QT * LD);
  int* qp_s = kp_s + MB;
  float* lse_s = reinterpret_cast<float*>(qp_s + QT);
  float* dl_s = lse_s + QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.x, b = bk / p.kv, hk = bk - b * p.kv;
  const int grp = p.h / p.kv;
  const int k0 = blockIdx.y * MB, nk = min(MB, p.sk - k0);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;

  load_tile<D>(Ks, k + (long long)k0 * p.kss, p.kss, MB, nk);
  load_tile<D>(Vs, v + (long long)k0 * p.vss, p.vss, MB, nk);
  for (int i = tid; i < MB; i += MMA_THREADS)
    kp_s[i] = i < nk ? p.kpos[k0 + i] : -1;
  __syncthreads();
  int kmin, kmax;
  pos_range(kp_s, nk, kmin, kmax);
  const int r0 = warp * 16;  // this warp's keys r0 .. r0 + 15
  const int kp[2] = {kp_s[r0 + g], kp_s[r0 + g + 8]};
  const bool key[2] = {r0 + g < nk, r0 + g + 8 < nk};
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int hg = 0; hg < grp; ++hg) {
    const int h = hk * grp + hg;
    const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
    const bf16* gd =
        static_cast<const bf16*>(p.dout) + b * p.dsb + h * p.dsh;
    const long long rows = ((long long)b * p.h + h) * p.sq;
    for (int q0 = 0; q0 < p.sq; q0 += QT) {
      const int nq = min(QT, p.sq - q0);
      __syncthreads();  // the previous tile is read
      if (tid < QT) {
        qp_s[tid] = tid < nq ? p.qpos[q0 + tid] : 0;
        lse_s[tid] = tid < nq ? p.lse[rows + q0 + tid] : 0.f;
        dl_s[tid] = tid < nq ? p.delta[rows + q0 + tid] : 0.f;
      }
      __syncthreads();
      int qmin, qmax;
      bool empty;
      query_range(qp_s, lse_s, nq, qmin, qmax, empty);
      if (!empty && !may_see(p, qmin, qmax, kmin, kmax)) continue;
      load_tile<D>(Qs, q + (long long)q0 * p.qss, p.qss, QT, nq);
      load_tile<D>(Gs, gd + (long long)q0 * p.dss, p.dss, QT, nq);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
      float s[QT / 8][4] = {}, dp[QT / 8][4] = {};
      {
        uint32_t kf[D / 16][4];
#pragma unroll
        for (int kt = 0; kt < D / 16; ++kt) a_frag<LD>(kf[kt], Ks, r0, kt);
        mma_abt<D, QT>(s, kf, Qs, 0);
#pragma unroll
        for (int kt = 0; kt < D / 16; ++kt) a_frag<LD>(kf[kt], Vs, r0, kt);
        mma_abt<D, QT>(dp, kf, Gs, 0);
      }
      // P^T into s, dS^T into dp
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = nt * 8 + 2 * t + c;
          const float lse = lse_s[qc], dl = dl_s[qc];
          const int qpc = qp_s[qc];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pr = 0.f, ds = 0.f;
            if (key[r] && qc < nq) {
              if (isinf(lse)) {
                pr = p.inv_sk;  // a row with no visible key: mean of v
              } else if (visible(p, kp[r], qpc)) {
                pr = __expf(s[nt][2 * r + c] * p.scale - lse);
                ds = pr * (dp[nt][2 * r + c] - dl);
              }
            }
            s[nt][2 * r + c] = pr;
            dp[nt][2 * r + c] = ds;
          }
        }
      mma_xb<D, QT>(dv, s, Gs, 0);
      mma_xb<D, QT>(dk, dp, Qs, 0);
    }
  }
  bf16* dko = static_cast<bf16*>(p.dk);
  bf16* dvo = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key[r]) continue;
    const long long at =
        (((long long)b * p.sk + k0 + r0 + g + 8 * r) * p.kv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dko + at + j * 8 + 2 * t) = pack_bf16(
          dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvo + at + j * 8 + 2 * t) =
          pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_one(K kernel, int bytes, bool (&raised)[MAX_DEVICES],
                       dim3 grid, int threads, const Params& p,
                       cudaStream_t s) {
  int dev;
  cudaError_t err =
      raise_smem(reinterpret_cast<const void*>(kernel), bytes, raised, dev);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, int b, cudaStream_t s) {
  static bool raised[4][MAX_DEVICES] = {};
  const dim3 gq(b * p.h, (p.sq + 63) / 64), gk(b * p.kv, (p.sk + 63) / 64);
  cudaError_t err;
  if (dtype == 0) {
    fa_bwd_delta_kernel<float, D><<<gq, 128, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_one(fa_bwd_dkv_f32_kernel<D>, dkv_f32_smem<D>(), raised[0],
                     gk, THREADS, p, s);
    if (err != cudaSuccess) return err;
    return launch_one(fa_bwd_dq_f32_kernel<D>, dq_f32_smem<D>(), raised[1],
                      gq, THREADS, p, s);
  }
  // bf16 at d = 64, 80, 96, 128 is csrc/flash_attention_bwd_sm90.cu's
  if constexpr (D == 16 || D == 32) {
    if (dtype == 1) {
      fa_bwd_delta_kernel<__nv_bfloat16, D><<<gq, 128, 0, s>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      err = launch_one(fa_bwd_dkv_mma_kernel<D>, dkv_bf16_smem<D>(),
                       raised[2], gk, MMA_THREADS, p, s);
      if (err != cudaSuccess) return err;
      return launch_one(fa_bwd_dq_mma_kernel<D>, dq_bf16_smem<D>(),
                        raised[3], gq, MMA_THREADS, p, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout: (B, Sq, H, d); k, v: (B, Sk, Kv, d); each with unit stride on
// d and the element strides given (batch, seq, head); qpos (Sq,), kpos (Sk,)
// int32, -1 = padding. lse: (B, H, Sq) float32, the forward's (natural log
// units, +inf for a row with no visible key); delta: (B, H, Sq) float32
// scratch. dq: contiguous (B, Sq, H, d); dk, dv: contiguous (B, Sk, Kv, d),
// all in the inputs' dtype. dtype 0 = float32 with d in {16, 32, 64, 80, 96,
// 128}, 1 = bfloat16 with d in {16, 32}. window <= 0 means no window.
// Launches the three kernels on `stream` in order; returns the first CUDA
// error (cudaErrorInvalidValue for a d or dtype it does not take).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* qpos, const int* kpos, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int dtype, int b, int h,
    int kv, int sq, int sk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss,
    long long dsh, int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (h <= 0 || kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  Params p{q,   k,   v,   o,   dout, qpos, kpos, lse, delta, dq,
           dk,  dv,  h,   kv,  sq,   sk,   qsb,  qss, qsh,   ksb,
           kss, ksh, vsb, vss, vsh,  osb,  oss,  osh, dsb,   dss,
           dsh, causal, window > 0 ? 1 : 0, window > 0 ? window : 0,
           scale, 1.f / (float)sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(p, dtype, b, s); break;
    case 32: err = launch<32>(p, dtype, b, s); break;
    case 64: err = launch<64>(p, dtype, b, s); break;
    case 80: err = launch<80>(p, dtype, b, s); break;
    case 96: err = launch<96>(p, dtype, b, s); break;
    case 128: err = launch<128>(p, dtype, b, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
