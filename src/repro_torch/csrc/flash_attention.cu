// Forward attention with an online softmax (flash attention), for Hopper.
//
// Replaces the TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py:72, body `_fa_kernel`), which walks a
// (B*H, Sq/bq, Sk/bk) grid whose last axis runs in order on one core and
// carries the softmax state (m, l) and the output accumulator across it in
// VMEM scratch. Here one block owns one (batch, head, 64-query tile) and loops
// over the 64-key tiles itself; m, l and the accumulator live in registers and
// nothing is carried between blocks.
//
// What it computes, for each query row i of head h (kv head h / (H / Kv)):
//
//   s_ij = (q_i . k_j) * d^-0.5 in fp32, the scale applied after the product;
//   visible_ij = kpos_j >= 0 && (!causal || kpos_j <= qpos_i)
//                && (!window || kpos_j > qpos_i - window);
//   s_ij = -1e30 where not visible;
//   online softmax over the key tiles: m, l = sum of fp32 p, acc += P V with
//   p rounded to v's dtype first; out_i = acc_i / max(l_i, 1e-30) in q's dtype;
//   where asked (for the gradient), lse_i = m_i + log l_i, +inf for a row
//   with no visible key.
//
// A row with no visible key sees -1e30 everywhere, so every p is exp(0) = 1
// and the row is the mean of v over all Sk keys, as in the reference (kernel
// and jnp oracle alike). Keys past Sk (the ragged last tile) are not keys at
// all: they score -inf and give p = 0 exactly.
//
// Tile skipping. Positions are arbitrary vectors (a ring cache has them out of
// order), so a key tile is skipped only from its own range of positions: when
// no valid key of the tile is visible to any query row of the block
// (causal: min kpos > max qpos; window: max kpos <= min qpos - window; or no
// kpos >= 0). For a row with a visible key the skipped terms are exactly 0
// (exp(-1e30 - m) = 0, and a tile seen before the first visible key is scaled
// by alpha = 0), so skipping changes nothing. A row with no visible key would
// lose part of its mean: if the block has such a row and skipped a tile, it
// runs the loop again without skipping. The fp32 path uses plain fp32 FMAs
// (no TF32); there are no atomics, so a run is deterministic.
//
// Two kernels here compute it. bfloat16 runs on the tensor cores:
// `flash_attention_mma_kernel`, four warps of 16 query rows, the products as
// mma.sync m16n8k16 with fp32 accumulators, Q fragments in registers, K and
// V tiles in shared memory read by ldmatrix, and P passed from the score
// fragments to the P.V product in registers. It serves the head dims 16
// and 32; at 64, 80, 96 and 128 the wgmma kernel of
// csrc/flash_attention_sm90.cu serves bf16 (kernels/flash_attention.py,
// `cuda_route`). float32 runs on the CUDA cores in full fp32 (no TF32):
// `flash_attention_tile_kernel`, 16 x 16 threads over a 64 x 64 tile staged
// in shared memory.
//
// What bounds a bf16 kernel on the card: at phi3's prefill shape (B*H = 128,
// S = 2048, d = 96, causal) the work is 1.03e11 FLOP of two matrix products
// against 201 MB of q, k, v and out, so the tensor cores' 989 TFLOP/s bound
// it (104 us) before the 3.35 TB/s of HBM (60 us). What the mma.sync design
// does about it: each q tile is read once into registers, and out written
// once; K and V tiles move in 16-byte cp.async copies into a double buffer,
// the next visible tile's copies running during the current tile's products
// (the skip decision is taken one tile ahead, from positions loaded during
// the products); ldmatrix feeds the K and V fragments to mma.sync; the
// invisible half of a causal product is skipped; the heaviest (last) query
// tiles launch first. Each warp owns 16 query rows, so it reads the whole K
// and V tile from shared memory for 16 rows (32 rows per warp spill
// registers at d = 96 with mma.sync's fragments): the wgmma kernel, a
// warpgroup per 64 rows with B read from shared memory, removes that.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads: ty owns rows ty + 16 i
constexpr float MASKED = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* out;
  float* lse;  // (B, H, Sq) float32, or null: no LSE written
  int h, kv, sq, sk;
  long long qsb, qss, qsh;  // element strides of q: batch, seq, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int causal, has_window, window;
  float scale;
};

template <int D>
constexpr int smem_bytes() {
  // Q, K, V tiles (rows padded to D + 1 floats), P tile, two position tiles
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * 4 +
         (BQ + BK) * 4;
}

// ---------------------------------------------------------------------------
// float32: the products on the CUDA cores in full fp32 (no TF32). 256
// threads as 16 x 16; 64-row query tiles and 64-key tiles staged in shared
// memory.

// The loop over key tiles for the block's 64 query rows. Thread (ty, tx)
// keeps the state of rows ty + 16 i (i < 4): m, l and out dims tx + 16 j.
// Returns whether a tile was skipped (the same on every thread).
template <int D>
__device__ __forceinline__ bool attend(const Params& p,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       const float* Qs, float* Ks, float* Vs,
                                       float* Ps, int* kp_s, int qmin, int qmax,
                                       const int (&qp)[4], float (&m)[4],
                                       float (&l)[4], float (&acc)[4][D / 16],
                                       bool allow_skip) {
  constexpr int LD = D + 1, LP = BK + 1, DJ = D / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  bool skipped = false;
  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    const int nk = min(BK, p.sk - k0);
    __syncthreads();  // the previous tile's shared memory is read
    for (int i = tid; i < BK; i += THREADS)
      kp_s[i] = i < nk ? p.kpos[k0 + i] : -1;
    __syncthreads();
    if (allow_skip) {
      int kmin = INT_MAX, kmax = INT_MIN;
      for (int i = 0; i < nk; ++i) {
        const int kp = kp_s[i];
        if (kp >= 0) {
          kmin = min(kmin, kp);
          kmax = max(kmax, kp);
        }
      }
      const bool none = kmax == INT_MIN;
      const bool late = p.causal && kmin > qmax;
      const bool early =
          p.has_window && (long long)kmax <= (long long)qmin - p.window;
      if (none || late || early) {
        skipped = true;
        continue;
      }
    }
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      float kk = 0.f, vv = 0.f;
      if (r < nk) {
        kk = k[(long long)(k0 + r) * p.kss + c];
        vv = v[(long long)(k0 + r) * p.vss + c];
      }
      Ks[r * LD + c] = kk;
      Vs[r * LD + c] = vv;
    }
    __syncthreads();

    // s = q . k for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax; P goes to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        float sc = -INFINITY;  // not a key: p = 0
        if (kk < nk) {
          const int kp = kp_s[kk];
          bool vis = kp >= 0;
          if (p.causal) vis = vis && kp <= qp[i];
          if (p.has_window)
            vis = vis && (long long)kp > (long long)qp[i] - p.window;
          sc = vis ? s[i][j] * p.scale : MASKED;
        }
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile's keys
    for (int kk = 0; kk < nk; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  return skipped;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_tile_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DJ = D / 16;
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  int* kp_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));
  int* qp_s = kp_s + BK;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (p.sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // last (heaviest) first
  const int bh = blockIdx.x;
  const int b = bh / p.h, h = bh - b * p.h;
  const int hk = h / (p.h / p.kv);
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;
  const int nrows = min(BQ, p.sq - q0);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    Qs[r * LD + c] = r < nrows ? q[(long long)(q0 + r) * p.qss + c] : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS)
    qp_s[i] = i < nrows ? p.qpos[q0 + i] : 0;
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < nrows; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = qp_s[ty + 16 * i];

  float m[4], l[4], acc[4][DJ];
  const bool skipped = attend<D>(p, k, v, Qs, Ks, Vs, Ps, kp_s, qmin, qmax,
                                 qp, m, l, acc, true);
  int empty = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (ty + 16 * i < nrows && m[i] == MASKED) empty = 1;
  // a row with no visible key averages v over every key: no tile may be
  // skipped for it (the condition is the same on every thread)
  if (__syncthreads_or(empty && skipped))
    attend<D>(p, k, v, Qs, Ks, Vs, Ps, kp_s, qmin, qmax, qp, m, l, acc,
              false);

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.h + h) * p.sq + q0 + r] =
          m[i] == MASKED ? INFINITY : m[i] + logf(l[i]);
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (((long long)b * p.sq + q0 + r) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = acc[i][j] * inv_l;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the products on the tensor cores (mma.sync m16n8k16, fp32
// accumulators). Four warps own 16 query rows each; per key tile a warp
// computes its 16 x 64 scores from Q fragments held in registers and K
// fragments read from shared memory with ldmatrix, takes the online softmax
// in registers (the four threads of a quad share a row), rounds p to bf16
// and multiplies it by V, whose fragments ldmatrix.trans reads from the
// row-major tile. The score fragments of two key columns of 8 are the A
// fragment of the P.V product, so P never goes through shared memory. Tiles
// move from global memory in 16-byte loads.

constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;

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

// the same as asynchronous copies (cp.async, 16 bytes each, zero-filled
// past n); the caller commits and waits
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long ld, int n) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < BK * C; i += MMA_THREADS) {
    const int r = i / C, c = i - r * C;
    const uint32_t d = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + r * (D + 8) + c * 8));
    const __nv_bfloat16* g = src + (r < n ? r * ld + c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(g), "r"(r < n ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int D>
constexpr int mma_smem_bytes() {
  // Q, two K and two V tiles (rows padded to D + 8), the query positions
  // and two key position tiles
  return (MMA_BQ + 4 * BK) * (D + 8) * 2 + (MMA_BQ + 2 * BK) * 4;
}

// This thread's position of key tile `k0` (threads past the tile read -1).
__device__ __forceinline__ int tile_kpos(const Params& p, int k0) {
  const int i = k0 + (int)threadIdx.x;
  return threadIdx.x < BK && i < p.sk ? p.kpos[i] : -1;
}

// The start of the first key tile at or after `from` that some query row of
// the block may see (p.sk if none), its positions left in kp_buf; with
// allow_skip false, the tile at `from`. A tile is skipped only from its own
// range of valid positions. `first` is this thread's position of tile
// `from`, loaded ahead by the caller (tile_kpos). Sets `skipped` when it
// passes a tile.
__device__ __forceinline__ int next_tile(const Params& p, int from, int first,
                                         int* kp_buf, int qmin, int qmax,
                                         bool allow_skip, bool& skipped) {
  const int lane = threadIdx.x & 31;
  for (int k0 = from; k0 < p.sk; k0 += BK) {
    const int mine = k0 == from ? first : tile_kpos(p, k0);
    __syncthreads();  // no thread still reads kp_buf
    if (threadIdx.x < BK) kp_buf[threadIdx.x] = mine;
    __syncthreads();
    if (!allow_skip) return k0;
    // the tile's min and max valid position, reduced by every warp alike
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int h = 0; h < BK / 32; ++h) {
      const int kp = kp_buf[lane + 32 * h];
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const bool none = hi == INT_MIN;
    const bool late = p.causal && lo > qmax;
    const bool early =
        p.has_window && (long long)hi <= (long long)qmin - p.window;
    if (!(none || late || early)) return k0;
    skipped = true;
  }
  return p.sk;
}

// Start the copies of key tile k0's K and V into buffer `buf` (none past the
// last tile) and commit them as one group.
template <int D>
__device__ __forceinline__ void fetch_kv(const Params& p,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v,
                                         __nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                         int buf, int k0) {
  if (k0 < p.sk) {
    const int n = min(BK, p.sk - k0);
    load_tile_async<D>(Ks + buf * BK * (D + 8), k + (long long)k0 * p.kss,
                       p.kss, n);
    load_tile_async<D>(Vs + buf * BK * (D + 8), v + (long long)k0 * p.vss,
                       p.vss, n);
  }
  cp_async_commit();
}

// The loop over key tiles for one warp's 16 rows: this thread holds rows
// g and g + 8 of the warp (g = lane / 4) and, of each 8-column block of the
// scores and of the output, columns 2t and 2t + 1 (t = lane % 4). The next
// visible tile's K and V are copied (cp.async) into the other buffer while
// this one's products run.
template <int D>
__device__ __forceinline__ bool attend_mma(
    const Params& p, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* Ks,
    __nv_bfloat16* Vs, int* kp_s, int qmin, int qmax, const int (&qp)[2],
    const uint32_t (&qf)[D / 16][4], float (&m)[2], float (&l)[2],
    float (&o)[D / 8][4], bool allow_skip) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = MASKED;
    l[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  bool skipped = false;
  // two tiles in flight: the current one (kc, buffer buf) and the next
  // visible one (kn, buffer buf ^ 1), whose copies run during kc's products
  int buf = 0;
  int kc = next_tile(p, 0, tile_kpos(p, 0), kp_s, qmin, qmax, allow_skip,
                     skipped);
  fetch_kv<D>(p, k, v, Ks, Vs, 0, kc);
  int kn = kc < p.sk ? next_tile(p, kc + BK, tile_kpos(p, kc + BK),
                                 kp_s + BK, qmin, qmax, allow_skip, skipped)
                     : p.sk;
  fetch_kv<D>(p, k, v, Ks, Vs, 1, kn);
  while (kc < p.sk) {
    const int nk = min(BK, p.sk - kc);
    __nv_bfloat16* Kb = Ks + buf * BK * LD;
    __nv_bfloat16* Vb = Vs + buf * BK * LD;
    const int* kp = kp_s + buf * BK;
    // the positions of the tile after kn, loaded during kc's products
    const int ahead = kn < p.sk ? tile_kpos(p, kn + BK) : -1;
    cp_async_wait_one();  // this thread's copies of tile kc landed
    __syncthreads();      // and every thread's

    // scores: key blocks nt and nt + 1 share one ldmatrix of K
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; nt += 2) {
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        uint32_t kb[4];
        ldsm_x4<false>(kb, Kb + ((nt + (mi >> 1)) * 8 + mr) * LD + kt * 16 +
                               (mi & 1) * 8);
        mma_bf16(s[nt], qf[kt], kb[0], kb[1]);
        mma_bf16(s[nt + 1], qf[kt], kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kk = nt * 8 + 2 * t + c;
        const int kpos = kk < nk ? kp[kk] : -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sc = -INFINITY;  // not a key: p = 0
          if (kk < nk) {
            bool vis = kpos >= 0;
            if (p.causal) vis = vis && kpos <= qp[r];
            if (p.has_window)
              vis = vis && (long long)kpos > (long long)qp[r] - p.window;
            sc = vis ? s[nt][2 * r + c] * p.scale : MASKED;
          }
          s[nt][2 * r + c] = sc;
          mx[r] = fmaxf(mx[r], sc);
        }
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += P V: keys 16 kt .. 16 kt + 15 are score blocks 2 kt and 2 kt + 1;
    // output blocks j and j + 1 share one ldmatrix.trans of V
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t vb[4];
        ldsm_x4<true>(vb, Vb + (kt * 16 + (mi & 1) * 8 + mr) * LD +
                              (j + (mi >> 1)) * 8);
        mma_bf16(o[j], a, vb[0], vb[1]);
        mma_bf16(o[j + 1], a, vb[2], vb[3]);
      }
    }
    // the tile after kn goes into this buffer once every warp is done
    // with it (next_tile synchronises first)
    const int k2 = kn < p.sk ? next_tile(p, kn + BK, ahead, kp_s + buf * BK,
                                         qmin, qmax, allow_skip, skipped)
                             : p.sk;
    fetch_kv<D>(p, k, v, Ks, Vs, buf, k2);
    kc = kn;
    kn = k2;
    buf ^= 1;
  }
  return skipped;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_attention_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  using bf16 = __nv_bfloat16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + MMA_BQ * LD;  // two buffers
  bf16* Vs = Ks + 2 * BK * LD;  // two buffers
  int* kp_s = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // two buffers
  int* qp_s = kp_s + 2 * BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.sq + MMA_BQ - 1) / MMA_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * MMA_BQ;  // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / p.h, h = bh - b * p.h;
  const int hk = h / (p.h / p.kv);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;
  const int nrows = min(MMA_BQ, p.sq - q0);

  load_tile<D>(Qs, q + (long long)q0 * p.qss, p.qss, MMA_BQ, nrows);
  for (int i = tid; i < MMA_BQ; i += MMA_THREADS)
    qp_s[i] = i < nrows ? p.qpos[q0 + i] : 0;
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < nrows; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }
  const int r0 = warp * 16 + g;
  const int qp[2] = {qp_s[r0], qp_s[r0 + 8]};
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    const bf16* qr = Qs + r0 * LD + kt * 16 + 2 * t;
    qf[kt][0] = ld32(qr);
    qf[kt][1] = ld32(qr + 8 * LD);
    qf[kt][2] = ld32(qr + 8);
    qf[kt][3] = ld32(qr + 8 * LD + 8);
  }

  float m[2], l[2], o[D / 8][4];
  const bool skipped = attend_mma<D>(p, k, v, Ks, Vs, kp_s, qmin, qmax, qp,
                                     qf, m, l, o, true);
  int empty = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (r0 + 8 * r < nrows && m[r] == MASKED) empty = 1;
  // a row with no visible key averages v over every key: no tile may be
  // skipped for it (the condition is the same on every thread)
  if (__syncthreads_or(empty && skipped))
    attend_mma<D>(p, k, v, Ks, Vs, kp_s, qmin, qmax, qp, qf, m, l, o, false);

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nrows) continue;
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.h + h) * p.sq + q0 + row] =
          m[r] == MASKED ? INFINITY : m[r] + logf(l[r]);
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = out + (((long long)b * p.sq + q0 + row) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * r] * inv_l, o[j][2 * r + 1] * inv_l);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  static bool raised[MAX_DEVICES] = {};
  int dev;
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(flash_attention_tile_kernel<D>), bytes,
      raised, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  flash_attention_tile_kernel<D><<<grid, THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t s) {
  constexpr int bytes = mma_smem_bytes<D>();
  static bool raised[MAX_DEVICES] = {};
  int dev;
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(flash_attention_mma_kernel<D>), bytes,
      raised, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + MMA_BQ - 1) / MMA_BQ);
  flash_attention_mma_kernel<D><<<grid, MMA_THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

// dtype 0: float32 on the CUDA cores; 1: bfloat16 on the tensor cores, at
// the head dims that the wgmma kernel (flash_attention_sm90.cu) does not take
template <int D>
cudaError_t launch(const Params& p, int dtype, int bh, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(p, bh, s);
  if constexpr (D == 16 || D == 32)
    if (dtype == 1) return launch_bf16<D>(p, bh, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Sq, H, d), k and v: (B, Sk, Kv, d), each with unit stride on d and
// the element strides given (batch, seq, head); qpos (Sq,), kpos (Sk,) int32,
// -1 = padding; out: contiguous (B, Sq, H, d); lse: (B, H, Sq) float32 or
// null, each row's LSE of its scaled scores (m + log l, natural log units;
// +inf for a row with no visible key). dtype 0 = float32 with d in
// {16, 32, 64, 80, 96, 128}, 1 = bfloat16 with d in {16, 32} (q, k, v
// and out alike). window <= 0 means no window. Launches on `stream`; returns
// the CUDA error of the launch (cudaErrorInvalidValue for a d or dtype it
// does not take).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* qpos,
    const int* kpos, void* out, float* lse, int dtype, int b, int h, int kv,
    int sq, int sk, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (h <= 0 || kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  Params p{q,   k,   v,   qpos, kpos, out, lse, h,   kv,     sq,
           sk,  qsb, qss, qsh,  ksb,  kss, ksh, vsb, vss,    vsh,
           causal, window > 0 ? 1 : 0, window > 0 ? window : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(p, dtype, b * h, s); break;
    case 32: err = launch<32>(p, dtype, b * h, s); break;
    case 64: err = launch<64>(p, dtype, b * h, s); break;
    case 80: err = launch<80>(p, dtype, b * h, s); break;
    case 96: err = launch<96>(p, dtype, b * h, s); break;
    case 128: err = launch<128>(p, dtype, b * h, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
