// The gradient of forward attention (flash attention backward) on Hopper's
// own units: wgmma, TMA and a warp-specialised mbarrier pipeline. bfloat16,
// head dim d in {64, 80, 96, 128}; float32 and bf16 at d = 16 and 32 stay on
// csrc/flash_attention_bwd.cu.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel and
// differentiates its plain jnp attention (src/repro/models/attention.py:
// 144-188) with jax.grad. The function is csrc/flash_attention_bwd.cu's
// (that file's header gives it in full): with s_ij = (q_i . k_j) d^-0.5 in
// fp32 and masks from positions (-1 is padding),
//
//   P_ij = exp(s_ij - lse_i) where visible, else 0;  dV_j = sum_i P_ij dO_i;
//   dP_ij = dO_i . v_j;  Delta_i = dO_i . o_i;  dS_ij = P_ij (dP_ij - Delta_i);
//   dQ_i = d^-0.5 sum_j dS_ij k_j;  dK_j = d^-0.5 sum_i dS_ij q_i;
//
// lse is the forward's (written by the forward kernel in natural log
// units; here P = exp2(s d^-0.5 log2 e - lse log2 e)). A row with no visible
// key (lse = +inf) has P = 1/Sk at every key: it gives 1/Sk dO_i to every
// dV_j and nothing to dQ or dK. P and dS are rounded to bf16 before their
// products, as the forward rounds P.
//
// What bounds it: at phi3's training shape (B*H = 128, S = 2048, d = 96,
// causal) the function is five products over the visible pairs, 2.6e11
// FLOP (0.26 ms at 989 TFLOP/s) against 0.2 GB of q, k, v, o, dO, dq, dk,
// dv (60 us at 3.35 TB/s): the tensor cores. This design does seven (S and
// dP in both kernels), 0.365 ms at that rate. Two kernels run a call:
//
//  1. fa_bwd_dq_wgmma: one work item per (b, h, 128-query tile), Q and dO
//     resident in shared memory. Its prologue writes Delta for the item's
//     rows (dO . o in fp32 from global memory), and its producer writes, for
//     each 64-row half, the range of query positions and whether a row's LSE
//     is +inf (a tile summary the second kernel skips by). Per key tile of
//     128 keys: S = Q K^T and dP = dO V^T (wgmma m64n128, both operands in
//     shared memory, K-major), P and dS = P (dP - Delta) in registers on the
//     accumulator layout, dS rounded to bf16 straight into the A fragments
//     of dQ += dS K (wgmma from registers, K read MN-major by the transpose
//     bit: the forward's P.V). A row with no visible key has dS = 0.
//  2. fa_bwd_dkv_wgmma: one work item per (b, kv head, 128-key tile), K and
//     V resident. The producer walks the G query heads of the group in
//     order and their query tiles of 64 rows, skips a tile from its summary
//     (no valid key, or positions out of reach) unless it holds a row with
//     no visible key, and streams Q and dO with the tile's LSE, Delta and
//     query positions. Per tile: S^T = K Q^T and dP^T =
//     V dO^T (wgmma m64n64), P^T and dS^T in registers as the A operands of
//     dV += P^T dO and dK += dS^T Q (B read MN-major). 64-query tiles keep
//     the accumulators of dK and dV (d columns each) beside S^T and dP^T
//     within a consumer's registers at d = 128. No score tile goes through
//     shared memory.
//
// Both kernels: 384 threads, a producer warpgroup (one warp loads positions
// and issues the TMA copies, and the warpgroup gives registers back by
// setmaxnreg) and two consumer warpgroups of 64 rows (queries in 1, keys in
// 2); a ring of stages with full and empty mbarriers, and RES buffers of
// the resident tiles, two where they fit, so the next item's load overlaps
// this one's products; tensor maps (d, heads, seq, batch) with the caller's
// strides, whose seq bound zero-fills a ragged last tile; d cut into slabs
// of one swizzle span by the forward's geometry, `Slabs<D>` of
// csrc/sm90.cuh (64 columns under a 128-byte swizzle at d = 64 and 128; 32
// under 64 bytes at 96; 16 under 32 bytes at 80). Persistent, one
// block per SM: items pair tiles y and n - 1 - y so that causal items of a
// pair cost about the same, in groups of (batch, head) pairs whose streamed
// operands fit in 8 MB of L2. Key and query tiles are skipped by their
// position ranges, as the forward skips them, never by indices.
//
// No atomics: every element of dq, dk, dv and Delta is written once by one
// thread, in a fixed order of tiles, so two runs are bit-equal. Shared
// memory that wgmma reads is written only by TMA; positions, LSE and Delta
// rows are plain stores released by the producer's mbarrier arrivals.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int THREADS = 384;        // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 128 x 56 + 256 x 224 = 384 x 168
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_FAILED = -1;   // returned when a tensor map is refused
constexpr int QT = 64;              // query rows of a tile summary (kernel 2)

struct Params {
  const __nv_bfloat16* o;     // the forward's output
  const __nv_bfloat16* dout;
  const int* qpos;
  const int* kpos;
  const float* lse;           // (B, H, Sq), natural log; +inf: no visible key
  float* delta;               // (B, H, Sq): written by 1, read by 2
  int4* qtiles;               // (B, H, ceil(Sq / QT)): qmin, qmax, empty
  __nv_bfloat16* dq;          // contiguous (B, Sq, H, d)
  __nv_bfloat16* dk;          // contiguous (B, Sk, Kv, d)
  __nv_bfloat16* dv;
  int h, kv, grp, sq, sk;     // grp = h / kv: query heads per kv head
  long long osb, oss, osh;    // element strides of o: batch, seq, head
  long long dsb, dss, dsh;    // of dout
  int causal, has_window, window;
  float scale, scale_log2, inv_sk;
  int pairs, group;           // work pairs; pairs scheduled together
};

// Whether some query with a position in [qmin, qmax] may see some valid key
// with a position in [kmin, kmax] (kmax == INT_MIN: no valid key).
__device__ __forceinline__ bool may_see(const Params& p, int qmin, int qmax,
                                        int kmin, int kmax) {
  return kmax != INT_MIN && !(p.causal && kmin > qmax) &&
         !(p.has_window && (long long)kmax <= (long long)qmin - p.window);
}

// The k-th work item of this block: units of two tiles y and nt - 1 - y of
// one of p.pairs pairs, block i taking units i, i + gridDim.x, ...; units in
// groups of p.group pairs. Even k is a unit's tile y = j, odd k its tile
// nt - 1 - j. Returns 1 with pair and tile set, 0 for the missing half of
// the middle unit (nt odd), -1 past this block's last unit.
__device__ __forceinline__ int work_item(const Params& p, int nt, int k,
                                         int& pair, int& tile) {
  const int units = (nt + 1) / 2;
  const int u = (k >> 1) * gridDim.x + blockIdx.x;
  if (u >= p.pairs * units) return -1;
  const int grp = u / (p.group * units);
  const int in_grp = u - grp * p.group * units;
  const int gsize = min(p.group, p.pairs - grp * p.group);
  const int j = in_grp / gsize;
  pair = grp * p.group + in_grp % gsize;
  tile = k & 1 ? nt - 1 - j : j;
  return (k & 1) && tile == j ? 0 : 1;
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// A block's dynamic shared memory for layout L: the tiles from a 1024-byte
// boundary, then the full and empty mbarriers of the stages and of the
// resident buffers, then L's tables, each at a constant offset from the
// one base.
template <typename L>
struct Smem {
  static constexpr int FULL = L::TILE_BYTES;
  static constexpr int EMPTY = FULL + 8 * L::STAGES;
  static constexpr int RFULL = EMPTY + 8 * L::STAGES;
  static constexpr int REMPTY = RFULL + 8 * L::RES;
  static constexpr int TABLES = REMPTY + 8 * L::RES;
  uint8_t* base;
  __device__ __forceinline__ uint32_t tiles() const { return smem_u32(base); }
  __device__ __forceinline__ uint32_t full(int s) const {
    return smem_u32(base + FULL + 8 * s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return smem_u32(base + EMPTY + 8 * s);
  }
  __device__ __forceinline__ uint32_t rfull(int s) const {
    return smem_u32(base + RFULL + 8 * s);
  }
  __device__ __forceinline__ uint32_t rempty(int s) const {
    return smem_u32(base + REMPTY + 8 * s);
  }
  // the table at byte offset `off` of L's tables
  __device__ __forceinline__ int* ints(int off) const {
    return reinterpret_cast<int*>(base + TABLES + off);
  }
  __device__ __forceinline__ float* floats(int off) const {
    return reinterpret_cast<float*>(base + TABLES + off);
  }
  // every barrier initialised: the full ones wait for the producer's 32
  // lanes (and the copies' bytes), the empty ones for the consumers' 8 warps
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 8);
    }
    for (int s = 0; s < L::RES; ++s) {
      mbar_init(rfull(s), 32);
      mbar_init(rempty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase,
                                        int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// ===========================================================================
// Kernel 1: dQ (and Delta, and the query tiles' summaries).

constexpr int DQ_BQ = 128;  // query rows per item: two warpgroups of 64
constexpr int DQ_BK = 128;  // keys per stage

template <int D>
struct DqLayout {
  using S = Slabs<D>;
  static constexpr int Q_SLAB = DQ_BQ * S::SW;
  static constexpr int Q_BYTES = S::NS * Q_SLAB;    // one Q (or dO) tile
  static constexpr int RES_BYTES = 2 * Q_BYTES;     // Q and dO
  static constexpr int KV_SLAB = DQ_BK * S::SW;
  static constexpr int KV_BYTES = S::NS * KV_SLAB;  // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // barriers, tile info and key positions, query positions
  static constexpr int meta(int res, int stages) {
    return (2 * stages + 2 * res) * 8 + stages * (4 + DQ_BK) * 4 +
           res * DQ_BQ * 4;
  }
  static constexpr bool fits(int res, int stages) {
    return res * RES_BYTES + stages * STAGE_BYTES + meta(res, stages) +
               1024 <= SMEM_LIMIT;
  }
  static constexpr int RES = fits(2, 2) ? 2 : 1;
  static constexpr int STAGES = fits(RES, 4) ? 4 : fits(RES, 3) ? 3 : 2;
  static_assert(fits(RES, STAGES), "shared memory of one block");
  static constexpr int TILE_BYTES = RES * RES_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = 1024 + TILE_BYTES + meta(RES, STAGES);
  // tiles: RES x (Q, dO), then the K/V stages. Tables (byte offsets):
  // [STAGES][4] k0 (-1: the item ends), kmin, kmax, all keys valid;
  // [STAGES][DQ_BK] the tile's key positions (-1: none); [RES][DQ_BQ] the
  // item's query positions
  static constexpr int INFO = 0;
  static constexpr int KPS = INFO + 16 * STAGES;
  static constexpr int QPS = KPS + 4 * DQ_BK * STAGES;
};

struct DqItem {
  int b, h, hk, q0, nrows;
};

__device__ __forceinline__ int dq_item(const Params& p, int k, DqItem& x) {
  const int nt = (p.sq + DQ_BQ - 1) / DQ_BQ;
  int pair, tile;
  const int got = work_item(p, nt, k, pair, tile);
  if (got > 0) {
    x.b = pair / p.h;
    x.h = pair - x.b * p.h;
    x.hk = x.h / p.grp;
    x.q0 = (nt - 1 - tile) * DQ_BQ;  // the heavier causal tile first
    x.nrows = min(DQ_BQ, p.sq - x.q0);
  }
  return got;
}

// Warp 0 of warpgroup 0: per item, the query positions (and the summaries
// of its two 64-row tiles), Q and dO into a free resident buffer, then every
// key tile some row may see, then an end marker.
template <int D>
__device__ __forceinline__ void dq_produce(const CUtensorMap* tq,
                                           const CUtensorMap* tg,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const Params& p,
                                           const Smem<DqLayout<D>>& sh) {
  using S = Slabs<D>;
  using L = DqLayout<D>;
  if (threadIdx.x >= 32) return;  // warps 1-3 only gave their registers
  const int lane = threadIdx.x;
  const uint32_t base = sh.tiles();
  const int ntq = (p.sq + QT - 1) / QT;
  int stage = 0;
  uint32_t phase = 0;
  DqItem x;
  for (int k = 0, n = 0, got; (got = dq_item(p, k, x)) >= 0; ++k) {
    if (!got) continue;
    const int rs = n % L::RES, use = n / L::RES;
    if (use > 0) mbar_wait(sh.rempty(rs), (use - 1) & 1);
    int* qps = sh.ints(L::QPS) + rs * DQ_BQ;
    const float* lse = p.lse + ((long long)x.b * p.h + x.h) * p.sq + x.q0;
    int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int lo = INT_MAX, hi = INT_MIN;
      bool empty = false;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = half * QT + lane + 32 * j;
        const int qp = i < x.nrows ? p.qpos[x.q0 + i] : 0;
        qps[i] = qp;
        if (i < x.nrows) {
          lo = min(lo, qp);
          hi = max(hi, qp);
          empty = empty || isinf(lse[i]);
        }
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      empty = __any_sync(0xffffffffu, empty);
      qmin = min(qmin, lo);
      qmax = max(qmax, hi);
      // the summary of query tile (q0 + 64 half) / 64, if it has rows
      if (lane == 0 && half * QT < x.nrows)
        p.qtiles[((long long)x.b * p.h + x.h) * ntq + x.q0 / QT + half] =
            make_int4(lo, hi, empty, 0);
    }
    const uint32_t rb = sh.rfull(rs);
    if (lane == 0) {
      mbar_arrive_tx(rb, L::RES_BYTES);
      const uint32_t qa = base + rs * L::RES_BYTES;
#pragma unroll
      for (int s = 0; s < S::NS; ++s) {
        tma_load(qa + s * L::Q_SLAB, tq, rb, s * S::SLAB, x.h, x.q0, x.b);
        tma_load(qa + L::Q_BYTES + s * L::Q_SLAB, tg, rb, s * S::SLAB, x.h,
                 x.q0, x.b);
      }
    } else {
      mbar_arrive(rb);
    }

    for (int k0 = 0; k0 < p.sk; k0 += DQ_BK) {
      int kp[DQ_BK / 32];
      int lo = INT_MAX, hi = INT_MIN;
      bool all = true;
#pragma unroll
      for (int j = 0; j < DQ_BK / 32; ++j) {
        const int i = k0 + lane + 32 * j;
        kp[j] = i < p.sk ? p.kpos[i] : -1;
        if (kp[j] >= 0) {
          lo = min(lo, kp[j]);
          hi = max(hi, kp[j]);
        } else {
          all = false;
        }
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      all = __all_sync(0xffffffffu, all);
      if (!may_see(p, qmin, qmax, lo, hi)) continue;
      mbar_wait(sh.empty(stage), phase ^ 1);
#pragma unroll
      for (int j = 0; j < DQ_BK / 32; ++j)
        sh.ints(L::KPS)[stage * DQ_BK + lane + 32 * j] = kp[j];
      const uint32_t fb = sh.full(stage);
      if (lane == 0) {
        int* in = sh.ints(L::INFO) + 4 * stage;
        in[0] = k0;
        in[1] = lo;
        in[2] = hi;
        in[3] = all;
        mbar_arrive_tx(fb, L::STAGE_BYTES);
        const uint32_t ks = base + L::RES * L::RES_BYTES +
                            stage * L::STAGE_BYTES;
#pragma unroll
        for (int s = 0; s < S::NS; ++s) {
          tma_load(ks + s * L::KV_SLAB, tk, fb, s * S::SLAB, x.hk, k0, x.b);
          tma_load(ks + L::KV_BYTES + s * L::KV_SLAB, tv, fb, s * S::SLAB,
                   x.hk, k0, x.b);
        }
      } else {
        mbar_arrive(fb);
      }
      advance(stage, phase, L::STAGES);
    }
    // the end of the item: a stage with no copies and k0 = -1
    mbar_wait(sh.empty(stage), phase ^ 1);
    if (lane == 0) sh.ints(L::INFO)[4 * stage] = -1;
    mbar_arrive(sh.full(stage));
    advance(stage, phase, L::STAGES);
    ++n;
  }
}

// Warpgroups 1 and 2: 64 query rows each. This thread holds rows r0 =
// 16 warp + g and r0 + 8 of its warpgroup and, of each block of 8 columns
// (keys, or d in dQ), columns 2t and 2t + 1: wgmma's accumulator layout.
template <int D>
__device__ __forceinline__ void dq_consume(const Params& p,
                                           const Smem<DqLayout<D>>& sh) {
  using S = Slabs<D>;
  using L = DqLayout<D>;
  constexpr int BK = DQ_BK;
  const int tid = threadIdx.x - 128, c = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = c * 64 + w * 16 + g;  // row in the item
  const uint32_t base = sh.tiles();

  float s[BK / 2], dp[BK / 2], acc[D / 2];
  uint32_t da[BK / 16][4];
  int stage = 0;
  uint32_t phase = 0;
  DqItem x;
  for (int k = 0, n = 0, got; (got = dq_item(p, k, x)) >= 0; ++k) {
    if (!got) continue;
    const long long row0 = ((long long)x.b * p.h + x.h) * p.sq + x.q0;
    // Delta of this warp's 16 rows, two lanes a row (half of d each), from
    // global memory; then rows r0 and r0 + 8's from their lanes
    float dl[2];
    {
      const int row = c * 64 + w * 16 + (lane >> 1), half = lane & 1;
      float sum = 0.f;
      if (row < x.nrows) {
        const uint4* orow = reinterpret_cast<const uint4*>(
            p.o + x.b * p.osb + (long long)(x.q0 + row) * p.oss +
            x.h * p.osh + half * (D / 2));
        const uint4* grow = reinterpret_cast<const uint4*>(
            p.dout + x.b * p.dsb + (long long)(x.q0 + row) * p.dss +
            x.h * p.dsh + half * (D / 2));
#pragma unroll
        for (int j = 0; j < D / 16; ++j) sum = dot8(orow[j], grow[j], sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (row < x.nrows && half == 0) p.delta[row0 + row] = sum;
      dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
      dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
    }
    const int rs = n % L::RES;
    mbar_wait(sh.rfull(rs), (n / L::RES) & 1);
    const int* qps = sh.ints(L::QPS) + rs * DQ_BQ;
    // this warpgroup's rows of Q and of dO
    const uint32_t qa = base + rs * L::RES_BYTES + c * 64 * S::SW;
    const uint32_t ga = qa + L::Q_BYTES;
    // per row: the visible key positions [vis_lo, vis_hi] and the LSE in
    // log2 units (+inf: no visible key, or no row; its P and dS are 0)
    int vis_lo[2], vis_hi[2];
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r, qp = qps[row];
      const long long lo = p.has_window ? (long long)qp - p.window + 1 : 0;
      vis_lo[r] = lo > 0 ? static_cast<int>(lo) : 0;
      vis_hi[r] = p.causal ? qp : INT_MAX;
      lse2[r] = row < x.nrows ? p.lse[row0 + row] * LOG2E : INFINITY;
    }
    // the warpgroup's range of query positions (every warp alike)
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int i = c * 64 + lane; i < c * 64 + 64; i += 32)
      if (i < x.nrows) {
        qmin = min(qmin, qps[i]);
        qmax = max(qmax, qps[i]);
      }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (;;) {
      mbar_wait(sh.full(stage), phase);
      const int* in = sh.ints(L::INFO) + 4 * stage;
      if (in[0] < 0) {
        release(sh.empty(stage), lane);
        advance(stage, phase, L::STAGES);
        break;
      }
      const uint32_t kb = base + L::RES * L::RES_BYTES +
                          stage * L::STAGE_BYTES;
      const uint32_t vb = kb + L::KV_BYTES;
      wgmma_fence();
      issue_abt<D, BK>(s, qa, L::Q_SLAB, kb, L::KV_SLAB);
      issue_abt<D, BK>(dp, ga, L::Q_SLAB, vb, L::KV_SLAB);
      wgmma_wait<1>();
      fence_regs(s);
      // P = exp2(s scale log2 e - lse2) where visible, else 0. A tile whose
      // keys are all valid and visible to every row of the warpgroup takes
      // no per-element mask (positions decide it, never indices).
      const bool unmasked =
          in[3] && (!p.causal || in[2] <= qmin) &&
          (!p.has_window || (long long)in[1] > (long long)qmax - p.window);
      if (unmasked) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[(i >> 1) & 1]));
      } else {
        const int* kp = sh.ints(L::KPS) + stage * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int kpos = kp[8 * j + 2 * t + cc];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = s[4 * j + 2 * r + cc];
              v = kpos >= vis_lo[r] && kpos <= vis_hi[r]
                      ? ex2(fmaf(v, p.scale_log2, -lse2[r]))
                      : 0.f;
            }
          }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - Delta), rounded to bf16: the A fragments of dQ += dS K
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kt + 2 * e;
          da[kt][e] = pack_bf16(s[i] * (dp[i] - dl[e & 1]),
                                s[i + 1] * (dp[i + 1] - dl[e & 1]));
        }
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
      issue_xb<D, BK / 16>(acc, da, kb, L::KV_SLAB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      release(sh.empty(stage), lane);
      advance(stage, phase, L::STAGES);
    }
    release(sh.rempty(rs), lane);  // Q, dO and the positions are read

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= x.nrows) continue;
      __nv_bfloat16* out =
          p.dq + (((long long)x.b * p.sq + x.q0 + row) * p.h + x.h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * r] * p.scale,
                      acc[4 * j + 2 * r + 1] * p.scale);
    }
    ++n;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = DqLayout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  const Smem<L> sh{smem_raw + pad};
  if (threadIdx.x == 0) sh.init();
  __syncthreads();
  // one if / else for the whole kernel, or setmaxnreg is ignored
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    dq_produce<D>(&tq, &tg, &tk, &tv, p, sh);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    dq_consume<D>(p, sh);
  }
}

// ===========================================================================
// Kernel 2: dK and dV.

constexpr int DKV_BK = 128;  // keys per item: two warpgroups of 64
constexpr int DKV_BQ = QT;   // query rows per stage

template <int D>
struct DkvLayout {
  using S = Slabs<D>;
  static constexpr int KV_SLAB = DKV_BK * S::SW;
  static constexpr int KV_BYTES = S::NS * KV_SLAB;  // one K (or V) tile
  static constexpr int RES_BYTES = 2 * KV_BYTES;     // K and V
  static constexpr int Q_SLAB = DKV_BQ * S::SW;
  static constexpr int Q_BYTES = S::NS * Q_SLAB;     // one Q (or dO) tile
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  // barriers, tile info and per-row LSE, Delta and position; key
  // positions
  static constexpr int meta(int res, int stages) {
    return (2 * stages + 2 * res) * 8 + stages * (8 + 3 * DKV_BQ) * 4 +
           res * DKV_BK * 4;
  }
  static constexpr bool fits(int res, int stages) {
    return res * RES_BYTES + stages * STAGE_BYTES + meta(res, stages) +
               1024 <= SMEM_LIMIT;
  }
  static constexpr int RES = fits(2, 2) ? 2 : 1;
  static constexpr int STAGES = fits(RES, 4) ? 4 : fits(RES, 3) ? 3 : 2;
  static_assert(fits(RES, STAGES), "shared memory of one block");
  static constexpr int TILE_BYTES = RES * RES_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = 1024 + TILE_BYTES + meta(RES, STAGES);
  // tiles: RES x (K, V), then the Q/dO stages. Tables (byte offsets):
  // [STAGES][8] q0 (-1: the item ends), rows, a row with no visible key,
  // qmin, qmax; [STAGES][DKV_BQ] each of the rows' LSE in log2 units (+inf
  // past the rows), Delta and positions; [RES][DKV_BK] the item's key
  // positions (-1: none)
  static constexpr int INFO = 0;
  static constexpr int LSE2 = INFO + 32 * STAGES;
  static constexpr int DL = LSE2 + 4 * DKV_BQ * STAGES;
  static constexpr int QPS = DL + 4 * DKV_BQ * STAGES;
  static constexpr int KPS = QPS + 4 * DKV_BQ * STAGES;
};

struct DkvItem {
  int b, hk, k0, nk;
};

__device__ __forceinline__ int dkv_item(const Params& p, int k,
                                        DkvItem& x) {
  const int nt = (p.sk + DKV_BK - 1) / DKV_BK;
  int pair, tile;
  const int got = work_item(p, nt, k, pair, tile);
  if (got > 0) {
    x.b = pair / p.kv;
    x.hk = pair - x.b * p.kv;
    x.k0 = tile * DKV_BK;  // the heavier causal tile (earlier keys) first
    x.nk = min(DKV_BK, p.sk - x.k0);
  }
  return got;
}

// Warp 0 of warpgroup 0: per item, the key positions and K and V into a
// free resident buffer; then, for each query head of the group in order,
// 32 query tiles at a time: a lane reads one tile's summary (written by
// kernel 1), the warp takes the tiles that may see a key of the item or
// hold a row with no visible key, and streams each with its rows' LSE,
// Delta and positions; then an end marker.
template <int D>
__device__ __forceinline__ void dkv_produce(const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            const CUtensorMap* tq,
                                            const CUtensorMap* tg,
                                            const Params& p,
                                            const Smem<DkvLayout<D>>& sh) {
  using S = Slabs<D>;
  using L = DkvLayout<D>;
  if (threadIdx.x >= 32) return;  // warps 1-3 only gave their registers
  const int lane = threadIdx.x;
  const uint32_t base = sh.tiles();
  const int ntq = (p.sq + QT - 1) / QT;
  int stage = 0;
  uint32_t phase = 0;
  DkvItem x;
  for (int k = 0, n = 0, got; (got = dkv_item(p, k, x)) >= 0; ++k) {
    if (!got) continue;
    const int rs = n % L::RES, use = n / L::RES;
    if (use > 0) mbar_wait(sh.rempty(rs), (use - 1) & 1);
    int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
    for (int j = 0; j < DKV_BK / 32; ++j) {
      const int i = lane + 32 * j;
      const int kp = i < x.nk ? p.kpos[x.k0 + i] : -1;
      sh.ints(L::KPS)[rs * DKV_BK + i] = kp;
      if (kp >= 0) {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
      }
    }
    kmin = warp_min(kmin);
    kmax = warp_max(kmax);
    const uint32_t rb = sh.rfull(rs);
    if (lane == 0) {
      mbar_arrive_tx(rb, L::RES_BYTES);
      const uint32_t ka = base + rs * L::RES_BYTES;
#pragma unroll
      for (int s = 0; s < S::NS; ++s) {
        tma_load(ka + s * L::KV_SLAB, tk, rb, s * S::SLAB, x.hk, x.k0, x.b);
        tma_load(ka + L::KV_BYTES + s * L::KV_SLAB, tv, rb, s * S::SLAB,
                 x.hk, x.k0, x.b);
      }
    } else {
      mbar_arrive(rb);
    }

    // the query tiles of the group's heads, in order (head-major): their
    // summaries lie together
    const int4* sums =
        p.qtiles + ((long long)x.b * p.h + x.hk * p.grp) * ntq;
    for (int t0 = 0; t0 < p.grp * ntq; t0 += 32) {
      const int t = t0 + lane;
      bool take_it = false;
      if (t < p.grp * ntq) {
        const int4 sm = sums[t];
        take_it = sm.z || may_see(p, sm.x, sm.y, kmin, kmax);
      }
      uint32_t take = __ballot_sync(0xffffffffu, take_it);
      while (take) {
        const int tt = t0 + __ffs(take) - 1;
        take &= take - 1;
        const int4 sm = sums[tt];  // qmin, qmax, a row with no visible key
        const int hg = tt / ntq, h = x.hk * p.grp + hg;
        const int q0 = (tt - hg * ntq) * QT, nq = min(QT, p.sq - q0);
        const long long rows = ((long long)x.b * p.h + h) * p.sq + q0;
        mbar_wait(sh.empty(stage), phase ^ 1);
#pragma unroll
        for (int jj = 0; jj < DKV_BQ / 32; ++jj) {
          // past the rows: LSE +inf, so P = 0 whatever the mask
          const int i = lane + 32 * jj, at = stage * DKV_BQ + i;
          const bool row = i < nq;
          sh.ints(L::QPS)[at] = row ? p.qpos[q0 + i] : 0;
          sh.floats(L::LSE2)[at] = row ? p.lse[rows + i] * LOG2E : INFINITY;
          sh.floats(L::DL)[at] = row ? p.delta[rows + i] : 0.f;
        }
        const uint32_t fb = sh.full(stage);
        if (lane == 0) {
          int* in = sh.ints(L::INFO) + 8 * stage;
          in[0] = q0;
          in[1] = nq;
          in[2] = sm.z;
          in[3] = sm.x;
          in[4] = sm.y;
          mbar_arrive_tx(fb, L::STAGE_BYTES);
          const uint32_t qs = base + L::RES * L::RES_BYTES +
                              stage * L::STAGE_BYTES;
#pragma unroll
          for (int s = 0; s < S::NS; ++s) {
            tma_load(qs + s * L::Q_SLAB, tq, fb, s * S::SLAB, h, q0, x.b);
            tma_load(qs + L::Q_BYTES + s * L::Q_SLAB, tg, fb, s * S::SLAB, h,
                     q0, x.b);
          }
        } else {
          mbar_arrive(fb);
        }
        advance(stage, phase, L::STAGES);
      }
    }
    mbar_wait(sh.empty(stage), phase ^ 1);
    if (lane == 0) sh.ints(L::INFO)[8 * stage] = -1;
    mbar_arrive(sh.full(stage));
    advance(stage, phase, L::STAGES);
    ++n;
  }
}

// Warpgroups 1 and 2: 64 keys each. This thread holds keys r0 = 16 warp + g
// and r0 + 8 of its warpgroup and, of each block of 8 columns (queries in
// S^T, d in dK and dV), columns 2t and 2t + 1.
template <int D>
__device__ __forceinline__ void dkv_consume(const Params& p,
                                            const Smem<DkvLayout<D>>& sh) {
  using S = Slabs<D>;
  using L = DkvLayout<D>;
  constexpr int BQ = DKV_BQ;
  const int tid = threadIdx.x - 128, c = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = c * 64 + w * 16 + g;  // key in the item
  const uint32_t base = sh.tiles();

  float s[BQ / 2], dp[BQ / 2], dk[D / 2], dv[D / 2];
  uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
  int stage = 0;
  uint32_t phase = 0;
  DkvItem x;
  for (int k = 0, n = 0, got; (got = dkv_item(p, k, x)) >= 0; ++k) {
    if (!got) continue;
    const int rs = n % L::RES;
    mbar_wait(sh.rfull(rs), (n / L::RES) & 1);
    const int* kps = sh.ints(L::KPS) + rs * DKV_BK;
    const int kp[2] = {kps[r0], kps[r0 + 8]};
    const bool key[2] = {r0 < x.nk, r0 + 8 < x.nk};  // a key, below Sk
    // the warpgroup's range of key positions where all 64 are valid keys,
    // else [INT_MIN, INT_MAX] (no tile is then taken without a mask;
    // positions are below INT_MAX); every warp alike
    int kmin = INT_MAX, kmax = INT_MIN;
    bool all = true;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kq = kps[c * 64 + lane + 32 * j];
      kmin = min(kmin, kq);
      kmax = max(kmax, kq);
      all = all && kq >= 0;
    }
    all = __all_sync(0xffffffffu, all);
    kmin = all ? warp_min(kmin) : INT_MIN;
    kmax = all ? warp_max(kmax) : INT_MAX;
    // this warpgroup's rows of K and of V
    const uint32_t ka = base + rs * L::RES_BYTES + c * 64 * S::SW;
    const uint32_t va = ka + L::KV_BYTES;

#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    for (;;) {
      mbar_wait(sh.full(stage), phase);
      const int* in = sh.ints(L::INFO) + 8 * stage;
      if (in[0] < 0) {
        release(sh.empty(stage), lane);
        advance(stage, phase, L::STAGES);
        break;
      }
      const uint32_t qt = base + L::RES * L::RES_BYTES +
                          stage * L::STAGE_BYTES;
      const uint32_t gt = qt + L::Q_BYTES;
      wgmma_fence();
      issue_abt<D, BQ>(s, ka, L::KV_SLAB, qt, L::Q_SLAB);
      issue_abt<D, BQ>(dp, va, L::KV_SLAB, gt, L::Q_SLAB);
      // rows below `none_rows` may see no key (0 where none does)
      const int none_rows = in[2] ? in[1] : 0;
      const int row0 = stage * BQ;  // the stage's rows in the tables
      // no per-element mask where the warpgroup's 64 keys are all valid and
      // visible to every row of the tile, and no row lacks a visible key
      const bool unmasked =
          kmax != INT_MAX && !in[2] && (!p.causal || kmax <= in[3]) &&
          (!p.has_window || (long long)kmin > (long long)in[4] - p.window);
      wgmma_wait<1>();
      fence_regs(s);
      // P^T: key r, query column 8 j + 2 t + cc
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = 8 * j + 2 * t + cc;
          const float lq = sh.floats(L::LSE2)[row0 + col];
          if (unmasked) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = s[4 * j + 2 * r + cc];
              v = ex2(fmaf(v, p.scale_log2, -lq));
            }
          } else {
            // the key positions the row sees: [lo, hi]
            const int qp = sh.ints(L::QPS)[row0 + col];
            const long long w = p.has_window ? (long long)qp - p.window + 1
                                             : 0;
            const int lo = w > 0 ? static_cast<int>(w) : 0;
            const int hi = p.causal ? qp : INT_MAX;
            // a row with no visible key: P = 1/Sk at every key below Sk
            const bool none = col < none_rows && isinf(lq);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = s[4 * j + 2 * r + cc];
              v = none ? (key[r] ? p.inv_sk : 0.f)
                  : kp[r] >= lo && kp[r] <= hi
                      ? ex2(fmaf(v, p.scale_log2, -lq))
                      : 0.f;
            }
          }
        }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS^T = P^T (dP^T - Delta), 0 for a row with no visible key; P^T
      // and dS^T rounded to bf16: the A fragments of dV and dK
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = 8 * j + 2 * t + cc;
          const bool none =
              col < none_rows && isinf(sh.floats(L::LSE2)[row0 + col]);
          const float dlt = sh.floats(L::DL)[row0 + col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + cc;
            dp[i] = none ? 0.f : s[i] * (dp[i] - dlt);
          }
        }
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kt + 2 * e;
          pa[kt][e] = pack_bf16(s[i], s[i + 1]);
          sa[kt][e] = pack_bf16(dp[i], dp[i + 1]);
        }
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(sa);
      wgmma_fence();
      issue_xb<D, BQ / 16>(dv, pa, gt, L::Q_SLAB);
      issue_xb<D, BQ / 16>(dk, sa, qt, L::Q_SLAB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(sa);
      release(sh.empty(stage), lane);
      advance(stage, phase, L::STAGES);
    }
    release(sh.rempty(rs), lane);  // K, V and the positions are read

    dkv_item(p, k, x);  // again: x is not held through the tile loop
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key[r]) continue;
      const long long at =
          (((long long)x.b * p.sk + x.k0 + r0 + 8 * r) * p.kv + x.hk) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(p.dk + at + 8 * j + 2 * t) =
            pack_bf16(dk[4 * j + 2 * r] * p.scale,
                      dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + at + 8 * j + 2 * t) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
    ++n;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fa_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tg,
                     const Params p) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  const Smem<L> sh{smem_raw + pad};
  if (threadIdx.x == 0) sh.init();
  __syncthreads();
  // one if / else for the whole kernel, or setmaxnreg is ignored
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    dkv_produce<D>(&tk, &tv, &tq, &tg, p, sh);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    dkv_consume<D>(p, sh);
  }
}

// ---------------------------------------------------------------------------

constexpr long long L2_BUDGET = 8 << 20;  // bytes of streamed operands in L2

// pairs per scheduling group: as many as keep `bytes` each within L2_BUDGET
int l2_group(int pairs, long long bytes) {
  const long long g = L2_BUDGET / (bytes > 0 ? bytes : 1);
  return g < 1 ? 1 : g > pairs ? pairs : static_cast<int>(g);
}

int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = dev < MAX_DEVICES ? sms[dev] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    if (dev < MAX_DEVICES) sms[dev] = n;
  }
  return n;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p0,
           int b, const long long (&st)[15], cudaStream_t stream) {
  using S = Slabs<D>;
  const EncodeTiled enc = encoder();
  CUtensorMap tq128, tg128, tk128, tv128, tq64, tg64;
  const auto map = [&](CUtensorMap* m, const void* x, int heads, int seq,
                       int i, int rows) {
    // st[3 i ..]: x's (batch, seq, head) element strides
    return encode_map(enc, m, x, D, heads, seq, b, st[3 * i + 2],
                      st[3 * i + 1], st[3 * i], S::SLAB, rows, S::SW);
  };
  if (enc == nullptr || !map(&tq128, q, p0.h, p0.sq, 0, DQ_BQ) ||
      !map(&tg128, p0.dout, p0.h, p0.sq, 4, DQ_BQ) ||
      !map(&tk128, k, p0.kv, p0.sk, 1, DQ_BK) ||
      !map(&tv128, v, p0.kv, p0.sk, 2, DQ_BK) ||
      !map(&tq64, q, p0.h, p0.sq, 0, DKV_BQ) ||
      !map(&tg64, p0.dout, p0.h, p0.sq, 4, DKV_BQ))
    return ENCODE_FAILED;
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorInvalidDevice;
  int dev;
  static bool raised[2][MAX_DEVICES] = {};
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(fa_bwd_dq_wgmma<D>),
      DqLayout<D>::SMEM_BYTES, raised[0], dev);
  if (err != cudaSuccess) return err;
  err = raise_smem(reinterpret_cast<const void*>(fa_bwd_dkv_wgmma<D>),
                   DkvLayout<D>::SMEM_BYTES, raised[1], dev);
  if (err != cudaSuccess) return err;

  // 1. dQ over (batch, head) pairs whose K and V stay in L2 together
  Params p = p0;
  p.pairs = b * p.h;
  p.group = l2_group(p.pairs, 4LL * p.sk * D);
  long long units =
      (long long)p.pairs * ((p.sq + 2 * DQ_BQ - 1) / (2 * DQ_BQ));
  fa_bwd_dq_wgmma<D>
      <<<dim3(static_cast<unsigned>(units < n_sm ? units : n_sm)), THREADS,
         DqLayout<D>::SMEM_BYTES, stream>>>(tq128, tg128, tk128, tv128, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. dK / dV over (batch, kv head) pairs whose G heads' Q and dO stay in
  // L2 together
  p.pairs = b * p.kv;
  p.group = l2_group(p.pairs, 4LL * p.grp * p.sq * D);
  units = (long long)p.pairs * ((p.sk + 2 * DKV_BK - 1) / (2 * DKV_BK));
  fa_bwd_dkv_wgmma<D>
      <<<dim3(static_cast<unsigned>(units < n_sm ? units : n_sm)), THREADS,
         DkvLayout<D>::SMEM_BYTES, stream>>>(tk128, tv128, tq64, tg64, p);
  return cudaGetLastError();
}

}  // namespace

// The bf16 entry for d in {64, 80, 96, 128}: q, o, dout (B, Sq, H, d), k, v
// (B, Sk, Kv, d), each with unit stride on d, a 16-byte aligned start and
// the element strides given (batch, seq, head), multiples of 8; qpos (Sq,),
// kpos (Sk,) int32, -1 = padding; lse (B, H, Sq) float32, the forward's
// (natural log units, +inf for a row with no visible key); delta (B, H, Sq)
// float32 and qtiles (B, H, ceil(Sq / 64)) int4 scratch; dq contiguous
// (B, Sq, H, d), dk and dv contiguous (B, Sk, Kv, d), bf16. window <= 0
// means no window. Launches the two kernels on `stream` in order; returns
// the first CUDA error, cudaErrorInvalidValue for a d it does not take, or
// -1 when cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* qpos, const int* kpos, const float* lse,
    float* delta, void* qtiles, void* dq, void* dk, void* dv, int b, int h,
    int kv, int sq, int sk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss,
    long long dsh, int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (h <= 0 || kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, osb, oss, osh, dsb, dss, dsh};
  Params p{};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.qpos = qpos;
  p.kpos = kpos;
  p.lse = lse;
  p.delta = delta;
  p.qtiles = static_cast<int4*>(qtiles);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.h = h;
  p.kv = kv;
  p.grp = h / kv;
  p.sq = sq;
  p.sk = sk;
  p.osb = osb;
  p.oss = oss;
  p.osh = osh;
  p.dsb = dsb;
  p.dss = dss;
  p.dsh = dsh;
  p.causal = causal;
  p.has_window = window > 0 ? 1 : 0;
  p.window = window > 0 ? window : 0;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.inv_sk = 1.f / static_cast<float>(sk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, p, b, st, s);
    case 80: return launch<80>(q, k, v, p, b, st, s);
    case 96: return launch<96>(q, k, v, p, b, st, s);
    case 128: return launch<128>(q, k, v, p, b, st, s);
    default: return cudaErrorInvalidValue;
  }
}
