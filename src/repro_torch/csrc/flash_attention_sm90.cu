// Forward attention with an online softmax (flash attention) built on
// Hopper's own units: wgmma, TMA and a warp-specialised mbarrier pipeline.
// bfloat16, head dim d in {64, 80, 96, 128}.
//
// Replaces the TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py:72, body `_fa_kernel`) for bf16 at
// the head dims of the served models (64: hymba, granite; 80: hubert's
// encoder; 96: phi3; 128: internlm2, starcoder2, dbrx, chameleon). float32,
// and bf16 at d = 16 and 32, stay on csrc/flash_attention.cu, whose header
// gives the function both compute: fp32 scores scaled after the product,
// masks from the position vectors (-1e30; keys past Sk give p = 0), p
// rounded to bf16 before P.V, out = acc / max(l, 1e-30), and a row with no
// visible key the mean of v over all Sk keys. Where the caller asks (the
// gradient needs it), it also writes each row's LSE of the scaled scores in
// natural log units, (m + log2 l) ln 2 from the epilogue's m and l, and
// +inf for a row with no visible key (the backward's P = exp(s * d^-0.5 -
// LSE)).
//
// What bounds it: at the serving shape (B*H = 128, S = 2048, d = 96,
// causal) the two products are 1.03e11 FLOP against 201 MB of q, k, v and
// out, so the tensor cores' 989 TFLOP/s bound it (104 us) before HBM
// (60 us); at hubert's encode (B*H = 64, S = 1,500, d = 80, bidirectional)
// 4.6e10 FLOP against 31 MB, 46.6 us against 9.2. What the design does
// about it:
//
//  * 384 threads in three warpgroups. Warpgroup 0 produces: one warp loads
//    positions and one thread issues the TMA copies, and the warpgroup
//    gives registers back (setmaxnreg). Warpgroups 1 and 2 consume, 64
//    query rows each, with the registers freed. (ptxas gives the consumer
//    path the setmaxnreg budget only if the kernel holds no trap after the
//    split: a watchdog trap in the barrier wait held it at the launch
//    bound's 168 registers.)
//  * Persistent: one block per SM walks work items of 128 query rows of one
//    (batch, head), and the K/V ring runs on from one item into the next.
//    Items pair query tiles y and nq - 1 - y counted from the last, so
//    causal items of a pair cost about the same and a fixed round-robin
//    over pairs balances the blocks; pairs come in groups of (batch, head)
//    whose K and V fit in 8 MB of L2 (without that, K and V of ~132 heads
//    at once streamed from HBM again and again).
//  * q, k and v are 4-D tensor maps (d, heads, seq, batch) with the
//    caller's strides, so the seq bound zero-fills a ragged last tile and
//    no copy reads into another head. The d axis is cut into slabs of one
//    swizzle span, each its own box and region, by `Slabs<D>` of
//    csrc/sm90.cuh, the backward's geometry too: 64 columns under a
//    128-byte swizzle at d = 64 and 128; 32 under 64 bytes at 96; 16 under
//    32 bytes at 80 (five boxes a tile).
//  * Q has two buffers where they fit (d = 64, 80, 96; one at d = 128); K
//    and V tiles of 128 keys go through a ring of three stages with full
//    and empty mbarriers.
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//    K-major; the online softmax runs in registers on the accumulator
//    layout (rows 16 warp + g and + 8, columns 2t, 2t + 1 of each block of
//    8), with the scale folded into exp2; p is rounded to bf16 and packed
//    straight into the register A fragments of P.V, wgmma m64n{d}k16 whose
//    B, the row-major V tile, is read MN-major through the transpose bit.
//    The two warpgroups take turns at the tensor cores (named barriers):
//    in its turn a warpgroup adds P.V of tile j - 1 and issues S of tile
//    j, then takes the softmax of S_j during the other's turn.
//  * The producer skips a key tile from its own range of valid positions
//    (as csrc/flash_attention.cu does) before it copies it, and hands the
//    tile's positions to the consumers on the same barrier. A tile whose
//    keys are all valid and visible to every row of a warpgroup (causal:
//    max kpos <= min qpos; window: min kpos > max qpos - window) takes no
//    per-element mask; only positions decide it, never indices, since a
//    ring cache holds positions out of order. Elsewhere the mask is two
//    compares against the row's range of visible positions.
//  * A row with no visible key must average v over every key. When a tile
//    was skipped and positions cannot rule such a row out, the consumers
//    vote into shared memory over a named barrier after the first pass;
//    if a row is empty the producer streams every tile again and both
//    warpgroups start over.
//  * No atomics, and one fixed tile order, so two launches give equal
//    outputs. Shared memory that wgmma reads is written only by TMA (the
//    async proxy), so no proxy fence is needed; the positions the
//    consumers read are plain stores released by the producer's mbarrier
//    arrivals.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int BQ = 128;       // query rows per block: two warpgroups of 64
constexpr int BK = 128;       // keys per tile
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 128 x 56 + 256 x 224 <= 65,536
constexpr int VOTE_BARRIER = 1;     // named barrier of the empty-row vote
constexpr int VOTERS = 32 + 256;    // the producer warp and the consumers
constexpr int SCHED_BARRIER = 2;    // + c: consumer c's turn to issue
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ENCODE_FAILED = -1;   // returned when a tensor map is refused

struct Params {
  const int* qpos;
  const int* kpos;
  __nv_bfloat16* out;
  float* lse;        // (B, H, Sq) float32, or null: no LSE written
  int h, kv, sq, sk;
  int causal, has_window, window;
  float scale_log2;  // d^-0.5 * log2(e): exp2 of the scaled score
  int bh, group;     // B * H; (batch, head) pairs scheduled together
};

// Shared-memory layout for head dim D: QBUF Q buffers (NS slabs of BQ rows
// each), then STAGES stages of a K and a V tile (NS slabs of BK rows each),
// then the barriers, the tiles' info and positions, the query positions and
// the vote flags. The slabs (SW, SLAB, NS, LAYOUT) are Slabs<D>'s, as in the
// backward.
template <int D>
struct Tiles : Slabs<D> {
  using S = Slabs<D>;
  static_assert(S::NS * S::SLAB == D, "the slabs cover d");
  static constexpr int STAGES = 3;
  static constexpr int Q_SLAB = BQ * S::SW;
  static constexpr int KV_SLAB = BK * S::SW;
  static constexpr int Q_BYTES = S::NS * Q_SLAB;
  static constexpr int KV_BYTES = S::NS * KV_SLAB;  // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // barriers, tile info and key positions, query positions, vote flags
  static constexpr int meta(int qbuf) {
    return (2 * STAGES + 2 * qbuf) * 8 + STAGES * (4 + BK) * 4 +
           qbuf * BQ * 4 + 16;
  }
  // two Q buffers where they fit beside the stages (not at d = 128)
  static constexpr int QBUF =
      2 * Q_BYTES + STAGES * STAGE_BYTES + meta(2) + 1024 <= 232448 ? 2 : 1;
  static constexpr int META_BYTES = meta(QBUF);
  static constexpr int TILE_BYTES = QBUF * Q_BYTES + STAGES * STAGE_BYTES;
  // up to 1024 bytes to align the tiles (the block's limit: 232,448)
  static constexpr int SLACK = 232448 - TILE_BYTES - META_BYTES < 1024
                                   ? 232448 - TILE_BYTES - META_BYTES
                                   : 1024;
  static constexpr int SMEM_BYTES = SLACK + TILE_BYTES + META_BYTES;
  static_assert(SLACK >= 0, "shared memory of one block");
};

// Shared state of one block, carved out of dynamic shared memory.
struct Shared {
  uint8_t* tiles;   // Q, then the K/V stages (1024-byte aligned)
  uint64_t* full;   // [STAGES]: the producer's 32 lanes + the copies' bytes
  uint64_t* empty;  // [STAGES]: the consumers' 8 warps
  uint64_t* qfull;  // [QBUF]: Q and the query positions: 32 lanes + bytes
  uint64_t* qempty; // [QBUF]: Q no longer read: the consumers' 8 warps
  int* info;        // [STAGES][4]: k0, kmin, kmax, all valid; or -1 (the
                    // pass ends) and whether the consumers vote
  int* kps;         // [STAGES][BK]: the tile's key positions (-1 past Sk)
  int* qps;         // [QBUF][BQ]: the work item's query positions
  int* flags;       // [2], by work item parity: some row saw no key
};

// One work item: 128 query rows of one (batch, head).
struct Work {
  int b, h, hk, q0, nrows;
};

// The k-th work item of this block. Items come in units of two query tiles
// of one (batch, head), y and nq - 1 - y counted from the last tile, so a
// causal unit costs about the same whatever y is, and block i takes units
// i, i + gridDim.x, ...: the blocks' loads balance with no atomic counter.
// Units come in groups of p.group (batch, head) pairs whose K and V fit in
// L2 together. Even k is a unit's heavier tile, odd k its lighter one.
// Returns 1 with x set, 0 for the missing half of the middle unit (nq
// odd), -1 past this block's last unit.
__device__ __forceinline__ int work_item(const Params& p, int k, Work& x) {
  const int nq = (p.sq + BQ - 1) / BQ, units = (nq + 1) / 2;
  const int u = (k >> 1) * gridDim.x + blockIdx.x;
  if (u >= p.bh * units) return -1;
  const int grp = u / (p.group * units);
  const int in_grp = u - grp * p.group * units;
  const int gsize = min(p.group, p.bh - grp * p.group);
  const int j = in_grp / gsize, bh = grp * p.group + in_grp % gsize;
  const int y = k & 1 ? nq - 1 - j : j;
  if ((k & 1) && y == j) return 0;
  x.q0 = (nq - 1 - y) * BQ;
  x.b = bh / p.h;
  x.h = bh - x.b * p.h;
  x.hk = x.h / (p.h / p.kv);
  x.nrows = min(BQ, p.sq - x.q0);
  return 1;
}

// Warpgroup 0. Warp 0 streams, per work item, Q and the query positions
// (once the consumers are done with the last item's), then per pass every
// key tile (pass 0 skips those no row of the item can see) and an end
// marker; it runs ahead into the next item while the consumers finish one.
// Warps 1-3 only take part in each item's vote.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Params& p, const Shared& sh) {
  using T = Tiles<D>;
  if (threadIdx.x >= 32) return;  // warps 1-3 only gave their registers
  const int lane = threadIdx.x;
  const uint32_t base = smem_u32(sh.tiles);
  int stage = 0;
  uint32_t phase = 0;
  int kmin_all = INT_MAX;  // the least valid key position (pass 0 sees all)
  Work x;
  for (int k = 0, n = 0, got; (got = work_item(p, k, x)) >= 0; ++k) {
    if (!got) continue;
    // Q buffer n % QBUF, its (n / QBUF)-th use: free once the item QBUF
    // back is done with it, and with it that item's vote flag
    const int qs = n % T::QBUF, use = n / T::QBUF;
    if (use > 0) mbar_wait(smem_u32(&sh.qempty[qs]), (use - 1) & 1);
    int* empty_row = sh.flags + (n & 1);
    if (lane == 0) *empty_row = 0;
    int* qps = sh.qps + qs * BQ;
    int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
    for (int i = lane; i < BQ; i += 32) {
      const int qp = i < x.nrows ? p.qpos[x.q0 + i] : 0;
      qps[i] = qp;
      if (i < x.nrows) {
        qmin = min(qmin, qp);
        qmax = max(qmax, qp);
      }
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    const uint32_t qb = smem_u32(&sh.qfull[qs]);
    if (lane == 0) {
      mbar_arrive_tx(qb, T::Q_BYTES);
#pragma unroll
      for (int s = 0; s < T::NS; ++s)
        tma_load(base + qs * T::Q_BYTES + s * T::Q_SLAB, tq, qb, s * T::SLAB,
                 x.h, x.q0, x.b);
    } else {
      mbar_arrive(qb);
    }

    bool skipped = false;
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < p.sk; k0 += BK) {
        int kp[BK / 32];
        int lo = INT_MAX, hi = INT_MIN;
        bool all = true;
#pragma unroll
        for (int j = 0; j < BK / 32; ++j) {
          const int i = k0 + lane + 32 * j;
          kp[j] = i < p.sk ? p.kpos[i] : -1;
          if (i < p.sk && kp[j] >= 0) {
            lo = min(lo, kp[j]);
            hi = max(hi, kp[j]);
          } else {
            all = false;
          }
        }
        lo = warp_min(lo);
        hi = warp_max(hi);
        all = __all_sync(0xffffffffu, all);
        if (pass == 0) {
          kmin_all = min(kmin_all, lo);
          const bool none = hi == INT_MIN;
          const bool late = p.causal && lo > qmax;
          const bool early =
              p.has_window && (long long)hi <= (long long)qmin - p.window;
          if (none || late || early) {
            skipped = true;
            continue;
          }
        }
        mbar_wait(smem_u32(&sh.empty[stage]), phase ^ 1);
#pragma unroll
        for (int j = 0; j < BK / 32; ++j)
          sh.kps[stage * BK + lane + 32 * j] = kp[j];
        const uint32_t fb = smem_u32(&sh.full[stage]);
        if (lane == 0) {
          int* in = sh.info + 4 * stage;
          in[0] = k0;
          in[1] = lo;
          in[2] = hi;
          in[3] = all;
          mbar_arrive_tx(fb, T::STAGE_BYTES);
          const uint32_t ks =
              base + T::QBUF * T::Q_BYTES + stage * T::STAGE_BYTES;
#pragma unroll
          for (int s = 0; s < T::NS; ++s) {
            tma_load(ks + s * T::KV_SLAB, tk, fb, s * T::SLAB, x.hk, k0, x.b);
            tma_load(ks + T::KV_BYTES + s * T::KV_SLAB, tv, fb, s * T::SLAB,
                     x.hk, k0, x.b);
          }
        } else {
          mbar_arrive(fb);
        }
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // A second pass is needed only if a tile was skipped and some row
      // sees no key. Positions alone rule that out when there is no window
      // and every row sees a valid key: causal, the least query position
      // is at or above the least valid key position; else any valid key.
      const bool sure = !p.has_window && kmin_all != INT_MAX &&
                        (!p.causal || qmin >= kmin_all);
      const bool vote = pass == 0 && skipped && !sure;
      // the end of the pass: a stage with no copies, k0 = -1 and whether
      // the consumers vote
      mbar_wait(smem_u32(&sh.empty[stage]), phase ^ 1);
      if (lane == 0) {
        sh.info[4 * stage] = -1;
        sh.info[4 * stage + 1] = vote;
      }
      mbar_arrive(smem_u32(&sh.full[stage]));
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (!vote) break;
      named_sync(VOTE_BARRIER, VOTERS);
      if (!*empty_row) break;
    }
    ++n;
  }
}

// o = o * alpha + P V for the V tile at `vs`: keys 16 kt .. 16 kt + 15 are
// the A fragments pa[kt]. Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         const float (&alpha)[2],
                                         uint32_t vs) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  issue_xb<D, BK / 16>(o, pa, vs, Tiles<D>::KV_SLAB);
  wgmma_commit();
}

// Warpgroups 1 and 2: 64 query rows each. This thread holds rows
// 16 warp + g and + 8 of its warpgroup (g = lane / 4) and, of each block of
// 8 columns of the scores and of the output, columns 2t and 2t + 1
// (t = lane % 4): wgmma's accumulator layout.
//
// Per key tile j a warpgroup, in its turn at the tensor cores, adds P V of
// tile j - 1 to o, gives that stage back to the producer, and issues
// S_j = Q K_j^T; then it takes the softmax of S_j while the other
// warpgroup has its turn (named barriers SCHED_BARRIER + c). Neither the P
// fragments nor o are in flight during a softmax, which keeps the
// consumers' registers low.
template <int D>
__device__ __forceinline__ void consume(const Params& p, const Shared& sh) {
  using T = Tiles<D>;
  const int tid = threadIdx.x - 128, c = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = c * 64 + ((tid >> 5) & 3) * 16 + g;  // row in the item
  const uint32_t base = smem_u32(sh.tiles);
  const auto stage_k = [&](int st) {
    return base + T::QBUF * T::Q_BYTES + st * T::STAGE_BYTES;
  };
  const auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(bar));
  };
  if (c == 1) named_arrive(SCHED_BARRIER, 256);  // c = 0 issues first

  float s[BK / 2], o[D / 2], m[2], l[2], alpha[2];
  uint32_t pa[BK / 16][4];
  int stage = 0;
  uint32_t phase = 0;
  Work x;
  for (int k = 0, n = 0, got; (got = work_item(p, k, x)) >= 0; ++k) {
    if (!got) continue;
    const int qs = n % T::QBUF;
    mbar_wait(smem_u32(&sh.qfull[qs]), (n / T::QBUF) & 1);
    const int* qps = sh.qps + qs * BQ;
    // this warpgroup's rows of Q buffer qs
    const uint32_t qa = base + qs * T::Q_BYTES + c * 64 * T::SW;
    const bool live[2] = {r0 < x.nrows, r0 + 8 < x.nrows};
    // the key positions rows r0 and r0 + 8 see: [vis_lo, vis_hi] (valid
    // keys are >= 0; causal: <= qpos; window: > qpos - window)
    int vis_lo[2], vis_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qps[r0 + 8 * r];
      const long long lo = p.has_window ? (long long)qp - p.window + 1 : 0;
      vis_lo[r] = lo > 0 ? static_cast<int>(lo) : 0;
      vis_hi[r] = p.causal ? qp : INT_MAX;
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
    int* empty_row = sh.flags + (n & 1);

    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = MASKED;
        l[r] = 0.f;  // this thread's part of the row sum
        alpha[r] = 1.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      int prev = -1;  // the stage whose P V is still to be added
      bool vote = false;
      for (;;) {
        mbar_wait(smem_u32(&sh.full[stage]), phase);
        const int* in = sh.info + 4 * stage;
        const int k0 = in[0];
        if (k0 < 0) {
          vote = in[1];
          release(&sh.empty[stage]);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
          break;
        }
        // this warpgroup's turn at the tensor cores: P V of the previous
        // tile, then S of this one
        named_sync(SCHED_BARRIER + c, 256);
        if (prev >= 0) {
          issue_pv<D>(o, pa, alpha, stage_k(prev) + T::KV_BYTES);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);
          release(&sh.empty[prev]);
        }
        // S = Q K^T: the k16 steps walk across the slabs of d
        wgmma_fence();
        issue_abt<D, BK>(s, qa, T::Q_SLAB, stage_k(stage), T::KV_SLAB);
        named_arrive(SCHED_BARRIER + 1 - c, 256);
        wgmma_wait<0>();
        fence_regs(s);

        // scale (in log2 units), mask, online softmax. A tile without a
        // mask keeps the raw scores and takes the scale in the exponent's
        // FMA.
        const bool unmasked =
            in[3] && (!p.causal || in[2] <= qmin) &&
            (!p.has_window || (long long)in[1] > (long long)qmax - p.window);
        const float k1 = unmasked ? p.scale_log2 : 1.f;
        if (!unmasked) {
          const int* kp = sh.kps + stage * BK;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int kpos = kp[8 * j + 2 * t + cc];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float& v = s[4 * j + 2 * r + cc];
                v = kpos >= vis_lo[r] && kpos <= vis_hi[r] ? v * p.scale_log2
                                                           : MASKED;
              }
            }
          const int nk = p.sk - k0;  // keys past Sk are no keys: p = 0
          if (nk < BK) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
              if (8 * (i >> 2) + 2 * t + (i & 1) >= nk) s[i] = -INFINITY;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * k1);  // the scale is > 0
          alpha[r] = ex2(m[r] - m_new);  // applied to o before the next P V
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] = ex2(fmaf(s[i], k1, -m[(i >> 1) & 1]));
          rs[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
        // p rounded to bf16: the A fragments of this tile's P V
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kt][e] = pack_bf16(s[8 * kt + 2 * e], s[8 * kt + 2 * e + 1]);
        prev = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (prev >= 0) {
        issue_pv<D>(o, pa, alpha, stage_k(prev) + T::KV_BYTES);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(&sh.empty[prev]);
      }
      if (!vote) break;
      if ((live[0] && m[0] == MASKED) || (live[1] && m[1] == MASKED))
        *empty_row = 1;
      named_sync(VOTE_BARRIER, VOTERS);
      if (!*empty_row) break;
    }
    release(&sh.qempty[qs]);  // Q and the positions are no longer read

    __nv_bfloat16* out = p.out;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r0 + 8 * r;
      if (!live[r]) continue;
      // LSE of the row's scaled scores in natural log units: m and l are
      // in log2 units; +inf marks a row with no visible key
      if (p.lse != nullptr && t == 0)
        p.lse[((long long)x.b * p.h + x.h) * p.sq + x.q0 + row] =
            m[r] == MASKED ? INFINITY : (m[r] + log2f(l[r])) * LN2;
      const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          out + (((long long)x.b * p.sq + x.q0 + row) * p.h + x.h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) = pack_bf16(
            o[4 * j + 2 * r] * inv_l, o[4 * j + 2 * r + 1] * inv_l);
    }
    ++n;
  }
  // c = 1's last turn handed to c = 0 is taken by no tile: take it
  if (c == 0) named_sync(SCHED_BARRIER, 256);
}

// One block per SM (at most), each walking work items blockIdx.x,
// + gridDim.x, ...: the K/V pipeline runs on from one item into the next.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const Params p) {
  using T = Tiles<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  if (pad > T::SLACK) __trap();  // the tiles would not fit aligned
  Shared sh;
  sh.tiles = smem_raw + pad;
  sh.full = reinterpret_cast<uint64_t*>(sh.tiles + T::TILE_BYTES);
  sh.empty = sh.full + T::STAGES;
  sh.qfull = sh.empty + T::STAGES;
  sh.qempty = sh.qfull + T::QBUF;
  sh.info = reinterpret_cast<int*>(sh.qempty + T::QBUF);
  sh.kps = sh.info + 4 * T::STAGES;
  sh.qps = sh.kps + T::STAGES * BK;
  sh.flags = sh.qps + T::QBUF * BQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(smem_u32(&sh.full[s]), 32);
      mbar_init(smem_u32(&sh.empty[s]), 8);
    }
    for (int s = 0; s < T::QBUF; ++s) {
      mbar_init(smem_u32(&sh.qfull[s]), 32);
      mbar_init(smem_u32(&sh.qempty[s]), 8);
    }
    sh.flags[0] = sh.flags[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if / else for the whole kernel, or setmaxnreg is ignored
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<D>(&tq, &tk, &tv, p, sh);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<D>(p, sh);
  }
}

// x as a (d, heads, seq, batch) tensor with element strides (sh, ss, sb);
// boxes of one slab of d by `rows` of seq
template <int D>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* x, int heads,
            int seq, int batch, long long sh, long long ss, long long sb,
            int rows) {
  using T = Tiles<D>;
  return encode_map(enc, map, x, D, heads, seq, batch, sh, ss, sb, T::SLAB,
                    rows, T::SW);
}

constexpr long long L2_BUDGET = 8 << 20;  // bytes of K and V kept in L2

// (batch, head) pairs per scheduling group: as many as keep their K and V
// (at most one copy per pair) within L2_BUDGET of the 50 MB L2
int l2_group(int bh, int sk, int d) {
  const long long per_pair = 4LL * sk * d;  // K and V, bf16
  const long long g = L2_BUDGET / (per_pair > 0 ? per_pair : 1);
  return g < 1 ? 1 : g > bh ? bh : static_cast<int>(g);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int b, long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, cudaStream_t stream) {
  using T = Tiles<D>;
  const EncodeTiled enc = encoder();
  CUtensorMap tq, tk, tv;
  if (enc == nullptr ||
      !encode<D>(enc, &tq, q, p.h, p.sq, b, qsh, qss, qsb, BQ) ||
      !encode<D>(enc, &tk, k, p.kv, p.sk, b, ksh, kss, ksb, BK) ||
      !encode<D>(enc, &tv, v, p.kv, p.sk, b, vsh, vss, vsb, BK))
    return ENCODE_FAILED;
  static bool raised[MAX_DEVICES] = {};
  int dev;
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(flash_attention_wgmma_kernel<D>),
      T::SMEM_BYTES, raised, dev);
  if (err != cudaSuccess) return err;
  static int sms[MAX_DEVICES] = {};
  int n_sm = dev < MAX_DEVICES ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms[dev] = n_sm;
  }
  // units of two query tiles per (batch, head)
  const long long units =
      (long long)b * p.h * ((p.sq + 2 * BQ - 1) / (2 * BQ));
  const dim3 grid(static_cast<unsigned>(units < n_sm ? units : n_sm));
  flash_attention_wgmma_kernel<D>
      <<<grid, THREADS, T::SMEM_BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// The bf16 entry for d in {64, 80, 96, 128}; the arguments of
// flash_attention_launch (csrc/flash_attention.cu) without the dtype: lse,
// (B, H, Sq) float32 or null, receives each row's LSE. q, k
// and v start 16-byte aligned, with element strides that are multiples of
// 8. Returns the CUDA error of the launch, cudaErrorInvalidValue for a d it
// does not take, or -1 when the driver refuses a tensor map.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, const int* qpos,
    const int* kpos, void* out, float* lse, int b, int h, int kv, int sq,
    int sk, int d, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (h <= 0 || kv <= 0 || h % kv != 0 || sk <= 0)
    return cudaErrorInvalidValue;
  const Params p{qpos,
                 kpos,
                 static_cast<__nv_bfloat16*>(out),
                 lse,
                 h,
                 kv,
                 sq,
                 sk,
                 causal,
                 window > 0 ? 1 : 0,
                 window > 0 ? window : 0,
                 scale * LOG2E,
                 b * h,
                 l2_group(b * h, sk, d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, p, b, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                        vsh, s);
    case 80:
      return launch<80>(q, k, v, p, b, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                        vsh, s);
    case 96:
      return launch<96>(q, k, v, p, b, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                        vsh, s);
    case 128:
      return launch<128>(q, k, v, p, b, qsb, qss, qsh, ksb, kss, ksh, vsb,
                         vss, vsh, s);
    default:
      return cudaErrorInvalidValue;
  }
}
