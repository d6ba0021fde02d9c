// Stable LSD radix argsort of u32 keys in one host call: onesweep.
//
// Replaces the TPU kernel `bucket_rank_hist` (src/repro/kernels/radix_hist.py,
// body `_hist_kernel`) and the 4-pass argsort built on it
// (src/repro/kernels/ops.py, `radix_argsort_u32`). The TPU kernel walks
// chunks of digits in grid order and carries the running per-bucket count
// in VMEM from one chunk to the next. On Hopper blocks run in no order, so
// the carry becomes a decoupled look-back (Adinets and Merrill, "Onesweep:
// A Faster Least Significant Digit Radix Sort for GPUs", arXiv 2206.01784):
//
//   1. radix_onesweep_hist_kernel, once per argsort: every block reads its
//      tile of keys once and counts all the byte histograms together (4 for
//      a u32 argsort, 8 for a (hi, lo) pair) in shared memory, then adds
//      them to global memory with integer atomics. Each thread compresses
//      runs of one digit before its shared atomic, so a bucket that holds
//      almost every key (the UMAX sentinel) costs one atomic per run.
//   2. radix_onesweep_pass_kernel, once per byte: a block takes the next
//      tile id from an atomic counter (so it waits only on tiles whose
//      blocks have started: no deadlock), ranks its tile stably (warp w
//      owns the w-th sub-range and walks it 32 keys at a time in order;
//      __match_any_sync gives the lanes with the same digit and
//      __popc(peers & lanemask_lt) the rank among them; an exclusive scan
//      over warps joins the warps), then thread d publishes the tile's
//      count of digit d in one 32-bit status word (flag bits "aggregate"
//      and "inclusive prefix" above a 30-bit count) and walks back over
//      the preceding tiles' words, 16 at a time, until it meets an
//      inclusive prefix; it then publishes its own. Every sum is
//      an exact integer count, so the result does not depend on the order
//      in which blocks finish. A key goes to
//        (exclusive scan of the pass's histogram)[d] + tile prefix[d]
//        + rank in the tile,
//      and key and value go there, into ping-pong buffers: the tile is
//      first laid out in that order in shared memory, so that neighbouring
//      threads write neighbouring positions of one digit. The next pass
//      reads the keys in that order directly. The first pass reads the
//      int64 keys' low 32 bits and takes the index as its value; the fifth
//      pass of a pair sort gathers hi through the carried value; the last
//      pass writes the int64 permutation.
//   3. One C call per argsort enqueues, on the caller's stream: one
//      cudaMemsetAsync of the histograms, tile counters and status words,
//      the histogram launch, and one launch per byte, in plain stream
//      order. Scratch comes from the caller (its size from
//      radix_scratch_bytes); nothing allocates.
//
// The TPU kernel's own entry (rank in bucket + histogram of one digit
// stream) is the histogram launch plus one pass in rank mode, which writes
// tile prefix + rank in tile at the element's own index instead of
// scattering.
//
// What bounds it: an argsort must read each int64 key once and write each
// int64 index once, 16 B per element (24 B for a pair), over the 3.35 TB/s
// of HBM3: 0.34 us at M = 72,072 (3.06 us at M = 639,998). At the main
// path's sizes (M <= 72,072, at most 36 tiles) everything stays in the
// 50 MB L2 and the time is the latency of five dependent launches (each an
// atomic, a load, a rank, a short look-back and a scatter), far above that
// bound; at M = 639,998 (313 tiles) the look-back's walk over the status
// words adds to it.
//
// Digits in rank mode are masked with 0xFF, so no digit can index outside
// shared memory. Counts live in 30 bits: m must be below 2^30.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 256;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;          // == NB: one thread per digit
constexpr int PER_THREAD = 8;                 // 32-key rounds per warp
constexpr int WARP_SPAN = 32 * PER_THREAD;    // keys owned by one warp
constexpr int TILE = WARPS * WARP_SPAN;       // keys per block: 2048
constexpr unsigned FULL = 0xffffffffu;
constexpr int LOOK = 16;                      // look-back words per step

constexpr unsigned FLAG_AGG = 1u << 30;       // the tile's own count
constexpr unsigned FLAG_INC = 2u << 30;       // count through this tile
constexpr unsigned FLAGS = FLAG_AGG | FLAG_INC;
constexpr unsigned COUNT_MASK = FLAG_AGG - 1u;

static_assert(THREADS == NB, "one thread per bucket in the scans");

// where a pass takes its keys and values
enum In { IN_KEYS, IN_DIGITS, IN_GATHER, IN_CHAIN };
// what a pass writes
enum Out { OUT_RANK, OUT_CHAIN, OUT_VALS, OUT_PERM };

struct Pass {
  const long long* src;     // IN_KEYS: keys[i]; IN_GATHER: keys[value]
  const int* digits;        // IN_DIGITS
  const unsigned* keys_in;  // IN_CHAIN
  const int* vals_in;       // IN_CHAIN, IN_GATHER
  unsigned* keys_out;       // OUT_CHAIN
  int* vals_out;            // OUT_CHAIN, OUT_VALS
  long long* perm_out;      // OUT_PERM
  int* rank_out;            // OUT_RANK
  const unsigned* hist;     // this pass's 256 bins (complete)
  unsigned* status;         // this pass's (n_tiles, 256) words, zeroed
  unsigned* tile_counter;   // zeroed
  int m;
  int shift;
};

// A status word carries its flag and its count together, and nothing else
// is published through it, so relaxed loads and stores at GPU scope are
// enough: any value read is either unpublished (0) or an exact count, and
// an older value only makes the walk go further back. Relaxed loads, unlike
// acquire loads, can all be in flight at once.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

template <int NP, bool DIGITS>
__global__ void __launch_bounds__(THREADS)
radix_onesweep_hist_kernel(const long long* __restrict__ lo,
                           const long long* __restrict__ hi,
                           const int* __restrict__ digits, int m,
                           unsigned* __restrict__ hist) {
  __shared__ unsigned h[NP * NB];
  for (int k = threadIdx.x; k < NP * NB; k += THREADS) h[k] = 0;
  __syncthreads();

  const int start = blockIdx.x * TILE + threadIdx.x;
  unsigned k0[PER_THREAD], k1[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = start + r * THREADS;
    k0[r] = k1[r] = 0;
    if (i < m) {
      if (DIGITS) {
        k0[r] = static_cast<unsigned>(__ldg(digits + i));
      } else {
        k0[r] = static_cast<unsigned>(__ldg(lo + i));
        if (NP == 8) k1[r] = static_cast<unsigned>(__ldg(hi + i));
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    int cur = -1;
    unsigned run = 0;
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      if (start + r * THREADS >= m) break;
      const unsigned k = p < 4 ? k0[r] : k1[r];
      const int d = (k >> (8 * (p & 3))) & 0xFF;
      if (d != cur) {
        if (run) atomicAdd(&h[p * NB + cur], run);
        cur = d;
        run = 0;
      }
      ++run;
    }
    if (run) atomicAdd(&h[p * NB + cur], run);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NP * NB; k += THREADS) {
    if (h[k]) atomicAdd(hist + k, h[k]);
  }
}

// The sum of the counts of digit d in the tiles before `tile` (decoupled
// look-back). Each step reads the LOOK nearest predecessors not yet added,
// all at once, and adds them nearest first up to the first inclusive
// prefix (done) or the first unpublished word (read again from there).
__device__ __forceinline__ unsigned walk_back(const unsigned* status,
                                              int tile, int d) {
  unsigned prefix = 0;
  int p = tile - 1;  // the nearest predecessor not yet added
  bool done = p < 0;
  while (!done) {
    unsigned w[LOOK];
#pragma unroll
    for (int j = 0; j < LOOK; ++j) {  // past tile 0: an inclusive zero
      w[j] = p - j >= 0
                 ? ld_relaxed(status + static_cast<long long>(p - j) * NB + d)
                 : FLAG_INC;
    }
    bool stop = false;
#pragma unroll
    for (int j = 0; j < LOOK; ++j) {
      if (stop) continue;
      if ((w[j] & FLAGS) == 0) {  // not published yet
        stop = true;
        continue;
      }
      prefix += w[j] & COUNT_MASK;
      --p;
      if (w[j] & FLAG_INC) stop = done = true;
    }
  }
  return prefix;
}

template <int IN, int OUT>
__global__ void __launch_bounds__(THREADS)
radix_onesweep_pass_kernel(const Pass a) {
  // an argsort pass stages its tile in sorted order in shared memory, so
  // that neighbouring threads write neighbouring positions of one digit
  constexpr bool STAGE = OUT != OUT_RANK;
  __shared__ int wcnt[WARPS][NB];
  __shared__ unsigned skey[STAGE ? TILE : 1];
  __shared__ int sval[STAGE ? TILE : 1];
  __shared__ int gdelta[NB];
  __shared__ unsigned wsum[2][WARPS];
  __shared__ int s_tile;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(a.tile_counter, 1u));
  }
  for (int k = threadIdx.x; k < WARPS * NB; k += THREADS) {
    (&wcnt[0][0])[k] = 0;
  }
  __syncthreads();

  const int tile = s_tile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int start = tile * TILE + warp * WARP_SPAN + lane;
  // the digit's histogram bin, for the scan below: its load overlaps the
  // key loads
  const unsigned h = STAGE ? __ldg(a.hist + threadIdx.x) : 0u;

  unsigned key[PER_THREAD];
  int val[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = start + r * 32;
    key[r] = 0;
    val[r] = i;
    if (i < a.m) {
      if (IN == IN_KEYS) key[r] = static_cast<unsigned>(__ldg(a.src + i));
      if (IN == IN_DIGITS) key[r] = static_cast<unsigned>(__ldg(a.digits + i));
      if (IN == IN_CHAIN) key[r] = __ldg(a.keys_in + i);
      if (IN == IN_CHAIN || IN == IN_GATHER) val[r] = __ldg(a.vals_in + i);
    }
  }
  if (IN == IN_GATHER) {
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      if (start + r * 32 < a.m) {
        key[r] = static_cast<unsigned>(__ldg(a.src + val[r]));
      }
    }
  }

  // stable rank within the warp's sub-range, in registers
  int dig[PER_THREAD];
  int loc[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const bool valid = start + r * 32 < a.m;
    // invalid lanes (the ragged tail) share the key -1, which no digit has
    const int d = valid ? static_cast<int>((key[r] >> a.shift) & 0xFF) : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    const int seen = valid ? wcnt[warp][d] : 0;
    __syncwarp();
    loc[r] = seen + __popc(peers & lanemask_lt);
    if (valid && lane == __ffs(peers) - 1) {
      wcnt[warp][d] = seen + __popc(peers);
    }
    __syncwarp();
    dig[r] = d;
  }
  __syncthreads();

  // thread d: exclusive scan of digit d over warps; the tile's count of d,
  // published at once (an inclusive prefix for tile 0)
  const int d = threadIdx.x;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = wcnt[w][d];
    wcnt[w][d] = static_cast<int>(count);
    count += c;
  }
  unsigned* mine = a.status + static_cast<long long>(tile) * NB + d;
  st_relaxed(mine, (tile == 0 ? FLAG_INC : FLAG_AGG) | count);

  // exclusive scans over digits: of the histogram (the digit's first
  // position in the output) and of the tile's counts (its first position
  // in the tile's sorted order)
  unsigned hist_excl = 0, tile_excl = 0;
  if (STAGE) {
    unsigned x = h, y = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned xs = __shfl_up_sync(FULL, x, o);
      const unsigned ys = __shfl_up_sync(FULL, y, o);
      if (lane >= o) {
        x += xs;
        y += ys;
      }
    }
    if (lane == 31) {
      wsum[0][warp] = x;
      wsum[1][warp] = y;
    }
    __syncthreads();
    for (int w = 0; w < warp; ++w) {
      hist_excl += wsum[0][w];
      tile_excl += wsum[1][w];
    }
    hist_excl += x - h;
    tile_excl += y - count;
  }

  const unsigned prefix = walk_back(a.status, tile, d);
  if (tile > 0) st_relaxed(mine, FLAG_INC | (prefix + count));
  // wcnt becomes each warp's first position of digit d: in the tile's
  // sorted order (staged), or among all equal digits (rank mode)
  const unsigned first = STAGE ? tile_excl : prefix;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) wcnt[w][d] += static_cast<int>(first);
  if (STAGE) gdelta[d] = static_cast<int>(hist_excl + prefix - tile_excl);
  __syncthreads();

  if (!STAGE) {
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int i = start + r * 32;
      if (i < a.m) a.rank_out[i] = wcnt[warp][dig[r]] + loc[r];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    if (start + r * 32 < a.m) {
      const int j = wcnt[warp][dig[r]] + loc[r];
      skey[j] = key[r];
      sval[j] = val[r];
    }
  }
  __syncthreads();
  // element j of the sorted tile goes to (its digit's output position for
  // this tile) + (j - the digit's first j)
  const int n = min(TILE, a.m - tile * TILE);
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const unsigned k = skey[j];
    const int pos = gdelta[(k >> a.shift) & 0xFF] + j;
    if (OUT == OUT_CHAIN) a.keys_out[pos] = k;
    if (OUT == OUT_CHAIN || OUT == OUT_VALS) a.vals_out[pos] = sval[j];
    if (OUT == OUT_PERM) a.perm_out[pos] = sval[j];
  }
}

template <int IN, int OUT>
cudaError_t launch_pass(const Pass& a, int n_tiles, cudaStream_t s) {
  radix_onesweep_pass_kernel<IN, OUT><<<n_tiles, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

constexpr long long align256(long long x) { return (x + 255) / 256 * 256; }

// Byte offsets into the scratch buffer. The first `zeroed` bytes are the
// histograms, the tile counters and the status words, cleared by the one
// memset of each call; the key and value ping-pong buffers follow (none
// for the rank entry, n_passes == 1).
struct Layout {
  long long hist, counters, status, zeroed, keys[2], vals[2], total;
};

Layout layout(int m, int n_passes) {
  const long long n_tiles = (m + TILE - 1) / TILE;
  Layout l{};
  long long off = 0;
  l.hist = off;
  off += align256(4LL * n_passes * NB);
  l.counters = off;
  off += align256(4LL * n_passes);
  l.status = off;
  off += align256(4LL * n_passes * n_tiles * NB);
  l.zeroed = off;
  if (n_passes > 1) {
    for (int b = 0; b < 2; ++b) {
      l.keys[b] = off;
      off += align256(4LL * m);
      l.vals[b] = off;
      off += align256(4LL * m);
    }
  }
  l.total = off;
  return l;
}

Pass pass_args(char* scratch, const Layout& l, int m, int p, int n_tiles) {
  Pass a{};
  a.m = m;
  a.shift = 8 * (p & 3);
  a.hist = reinterpret_cast<const unsigned*>(scratch + l.hist) + p * NB;
  a.status = reinterpret_cast<unsigned*>(scratch + l.status) +
             static_cast<long long>(p) * n_tiles * NB;
  a.tile_counter = reinterpret_cast<unsigned*>(scratch + l.counters) + p;
  return a;
}

}  // namespace

extern "C" int radix_tile_elems() { return TILE; }

// Bytes of scratch one call needs: n_passes 4 (u32 argsort), 8 (pair
// argsort) or 1 (the rank entry).
extern "C" long long radix_scratch_bytes(int m, int n_passes) {
  return layout(m, n_passes).total;
}

// Stable ascending argsort of m keys held in int64 (low 32 bits read):
// n_passes 4 sorts `lo`; n_passes 8 sorts (hi, lo) pairs, lo's bytes
// first. perm: (m,) int64. 0 < m < 2^30. Returns the CUDA error code of
// the memset and the launches (0 on success).
extern "C" int radix_argsort_launch(const long long* lo, const long long* hi,
                                    int m, int n_passes, long long* perm,
                                    void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  const Layout l = layout(m, n_passes);
  const int n_tiles = (m + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* hist = reinterpret_cast<unsigned*>(base + l.hist);
  if (n_passes == 8) {
    radix_onesweep_hist_kernel<8, false><<<n_tiles, THREADS, 0, s>>>(
        lo, hi, nullptr, m, hist);
  } else {
    radix_onesweep_hist_kernel<4, false><<<n_tiles, THREADS, 0, s>>>(
        lo, nullptr, nullptr, m, hist);
  }
  err = cudaGetLastError();
  for (int p = 0; p < n_passes && err == cudaSuccess; ++p) {
    Pass a = pass_args(base, l, m, p, n_tiles);
    const int in_buf = (p + 1) & 1, out_buf = p & 1;
    a.keys_in = reinterpret_cast<const unsigned*>(base + l.keys[in_buf]);
    a.vals_in = reinterpret_cast<const int*>(base + l.vals[in_buf]);
    a.keys_out = reinterpret_cast<unsigned*>(base + l.keys[out_buf]);
    a.vals_out = reinterpret_cast<int*>(base + l.vals[out_buf]);
    a.perm_out = perm;
    const bool last = p == n_passes - 1;
    const bool before_gather = n_passes == 8 && p == 3;
    if (p == 0) {
      a.src = lo;
      err = launch_pass<IN_KEYS, OUT_CHAIN>(a, n_tiles, s);
    } else if (p == 4) {
      a.src = hi;
      err = launch_pass<IN_GATHER, OUT_CHAIN>(a, n_tiles, s);
    } else if (last) {
      err = launch_pass<IN_CHAIN, OUT_PERM>(a, n_tiles, s);
    } else if (before_gather) {
      err = launch_pass<IN_CHAIN, OUT_VALS>(a, n_tiles, s);
    } else {
      err = launch_pass<IN_CHAIN, OUT_CHAIN>(a, n_tiles, s);
    }
  }
  return static_cast<int>(err);
}

// The TPU kernel's entry: digits (m,) int32 in [0, 256); rank (m,) int32,
// the stable rank of each digit among equal digits. The 256-bin histogram
// is left in the first 1 KiB of `scratch` (radix_scratch_bytes(m, 1)).
// 0 < m < 2^30. Returns the CUDA error code (0 on success).
extern "C" int radix_rank_launch(const int* digits, int m, int* rank,
                                 void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  const Layout l = layout(m, 1);
  const int n_tiles = (m + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_onesweep_hist_kernel<1, true><<<n_tiles, THREADS, 0, s>>>(
      nullptr, nullptr, digits, m, reinterpret_cast<unsigned*>(base + l.hist));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Pass a = pass_args(base, l, m, 0, n_tiles);
  a.digits = digits;
  a.rank_out = rank;
  return static_cast<int>(launch_pass<IN_DIGITS, OUT_RANK>(a, n_tiles, s));
}
