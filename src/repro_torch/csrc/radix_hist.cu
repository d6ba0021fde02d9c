// Per-byte stable rank and 256-bin histogram: one counting-sort pass.
//
// Replaces the TPU kernel `bucket_rank_hist` (src/repro/kernels/radix_hist.py,
// body `_hist_kernel`), which walks chunks of 1024 digits in grid order and
// carries the running per-bucket count in VMEM from one chunk to the next.
// On Hopper blocks run in no order, so nothing can be carried between them;
// the pass is split into three launches on one stream:
//
//   1. tile_count: each block counts its tile of TILE digits into a
//      shared-memory histogram (shared atomics) and writes one row of the
//      (n_tiles, 256) count table;
//   2. tile_scan: one block, one thread per digit, turns each column of
//      the table into an exclusive prefix over tiles in place (the base of
//      each (tile, digit)) and writes the column total: the histogram;
//   3. tile_rank: each block ranks its tile stably. Warp w owns the w-th
//      consecutive sub-range of the tile and walks it 32 digits at a time,
//      in order; __match_any_sync gives each lane the lanes holding the
//      same digit, __popc(peers & lanemask_lt) its rank among them, and a
//      per-warp shared counter the digits of that value seen in earlier
//      rounds. An exclusive scan of the per-warp counts over warps, plus
//      the tile base from step 2, gives the global stable rank.
//
// What bounds it: a pass reads the M digits twice (4 B each, steps 1 and 3)
// and writes M ranks, so the floor is ~12 B per element over the 3.35 TB/s
// of HBM3: about 0.26 us at M = 72,072. At the main path's sizes (M <= 72k,
// 36 tiles) it is far from that floor and bounded instead by three launches
// and the serial 36-step column scan; the design keeps every digit read
// coalesced and all per-bucket counting in shared memory, never in global
// atomics, so it stays deterministic.
//
// Digits must lie in [0, 256); the kernel masks them with 0xFF so a bad
// digit cannot write outside shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 256;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;          // == NB: one thread per digit
constexpr int PER_THREAD = 8;                 // 32-digit rounds per warp
constexpr int WARP_SPAN = 32 * PER_THREAD;    // digits owned by one warp
constexpr int TILE = WARPS * WARP_SPAN;       // digits per block: 2048

static_assert(THREADS == NB, "one thread per bucket in the scans");

__global__ void tile_count_kernel(const int* __restrict__ digits, int m,
                                  int* __restrict__ tile_counts) {
  __shared__ int h[NB];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    const long long i = base + k;
    if (i < m) atomicAdd(&h[__ldg(digits + i) & 0xFF], 1);
  }
  __syncthreads();
  tile_counts[(long long)blockIdx.x * NB + threadIdx.x] = h[threadIdx.x];
}

__global__ void tile_scan_kernel(int* __restrict__ tile_counts, int n_tiles,
                                 int* __restrict__ hist) {
  const int d = threadIdx.x;
  int run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const long long at = (long long)t * NB + d;
    const int c = tile_counts[at];
    tile_counts[at] = run;
    run += c;
  }
  hist[d] = run;
}

__global__ void tile_rank_kernel(const int* __restrict__ digits, int m,
                                 const int* __restrict__ tile_base,
                                 int* __restrict__ rank) {
  __shared__ int wcnt[WARPS][NB];
  for (int k = threadIdx.x; k < WARPS * NB; k += THREADS) {
    (&wcnt[0][0])[k] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const long long start = (long long)blockIdx.x * TILE + warp * WARP_SPAN;

  int dig[PER_THREAD];
  int loc[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const long long i = start + r * 32 + lane;
    const bool valid = i < m;
    // invalid lanes (the ragged tail) share the key -1, which no digit has
    const int d = valid ? (__ldg(digits + i) & 0xFF) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int seen = valid ? wcnt[warp][d] : 0;
    __syncwarp();
    if (valid) {
      loc[r] = seen + __popc(peers & lanemask_lt);
      if (lane == __ffs(peers) - 1) wcnt[warp][d] = seen + __popc(peers);
    }
    __syncwarp();
    dig[r] = d;
  }
  __syncthreads();

  {  // exclusive scan over warps, seeded with this tile's base
    const int d = threadIdx.x;
    int run = tile_base[(long long)blockIdx.x * NB + d];
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w][d];
      wcnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const long long i = start + r * 32 + lane;
    if (i < m) rank[i] = wcnt[warp][dig[r]] + loc[r];
  }
}

}  // namespace

extern "C" int radix_hist_tile_elems() { return TILE; }

// digits, rank: (m,) int32; hist: (256,) int32; tile_scratch: at least
// (ceil(m / TILE), 256) int32. Launches on `stream`; returns the CUDA error
// code of the launches (0 on success).
extern "C" int radix_hist_launch(const int* digits, int m, int* rank,
                                 int* hist, int* tile_scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (m + TILE - 1) / TILE;
  if (n_tiles > 0) {
    tile_count_kernel<<<n_tiles, THREADS, 0, s>>>(digits, m, tile_scratch);
  }
  tile_scan_kernel<<<1, NB, 0, s>>>(tile_scratch, n_tiles, hist);
  if (n_tiles > 0) {
    tile_rank_kernel<<<n_tiles, THREADS, 0, s>>>(digits, m, tile_scratch,
                                                 rank);
  }
  return static_cast<int>(cudaGetLastError());
}
