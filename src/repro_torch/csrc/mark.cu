// MARK (phase 1 of LGRASS) in one launch: the per-group greedy over the
// sorted crossing edges, with the tree distances computed where the cover
// decision is made.
//
// Replaces the host loop of `core/marking.phase1_chunked` and, under
// use_tree_kernel=True, its launches of the TPU kernel `tree_dist_pairs`
// (src/repro/kernels/tree_dist.py, body `_tree_dist_kernel`), whose climb is
// now the `LiftDist` engine (tree_dist.cuh); the default engine is the Euler
// tour's O(1) LCA (`EulerDist`, euler_lca.cuh). The reference runs phase 1 as
// a lax.scan inside one compiled program; the port's plain version makes it a
// host loop with a sync per fixed-point step. Here it is one launch with no
// host sync.
//
// The semantics, per group and in slot order: a slot is covered when a
// stored entry's ball pair covers it (ball_pair.cuh); an uncovered slot is
// accepted; an accepted slot is stored while the group holds fewer than k_cap
// entries, else the group overflows. Groups are independent (the paper's
// Lemma 3.1/3.2), so the decisions do not depend on how the slots are cut.
//
// Design. A block takes one group at a time from an atomic counter (the
// group count is read on the device) and walks it in chunks:
//   * while the group can still store, chunks of 32 slots: the block tests
//     every (slot, stored entry) and every (earlier slot, slot) pair of the
//     chunk, then warp 0 resolves the accept/store chain on 32-bit masks
//     (ballot, ffs, shfl), and appends the stored slots;
//   * once k_cap entries are stored, the entries no longer change and every
//     slot is decided alone: chunks of 256 slots, one thread per slot, an
//     accept sets the overflow flag.
// Groups of one or a few slots cost a block a few hundred cycles; the large
// groups (5,300 slots at case3, 64,572 at n = 160,000) spread their pair
// tests over the block's 256 threads.
//
// What bounds it: per slot, up to 4·k_cap + 4·31 tree distances of a few
// dependent L2 loads each (the tables stay in L2); the HBM floor is the
// slots' 17 B read once and the 2 B written per slot. The latency of the
// largest group's chain of chunks sets the pace, not the bytes.

#include <cuda_runtime.h>

#include "ball_pair.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHAIN = 32;     // slots per chunk while the group can store
constexpr int SMEM_K = 256;   // stored entries kept in shared memory up to this
constexpr int MAX_DEVICES = 64;

struct MarkArgs {
  const int* su;               // (L,) sorted slots' endpoints and radii
  const int* sv;
  const int* sb;
  const int* group_start;      // (L,) first slot of each dense group
  const unsigned char* active; // (L,) slot holds a crossing edge
  const long long* n_groups;   // 0-d, on the device
  const unsigned char* connected;  // 0-d: every node is reachable
  int L;
  int k_cap;
  int depth_skip;              // 0 turns the depth-difference skip off
  unsigned char* accept;       // (L,) out, zeroed
  unsigned char* overflow;     // (L,) out, zeroed
  int* work;                   // group counter, zeroed
};

template <class E>
__global__ void __launch_bounds__(THREADS)
    mark_kernel(E eng, MarkArgs a, Ball<E>* gscratch) {
  using Node = typename E::Node;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Node sx[THREADS];
  __shared__ Node sy[THREADS];
  __shared__ int sb[THREADS];
  __shared__ unsigned char cov_s[THREADS];
  __shared__ unsigned cmask[CHAIN];
  __shared__ int s_g, s_cnt, s_ovf;
  volatile unsigned char* cov = cov_s;
  Ball<E>* ent = a.k_cap <= SMEM_K
                     ? reinterpret_cast<Ball<E>*>(dyn)
                     : gscratch + (long long)blockIdx.x * a.k_cap;
  const int tid = threadIdx.x;
  const long long ng = *a.n_groups;
  const bool bound = a.depth_skip && *a.connected;
  for (;;) {
    __syncthreads();  // the previous group is done with s_g and the tables
    if (tid == 0) {
      s_g = atomicAdd(a.work, 1);
      s_ovf = 0;
    }
    __syncthreads();
    const int g = s_g;
    if (g >= ng) break;
    const int s0 = a.group_start[g];
    const int s1 = g + 1 < a.L ? a.group_start[g + 1] : a.L;
    if (!a.active[s0]) continue;  // the tail group of non-crossing edges
    int cnt = 0;
    for (int base = s0; base < s1;) {
      const bool chain = cnt < a.k_cap;
      const int c = min(chain ? CHAIN : THREADS, s1 - base);
      if (tid < c) {
        sx[tid] = eng.node(a.su[base + tid]);
        sy[tid] = eng.node(a.sv[base + tid]);
        sb[tid] = a.sb[base + tid];
        cov[tid] = 0;
      }
      if (tid < CHAIN) cmask[tid] = 0;
      __syncthreads();
      // slot i against stored entry j; c consecutive threads share an entry
      for (int p = tid; p < c * cnt; p += THREADS) {
        const int i = p % c;
        if (!cov[i] && covers(eng, ent[p / c], sx[i], sy[i], bound))
          cov[i] = 1;
      }
      if (chain) {
        // earlier slot j of the chunk against slot i, for the chain
        for (int p = tid; p < c * c; p += THREADS) {
          const int i = p / c;
          const int j = p % c;
          if (j < i && covers(eng, Ball<E>{sx[j], sy[j], sb[j], 0}, sx[i],
                              sy[i], bound))
            atomicOr(&cmask[i], 1u << j);
        }
      }
      __syncthreads();
      if (chain) {
        if (tid < 32) {
          const bool cand = tid < c && !cov[tid];
          const unsigned m = cmask[tid];
          unsigned left = __ballot_sync(0xffffffffu, cand);
          unsigned acc = 0, stored = 0;
          int k = cnt;
          bool ovf = false;
          while (left) {
            const int i = __ffs(left) - 1;
            left &= left - 1;
            const unsigned mi = __shfl_sync(0xffffffffu, m, i);
            if (!(mi & stored)) {
              acc |= 1u << i;
              if (k < a.k_cap) {
                stored |= 1u << i;
                ++k;
              } else {
                ovf = true;
              }
            }
          }
          if ((acc >> tid) & 1) a.accept[base + tid] = 1;
          if ((stored >> tid) & 1)
            ent[cnt + __popc(stored & ((1u << tid) - 1))] =
                Ball<E>{sx[tid], sy[tid], sb[tid], 0};
          if (tid == 0) {
            s_cnt = k;
            if (ovf) s_ovf = 1;
          }
        }
        __syncthreads();
        cnt = s_cnt;
      } else if (tid < c && !cov[tid]) {
        a.accept[base + tid] = 1;
        s_ovf = 1;
      }
      base += c;
    }
    __syncthreads();
    if (tid == 0 && s_ovf) a.overflow[g] = 1;
  }
}

template <class E>
int grid_size(int dev) {
  static int cached[MAX_DEVICES] = {0};
  if (dev < MAX_DEVICES && cached[dev]) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mark_kernel<E>, THREADS, SMEM_K * sizeof(Ball<E>));
  const int grid = max(sms * max(per_sm, 1), 1);
  if (dev < MAX_DEVICES) cached[dev] = grid;
  return grid;
}

template <class E>
int blocks(int L) {
  int dev = 0;
  cudaGetDevice(&dev);
  return min(grid_size<E>(dev), max(L, 1));
}

template <class E>
int run(E eng, MarkArgs a, void* scratch, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(a.accept, 0, a.L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.overflow, 0, a.L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.work, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = a.k_cap <= SMEM_K ? a.k_cap * sizeof(Ball<E>) : 0;
  mark_kernel<E><<<blocks<E>(a.L), THREADS, dyn, s>>>(
      eng, a, static_cast<Ball<E>*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch the launch needs for its stored entries: 0 while k_cap fits
// shared memory, else k_cap entries per block. engine: 0 Euler, 1 lifting.
extern "C" long long mark_scratch_bytes(int engine, int L, int k_cap) {
  if (k_cap <= SMEM_K) return 0;
  const long long b = engine == 0 ? blocks<EulerDist>(L) : blocks<LiftDist>(L);
  return b * k_cap * (long long)sizeof(Ball<EulerDist>);
}

// engine 0 (Euler): t0..t4 = first, table (LOGP, P), dseq, tour, depth, all
// int32, and tn = P. engine 1 (lifting): t0 = up (tlog, tn), t1 = depth.
// su, sv, sb, group_start: (L,) int32; active: (L,) bool; n_groups: 0-d
// int64 and connected: 0-d bool, both on the device; depth_skip: 0 turns off
// the depth-difference skip of ball_pair.cuh (the decisions do not change).
// Writes accept and overflow ((L,) bool) and uses `work` (one int32) as its
// group counter; all three are zeroed here.
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int mark_launch(int engine, const int* t0, const int* t1,
                           const int* t2, const int* t3, const int* t4,
                           int tlog, int tn, const int* su, const int* sv,
                           const int* sb, const int* group_start,
                           const unsigned char* active,
                           const long long* n_groups,
                           const unsigned char* connected, int L, int k_cap,
                           int depth_skip, unsigned char* accept, unsigned char* overflow,
                           int* work, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0) return 0;
  const MarkArgs a{su,       sv,        sb, group_start, active,
                   n_groups, connected, L,  k_cap,       depth_skip,
                   accept,   overflow,  work};
  if (engine == 0) return run(EulerDist{t0, t1, t2, t3, t4, tn}, a, scratch, s);
  return run(LiftDist{t0, t1, tlog, tn}, a, scratch, s);
}
