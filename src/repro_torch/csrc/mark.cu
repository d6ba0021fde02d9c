// MARK (phase 1 of LGRASS) in two launches: the per-group greedy over the
// sorted crossing edges, with the tree distances computed where the cover
// decision is made.
//
// Replaces the host loop of `core/marking.phase1_chunked` and, under
// use_tree_kernel=True, its launches of the TPU kernel `tree_dist_pairs`
// (src/repro/kernels/tree_dist.py, body `_tree_dist_kernel`), whose climb is
// now the `LiftDist` engine (tree_dist.cuh); the default engine is the Euler
// tour's O(1) LCA (`EulerDist`, euler_lca.cuh). The reference runs phase 1 as
// a lax.scan inside one compiled program; the port's plain version makes it a
// host loop with a sync per fixed-point step. Here it is two launches with
// no host sync between them.
//
// The semantics, per group and in slot order: a slot is covered when a
// stored entry's ball pair covers it (ball_pair.cuh); an uncovered slot is
// accepted; an accepted slot is stored while the group holds fewer than k_cap
// entries, else the group overflows. Groups are independent (the paper's
// Lemma 3.1/3.2), so the decisions do not depend on how the slots are cut.
//
// Design. Two launches.
//   * The chain: a block of 1024 threads takes one group at a time from an
//     atomic counter (the group count is read on the device) and walks it in
//     chunks of 32 slots while the group holds fewer than k_cap stored
//     entries: the block tests every (slot, stored entry) and every (earlier
//     slot, slot) pair of the chunk, then warp 0 resolves the accept/store
//     chain on 32-bit masks (ballot, ffs, shfl) and appends the stored
//     slots. When the group has
//     stored k_cap entries with slots left, its entries no longer change:
//     the block publishes them to global memory, at the group's first slot
//     (a group that stores k_cap entries has at least k_cap slots, so the
//     (L,) array holds every group's entries without overlap), records where
//     the group's tail starts, and takes the next group.
//   * The tail: one thread per slot over all L slots, on the whole card;
//     a slot before its group's tail start returns at once, every other one
//     is tested alone against its group's k_cap entries, and an uncovered
//     slot is accepted and sets its group's overflow flag.
// So MARK takes its longest chain (608 slots of case3's 5,300-slot group,
// 960 of the 64,572 at n = 160,000) plus a card-wide tail, where one block
// used to walk each large group to its end. The tail is a second launch, not
// tiles that idle blocks of the chain launch take from a second queue: no
// block waits on tails that other blocks publish later, the tail's grid fits
// its slots, and stream order alone makes every group's entries visible.
//
// What bounds it: per slot, up to 4·k_cap + 4·31 tree distances of a few
// dependent L2 loads each (the tables stay in L2); the HBM floor is the
// slots' 17 B read once and the 2 B written per slot. The pace is set by
// latency: the longest chain of 32-slot chunks (a chunk's tests, then warp
// 0's resolution), then one round of the tail's k_cap tests per slot.

#include <cuda_runtime.h>

#include "ball_pair.cuh"

namespace {

constexpr int THREADS = 1024;      // a chain block
constexpr int TAIL_THREADS = 256;  // a tail block (phase1.MARK_TAIL_THREADS)
constexpr int CHAIN = 32;     // slots per chunk while the group can store
constexpr int SMEM_K = 256;   // stored entries kept in shared memory up to this
constexpr int MAX_DEVICES = 64;

struct MarkArgs {
  const int* su;               // (L,) sorted slots' endpoints and radii
  const int* sv;
  const int* sb;
  const int* group_start;      // (L,) first slot of each dense group
  const int* gidx;             // (L,) dense group of each slot
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
struct MarkScratch {
  Ball<E>* ent;     // (L,) each group's stored entries from its first slot
  int* tail_start;  // (L,) each group's first slot decided alone
};

template <class E>
__global__ void __launch_bounds__(THREADS)
    mark_chain_kernel(E eng, MarkArgs a, MarkScratch<E> sc) {
  using Node = typename E::Node;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Node sx[CHAIN];
  __shared__ Node sy[CHAIN];
  __shared__ int sb[CHAIN];
  __shared__ unsigned char cov_s[CHAIN];
  __shared__ unsigned cmask[CHAIN];
  __shared__ int s_g, s_cnt, s_ovf;
  volatile unsigned char* cov = cov_s;
  const bool in_smem = a.k_cap <= SMEM_K;
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
    Ball<E>* ent = in_smem ? reinterpret_cast<Ball<E>*>(dyn) : sc.ent + s0;
    int cnt = 0;
    int base = s0;
    for (; base < s1 && cnt < a.k_cap; base += CHAIN) {
      const int c = min(CHAIN, s1 - base);
      if (tid < c) {
        sx[tid] = eng.node(a.su[base + tid]);
        sy[tid] = eng.node(a.sv[base + tid]);
        sb[tid] = a.sb[base + tid];
        cov[tid] = 0;
        cmask[tid] = 0;
      }
      __syncthreads();
      // slot i against stored entry j; c consecutive threads share an entry
      for (int p = tid; p < c * cnt; p += THREADS) {
        const int i = p % c;
        if (!cov[i] && covers(eng, ent[p / c], sx[i], sy[i], bound))
          cov[i] = 1;
      }
      // earlier slot j of the chunk against slot i, from the block's last
      // thread down, so that few threads hold a test of each kind
      for (int p = THREADS - 1 - tid; p < c * c; p += THREADS) {
        const int i = p / c;
        const int j = p % c;
        if (j < i && covers(eng, Ball<E>{sx[j], sy[j], sb[j], 0}, sx[i],
                            sy[i], bound))
          atomicOr(&cmask[i], 1u << j);
      }
      __syncthreads();
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
    }
    // k_cap entries and slots left: the entries go out for the tail
    if (base < s1 && in_smem)
      for (int j = tid; j < a.k_cap; j += THREADS) sc.ent[s0 + j] = ent[j];
    if (tid == 0) {
      sc.tail_start[g] = base;
      if (s_ovf) a.overflow[g] = 1;
    }
  }
}

template <class E>
__global__ void __launch_bounds__(TAIL_THREADS)
    mark_tail_kernel(E eng, MarkArgs a, MarkScratch<E> sc) {
  const int s = blockIdx.x * TAIL_THREADS + threadIdx.x;
  if (s >= a.L || !a.active[s]) return;
  const int g = a.gidx[s];
  if (s < sc.tail_start[g]) return;  // decided by the chain
  const bool bound = a.depth_skip && *a.connected;
  const Ball<E>* ent = sc.ent + a.group_start[g];
  const typename E::Node x = eng.node(a.su[s]);
  const typename E::Node y = eng.node(a.sv[s]);
  for (int j = 0; j < a.k_cap; ++j)
    if (covers(eng, ent[j], x, y, bound)) return;
  a.accept[s] = 1;
  a.overflow[g] = 1;
}

template <class E>
int grid_size(int dev) {
  static int cached[MAX_DEVICES] = {0};
  if (dev < MAX_DEVICES && cached[dev]) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mark_chain_kernel<E>, THREADS, SMEM_K * sizeof(Ball<E>));
  const int grid = max(sms * max(per_sm, 1), 1);
  if (dev < MAX_DEVICES) cached[dev] = grid;
  return grid;
}

template <class E>
int run(E eng, MarkArgs a, void* scratch, cudaStream_t s) {
  MarkScratch<E> sc;
  sc.ent = static_cast<Ball<E>*>(scratch);
  sc.tail_start = reinterpret_cast<int*>(sc.ent + a.L);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.accept, 0, a.L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.overflow, 0, a.L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.work, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = a.k_cap <= SMEM_K ? a.k_cap * sizeof(Ball<E>) : 0;
  mark_chain_kernel<E><<<min(grid_size<E>(dev), a.L), THREADS, dyn, s>>>(
      eng, a, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tail_blocks = (a.L + TAIL_THREADS - 1) / TAIL_THREADS;
  mark_tail_kernel<E><<<tail_blocks, TAIL_THREADS, 0, s>>>(eng, a, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch a launch over L slots needs: the groups' published entries
// ((L,) entries) and their tail starts ((L,) int32). k_cap is not needed.
extern "C" long long mark_scratch_bytes(int L) {
  return (long long)L * ((long long)sizeof(Ball<EulerDist>) + sizeof(int));
}

// engine 0 (Euler): t0..t4 = first, table (LOGP, P), dseq, tour, depth, all
// int32, and tn = P. engine 1 (lifting): t0 = up (tlog, tn), t1 = depth.
// su, sv, sb, group_start, gidx: (L,) int32; active: (L,) bool; n_groups:
// 0-d int64 and connected: 0-d bool, both on the device; depth_skip: 0 turns
// off the depth-difference skip of ball_pair.cuh (the decisions do not
// change). Writes accept and overflow ((L,) bool) and uses `work` (one int32)
// as its group counter; all three are zeroed here. scratch:
// mark_scratch_bytes(L).
// Launches the chain and then the tail on `stream`; returns the CUDA error
// code of the launches.
extern "C" int mark_launch(int engine, const int* t0, const int* t1,
                           const int* t2, const int* t3, const int* t4,
                           int tlog, int tn, const int* su, const int* sv,
                           const int* sb, const int* group_start,
                           const int* gidx, const unsigned char* active,
                           const long long* n_groups,
                           const unsigned char* connected, int L, int k_cap,
                           int depth_skip, unsigned char* accept,
                           unsigned char* overflow, int* work, void* scratch,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0) return 0;
  const MarkArgs a{su,     sv,        sb,       group_start, gidx,
                   active, n_groups,  connected, L,          k_cap,
                   depth_skip, accept, overflow, work};
  if (engine == 0) return run(EulerDist{t0, t1, t2, t3, t4, tn}, a, scratch, s);
  return run(LiftDist{t0, t1, tlog, tn}, a, scratch, s);
}
