// REC (the recovery replay of LGRASS, Algorithm 6) in one launch: the greedy
// over all off-tree edges in criticality order, with the tree distances
// computed where the cover decision is made.
//
// Replaces the host loop of `core/recovery._recover_scan` and, under
// use_tree_kernel=True, its launches of the TPU kernel `tree_dist_pairs`
// (src/repro/kernels/tree_dist.py, body `_tree_dist_kernel`); the engines are
// those of mark.cu. The reference runs recovery as a lax.scan inside one
// compiled program; the port's plain version syncs per fixed-point step and
// per block. Here it is one launch, and the accepted count is the only value
// the host reads back.
//
// The semantics, edge by edge in `order` (criticality desc, id asc), until
// `budget` edges are accepted: a crossing edge that is not dirty keeps its
// phase-1 decision; it is dirty when its group overflowed (dirty0), when an
// earlier decision of its group flipped (gflag), or when an accepted
// non-crossing edge covers it. Every other edge is accepted iff no accepted
// edge covers it. A crossing edge whose decision differs from phase 1's flags
// its group.
//
// Design. The chain is global, so one thread-block cluster walks it: 16
// blocks of 1024 threads on 16 SMs where the card can place them, else 8
// (the portable size). The off-tree edges come in the order's sequence
// (compacted by the wrapper). Every block stages the same 512 of them at a
// time (endpoints with their tour keys and depths, radius, group, flags) and
// takes chunks of 32; each block's warp 0 does the same work on the same
// data, so every block holds the same state without being told:
//   * warp 0 classifies each edge: FULL (not crossing, dirty0 or gflag set:
//     decided by any cover), SAFE (crossing and clean, and no earlier edge of
//     its group in the chunk: only non-crossing entries can change it) or
//     MAYBE (clean, but an earlier edge of its group in the chunk may flip);
//   * the cluster tests every (edge, accepted entry) pair the class needs,
//     and every (earlier edge, edge) pair of the chunk: one flat range of
//     pairs, cut over the cluster's 16,384 (or 8,192) threads;
//   * each block ORs its cover bits into every block's shared memory
//     (distributed shared memory, a double-buffered word per edge), then the
//     cluster meets at one barrier (barrier.cluster arrive.release /
//     wait.acquire);
//   * each block's warp 0 resolves the chunk on 32-bit masks: the edges that
//     no earlier edge of the chunk can change at once, the others in order,
//     then the cut at the edge that fills the budget; it appends the
//     accepted edges.
// Each accepted entry (tour keys and depths of both endpoints, radius,
// group: 24 B) goes to three places: the buffer in acceptance order (every
// block's own shared memory up to b_cap = 8192, written by its own warp 0,
// so that the tests, which set a chunk's time, read it without a remote
// or L2 hop; else global memory), and
// either its group's list (global, at the group's offset: a group holds at
// most its own edges) or the list of non-crossing entries (global). Every
// block writes the same values to the same global slots, and a list's length
// is written, not added to: a block reads its group lengths before it
// arrives at the chunk's barrier, and no block writes the next lengths
// before that barrier, so one barrier per chunk keeps the state exact. When
// every node is reachable, a crossing entry of another group cannot cover a
// crossing edge (its balls lie under that group's LCA; the paper's Lemma
// 3.1/3.2), so a crossing edge is tested against the non-crossing list and
// its own group's list only (at n = 160,000, 26 M pairs instead of 240 M); a
// non-crossing edge, and every edge of a forest, against the whole buffer, as
// the plain version does.
//
// What bounds it: the walk's chain of chunks, now latency on 16 SMs. At
// n = 160,000 (2,130 chunks) a chunk took ~7.0 µs on an H100 SXM at 1980 MHz
// (the kernel's phase clocks): a round of pair tests ~4.2 (per thread about
// one pair: the entry, then the distances of its pairings, a few dependent
// L2 loads), the exchange and its cluster barrier ~1.1, the classification
// and the resolution ~0.6 each, staging ~0.5. The one-block kernel before it
// took ~31 µs, 26 of them in the tests. The HBM floor, the edges' 22 B read
// once and 1 B written, is far below either.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ball_pair.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WIN = 512;            // edges staged at once
constexpr int CHUNK = 32;           // edges resolved together by warp 0
constexpr int SMEM_ENTRIES = 8192;  // buffer entries kept in shared memory
constexpr int WORDS = 2 + CHUNK;    // cover words a block sends per chunk
constexpr int FULL = 0, SAFE = 1, MAYBE = 2;      // an edge's class
constexpr int ALL_LIST = 0, NC_LIST = 1, GROUP_LIST = 2;  // what it scans
constexpr unsigned ALL = 0xffffffffu;
// the cluster sizes tried, largest first; 8 is the portable limit
constexpr int CLUSTER_SIZES[] = {16, 8};
// phase clocks of block 0's thread 0 (rec_launch's `clocks`)
enum Clock {
  CLK_STAGE, CLK_CLASSIFY, CLK_TESTS, CLK_EXCHANGE, CLK_RESOLVE, CLK_CHUNKS,
  CLK_PAIRS, CLK_TOTAL, N_CLOCKS
};

struct RecArgs {
  const int* walk;                // off-tree edge ids in order
  const long long* n_walk;        // 0-d, on the device
  const int* u;                   // (L,) endpoints, radius, group (-1: none)
  const int* v;
  const int* beta;
  const int* group;
  const unsigned char* crossing;  // (L,) bool
  const unsigned char* p1a;       // (L,) phase-1 decision per edge
  const unsigned char* dirty0;    // (L,) crossing edge of an overflowed group
  const unsigned char* connected; // 0-d: every node is reachable
  const int* group_off;           // (L,) first list slot of each group
  int budget;                     // clamped to b_cap
  int b_cap;
  int depth_skip;                 // 0 turns the depth-difference skip off
  unsigned char* gflag;           // (L,) zeroed
  unsigned char* out;             // (L,) zeroed
  int* n_accepted;                // one int32
  unsigned long long* clocks;     // N_CLOCKS sums, or null
};

template <class E>
struct RecScratch {
  Ball<E>* buf;    // b_cap entries in acceptance order, when not in smem
  Ball<E>* lists;  // (L,) the groups' lists, group g from group_off[g]
  Ball<E>* nc;     // b_cap non-crossing entries
  int* list_len;   // (L,) entries in each group's list, zeroed
};

// block 0's thread 0 adds the cycles since the last mark to clock k
struct PhaseClock {
  unsigned long long* sums;
  long long last;
  __device__ void mark(int k) {
    if (!sums) return;
    const long long t = clock64();
    atomicAdd(sums + k, static_cast<unsigned long long>(t - last));
    last = t;
  }
  __device__ void add(int k, unsigned long long n) {
    if (sums) atomicAdd(sums + k, n);
  }
};

template <class E>
__global__ void __launch_bounds__(THREADS, 1)
    rec_kernel(E eng, RecArgs a, RecScratch<E> sc) {
  using Node = typename E::Node;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Node wx[WIN];
  __shared__ Node wy[WIN];
  __shared__ int wb[WIN];
  __shared__ int wg[WIN];
  __shared__ int we[WIN];
  __shared__ int wo[WIN];  // the group's first list slot
  __shared__ unsigned char wf[WIN];  // bit 0 crossing, 1 phase-1 accept, 2 dirty0
  __shared__ unsigned char cls[CHUNK];
  __shared__ unsigned char list[CHUNK];
  __shared__ unsigned same[CHUNK];  // earlier edges of the chunk in my group
  __shared__ unsigned later[CHUNK]; // later edges of the chunk in my group
  __shared__ int glen[CHUNK];       // my group's list length before the chunk
  __shared__ int start[CHUNK + 1];  // each edge's first pair in the chunk
  // this block's cover bits: any entry, a non-crossing one, earlier edges
  __shared__ unsigned part[WORDS];
  // the cluster's cover bits, by chunk parity; every block ORs into these
  __shared__ unsigned recv[2][WORDS];
  __shared__ int s_cnt, s_nnc;
  cg::cluster_group cluster = cg::this_cluster();
  volatile unsigned* vpart = part;
  Ball<E>* buf = a.b_cap <= SMEM_ENTRIES ? reinterpret_cast<Ball<E>*>(dyn)
                                         : sc.buf;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int ctid = rank * THREADS + tid;  // thread index in the cluster
  const int cthreads = ranks * THREADS;
  const bool lemma = *a.connected;
  const bool bound = lemma && a.depth_skip;
  const long long nw = *a.n_walk;
  PhaseClock clk{rank == 0 && tid == 0 ? a.clocks : nullptr, clock64()};
  const long long t_begin = clk.last;
  if (tid == 0) s_nnc = 0;
  if (tid < 2 * WORDS) recv[tid / WORDS][tid % WORDS] = 0;
  cluster.sync();  // every block runs and its receive words are zero
  int cnt = 0, par = 0;
  for (long long pos = 0; pos < nw && cnt < a.budget; pos += WIN) {
    const int w = static_cast<int>(min(static_cast<long long>(WIN), nw - pos));
    __syncthreads();  // the previous window is no longer read
    clk.mark(CLK_RESOLVE);
    for (int t = tid; t < w; t += THREADS) {
      const int e = a.walk[pos + t];
      const bool cr = a.crossing[e];
      we[t] = e;
      wx[t] = eng.node(a.u[e]);
      wy[t] = eng.node(a.v[e]);
      wb[t] = a.beta[e];
      wg[t] = cr ? a.group[e] : -1;
      wo[t] = cr ? a.group_off[a.group[e]] : 0;
      wf[t] = static_cast<unsigned char>(cr | (a.p1a[e] << 1) |
                                         (a.dirty0[e] << 2));
    }
    __syncthreads();
    clk.mark(CLK_STAGE);
    for (int cb = 0; cb < w && cnt < a.budget; cb += CHUNK) {
      const int c = min(CHUNK, w - cb);
      if (tid < CHUNK) {
        const bool in = tid < c;
        const int gi = in ? wg[cb + tid] : -1;
        const int f = in ? wf[cb + tid] : 0;
        // edges of the chunk in my group, before and after me
        const unsigned mine = __match_any_sync(ALL, gi) & (gi >= 0 ? ALL : 0u);
        const unsigned sg = mine & ((1u << tid) - 1);
        const unsigned lt = mine & ~((2u << tid) - 1);
        const int gl = gi >= 0 ? __ldcg(sc.list_len + gi) : 0;
        int k = FULL;
        if (in && (f & 1) && !(f & 4) && !__ldcg(a.gflag + gi))
          k = sg ? MAYBE : SAFE;
        // the entries it is tested against, and how many
        const int nnc = s_nnc;
        int lk = ALL_LIST, len = cnt;
        if (k == SAFE) {
          lk = NC_LIST;
          len = nnc;
        } else if (lemma && gi >= 0) {
          lk = GROUP_LIST;
          len = nnc + gl;
        }
        if (!in) len = 0;
        int incl = len;  // inclusive prefix sum over the chunk
        for (int d = 1; d < CHUNK; d <<= 1) {
          const int o = __shfl_up_sync(ALL, incl, d);
          if (tid >= d) incl += o;
        }
        start[tid] = incl - len;
        if (tid == CHUNK - 1) start[CHUNK] = incl;
        cls[tid] = static_cast<unsigned char>(k);
        list[tid] = static_cast<unsigned char>(lk);
        same[tid] = sg;
        later[tid] = lt;
        glen[tid] = gl;
        part[2 + tid] = 0;
        if (tid < 2) part[tid] = 0;
      }
      __syncthreads();
      clk.mark(CLK_CLASSIFY);
      // edge i against the entries of its list: one flat range of pairs
      // over the cluster
      const int nnc = s_nnc;
      const int npairs = start[CHUNK];
      for (int p = ctid; p < npairs; p += cthreads) {
        int i = 0;  // the last edge whose range starts at or before p
        for (int step = CHUNK / 2; step > 0; step >>= 1)
          if (start[i + step] <= p) i += step;
        const int k = cls[i];
        const unsigned bit = 1u << i;
        if (vpart[k == FULL ? 0 : 1] & bit) continue;  // decided here
        const int j = p - start[i];
        const Ball<E>* s;
        bool nc;
        if (list[i] == ALL_LIST) {
          s = buf + j;
          nc = s->group < 0;
        } else {
          nc = j < nnc;
          s = nc ? sc.nc + j : sc.lists + wo[cb + i] + (j - nnc);
        }
        if (!nc && (k == SAFE || (k == MAYBE && (vpart[0] & bit)))) continue;
        if (covers(eng, *s, wx[cb + i], wy[cb + i], bound)) {
          atomicOr(&part[0], bit);
          if (nc) atomicOr(&part[1], bit);
        }
      }
      // earlier edge j of the chunk against edge i, from the cluster's
      // last thread down, so that no thread holds a test of each kind
      for (int p = cthreads - 1 - ctid; p < c * c; p += cthreads) {
        const int i = p / c;
        const int j = p % c;
        if (j < i &&
            covers(eng, Ball<E>{wx[cb + j], wy[cb + j], wb[cb + j], 0},
                   wx[cb + i], wy[cb + i], bound))
          atomicOr(&part[2 + i], 1u << j);
      }
      __syncthreads();
      clk.mark(CLK_TESTS);
      clk.add(CLK_PAIRS, npairs);
      // this block's bits to every block of the cluster, then the barrier
      if (tid < WORDS * ranks) {
        const unsigned word = part[tid % WORDS];
        if (word)
          atomicOr(cluster.map_shared_rank(&recv[par][tid % WORDS],
                                           tid / WORDS),
                   word);
      }
      cluster.sync();
      clk.mark(CLK_EXCHANGE);
      if (tid < CHUNK) {
        const bool in = tid < c;
        const int f = in ? wf[cb + tid] : 0;
        // the chunk as masks, bit i for edge i; the cluster's cover words
        const int k = cls[tid];
        const bool cr = f & 1, p1 = f & 2;
        const bool ca = (recv[par][0] >> tid) & 1;
        const bool cn = (recv[par][1] >> tid) & 1;
        const unsigned m = recv[par][2 + tid];
        const unsigned full = __ballot_sync(ALL, k == FULL);
        const unsigned crm = __ballot_sync(ALL, cr);
        const unsigned p1m = __ballot_sync(ALL, p1);
        const unsigned cam = recv[par][0];
        const unsigned cnm = recv[par][1];
        const unsigned sg = same[tid];
        // an edge that no earlier edge of the chunk can change is decided
        // at once: covered by an entry, or untouched by the chunk's covers
        // (and, unless FULL, by its group's flips)
        const bool ind = k == FULL ? (ca || !m) : (cn || (k == SAFE && !m));
        const bool dec0 = k == FULL ? !ca : (!cn && p1);
        unsigned acc = __ballot_sync(ALL, in && ind && dec0);
        unsigned flip = __ballot_sync(ALL, in && ind && cr && dec0 != p1);
        unsigned nc = __ballot_sync(ALL, in && ind && dec0 && !cr);
        // the others in order, every lane alike, on registers and broadcasts
        for (unsigned left = __ballot_sync(ALL, in && !ind); left;
             left &= left - 1) {
          const int i = __ffs(left) - 1;
          const unsigned bit = 1u << i;
          const unsigned mi = recv[par][2 + i];
          const bool covered = (cam & bit) || (mi & acc);
          bool dec;
          if (full & bit) {
            dec = !covered;
          } else {
            const bool dirty =
                (flip & same[i]) || (cnm & bit) || (mi & acc & nc);
            dec = dirty ? !covered : (p1m & bit) != 0;
          }
          if ((crm & bit) && dec != ((p1m & bit) != 0)) flip |= bit;
          if (dec) {
            acc |= bit;
            if (!(crm & bit)) nc |= bit;
          }
        }
        // the walk stops at the accept that fills the budget
        const int room = a.budget - cnt;
        if (__popc(acc) > room) {
          unsigned last = acc;
          for (int r = 1; r < room; ++r) last &= last - 1;
          const unsigned keep = (last & (0u - last)) * 2u - 1u;
          acc &= keep;
          flip &= keep;
          nc &= keep;
        }
        const int n = cnt + __popc(acc);
        __syncwarp();
        recv[par][2 + tid] = 0;  // for the chunk after next
        if (tid < 2) recv[par][tid] = 0;
        const unsigned below = (1u << tid) - 1;
        if ((acc >> tid) & 1) {
          const int g = wg[cb + tid];
          const Ball<E> e{wx[cb + tid], wy[cb + tid], wb[cb + tid], g};
          if (rank == 0) a.out[we[cb + tid]] = 1;
          buf[cnt + __popc(acc & below)] = e;
          if (g >= 0) {
            const int at = glen[tid] + __popc(acc & sg);
            sc.lists[wo[cb + tid] + at] = e;
            if (!(acc & later[tid])) sc.list_len[g] = at + 1;
          } else {
            sc.nc[s_nnc + __popc(acc & nc & below)] = e;
          }
        }
        if ((flip >> tid) & 1) a.gflag[wg[cb + tid]] = 1;
        __syncwarp();
        if (tid == 0) {
          s_cnt = n;
          s_nnc += __popc(nc);
        }
      }
      __syncthreads();
      clk.mark(CLK_RESOLVE);
      clk.add(CLK_CHUNKS, 1);
      cnt = s_cnt;
      par ^= 1;
    }
  }
  if (rank == 0 && tid == 0) *a.n_accepted = cnt;
  if (clk.sums) atomicAdd(clk.sums + CLK_TOTAL, clock64() - t_begin);
  cluster.sync();  // no block leaves while another may still write to it
}

// The scratch a launch needs, carved in this order: the acceptance-order
// buffer when it does not fit shared memory, the groups' lists (L entries),
// the non-crossing list (b_cap entries), the list lengths (L ints).
long long buf_bytes(int b_cap) {
  return b_cap <= SMEM_ENTRIES ? 0 : b_cap * (long long)sizeof(Ball<EulerDist>);
}

constexpr size_t MAX_DYN = SMEM_ENTRIES * sizeof(Ball<EulerDist>);

cudaLaunchConfig_t cluster_config(int blocks, size_t dyn, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster size of CLUSTER_SIZES that the card can place with
// the most dynamic shared memory a launch asks for, once per (engine,
// device); raises the kernel's shared-memory limit and allows the
// non-portable size first. A negative value is a CUDA error code; 0 means
// no size fits.
template <class E>
int cluster_size() {
  static bool raised[MAX_DEVICES] = {false};
  static int cached[MAX_DEVICES] = {0};
  const void* kernel = reinterpret_cast<const void*>(rec_kernel<E>);
  int dev = 0;
  cudaError_t err = raise_smem(kernel, MAX_DYN, raised, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < MAX_DEVICES && cached[dev]) return cached[dev];
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int size = 0;
  for (int cs : CLUSTER_SIZES) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cs, MAX_DYN, nullptr, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err == cudaSuccess && n >= 1) {
      size = cs;
      break;
    }
    cudaGetLastError();  // a size the card refuses is not a fault
  }
  if (dev < MAX_DEVICES) cached[dev] = size;
  return size;
}

template <class E>
int run(E eng, RecArgs a, int L, void* scratch, cudaStream_t s) {
  char* p = static_cast<char*>(scratch);
  RecScratch<E> sc;
  sc.buf = reinterpret_cast<Ball<E>*>(p);
  p += buf_bytes(a.b_cap);
  sc.lists = reinterpret_cast<Ball<E>*>(p);
  p += (long long)L * sizeof(Ball<E>);
  sc.nc = reinterpret_cast<Ball<E>*>(p);
  p += (long long)a.b_cap * sizeof(Ball<E>);
  sc.list_len = reinterpret_cast<int*>(p);
  const int cs = cluster_size<E>();
  if (cs < 0) return -cs;
  if (cs < 2) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cudaError_t err = cudaMemsetAsync(a.gflag, 0, L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.out, 0, L, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sc.list_len, 0, (long long)L * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = a.b_cap <= SMEM_ENTRIES ? a.b_cap * sizeof(Ball<E>) : 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cs, dyn, s, &attr);
  err = cudaLaunchKernelEx(&cfg, rec_kernel<E>, eng, a, sc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch bytes a launch over L edges with a b_cap buffer needs.
extern "C" long long rec_scratch_bytes(int L, int b_cap) {
  return buf_bytes(b_cap) +
         ((long long)L + b_cap) * (long long)sizeof(Ball<EulerDist>) +
         (long long)L * sizeof(int);
}

// The cluster size REC launches with on the current device for `engine`
// (0 Euler, 1 lifting): 16 or 8; 0 when neither fits, a negative CUDA error
// code when the query failed.
extern "C" int rec_cluster_size(int engine) {
  return engine == 0 ? cluster_size<EulerDist>() : cluster_size<LiftDist>();
}

// The number of phase clocks rec_launch adds to.
extern "C" int rec_clock_count() { return N_CLOCKS; }

// engine and t0..t4, tlog, tn as for mark_launch. walk: off-tree edge ids in
// order (int32), n_walk: 0-d int64 on the device; u, v, beta, group: (L,)
// int32 (group -1 for an edge that is not crossing); crossing, p1a, dirty0:
// (L,) bool; connected: 0-d bool; group_off: (L,) int32, the first slot of
// each group's list (an exclusive sum of the groups' edge counts); depth_skip
// as for mark_launch. Writes
// out ((L,) bool, zeroed here) and n_accepted (one int32), and uses gflag
// ((L,) bytes, zeroed here) and `scratch` (rec_scratch_bytes). clocks: null,
// or rec_clock_count() uint64 sums to which block 0's thread 0 adds the SM
// cycles of each phase (staging, classification, tests, the exchange and
// its cluster barrier, resolution), the chunks, the pairs and the whole run.
// Launches one cluster on `stream` (a cluster size below 2 is an error);
// returns the CUDA error code of the launch.
extern "C" int rec_launch(int engine, const int* t0, const int* t1,
                          const int* t2, const int* t3, const int* t4,
                          int tlog, int tn, const int* walk,
                          const long long* n_walk, const int* u, const int* v,
                          const int* beta, const int* group,
                          const unsigned char* crossing,
                          const unsigned char* p1a,
                          const unsigned char* dirty0,
                          const unsigned char* connected,
                          const int* group_off, int L, int budget,
                          int b_cap, int depth_skip, unsigned char* gflag,
                          unsigned char* out, int* n_accepted,
                          unsigned long long* clocks, void* scratch,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RecArgs a{walk,      n_walk, u,         v,      beta,
                  group,     crossing, p1a,     dirty0, connected,
                  group_off, budget, b_cap,     depth_skip, gflag,
                  out,       n_accepted, clocks};
  if (engine == 0)
    return run(EulerDist{t0, t1, t2, t3, t4, tn}, a, L, scratch, s);
  return run(LiftDist{t0, t1, tlog, tn}, a, L, scratch, s);
}
