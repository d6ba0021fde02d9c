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
// Design. The chain is global, so one block of 1024 threads walks it. The
// off-tree edges come in the order's sequence (compacted by the wrapper); the
// block stages 512 of them at a time (endpoints with their tour keys and
// depths, radius, group, flags), then takes chunks of 32:
//   * warp 0 classifies each edge: FULL (not crossing, dirty0 or gflag set:
//     decided by any cover), SAFE (crossing and clean, and no earlier edge of
//     its group in the chunk: only non-crossing entries can change it) or
//     MAYBE (clean, but an earlier edge of its group in the chunk may flip);
//   * the block tests every (edge, accepted entry) pair the class needs, and
//     every (earlier edge, edge) pair of the chunk;
//   * warp 0 resolves the chunk on 32-bit masks, edge by edge, with the budget
//     checked per edge, and appends the accepted edges to the buffer.
// Each accepted entry (tour keys and depths of both endpoints, radius,
// group: 24 B) goes to three places: the buffer in acceptance order (shared
// memory up to b_cap = 8192, else global memory), and either its group's
// list (global, at the group's offset: a group holds at most its own edges)
// or the list of non-crossing entries (global). When every node is
// reachable, a crossing entry of another group cannot cover a crossing edge
// (its balls lie under that group's LCA; the paper's Lemma 3.1/3.2), so a
// crossing edge is tested against the non-crossing list and its own group's
// list only (at n = 160,000, 26 M pairs instead of 240 M); a non-crossing
// edge, and every edge of a forest, against the whole buffer, as the plain
// version does. The pairs of a chunk are one flat range over its edges'
// lists (a prefix sum in warp 0), spread over the block.
//
// What bounds it: the walk's chain of chunks. Each costs three block barriers,
// warp 0's 32 resolution steps and its share of pair tests (a few dependent
// L2 loads for each pair that survives the filters). The HBM floor, the
// edges' 22 B read once and 1 B written, is far below that.

#include <cuda_runtime.h>

#include "ball_pair.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WIN = 512;            // edges staged at once
constexpr int CHUNK = 32;           // edges resolved together by warp 0
constexpr int SMEM_ENTRIES = 8192;  // buffer entries kept in shared memory
constexpr int FULL = 0, SAFE = 1, MAYBE = 2;      // an edge's class
constexpr int ALL_LIST = 0, NC_LIST = 1, GROUP_LIST = 2;  // what it scans
constexpr unsigned ALL = 0xffffffffu;

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
};

template <class E>
struct RecScratch {
  Ball<E>* buf;    // b_cap entries in acceptance order, when not in smem
  Ball<E>* lists;  // (L,) the groups' lists, group g from group_off[g]
  Ball<E>* nc;     // b_cap non-crossing entries
  int* list_len;   // (L,) entries in each group's list, zeroed
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
  __shared__ unsigned char wf[WIN];  // bit 0 crossing, 1 phase-1 accept, 2 dirty0
  __shared__ unsigned char cls[CHUNK];
  __shared__ unsigned char cov_any_s[CHUNK];
  __shared__ unsigned char cov_nc_s[CHUNK];
  __shared__ unsigned cmask[CHUNK];
  __shared__ unsigned same[CHUNK];
  __shared__ unsigned char list[CHUNK];
  __shared__ int start[CHUNK + 1];  // each edge's first pair in the chunk
  __shared__ int base[CHUNK];       // its group list's first slot
  __shared__ int s_cnt, s_nnc;
  volatile unsigned char* cov_any = cov_any_s;
  volatile unsigned char* cov_nc = cov_nc_s;
  Ball<E>* buf = a.b_cap <= SMEM_ENTRIES ? reinterpret_cast<Ball<E>*>(dyn)
                                         : sc.buf;
  const int tid = threadIdx.x;
  const bool lemma = *a.connected;
  const bool bound = lemma && a.depth_skip;
  const long long nw = *a.n_walk;
  if (tid == 0) s_nnc = 0;
  int cnt = 0;
  for (long long pos = 0; pos < nw && cnt < a.budget; pos += WIN) {
    const int w = static_cast<int>(min(static_cast<long long>(WIN), nw - pos));
    __syncthreads();  // the previous window is no longer read
    for (int t = tid; t < w; t += THREADS) {
      const int e = a.walk[pos + t];
      const bool cr = a.crossing[e];
      we[t] = e;
      wx[t] = eng.node(a.u[e]);
      wy[t] = eng.node(a.v[e]);
      wb[t] = a.beta[e];
      wg[t] = cr ? a.group[e] : -1;
      wf[t] = static_cast<unsigned char>(cr | (a.p1a[e] << 1) |
                                         (a.dirty0[e] << 2));
    }
    __syncthreads();
    for (int cb = 0; cb < w && cnt < a.budget; cb += CHUNK) {
      const int c = min(CHUNK, w - cb);
      if (tid < CHUNK) {
        const bool in = tid < c;
        const int gi = in ? wg[cb + tid] : -1;
        const int f = in ? wf[cb + tid] : 0;
        unsigned sg = 0;  // earlier crossing edges of the chunk in my group
        for (int j = 0; j < c; ++j) {
          const int gj = __shfl_sync(ALL, gi, j);
          if (j < tid && gj >= 0 && gj == gi) sg |= 1u << j;
        }
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
          base[tid] = a.group_off[gi];
          len = nnc + __ldcg(sc.list_len + gi);
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
        cov_any[tid] = 0;
        cov_nc[tid] = 0;
        cmask[tid] = 0;
      }
      __syncthreads();
      // edge i against the entries of its list: one flat range of pairs
      const int nnc = s_nnc;
      for (int p = tid; p < start[CHUNK]; p += THREADS) {
        int i = 0;  // the last edge whose range starts at or before p
        for (int step = CHUNK / 2; step > 0; step >>= 1)
          if (start[i + step] <= p) i += step;
        const int k = cls[i];
        if (k == FULL ? cov_any[i] : cov_nc[i]) continue;  // decided
        const int j = p - start[i];
        const Ball<E>* s;
        bool nc;
        if (list[i] == ALL_LIST) {
          s = buf + j;
          nc = s->group < 0;
        } else {
          nc = j < nnc;
          s = nc ? sc.nc + j : sc.lists + base[i] + (j - nnc);
        }
        if (!nc && (k == SAFE || (k == MAYBE && cov_any[i]))) continue;
        if (covers(eng, *s, wx[cb + i], wy[cb + i], bound)) {
          cov_any[i] = 1;
          if (nc) cov_nc[i] = 1;
        }
      }
      // earlier edge j of the chunk against edge i
      for (int p = tid; p < c * c; p += THREADS) {
        const int i = p / c;
        const int j = p % c;
        if (j < i &&
            covers(eng, Ball<E>{wx[cb + j], wy[cb + j], wb[cb + j], 0},
                   wx[cb + i], wy[cb + i], bound))
          atomicOr(&cmask[i], 1u << j);
      }
      __syncthreads();
      if (tid < CHUNK) {
        const bool in = tid < c;
        const int k = cls[tid];
        const int f = in ? wf[cb + tid] : 0;
        const bool ca = cov_any[tid];
        const bool cn = cov_nc[tid];
        const unsigned m = cmask[tid];
        const unsigned sg = same[tid];
        unsigned acc = 0, flip = 0, nc = 0;
        int n = cnt;
        for (int i = 0; i < c && n < a.budget; ++i) {
          const int ki = __shfl_sync(ALL, k, i);
          const int fi = __shfl_sync(ALL, f, i);
          const bool cai = __shfl_sync(ALL, ca, i);
          const bool cni = __shfl_sync(ALL, cn, i);
          const unsigned mi = __shfl_sync(ALL, m, i);
          const unsigned si = __shfl_sync(ALL, sg, i);
          const bool cr = fi & 1;
          const bool p1 = (fi >> 1) & 1;
          const bool covered = cai || (mi & acc);
          bool dec;
          if (ki == FULL) {
            dec = !covered;
          } else {
            const bool dirty = (flip & si) || cni || (mi & acc & nc);
            dec = dirty ? !covered : p1;
          }
          if (cr && dec != p1) flip |= 1u << i;
          if (dec) {
            acc |= 1u << i;
            if (!cr) nc |= 1u << i;
            ++n;
          }
        }
        if ((acc >> tid) & 1) {
          const int g = wg[cb + tid];
          const Ball<E> e{wx[cb + tid], wy[cb + tid], wb[cb + tid], g};
          a.out[we[cb + tid]] = 1;
          buf[cnt + __popc(acc & ((1u << tid) - 1))] = e;
          if (g >= 0)
            sc.lists[a.group_off[g] + atomicAdd(sc.list_len + g, 1)] = e;
          else
            sc.nc[atomicAdd(&s_nnc, 1)] = e;
        }
        if ((flip >> tid) & 1) a.gflag[wg[cb + tid]] = 1;
        if (tid == 0) s_cnt = n;
      }
      __syncthreads();
      cnt = s_cnt;
    }
  }
  if (tid == 0) *a.n_accepted = cnt;
}

// The scratch a launch needs, carved in this order: the acceptance-order
// buffer when it does not fit shared memory, the groups' lists (L entries),
// the non-crossing list (b_cap entries), the list lengths (L ints).
long long buf_bytes(int b_cap) {
  return b_cap <= SMEM_ENTRIES ? 0 : b_cap * (long long)sizeof(Ball<EulerDist>);
}

template <class E>
int run(E eng, RecArgs a, int L, void* scratch, cudaStream_t s) {
  static bool raised[MAX_DEVICES] = {false};
  int dev = 0;
  char* p = static_cast<char*>(scratch);
  RecScratch<E> sc;
  sc.buf = reinterpret_cast<Ball<E>*>(p);
  p += buf_bytes(a.b_cap);
  sc.lists = reinterpret_cast<Ball<E>*>(p);
  p += (long long)L * sizeof(Ball<E>);
  sc.nc = reinterpret_cast<Ball<E>*>(p);
  p += (long long)a.b_cap * sizeof(Ball<E>);
  sc.list_len = reinterpret_cast<int*>(p);
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(rec_kernel<E>),
                               SMEM_ENTRIES * sizeof(Ball<E>), raised, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.gflag, 0, L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.out, 0, L, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sc.list_len, 0, (long long)L * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = a.b_cap <= SMEM_ENTRIES ? a.b_cap * sizeof(Ball<E>) : 0;
  rec_kernel<E><<<1, THREADS, dyn, s>>>(eng, a, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch bytes a launch over L edges with a b_cap buffer needs.
extern "C" long long rec_scratch_bytes(int L, int b_cap) {
  return buf_bytes(b_cap) +
         ((long long)L + b_cap) * (long long)sizeof(Ball<EulerDist>) +
         (long long)L * sizeof(int);
}

// engine and t0..t4, tlog, tn as for mark_launch. walk: off-tree edge ids in
// order (int32), n_walk: 0-d int64 on the device; u, v, beta, group: (L,)
// int32 (group -1 for an edge that is not crossing); crossing, p1a, dirty0:
// (L,) bool; connected: 0-d bool; group_off: (L,) int32, the first slot of
// each group's list (an exclusive sum of the groups' edge counts); depth_skip
// as for mark_launch. Writes
// out ((L,) bool, zeroed here) and n_accepted (one int32), and uses gflag
// ((L,) bytes, zeroed here) and `scratch` (rec_scratch_bytes).
// Launches on `stream`; returns the CUDA error code of the launch.
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
                          unsigned char* out,
                          int* n_accepted, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RecArgs a{walk,      n_walk, u,         v,      beta,
                  group,     crossing, p1a,     dirty0, connected,
                  group_off, budget, b_cap,     depth_skip, gflag,
                  out,       n_accepted};
  if (engine == 0)
    return run(EulerDist{t0, t1, t2, t3, t4, tn}, a, L, scratch, s);
  return run(LiftDist{t0, t1, tlog, tn}, a, L, scratch, s);
}
