// Tree hop distance by the Euler tour's O(1) range-minimum LCA, as a device
// function: the default distance engine of MARK (mark.cu) and REC
// (recover.cu).
//
// The port of `lca_euler` and `tree_distance_euler`
// (src/repro_torch/core/lca.py): for nodes a, b with first tour positions
// fa, fb, lo = min, hi = max, k = floor(log2(hi - lo + 1)); the depth minimum
// of [lo, hi] is at table[k][lo] or table[k][hi + 1 - 2^k] (the first on a
// tie), and the LCA is the tour node there. The plain loop's k (the number of
// j >= 1 with span >= 2^j, over the table's levels) is 31 - clz(span) for
// every span >= 1, because span <= P and the table has floor(log2 P) + 1
// levels.
//
// The LCA's depth is read as dseq[w] (the depth along the tour) where w is a
// real tour position, which saves two dependent loads. Past the tour's end
// dseq is INT32_MAX; there (both nodes off the root's component) the plain
// version reads depth[tour[w]], and so does this one. The sum wraps to int32
// as the plain version's (and the reference's) does: unreachable depths are
// INT32_MAX. It is done in unsigned so that the wrap is defined behaviour.
#pragma once

#include <cuda_runtime.h>

struct EulerDist {
  struct Node {
    int key;    // first tour position of the node
    int depth;  // depth[node]
  };
  const int* first;  // (n,)
  const int* table;  // (LOGP, P) row-major
  const int* dseq;   // (P,)
  const int* tour;   // (P,)
  const int* depth;  // (n,)
  int P;

  __device__ __forceinline__ Node node(int a) const {
    return Node{__ldg(first + a), __ldg(depth + a)};
  }
  __device__ __forceinline__ int dist(Node a, Node b) const {
    const int lo = min(a.key, b.key);
    const int hi = max(a.key, b.key);
    const int k = 31 - __clz(hi - lo + 1);
    const int* row = table + (long long)k * P;
    const int i1 = __ldg(row + lo);
    const int i2 = __ldg(row + hi + 1 - (1 << k));
    const int d1 = __ldg(dseq + i1);
    const int d2 = __ldg(dseq + i2);
    const int w = d2 < d1 ? i2 : i1;
    int dl = d2 < d1 ? d2 : d1;
    if (dl == 0x7fffffff) dl = __ldg(depth + __ldg(tour + w));
    return static_cast<int>(static_cast<unsigned>(a.depth) +
                            static_cast<unsigned>(b.depth) -
                            2u * static_cast<unsigned>(dl));
  }
};
