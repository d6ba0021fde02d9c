// The ball-pair cover test of MARK and REC, over either distance engine.
//
// An accepted edge (u, v) with radius b covers an edge (x, y) when
//
//   (d(x, u) <= b and d(y, v) <= b) or (d(x, v) <= b and d(y, u) <= b),
//
// the predicate of `core/marking.ball_pair_table`. The engine `E` is
// EulerDist (euler_lca.cuh) or LiftDist (tree_dist.cuh); its distances and
// the comparison are those of the plain version, so every decision is too.
#pragma once

#include <cuda_runtime.h>

#include "euler_lca.cuh"
#include "tree_dist.cuh"

// An accepted edge as the cover tests read it: both endpoints with their
// tour keys and depths, the radius, and the edge's phase-1 group (-1 for an
// edge that is not crossing; MARK does not read it).
template <class E>
struct Ball {
  typename E::Node u;
  typename E::Node v;
  int b;
  int group;
};

// d(a, c) <= b. With `bound` (every node reachable: no depth is INT32_MAX
// and no distance wraps) the LCA's depth is at most either endpoint's, so
// d(a, c) >= |depth a - depth c|, and a pair whose depths differ by more than
// b is out of the ball without a load.
template <class E>
__device__ __forceinline__ bool within(const E& eng, typename E::Node a,
                                       typename E::Node c, int b,
                                       bool bound) {
  if (bound) {
    const long long dd = (long long)a.depth - c.depth;
    if (dd > b || -dd > b) return false;
  }
  return eng.dist(a, c) <= b;
}

// Whether the ball pair `s` covers the edge (x, y); `bound` as for within.
template <class E>
__device__ __forceinline__ bool covers(const E& eng, const Ball<E>& s,
                                       typename E::Node x, typename E::Node y,
                                       bool bound) {
  const bool xu = within(eng, x, s.u, s.b, bound);
  const bool xv = within(eng, x, s.v, s.b, bound);
  return (xu && within(eng, y, s.v, s.b, bound)) ||
         (xv && within(eng, y, s.u, s.b, bound));
}
