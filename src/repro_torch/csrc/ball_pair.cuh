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

// |depth a - depth c| <= b: with `bound` (every node reachable: no depth
// is INT32_MAX and no distance wraps) the LCA's depth is at most either
// endpoint's, so d(a, c) >= |depth a - depth c|, and a pair whose depths
// differ by more than b is out of the ball without a load.
template <class E>
__device__ __forceinline__ bool within_depth(typename E::Node a,
                                             typename E::Node c, int b) {
  const long long dd = (long long)a.depth - c.depth;
  return dd <= b && -dd <= b;
}

// Whether the ball pair `s` covers the edge (x, y). With `bound` (as for
// within_depth) the depth test rules a pairing out first; the distances of
// the pairings left are then all computed, so that their loads are in flight
// together rather than one ball after another.
template <class E>
__device__ __forceinline__ bool covers(const E& eng, const Ball<E>& s,
                                       typename E::Node x, typename E::Node y,
                                       bool bound) {
  const bool p1 = !bound || (within_depth<E>(x, s.u, s.b) &&
                              within_depth<E>(y, s.v, s.b));
  const bool p2 = !bound || (within_depth<E>(x, s.v, s.b) &&
                              within_depth<E>(y, s.u, s.b));
  if (!p1 && !p2) return false;
  if (p1 && p2) {
    const int xu = eng.dist(x, s.u), yv = eng.dist(y, s.v);
    const int xv = eng.dist(x, s.v), yu = eng.dist(y, s.u);
    return (xu <= s.b && yv <= s.b) || (xv <= s.b && yu <= s.b);
  }
  const typename E::Node a = p1 ? s.u : s.v;
  const typename E::Node c = p1 ? s.v : s.u;
  const int xa = eng.dist(x, a), yc = eng.dist(y, c);
  return xa <= s.b && yc <= s.b;
}
