// Tree hop distance by a binary-lifting climb, as a device function.
//
// The climb of the TPU kernel `tree_dist_pairs` (src/repro/kernels/tree_dist.py,
// body `_tree_dist_kernel`): lift the deeper endpoint to the shallower one's
// depth, then descend in lockstep from the top level to just below the LCA.
// Used by the standalone kernel (tree_dist.cu) and, as the `LiftDist` engine,
// by MARK (mark.cu) and REC (recover.cu) under use_tree_kernel=True, where no
// Euler table is built.
//
// The distance is returned as int32 with two's-complement wrap, which is what
// the plain version gives (`lca.tree_distance` in int64, then cast to int32):
// an unreachable node's depth is INT32_MAX, and a sum over two of them wraps.
// The arithmetic is done in unsigned so that the wrap is defined behaviour.
#pragma once

#include <cuda_runtime.h>

// up: (log, n) int32 row-major 2^k-th ancestors (the root loops to itself);
// depth: (n,) int32; dx, dy: depth[x], depth[y].
__device__ __forceinline__ int tree_dist_climb(const int* __restrict__ up,
                                               const int* __restrict__ depth,
                                               int log, int n, int x, int dx,
                                               int y, int dy) {
  const int ka = max(dx - dy, 0);
  const int kb = max(dy - dx, 0);
  int ca = x;
  int cb = y;
  for (int k = 0; k < log; ++k) {
    const int* row = up + (long long)k * n;
    if ((ka >> k) & 1) ca = __ldg(row + ca);
    if ((kb >> k) & 1) cb = __ldg(row + cb);
  }
  for (int k = log - 1; k >= 0; --k) {
    const int* row = up + (long long)k * n;
    const int ua = __ldg(row + ca);
    const int ub = __ldg(row + cb);
    if (ca != cb && ua != ub) {
      ca = ua;
      cb = ub;
    }
  }
  const int w = (ca == cb) ? ca : __ldg(up + ca);
  return static_cast<int>(static_cast<unsigned>(dx) +
                          static_cast<unsigned>(dy) -
                          2u * static_cast<unsigned>(__ldg(depth + w)));
}

// The lifting climb as a distance engine of the cover tests (ball_pair.cuh).
struct LiftDist {
  struct Node {
    int key;    // node id
    int depth;  // depth[node]
  };
  const int* up;
  const int* depth;
  int log;
  int n;

  __device__ __forceinline__ Node node(int a) const {
    return Node{a, __ldg(depth + a)};
  }
  __device__ __forceinline__ int dist(Node a, Node b) const {
    return tree_dist_climb(up, depth, log, n, a.key, a.depth, b.key, b.depth);
  }
};
