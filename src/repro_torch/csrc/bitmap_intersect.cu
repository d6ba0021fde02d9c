// Per-row "do two bitmaps intersect": out[r] = any_k (m1[r, k] & m2[r, k]).
//
// Replaces the TPU kernel `bitmap_intersect_any`
// (src/repro/kernels/bitmap_intersect.py, body `_bitmap_kernel`), which tiles
// (block, W) uint32 rows through VMEM and does the AND and the any-reduce on
// the VPU. The words are 32-bit patterns; the sign of an int32 view does not
// matter, since only AND != 0 is asked.
//
// What bounds it: one pass over both bitmaps, 2 * 4 * L * W bytes read and
// L bytes written; the AND/OR per word is negligible. Two shapes of work:
//
//   * W < 32: one thread per row walks its W words. A warp's 32 rows are
//     32 * W consecutive words, so its loads stay within a few lines.
//   * W >= 32: one warp per row, lanes stride the row (16-byte loads when
//     W % 4 == 0 and both rows are 16-byte aligned), then __any_sync.
//
// Every word is read; there is no early exit, so the time does not depend on
// the data.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void bitmap_row_thread_kernel(const unsigned* __restrict__ m1,
                                         const unsigned* __restrict__ m2,
                                         long long l, int w,
                                         bool* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= l) return;
  const unsigned* a = m1 + r * w;
  const unsigned* b = m2 + r * w;
  unsigned acc = 0u;
  for (int k = 0; k < w; ++k) acc |= __ldg(a + k) & __ldg(b + k);
  out[r] = acc != 0u;
}

template <bool VEC4>
__global__ void bitmap_row_warp_kernel(const unsigned* __restrict__ m1,
                                       const unsigned* __restrict__ m2,
                                       long long l, int w,
                                       bool* __restrict__ out) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= l) return;  // uniform across the warp: one row per warp
  unsigned acc = 0u;
  if (VEC4) {
    const uint4* a = reinterpret_cast<const uint4*>(m1 + r * w);
    const uint4* b = reinterpret_cast<const uint4*>(m2 + r * w);
    for (int k = lane; k < w / 4; k += 32) {
      const uint4 x = __ldg(a + k);
      const uint4 y = __ldg(b + k);
      acc |= (x.x & y.x) | (x.y & y.y) | (x.z & y.z) | (x.w & y.w);
    }
  } else {
    const unsigned* a = m1 + r * w;
    const unsigned* b = m2 + r * w;
    for (int k = lane; k < w; k += 32) acc |= __ldg(a + k) & __ldg(b + k);
  }
  const bool any = __any_sync(0xffffffffu, acc != 0u);
  if (lane == 0) out[r] = any;
}

}  // namespace

// m1, m2: (l, w) 32-bit words, row-major; out: (l,) bool. `vec4` asks for
// 16-byte loads (the caller guarantees w % 4 == 0 and 16-byte alignment).
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int bitmap_intersect_launch(const unsigned* m1, const unsigned* m2,
                                       long long l, int w, int vec4,
                                       bool* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l > 0) {
    if (w < 32) {
      const long long blocks = (l + THREADS - 1) / THREADS;
      bitmap_row_thread_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(m1, m2, l,
                                                                    w, out);
    } else {
      const long long blocks = (l * 32 + THREADS - 1) / THREADS;
      if (vec4) {
        bitmap_row_warp_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
            m1, m2, l, w, out);
      } else {
        bitmap_row_warp_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
            m1, m2, l, w, out);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
