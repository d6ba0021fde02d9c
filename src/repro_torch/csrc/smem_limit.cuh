// The dynamic shared-memory limit of a kernel, raised once per device.
//
// A kernel that takes more than 48 KiB of dynamic shared memory needs
// cudaFuncSetAttribute before its first launch on each device. The call
// costs host time, so the launchers make it once per (kernel, device), not
// on every launch. Included by the flash attention sources
// (flash_attention*.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

// The current device in `dev`, and `kernel`'s dynamic shared-memory limit
// raised to `bytes` there unless `raised` (the kernel's own) says it was.
cudaError_t raise_smem(const void* kernel, int bytes,
                       bool (&raised)[MAX_DEVICES], int& dev) {
  dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && raised[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

}  // namespace
