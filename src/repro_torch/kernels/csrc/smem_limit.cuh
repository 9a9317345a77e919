// Per-device dynamic shared-memory limit, shared by the kernels that take
// more than the default 48 KB (flash_attention.cu, decode_attention.cu,
// ssd_scan.cu).  The attribute belongs to the device that is current when
// it is set, so it is set once per device: the Python launchers enter
// `torch.cuda.device(t.device)` before every launch, and the flag array is
// indexed by `cudaGetDevice()`.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

// Raise `fn`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device (`done` is the caller's per-kernel flag array
// of MAX_DEVICES entries).  Returns a cudaError_t.
inline int smem_limit_once(const void* fn, int bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

}  // namespace
