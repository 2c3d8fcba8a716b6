// Device helpers shared by the hand-written kernels.
//
// cp_async4 / cp_async_commit / cp_async_wait: 4-byte asynchronous copies
// from global to shared memory (thomas.cu, channel_lines.cuh) and the
// waits for them (also grayscale_lines.cuh's 16-byte copies).
// allow_shared_memory: the once-per-device opt-in above 48 KB (every
// kernel that asks for more).
// kMaxN, kMaxC: the longest line and the most channels the fused kernels
// take (the wrappers check both).

#pragma once

#include <cuda_runtime.h>

namespace channel_sweep {

constexpr int kMaxN = 64;
constexpr int kMaxC = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ``n`` of this thread's newest copy groups are
// pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Opt `kernel` into `smem` bytes of dynamic shared memory on the current
// device when that is above the 48 KB default, once per device for the
// largest size asked so far (`allowed` is the caller's static record).
inline cudaError_t allow_shared_memory(const void* kernel, size_t smem,
                                       size_t* allowed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[device] = smem;
  }
  return cudaSuccess;
}

}  // namespace channel_sweep
