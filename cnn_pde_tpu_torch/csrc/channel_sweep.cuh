// Device helpers shared by the hand-written kernels.
//
// solve_line: one implicit sweep line solved by the Thomas recurrence, one
// thread a line, the coefficients read and the factors formed again for
// every image; used by the grayscale kernels (fused_grayscale.cu: K6 and
// K7; fused_grayscale_vjp.cu: K8).  The channel kernels K2, K4 and K5 form
// a line's factors once a block and apply them to every image
// (channel_lines.cuh).
// The line is the Neumann system of ops/fused_channel.py::_abc_nosmooth:
// a = c = -r, b = 1 + 2r (1 + r on the two edge rows) + eps, with
// r = c * dtf and c = clamp(base + time_coeff * t, eps, cmax) read from the
// raw coefficient field and clamped on the fly.  The grayscale kernels pass
// cmax = +inf (a one-sided clamp) and kSmooth, which replaces c[i] by the
// 3-tap replicate average c[i-1]/3 + c[i]/3 + c[i+1]/3 along the line
// (c[-1] = c[0], c[n] = c[n-1]), ops/smoothing.py::smooth3.
//
// cp_async4 / cp_async_commit / cp_async_wait: 4-byte asynchronous copies
// from global to shared memory (thomas.cu, fused_channel_vjp.cu).
// allow_shared_memory: the once-per-device opt-in above 48 KB (every
// kernel that asks for more).

#pragma once

#include <cuda_runtime.h>

namespace channel_sweep {

constexpr int kMaxN = 64;
constexpr int kMaxC = 8;
constexpr int kMaxDevices = 64;

struct Field {
  const float* base;
  const float* tc;
};

// Solve one line of n elements at `line` (element stride `stride`) in place:
// T x = d, or T^T x = d when kT (sub'[i] = c[i-1] = -r[i-1], super'[i] =
// a[i+1] = -r[i+1]; the diagonal is the same).  The coefficient of element i
// sits at coef + i * cstride; with kSmooth it is averaged with its two
// neighbours along the line.
template <bool kT, bool kSmooth = false>
__device__ void solve_line(float* line, int stride, int n, Field f,
                           long long coef, int cstride, float t, float dtf,
                           float eps, float cmax) {
  float cs[kMaxN];
  auto c_at = [&](int i) {
    const long long k = coef + (long long)i * cstride;
    float v = __ldg(f.base + k) + __ldg(f.tc + k) * t;
    return fminf(fmaxf(v, eps), cmax);
  };
  auto r_at = [&](int i) {
    if constexpr (kSmooth) {
      const float third = 1.0f / 3.0f;
      const float l = c_at(i > 0 ? i - 1 : 0);
      const float r = c_at(i < n - 1 ? i + 1 : n - 1);
      return (l * third + c_at(i) * third + r * third) * dtf;
    } else {
      return c_at(i) * dtf;
    }
  };
  float r = r_at(0);                               // r[i]
  float rn = (kT && n > 1) ? r_at(1) : 0.0f;       // r[i + 1], kT only
  float bi = 1.0f + r + eps;  // row 0 is an edge row, also when n == 1
  cs[0] = (n == 1 ? 0.0f : -(kT ? rn : r)) / bi;
  float dprev = line[0] / bi;
  line[0] = dprev;
  for (int i = 1; i < n; ++i) {
    const float rp = r;                            // r[i - 1]
    if (kT) {
      r = rn;
      rn = (i + 1 < n) ? r_at(i + 1) : 0.0f;
    } else {
      r = r_at(i);
    }
    const float ai = kT ? -rp : -r;
    const float ci = (i == n - 1) ? 0.0f : (kT ? -rn : -r);
    bi = ((i == n - 1) ? 1.0f + r : 1.0f + 2.0f * r) + eps;
    const float denom = bi - ai * cs[i - 1];
    cs[i] = ci / denom;
    dprev = (line[i * stride] - ai * dprev) / denom;
    line[i * stride] = dprev;
  }
  float xnext = dprev;
  for (int i = n - 2; i >= 0; --i) {
    xnext = line[i * stride] - cs[i] * xnext;
    line[i * stride] = xnext;
  }
}

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
