// A whole MixedChannelDiffusion eval forward in one launch, for Hopper (sm_90a).
//
// Replaces: cnn_pde_tpu/ops/pallas_fused_channel.py::fused_channel_diffusion_fwd
// (the Pallas kernel built by _make_kernel, with _abc_nosmooth,
// _sweep_nosmooth and pallas_fused_adi.py::_pcr_rows).
//
// Per step, for each image of the block's tile:
//   u[c] <- sum_k mix[c, k] * u[k]                      (channel mixing)
//   x-sweep at ts[s, 0], y-sweep at ts[s, 1], and for Strang a second x-sweep
//   at ts[s, 2]; each sweep solves, per line, the Neumann system
//   a = c = -r, b = 1 + 2r (1 + r on the two edge rows) + eps, with
//   r = clamp(base + time_coeff * t, eps, cmax) * dtf.
//
// What bounds it.  What every image needs is the channel mixing (2C flops an
// element and step) and, per sweep, the elimination and back-substitution
// (about 5 flops an element); the clamped coefficients, the bands and the c*
// chain are the same for every image of the batch.  Against the 8 bytes an
// element that cross device memory (the state in and out, once), an 8-step
// Strang branch at C = 3 does about 21 flops a byte, close to the card's own
// ratio (67 TFLOP/s f32 over 3.35 TB/s on an H100 SXM): bytes and operations
// bound it about equally, as long as the state stays on chip between steps.
// This kernel does more than that: each thread recomputes the batch-free
// chain for its own line and divides instead of multiplying by a shared
// reciprocal, and one thread per line leaves most of the card's thread slots
// empty, so it runs far above that bound.

// What the design does about it.  One block holds TILE_B images' state
// (C, H, W) in shared memory for all steps, rows padded to W + 1 floats so
// that both the row-wise (x) and the column-wise (y) lines are free of bank
// conflicts; the y-sweep walks down the columns in place, with no transpose.
// Each line is solved by the Thomas recurrence (O(N) work where the TPU
// kernel's PCR does O(N log N)), one thread per (image, channel, line), with
// d* written in place in shared memory and c* in a per-thread local array.
// Coefficient fields are read through the read-only cache and clamped on the
// fly, so no field is materialised.  Images past the batch are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxC = 8;
constexpr int kMaxDevices = 64;

struct Field {
  const float* base;
  const float* tc;
};

// Solve one line of n elements at `line` (element stride `stride`) in place.
// The coefficient of element i sits at coef[i * cstride].
__device__ void solve_line(float* line, int stride, int n, Field f,
                           long long coef, int cstride, float t, float dtf,
                           float eps, float cmax) {
  float cs[kMaxN];
  auto r_at = [&](int i) {
    const long long k = coef + (long long)i * cstride;
    float v = __ldg(f.base + k) + __ldg(f.tc + k) * t;
    v = fminf(fmaxf(v, eps), cmax);
    return v * dtf;
  };
  float r = r_at(0);
  float bi = 1.0f + r + eps;  // row 0 is an edge row, also when n == 1
  cs[0] = (n == 1 ? 0.0f : -r) / bi;
  float dprev = line[0] / bi;
  line[0] = dprev;
  for (int i = 1; i < n; ++i) {
    r = r_at(i);
    const float ai = -r;
    const float ci = (i == n - 1) ? 0.0f : -r;
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

__global__ void fused_channel_kernel(
    const float* __restrict__ u, float* __restrict__ out,
    const float* __restrict__ alpha_base, const float* __restrict__ alpha_tc,
    const float* __restrict__ beta_base, const float* __restrict__ beta_tc,
    const float* __restrict__ mix, const float* __restrict__ ts, int B,
    int C, int H, int W, int tile_b, int num_steps, int strang, float dtf_x,
    float dtf_y, float eps, float cmax) {
  extern __shared__ float s[];  // (tile_b, C, H, W + 1)
  const int ld = W + 1;
  const int img0 = blockIdx.x * tile_b;
  const int nimg = min(tile_b, B - img0);
  const int hw = H * W;
  const int chw = C * hw;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  const float* src = u + (long long)img0 * chw;
  for (int k = tid; k < nimg * chw; k += nthreads) {
    const int row = k / W;  // (image, c, h) flattened
    s[row * ld + k % W] = src[k];
  }
  __syncthreads();

  const Field alpha{alpha_base, alpha_tc};
  const Field beta{beta_base, beta_tc};
  const int x_lines = nimg * C * H;
  const int y_lines = nimg * C * W;

  for (int step = 0; step < num_steps; ++step) {
    // channel mixing, one thread per pixel
    for (int p = tid; p < nimg * hw; p += nthreads) {
      const int img = p / hw;
      const int h = (p % hw) / W;
      const int w = p % W;
      float* px = s + ((img * C) * H + h) * ld + w;
      const int cstep = H * ld;
      float v[kMaxC];
      for (int k = 0; k < C; ++k) v[k] = px[k * cstep];
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < C; ++k) acc += __ldg(mix + c * C + k) * v[k];
        px[c * cstep] = acc;
      }
    }
    __syncthreads();

    // x(ts[s, 0]), y(ts[s, 1]) and, for Strang, x(ts[s, 2]) again
    for (int stage = 0; stage < (strang ? 3 : 2); ++stage) {
      const float t = __ldg(ts + 3 * step + stage);
      if (stage == 1) {
        // one thread per (image, c, w) column, down the column in place
        if (tid < y_lines) {
          const int w = tid % W;
          const int ic = tid / W;  // img * C + c
          solve_line(s + ic * H * ld + w, ld, H, beta,
                     (long long)(ic % C) * hw + w, W, t, dtf_y, eps, cmax);
        }
      } else if (tid < x_lines) {
        // one thread per (image, c, h) row; tid = (img * C + c) * H + h
        solve_line(s + tid * ld, 1, W, alpha, (long long)(tid % (C * H)) * W,
                   1, t, dtf_x, eps, cmax);
      }
      __syncthreads();
    }
  }

  float* dst = out + (long long)img0 * chw;
  for (int k = tid; k < nimg * chw; k += nthreads) {
    dst[k] = s[(k / W) * ld + k % W];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is
// not 0.  The wrapper checks C <= 8, H, W <= 64 and the thread count.
extern "C" int fused_channel_diffusion(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* mix, const float* ts, int B, int C, int H, int W, int tile_b,
    int num_steps, int strang, float dtf_x, float dtf_y, float eps,
    float cmax, void* stream) {
  // Shared memory above the 48 KB default is opted into once per device, for
  // the largest size asked so far.
  static size_t smem_allowed[kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)tile_b * C * H * (W + 1);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_allowed[device]) {
    err = cudaFuncSetAttribute(fused_channel_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed[device] = smem;
  }
  const int longest = H > W ? H : W;
  const int threads = tile_b * C * longest;
  const unsigned blocks = (unsigned)((B + tile_b - 1) / tile_b);
  fused_channel_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      u, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, B, C, H, W,
      tile_b, num_steps, strang, dtf_x, dtf_y, eps, cmax);
  return (int)cudaGetLastError();
}
