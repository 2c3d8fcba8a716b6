// A whole MixedChannelDiffusion forward in one launch, for Hopper (sm_90a).
//
// K2 (res == nullptr): the eval forward.  Replaces
// cnn_pde_tpu/ops/pallas_fused_channel.py::fused_channel_diffusion_fwd (the
// Pallas kernel built by _make_kernel, with _abc_nosmooth, _sweep_nosmooth
// and pallas_fused_adi.py::_pcr_rows).
//
// K4 (res != nullptr): the trainable forward, the same kernel with one more
// output.  Before each step's mixing the block writes its images' state to
// res[step] of a (num_steps, B, C, H, W) tensor: the residuals that K5
// (fused_channel_vjp.cu) recomputes the step from.  Replaces
// cnn_pde_tpu/ops/pallas_fused_channel_vjp.py::_fwd_call (_make_fwd_kernel).
// The residual stores add S state-sized writes to the bytes K2 moves.
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

#include "channel_sweep.cuh"

namespace {

using channel_sweep::Field;
using channel_sweep::kMaxC;
using channel_sweep::solve_line;

__global__ void fused_channel_kernel(
    const float* __restrict__ u, float* __restrict__ out,
    const float* __restrict__ alpha_base, const float* __restrict__ alpha_tc,
    const float* __restrict__ beta_base, const float* __restrict__ beta_tc,
    const float* __restrict__ mix, const float* __restrict__ ts,
    float* __restrict__ res, int B, int C, int H, int W, int tile_b,
    int num_steps, int strang, float dtf_x, float dtf_y, float eps,
    float cmax) {
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
    if (res != nullptr) {  // K4: the step's input state, before mixing
      float* dst = res + ((long long)step * B + img0) * chw;
      for (int k = tid; k < nimg * chw; k += nthreads) {
        dst[k] = s[(k / W) * ld + k % W];
      }
      __syncthreads();  // the mixing below rewrites s in place
    }
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
          solve_line<false>(s + ic * H * ld + w, ld, H, beta,
                            (long long)(ic % C) * hw + w, W, t, dtf_y, eps,
                            cmax);
        }
      } else if (tid < x_lines) {
        // one thread per (image, c, h) row; tid = (img * C + c) * H + h
        solve_line<false>(s + tid * ld, 1, W, alpha,
                          (long long)(tid % (C * H)) * W, 1, t, dtf_x, eps,
                          cmax);
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
// not 0.  The wrapper checks C <= 8, H, W <= 64 and the thread count.  res
// is null for K2 and the (num_steps, B, C, H, W) residuals for K4.
extern "C" int fused_channel_diffusion(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* mix, const float* ts, float* res, int B, int C, int H,
    int W, int tile_b, int num_steps, int strang, float dtf_x, float dtf_y,
    float eps, float cmax, void* stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)tile_b * C * H * (W + 1);
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_channel_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const int longest = H > W ? H : W;
  const int threads = tile_b * C * longest;
  const unsigned blocks = (unsigned)((B + tile_b - 1) / tile_b);
  fused_channel_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      u, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, res, B, C,
      H, W, tile_b, num_steps, strang, dtf_x, dtf_y, eps, cmax);
  return (int)cudaGetLastError();
}
