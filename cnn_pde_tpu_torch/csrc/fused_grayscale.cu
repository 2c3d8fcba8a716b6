// A whole GrayscaleDiffusion forward in one launch, for Hopper (sm_90a).
//
// K6 (res == nullptr): the eval forward.  Replaces
// cnn_pde_tpu/ops/pallas_fused_adi.py::fused_grayscale_diffusion_fwd (the
// Pallas kernel built by _make_kernel, with _sweep_rows, _smooth3_edge and
// _pcr_rows).
//
// K7 (res != nullptr): the trainable forward, the same kernel with one more
// output.  Before each step the block writes its images' state to res[step]
// of a (num_steps, B, H, W) tensor: the residuals that K8
// (fused_grayscale_vjp.cu) recomputes the step from.  Replaces
// cnn_pde_tpu/ops/pallas_fused_adi_vjp.py::_fwd_call (_make_fwd_kernel).
//
// Per Strang step, for each image of the block's tile: an x-sweep at
// ts[s, 0] with dt/2, a y-sweep at ts[s, 1] with dt, an x-sweep at ts[s, 2]
// with dt/2.  Each sweep solves, per line, the Neumann system
// a = c = -r, b = 1 + 2r (1 + r on the two edge rows) + eps with
// r = smooth3(max(base + time_coeff * t, eps)) * dtf, the smoothing running
// along the sweep axis: along W for x, down the column (along H) for y.
//
// What bounds it.  Per image only the solves depend on the data: about 5
// flops an element and sweep.  The clamped, smoothed coefficients, the bands
// and the c* chain are the same for every image of the batch; counted once
// they are a few thousand flops a step.  Against the 8 bytes an element that
// cross device memory (the state in and out, once), a 10-step layer does
// about 19 flops a byte, near the card's own ratio (67 TFLOP/s f32 over
// 3.35 TB/s): bytes and operations bound it about equally.  This kernel does
// more than that: each thread recomputes the batch-free chain (and the three
// field reads of each smoothed coefficient) for its own line and divides
// instead of multiplying by a shared reciprocal, and one thread a line keeps
// few of the card's thread slots busy, so it runs far above that bound.
//
// What the design does about it.  One block holds TILE_B images' (H, W)
// state in shared memory for the whole evolution, rows padded to W + 1
// floats so that the row-wise (x) and column-wise (y) lines are both free of
// bank conflicts; the y-sweep walks down the columns in place, with no
// transpose.  Each line is solved by the Thomas recurrence of
// channel_sweep.cuh (O(N) work where the TPU kernel's PCR does O(N log N)),
// one thread a line, with the coefficients read through the read-only cache
// and clamped and smoothed on the fly, so no field is materialised.  The
// thread count is rounded up to whole warps (28 lines an image at 28 x 28:
// 8 images make 224 threads, seven full warps).  Images past the batch are
// masked.

#include <cuda_runtime.h>

#include <cmath>

#include "channel_sweep.cuh"

namespace {

using channel_sweep::Field;
using channel_sweep::solve_line;

__global__ void fused_grayscale_kernel(
    const float* __restrict__ u, float* __restrict__ out,
    const float* __restrict__ alpha_base, const float* __restrict__ alpha_tc,
    const float* __restrict__ beta_base, const float* __restrict__ beta_tc,
    const float* __restrict__ ts, float* __restrict__ res, int B, int H,
    int W, int tile_b, int num_steps, float dtf_x, float dtf_y, float eps) {
  extern __shared__ float s[];  // (tile_b, H, W + 1)
  const float cmax = INFINITY;  // one-sided clamp: max(raw, eps)
  const int ld = W + 1;
  const int img0 = blockIdx.x * tile_b;
  const int nimg = min(tile_b, B - img0);
  const int hw = H * W;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  const float* src = u + (long long)img0 * hw;
  for (int k = tid; k < nimg * hw; k += nthreads) {
    s[(k / W) * ld + k % W] = src[k];  // row k / W = (image, h)
  }
  __syncthreads();

  const Field alpha{alpha_base, alpha_tc};
  const Field beta{beta_base, beta_tc};
  const int x_lines = nimg * H;
  const int y_lines = nimg * W;

  for (int step = 0; step < num_steps; ++step) {
    if (res != nullptr) {  // K7: the step's input state
      float* dst = res + ((long long)step * B + img0) * hw;
      for (int k = tid; k < nimg * hw; k += nthreads) {
        dst[k] = s[(k / W) * ld + k % W];
      }
      __syncthreads();  // the sweeps below rewrite s in place
    }
    for (int stage = 0; stage < 3; ++stage) {
      const float t = __ldg(ts + 3 * step + stage);
      if (stage == 1) {
        // one thread per (image, w) column, down the column in place; the
        // coefficient of row h is field[h * W + w], smoothed along h
        if (tid < y_lines) {
          const int w = tid % W;
          const int img = tid / W;
          solve_line<false, true>(s + img * H * ld + w, ld, H, beta, w, W, t,
                                  dtf_y, eps, cmax);
        }
      } else if (tid < x_lines) {
        // one thread per (image, h) row; tid = img * H + h
        solve_line<false, true>(s + tid * ld, 1, W, alpha,
                                (long long)(tid % H) * W, 1, t, dtf_x, eps,
                                cmax);
      }
      __syncthreads();
    }
  }

  float* dst = out + (long long)img0 * hw;
  for (int k = tid; k < nimg * hw; k += nthreads) {
    dst[k] = s[(k / W) * ld + k % W];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is
// not 0.  The wrapper checks H, W <= 64 and computes the same thread count
// and shared memory size against the card's limits.  res is null for K6 and
// the (num_steps, B, H, W) residuals for K7.
extern "C" int fused_grayscale_diffusion(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* ts, float* res, int B, int H, int W, int tile_b,
    int num_steps, float dtf_x, float dtf_y, float eps, void* stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)tile_b * H * (W + 1);
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_grayscale_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const int longest = H > W ? H : W;
  const int threads = (tile_b * longest + 31) / 32 * 32;
  const unsigned blocks = (unsigned)((B + tile_b - 1) / tile_b);
  fused_grayscale_kernel<<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      u, out, alpha_base, alpha_tc, beta_base, beta_tc, ts, res, B, H, W,
      tile_b, num_steps, dtf_x, dtf_y, eps);
  return (int)cudaGetLastError();
}
