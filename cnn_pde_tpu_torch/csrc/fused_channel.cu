// A whole MixedChannelDiffusion forward in one launch, for Hopper (sm_90a).
//
// K2 (res == nullptr): the eval forward.  Replaces
// cnn_pde_tpu/ops/pallas_fused_channel.py::fused_channel_diffusion_fwd (the
// Pallas kernel built by _make_kernel, pallas_call at :102, with
// _abc_nosmooth, _sweep_nosmooth and pallas_fused_adi.py::_pcr_rows).
//
// K4 (res != nullptr): the trainable forward, the same kernel with one more
// output.  Before each step's mixing the block writes its images' state to
// res[step] of a (num_steps, B, C, H, W) tensor: the residuals that K5
// (fused_channel_vjp.cu) recomputes the step from.  Replaces
// cnn_pde_tpu/ops/pallas_fused_channel_vjp.py::_fwd_call (_make_fwd_kernel,
// pallas_call at :195).
//
// Per step, for each image of the block:
//   u[c] <- sum_k mix[c, k] * u[k]                      (channel mixing)
//   x-sweep at ts[s, 0], y-sweep at ts[s, 1], and for Strang a second x-sweep
//   at ts[s, 2]; each sweep solves, per line, the Neumann system
//   a = c = -r, b = 1 + 2r (1 + r on the two edge rows) + eps, with
//   r = clamp(base + time_coeff * t, eps, cmax) * dtf.
//
// What bounds it.  Bytes: the state in and out of device memory once (8
// bytes an element), K4's S residual states once more, and the fields; the
// per-image arithmetic (mixing 2C flops an element and step, a few flops an
// element and sweep) is about the card's own flop-per-byte ratio, and the
// batch-free work (the clamped coefficients, the bands and their
// factorisation) is the same for every image of the batch.  At B = 512 the
// bound is a few microseconds; K4's residuals (50 MB at B = 512 on the
// 8-step branch) are most of its bound.  What holds the kernel far above it
// is latency: each sweep's line recurrences are serial, 2N dependent steps
// an image and N reciprocals a line, and the sweeps of a layer follow one
// another.
//
// What the design does about it (channel_lines.cuh).
// - The state of the block's images stays in shared memory for all steps,
//   rows of W | 1 floats, read and written in place by x and y lines
//   without bank conflicts; device memory sees the state once in, once out
//   and, for K4, once a step as residuals.
// - The batch-free work is done once a block, not once an image: a factor
//   thread a line makes the Thomas factors of the sweep (1/denominator and
//   one multiplier a row, one reciprocal a row: the hardware's approximate
//   one refined by a Newton step), and a worker a (line, image) applies
//   them: two fmas and a product a row, no division.  The factors of the
//   next sweep are made while the workers apply the current one, into the
//   other of two buffers.
// - A warp-parallel solve (PCR, as K1 uses: a warp a line, lane = row) was
//   built first and measured on an H100: its factorisation costs about 200
//   warp instructions a line and is repeated in every block, which held K2
//   at 0.18 ms at B = 512, 2x faster than the one-thread-a-line kernel it
//   replaced and no more.  The serial factorisation is about 20x cheaper in
//   instructions and overlaps the apply.
// - Rows move through registers eight at a time, so that no row's loads wait
//   behind the previous row's stores, and the factor threads load a line's
//   coefficients together before its recurrence.
// - The wrapper (ops/fused_channel.py::plan_tiles) spreads the batch over
//   about one block an SM where the batch allows it (one image a block at
//   B <= 132, three or four at B = 512); blocks take whole images, as evenly
//   as they split.  512 threads a block: more leave 64 registers a thread
//   and spill.  The flagship's C = 3 has its own instantiation, so that the
//   mixing's loops are unrolled.
// - K4's residual stores are made by the mixing pass from the values it
//   reads anyway, and depend on nothing after them.

#include <cuda_runtime.h>

#include "channel_lines.cuh"

namespace {

using channel_lines::Field;
using channel_lines::Sweep;
using channel_lines::Tile;

constexpr int kBuffers = 1;  // image buffers: the state

// kC: the channel count at compile time (3, the flagship's), or 0 for any.
template <int kC>
__global__ void __launch_bounds__(channel_lines::kThreads, 1)
    fused_channel_kernel(const float* __restrict__ u, float* __restrict__ out,
                         const float* __restrict__ alpha_base,
                         const float* __restrict__ alpha_tc,
                         const float* __restrict__ beta_base,
                         const float* __restrict__ beta_tc,
                         const float* __restrict__ mix,
                         const float* __restrict__ ts, float* __restrict__ res,
                         int B, int C, int H, int W, int num_steps, int strang,
                         float dtf_x, float dtf_y, float eps, float cmax,
                         channel_lines::Layout l) {
  extern __shared__ float smem[];
  int first, count;
  channel_lines::block_images(B, first, count);
  const Tile t = channel_lines::make_tile(C, H, W, count);
  const long long chw = (long long)C * H * W;
  // the mixing matrix, the factor buffers, alpha's staged fields, the
  // images
  const float* m = smem;
  // sweep n's factors: at F0, or alternately F0 and the buffer after it
  float* F0 = smem + C * C;
  const int fnext = (l.nbuf - 1) * channel_lines::factor_floats(C, H, W);
  auto factors = [&](int n) { return F0 + (n & 1) * fnext; };
  float* s = smem + channel_lines::fixed_floats(C, H, W, 0, l.nbuf, l.staged);
  Field alpha, beta;
  channel_lines::stage(smem, 0, alpha_base, alpha_tc, beta_base, beta_tc, mix,
                       t, l, alpha, beta);
  channel_lines::load_rows<false>(s, u + first * chw, t, 0, blockDim.x);
  __syncthreads();

  // the first warps factor, one thread a line; the others work on images
  const int nf = channel_lines::factor_threads(C, H, W);
  const int nw = blockDim.x - nf;
  const int worker = (int)threadIdx.x - nf;
  const Sweep sx = channel_lines::sweep_of(t, false);
  const Sweep sy = channel_lines::sweep_of(t, true);
  // sweep n of the layer: step n / k, x at ts[step, 0], y at ts[step, 1]
  // and, for Strang, x at ts[step, 2]
  const int k = strang ? 3 : 2;
  const int total = num_steps * k;
  auto factor = [&](int n) {
    const int q = n % k;
    const float tt = __ldg(ts + 3 * (n / k) + q);
    if (q == 1)
      channel_lines::factor_sweep(factors(n), t, sy, false, beta, tt, dtf_y,
                                  eps, cmax);
    else
      channel_lines::factor_sweep(factors(n), t, sx, false, alpha, tt, dtf_x,
                                  eps, cmax);
  };
  auto mix_step = [&](int step) {
    channel_lines::mix_tile<false, kC>(
        s, s, t, m,
        res == nullptr ? nullptr : res + ((long long)step * B + first) * chw,
        worker, nw);
  };

  // With two factor buffers the factors of sweep n + 1 are made while sweep
  // n is applied; with one, in a phase of their own before it.
  const bool ahead = l.nbuf == 2;
  if (worker < 0) {
    if (ahead) factor(0);
  } else {
    mix_step(0);
  }
  __syncthreads();
  for (int n = 0; n < total; ++n) {
    if (!ahead) {
      if (worker < 0) factor(n);
      __syncthreads();
    }
    if (worker < 0) {
      if (ahead && n + 1 < total) factor(n + 1);
    } else {
      channel_lines::apply_sweep<false>(factors(n), s, t, n % k == 1 ? sy : sx,
                                        worker, nw);
    }
    __syncthreads();
    if (n % k == k - 1 && n + 1 < total) {
      if (worker >= 0) mix_step(n / k + 1);
      __syncthreads();
    }
  }
  channel_lines::store_rows(out + first * chw, s, t, 0, blockDim.x);
}

template <int kC>
int launch(const float* u, float* out, const float* alpha_base,
           const float* alpha_tc, const float* beta_base,
           const float* beta_tc, const float* mix, const float* ts,
           float* res, int B, int C, int H, int W, int grid,
           channel_lines::Layout l, int num_steps, int strang, float dtf_x,
           float dtf_y, float eps, float cmax, cudaStream_t stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  if (!channel_lines::valid(l)) return (int)cudaErrorInvalidValue;
  const int tile = (B + grid - 1) / grid;
  const size_t smem =
      (size_t)channel_lines::block_bytes(C, H, W, tile, kBuffers, 0, l);
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_channel_kernel<kC>, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  fused_channel_kernel<kC><<<grid, channel_lines::kThreads, smem, stream>>>(
      u, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, res, B, C, H,
      W, num_steps, strang, dtf_x, dtf_y, eps, cmax, l);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape of a plan of the wrapper (ops/fused_channel.py::
// plan_tiles), checked the first time the wrapper launches that plan:
// threads a block and bytes of shared memory a block for (C, H, W) images,
// ``tile`` a block, ``nbuf`` factor buffers and ``staged`` coefficients'
// fields in shared memory.  Beside the images a block holds the mixing
// matrix, the factor buffers and the staged fields.
extern "C" int fused_channel_layout(int C, int H, int W, int tile, int nbuf,
                                    int staged, int* threads, int* smem) {
  *threads = channel_lines::kThreads;
  *smem = (int)channel_lines::block_bytes(C, H, W, tile, kBuffers, 0,
                                          channel_lines::Layout{nbuf, staged});
  return 0;
}

// K2 (res null) and K4 (res: the (num_steps, B, C, H, W) residuals).
// ``grid``: blocks, 1 <= grid <= B; each takes B / grid images, rounded up
// or down, and ceil(B / grid) images' shared memory.  ``nbuf`` and
// ``staged``: the plan's layout.  Returns the error of the shared-memory
// opt-in or cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a layout out of range); the caller raises if it is not 0.  The wrapper
// checks C <= 8, H, W <= 64 and the shared memory.
extern "C" int fused_channel_diffusion(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* mix, const float* ts, float* res, int B, int C, int H,
    int W, int grid, int nbuf, int staged, int num_steps, int strang,
    float dtf_x, float dtf_y, float eps, float cmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const channel_lines::Layout l{nbuf, staged};
  if (C == 3)
    return launch<3>(u, out, alpha_base, alpha_tc, beta_base, beta_tc, mix,
                     ts, res, B, C, H, W, grid, l, num_steps, strang, dtf_x,
                     dtf_y, eps, cmax, s);
  return launch<0>(u, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts,
                   res, B, C, H, W, grid, l, num_steps, strang, dtf_x, dtf_y,
                   eps, cmax, s);
}
