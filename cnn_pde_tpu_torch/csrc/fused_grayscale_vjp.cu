// K8: the backward of a whole GrayscaleDiffusion layer in one launch, for
// Hopper (sm_90a).
//
// Replaces: cnn_pde_tpu/ops/pallas_fused_adi_vjp.py::_bwd_call (the Pallas
// kernel built by _make_bwd_kernel, with _sweepT_rows and _grad_r).
//
// Given the cotangent g of the layer's output, the residuals res (S, B, H,
// W) that K7 wrote (each step's input state) and the output, one block
// walks its tile of images through the steps in reverse.  Per step s:
//   recompute x1 = x-sweep(res[s], t0) and x2 = y-sweep(x1, t1), as K6 does;
//     x3 is the step's output: res[s + 1], or the layer's output at S - 1;
//   adjoints, last sweep first: x at t2 on x3, y at t1 on x2, x at t0 on x1.
//     Each is lam = T^-T cot per line (the smoothed, clamped bands read on
//     the fly, transposed), then grad_r folded onto the Neumann structure
//     (2gb - ga - gc inside the line, gb - gc on the first row, gb - ga on
//     the last, with gb = -lam*x, ga[i] = -lam[i]x[i-1],
//     gc[i] = -lam[i]x[i+1]) and summed over the tile's images, times dtf;
//     then the adjoint of smooth3 along the sweep axis (the 3-tap sum with
//     zero outside the line, over 3, plus one more third of the element
//     itself on the line's two edge elements: the replicate pad), gated by
//     the one-sided clamp mask base + tc*t > eps, added to the base
//     gradient and, times t, to the time-coefficient gradient; cot <- lam.
// Every block writes its own partial field gradients (G, H, W) x 4; the
// wrapper sums them over G, as the JAX code does.
//
// What bounds it.  Per element, step and image it does about three times
// the forward's work (two recompute sweeps, three adjoint sweeps and the
// grad_r folds) against the bytes of the residuals and the output read
// once and the cotangent in and out: like K6 it sits near the card's
// flop-per-byte ratio, so bytes and f32 operations bound it about equally.
// What bounds this first version in practice is parallelism and latency:
// one thread a line and a serial Thomas chain of 28 elements, ten times five
// sweeps a step, in blocks of a few images.
//
// What the design does about it.  The tile's state never leaves shared
// memory within a step: four buffers (cot, x1, x2 and the step's output) of
// TILE_B images' (H, W + 1) padded rows, so x and y lines are both free of
// bank conflicts and the y adjoint walks down the columns in place, and one
// (H, W) buffer for the tile's grad_r field, which the smooth3 adjoint reads
// at its neighbours.  The sums over the tile's images run in a fixed order,
// one thread per field element looping over the images; each field element's
// partial is owned by one thread.  No atomics, so results repeat bit for bit.
// Images past the batch are masked rather than padded.

#include <cuda_runtime.h>

#include <cmath>

#include "channel_sweep.cuh"

namespace {

using channel_sweep::Field;
using channel_sweep::solve_line;

struct Tile {
  int nimg, H, W, ld, hw;
  int tid, nthreads;
};

// Global (nimg, H, W) -> shared (nimg, H, W + 1).
__device__ void load(float* dst, const float* src, const Tile& t) {
  for (int k = t.tid; k < t.nimg * t.hw; k += t.nthreads) {
    dst[(k / t.W) * t.ld + k % t.W] = src[k];
  }
}

// One sweep over every line of the tile in place: along W (x) or down the
// columns along H (y); T or T^T, with the coefficients smoothed along the
// line and clamped below at eps.  One thread per line.
template <bool kT>
__device__ void sweep(float* s, Field f, bool y, float tt, float dtf,
                      float eps, const Tile& t) {
  const float cmax = INFINITY;
  if (y) {
    if (t.tid < t.nimg * t.W) {
      const int w = t.tid % t.W;
      const int img = t.tid / t.W;
      solve_line<kT, true>(s + img * t.H * t.ld + w, t.ld, t.H, f, w, t.W,
                           tt, dtf, eps, cmax);
    }
  } else if (t.tid < t.nimg * t.H) {
    solve_line<kT, true>(s + t.tid * t.ld, 1, t.W, f,
                         (long long)(t.tid % t.H) * t.W, 1, tt, dtf, eps,
                         cmax);
  }
}

// The adjoint of one sweep whose output was `xo`: cot <- T^-T cot in place,
// then the tile's grad_r field into `gr`, then its smooth3 adjoint, gated,
// into this block's partials.
__device__ void sweep_adjoint(float* cot, const float* xo, float* gr,
                              Field f, float* gbase, float* gtc, bool y,
                              float tt, float dtf, float eps,
                              const Tile& t) {
  sweep<true>(cot, f, y, tt, dtf, eps, t);
  __syncthreads();
  const int n = y ? t.H : t.W;
  const int step = y ? t.ld : 1;
  for (int e = t.tid; e < t.hw; e += t.nthreads) {
    const int h = e / t.W;
    const int w = e % t.W;
    const int i = y ? h : w;
    float sum = 0.0f;
    for (int img = 0; img < t.nimg; ++img) {
      const int o = (img * t.H + h) * t.ld + w;
      const float l = cot[o];
      const float gb = -l * xo[o];
      const float ga = i > 0 ? -l * xo[o - step] : 0.0f;
      const float gc = i < n - 1 ? -l * xo[o + step] : 0.0f;
      sum += i == 0 ? gb - gc : (i == n - 1 ? gb - ga : 2.0f * gb - ga - gc);
    }
    gr[e] = sum * dtf;
  }
  __syncthreads();
  const float third = 1.0f / 3.0f;
  const int estep = y ? t.W : 1;  // the neighbour along the line in gr
  for (int e = t.tid; e < t.hw; e += t.nthreads) {
    const int i = y ? e / t.W : e % t.W;
    const float g = gr[e];
    const float left = i > 0 ? gr[e - estep] : 0.0f;
    const float right = i < n - 1 ? gr[e + estep] : 0.0f;
    float gsm = (left + g + right) * third;
    if (i == 0 || i == n - 1) gsm += g * third;
    const float raw = __ldg(f.base + e) + __ldg(f.tc + e) * tt;
    if (raw > eps) {
      gbase[e] += gsm;
      gtc[e] += gsm * tt;
    }
  }
  __syncthreads();
}

__global__ void fused_grayscale_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ res,
    const float* __restrict__ out, const float* __restrict__ alpha_base,
    const float* __restrict__ alpha_tc, const float* __restrict__ beta_base,
    const float* __restrict__ beta_tc, const float* __restrict__ ts,
    float* __restrict__ gu, float* __restrict__ g_ab,
    float* __restrict__ g_atc, float* __restrict__ g_bb,
    float* __restrict__ g_btc, int B, int H, int W, int tile_b,
    int num_steps, float dtf_x, float dtf_y, float eps) {
  extern __shared__ float smem[];
  Tile t;
  const int img0 = blockIdx.x * tile_b;
  t.nimg = min(tile_b, B - img0);
  t.H = H;
  t.W = W;
  t.ld = W + 1;
  t.hw = H * W;
  t.tid = threadIdx.x;
  t.nthreads = blockDim.x;
  const int buf = tile_b * H * t.ld;
  float* cot = smem;
  float* x1 = cot + buf;
  float* x2 = x1 + buf;
  float* x3 = x2 + buf;  // the step's output
  float* gr = x3 + buf;  // (H, W)

  // this block's partial gradients, zeroed by the threads that own them
  const long long field0 = (long long)blockIdx.x * t.hw;
  float* gab = g_ab + field0;
  float* gatc = g_atc + field0;
  float* gbb = g_bb + field0;
  float* gbtc = g_btc + field0;
  for (int e = t.tid; e < t.hw; e += t.nthreads) {
    gab[e] = 0.0f;
    gatc[e] = 0.0f;
    gbb[e] = 0.0f;
    gbtc[e] = 0.0f;
  }

  const Field alpha{alpha_base, alpha_tc};
  const Field beta{beta_base, beta_tc};
  const long long plane = (long long)B * t.hw;  // one step of res
  const long long tile0 = (long long)img0 * t.hw;
  load(cot, g + tile0, t);

  for (int s = num_steps - 1; s >= 0; --s) {
    const float t0 = __ldg(ts + 3 * s);
    const float t1 = __ldg(ts + 3 * s + 1);
    const float t2 = __ldg(ts + 3 * s + 2);
    load(x1, res + s * plane + tile0, t);
    load(x3, (s == num_steps - 1 ? out : res + (s + 1) * plane) + tile0, t);
    __syncthreads();
    sweep<false>(x1, alpha, false, t0, dtf_x, eps, t);
    __syncthreads();
    for (int k = t.tid; k < buf; k += t.nthreads) x2[k] = x1[k];
    __syncthreads();
    sweep<false>(x2, beta, true, t1, dtf_y, eps, t);
    __syncthreads();
    sweep_adjoint(cot, x3, gr, alpha, gab, gatc, false, t2, dtf_x, eps, t);
    sweep_adjoint(cot, x2, gr, beta, gbb, gbtc, true, t1, dtf_y, eps, t);
    sweep_adjoint(cot, x1, gr, alpha, gab, gatc, false, t0, dtf_x, eps, t);
  }

  float* dst = gu + tile0;
  for (int k = t.tid; k < t.nimg * t.hw; k += t.nthreads) {
    dst[k] = cot[(k / W) * t.ld + k % W];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is
// not 0.  The wrapper computes the same thread count and shared memory size
// and checks them against the card's limits, with H, W <= 64.
extern "C" int fused_grayscale_diffusion_bwd(
    const float* g, const float* res, const float* out,
    const float* alpha_base, const float* alpha_tc, const float* beta_base,
    const float* beta_tc, const float* ts, float* gu, float* g_ab,
    float* g_atc, float* g_bb, float* g_btc, int B, int H, int W,
    int tile_b, int num_steps, float dtf_x, float dtf_y, float eps,
    void* stream) {
  const int longest = H > W ? H : W;
  const int threads = (tile_b * longest + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (4 * (size_t)tile_b * H * (W + 1) +
                                       (size_t)H * W);
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_grayscale_bwd_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + tile_b - 1) / tile_b);
  fused_grayscale_bwd_kernel<<<blocks, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      g, res, out, alpha_base, alpha_tc, beta_base, beta_tc, ts, gu, g_ab,
      g_atc, g_bb, g_btc, B, H, W, tile_b, num_steps, dtf_x, dtf_y, eps);
  return (int)cudaGetLastError();
}
