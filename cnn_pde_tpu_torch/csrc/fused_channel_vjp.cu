// K5: the backward of a whole MixedChannelDiffusion layer in one launch, for
// Hopper (sm_90a).
//
// Replaces: cnn_pde_tpu/ops/pallas_fused_channel_vjp.py::_bwd_call (the
// Pallas kernel built by _make_bwd_kernel, with _sweepT_nosmooth and
// pallas_fused_adi_vjp.py::_grad_r).
//
// Given the cotangent g of the layer's output, the residuals res (S, B, C,
// H, W) that K4 wrote (each step's input state) and the output, one block
// walks its tile of images through the steps in reverse.  Per step s:
//   recompute u_mix = mix . res[s], x1 = x-sweep(u_mix, t0) and, for Strang,
//     x2 = y-sweep(x1, t1), as K2 does;
//   adjoints, last sweep first (Strang: x at t2 on the step's output, y at t1
//     on x2, x at t0 on x1; Lie: y at t1 on the output, x at t0 on x1).
//     Each is lam = T^-T cot per line, then grad_r folded onto the Neumann
//     structure (2gb - ga - gc inside the line, gb - gc on the first row,
//     gb - ga on the last, with gb = -lam*x, ga[i] = -lam[i]x[i-1],
//     gc[i] = -lam[i]x[i+1]), summed over the tile's images, times dtf,
//     gated by the strict clamp mask eps < base + tc*t < cmax, and added to
//     the base gradient and, times t, to the time-coefficient gradient;
//     cot <- lam;
//   the mixing adjoint: grad_mix[k, c] += sum cot[:, k] * res[s][:, c];
//     cot <- mix^T . cot.
// Every block writes its own partial field gradients (G, C, H, W) x 4 and
// (G, C, C); the wrapper sums them over G, as the JAX code does.
//
// What bounds it.  Per element, step and image it does about three times
// the forward's work (two recompute sweeps and the mixing, three adjoint
// sweeps, the grad_r folds and the mixing adjoint) against the bytes of the
// residual and the output read once and the cotangent in and out: like K2 it
// sits near the card's flop-per-byte ratio, so bytes and f32 operations
// bound it about equally.  What bounds this first version in practice is
// parallelism: one thread per line and a small tile leave most of the card's
// thread slots empty at the flagship's batch.
//
// What the design does about it.  The tile's state never leaves shared
// memory within a step: four buffers (cot, x1, x2 and the step output or
// input) of TILE_B images' (C, H, W + 1) padded rows, so x and y lines are
// both free of bank conflicts and the y adjoint walks down the columns in
// place.  Transposed bands are read on the fly from the raw fields, as the
// forward bands are.  The sums over the tile's images run in a fixed order:
// one thread per field element loops over the images for the field
// gradients, and the C x C mixing sums reduce per warp by shuffles and then
// across warps in warp order.  No atomics, so results repeat bit for bit.
// Images past the batch are masked rather than padded.

#include <cuda_runtime.h>

#include "channel_sweep.cuh"

namespace {

using channel_sweep::Field;
using channel_sweep::kMaxC;
using channel_sweep::solve_line;

struct Tile {
  int nimg, C, H, W, ld, hw, chw;
  int tid, nthreads;
};

// Global (nimg, C, H, W) -> shared (nimg, C, H, W + 1).
__device__ void load(float* dst, const float* src, const Tile& t) {
  for (int k = t.tid; k < t.nimg * t.chw; k += t.nthreads) {
    dst[(k / t.W) * t.ld + k % t.W] = src[k];
  }
}

// u[c] <- sum_k m[c, k] u[k] per pixel, or sum_k m[k, c] u[k] when `trans`.
__device__ void mix_pixels(float* s, const float* __restrict__ mix,
                           bool trans, const Tile& t) {
  const int C = t.C;
  const int cstep = t.H * t.ld;
  for (int p = t.tid; p < t.nimg * t.hw; p += t.nthreads) {
    const int img = p / t.hw;
    const int h = (p % t.hw) / t.W;
    const int w = p % t.W;
    float* px = s + (img * C * t.H + h) * t.ld + w;
    float v[kMaxC];
    for (int k = 0; k < C; ++k) v[k] = px[k * cstep];
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
      for (int k = 0; k < C; ++k) {
        acc += __ldg(mix + (trans ? k * C + c : c * C + k)) * v[k];
      }
      px[c * cstep] = acc;
    }
  }
}

// One sweep over every line of the tile in place: along W (x) or down the
// columns along H (y); T or T^T.  One thread per line.
template <bool kT>
__device__ void sweep(float* s, Field f, bool y, float tt, float dtf,
                      float eps, float cmax, const Tile& t) {
  if (y) {
    if (t.tid < t.nimg * t.C * t.W) {
      const int w = t.tid % t.W;
      const int ic = t.tid / t.W;  // img * C + c
      solve_line<kT>(s + ic * t.H * t.ld + w, t.ld, t.H, f,
                     (long long)(ic % t.C) * t.hw + w, t.W, tt, dtf, eps,
                     cmax);
    }
  } else if (t.tid < t.nimg * t.C * t.H) {
    solve_line<kT>(s + t.tid * t.ld, 1, t.W, f,
                   (long long)(t.tid % (t.C * t.H)) * t.W, 1, tt, dtf, eps,
                   cmax);
  }
}

// The adjoint of one sweep whose output was `xo`: cot <- T^-T cot in place,
// then the clamp-gated field gradients into this block's partials.
__device__ void sweep_adjoint(float* cot, const float* xo, Field f,
                              float* gbase, float* gtc, bool y, float tt,
                              float dtf, float eps, float cmax,
                              const Tile& t) {
  sweep<true>(cot, f, y, tt, dtf, eps, cmax, t);
  __syncthreads();
  const int n = y ? t.H : t.W;
  const int step = y ? t.ld : 1;
  for (int e = t.tid; e < t.chw; e += t.nthreads) {
    const int c = e / t.hw;
    const int h = (e % t.hw) / t.W;
    const int w = e % t.W;
    const int i = y ? h : w;
    float sum = 0.0f;
    for (int img = 0; img < t.nimg; ++img) {
      const int o = ((img * t.C + c) * t.H + h) * t.ld + w;
      const float l = cot[o];
      const float gb = -l * xo[o];
      const float ga = i > 0 ? -l * xo[o - step] : 0.0f;
      const float gc = i < n - 1 ? -l * xo[o + step] : 0.0f;
      sum += i == 0 ? gb - gc : (i == n - 1 ? gb - ga : 2.0f * gb - ga - gc);
    }
    const float gfield = sum * dtf;
    const float raw = __ldg(f.base + e) + __ldg(f.tc + e) * tt;
    if (raw > eps && raw < cmax) {
      gbase[e] += gfield;
      gtc[e] += gfield * tt;
    }
  }
  __syncthreads();
}

// grad_mix[k, c] += sum over the tile's pixels of cot[k] * u[c], in a fixed
// order: per thread, then per warp by shuffles, then across warps.
__device__ void mixing_grad(const float* cot, const float* u, float* red,
                            float* gm, const Tile& t) {
  const int C = t.C;
  const int cstep = t.H * t.ld;
  float acc[kMaxC * kMaxC];
  for (int j = 0; j < C * C; ++j) acc[j] = 0.0f;
  for (int p = t.tid; p < t.nimg * t.hw; p += t.nthreads) {
    const int img = p / t.hw;
    const int h = (p % t.hw) / t.W;
    const int w = p % t.W;
    const int o = (img * C * t.H + h) * t.ld + w;
    for (int k = 0; k < C; ++k) {
      const float ck = cot[o + k * cstep];
      for (int c = 0; c < C; ++c) acc[k * C + c] += ck * u[o + c * cstep];
    }
  }
  const int lane = t.tid % 32;
  const int warp = t.tid / 32;
  for (int j = 0; j < C * C; ++j) {
    float v = acc[j];
    for (int off = 16; off > 0; off /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp * C * C + j] = v;
  }
  __syncthreads();
  if (t.tid < C * C) {
    float sum = 0.0f;
    for (int wi = 0; wi < t.nthreads / 32; ++wi) sum += red[wi * C * C + t.tid];
    gm[t.tid] += sum;
  }
  __syncthreads();
}

__global__ void fused_channel_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ res,
    const float* __restrict__ out, const float* __restrict__ alpha_base,
    const float* __restrict__ alpha_tc, const float* __restrict__ beta_base,
    const float* __restrict__ beta_tc, const float* __restrict__ mix,
    const float* __restrict__ ts, float* __restrict__ gu,
    float* __restrict__ g_ab, float* __restrict__ g_atc,
    float* __restrict__ g_bb, float* __restrict__ g_btc,
    float* __restrict__ g_mix, int B, int C, int H, int W, int tile_b,
    int num_steps, int strang, float dtf_x, float dtf_y, float eps,
    float cmax) {
  extern __shared__ float smem[];
  Tile t;
  const int img0 = blockIdx.x * tile_b;
  t.nimg = min(tile_b, B - img0);
  t.C = C;
  t.H = H;
  t.W = W;
  t.ld = W + 1;
  t.hw = H * W;
  t.chw = C * H * W;
  t.tid = threadIdx.x;
  t.nthreads = blockDim.x;
  const int buf = tile_b * C * H * t.ld;
  float* cot = smem;
  float* x1 = cot + buf;
  float* x2 = x1 + buf;
  float* other = x2 + buf;  // the step's output, then its input
  float* red = other + buf;

  // this block's partial gradients, zeroed by the threads that own them
  const long long field0 = (long long)blockIdx.x * t.chw;
  float* gab = g_ab + field0;
  float* gatc = g_atc + field0;
  float* gbb = g_bb + field0;
  float* gbtc = g_btc + field0;
  float* gm = g_mix + (long long)blockIdx.x * C * C;
  for (int e = t.tid; e < t.chw; e += t.nthreads) {
    gab[e] = 0.0f;
    gatc[e] = 0.0f;
    gbb[e] = 0.0f;
    gbtc[e] = 0.0f;
  }
  if (t.tid < C * C) gm[t.tid] = 0.0f;

  const Field alpha{alpha_base, alpha_tc};
  const Field beta{beta_base, beta_tc};
  const long long plane = (long long)B * t.chw;  // one step of res
  const long long tile0 = (long long)img0 * t.chw;
  load(cot, g + tile0, t);

  for (int s = num_steps - 1; s >= 0; --s) {
    const float* u_s = res + s * plane + tile0;
    load(x1, u_s, t);
    load(other, (s == num_steps - 1 ? out : res + (s + 1) * plane) + tile0,
         t);
    __syncthreads();
    mix_pixels(x1, mix, false, t);
    __syncthreads();
    sweep<false>(x1, alpha, false, __ldg(ts + 3 * s), dtf_x, eps, cmax, t);
    __syncthreads();
    if (strang) {
      for (int k = t.tid; k < buf; k += t.nthreads) x2[k] = x1[k];
      __syncthreads();
      sweep<false>(x2, beta, true, __ldg(ts + 3 * s + 1), dtf_y, eps, cmax,
                   t);
      __syncthreads();
      sweep_adjoint(cot, other, alpha, gab, gatc, false, __ldg(ts + 3 * s + 2),
                    dtf_x, eps, cmax, t);
      sweep_adjoint(cot, x2, beta, gbb, gbtc, true, __ldg(ts + 3 * s + 1),
                    dtf_y, eps, cmax, t);
    } else {
      sweep_adjoint(cot, other, beta, gbb, gbtc, true, __ldg(ts + 3 * s + 1),
                    dtf_y, eps, cmax, t);
    }
    sweep_adjoint(cot, x1, alpha, gab, gatc, false, __ldg(ts + 3 * s), dtf_x,
                  eps, cmax, t);
    load(other, u_s, t);
    __syncthreads();
    mixing_grad(cot, other, red, gm, t);
    mix_pixels(cot, mix, true, t);
    __syncthreads();
  }

  float* dst = gu + tile0;
  for (int k = t.tid; k < t.nimg * t.chw; k += t.nthreads) {
    dst[k] = cot[(k / W) * t.ld + k % W];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is
// not 0.  The wrapper computes the same thread count and shared memory size
// and checks them against the card's limits, with C <= 8 and H, W <= 64.
extern "C" int fused_channel_diffusion_bwd(
    const float* g, const float* res, const float* out,
    const float* alpha_base, const float* alpha_tc, const float* beta_base,
    const float* beta_tc, const float* mix, const float* ts, float* gu,
    float* g_ab, float* g_atc, float* g_bb, float* g_btc, float* g_mix,
    int B, int C, int H, int W, int tile_b, int num_steps, int strang,
    float dtf_x, float dtf_y, float eps, float cmax, void* stream) {
  const int longest = H > W ? H : W;
  const int threads = (tile_b * C * longest + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * (4 * (size_t)tile_b * C * H * (W + 1) +
                       (size_t)(threads / 32) * C * C);
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_channel_bwd_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + tile_b - 1) / tile_b);
  fused_channel_bwd_kernel<<<blocks, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      g, res, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, gu,
      g_ab, g_atc, g_bb, g_btc, g_mix, B, C, H, W, tile_b, num_steps, strang,
      dtf_x, dtf_y, eps, cmax);
  return (int)cudaGetLastError();
}
