// K5: the backward of a whole MixedChannelDiffusion layer, for Hopper
// (sm_90a): one kernel that walks each block's images through the steps in
// reverse, and a second small one that sums the blocks' partial parameter
// gradients in a fixed order; both launched by one C call.
//
// Replaces: cnn_pde_tpu/ops/pallas_fused_channel_vjp.py::_bwd_call (the
// Pallas kernel built by _make_bwd_kernel, pallas_call at :233, with
// _sweepT_nosmooth and pallas_fused_adi_vjp.py::_grad_r).
//
// Given the cotangent g of the layer's output, the residuals res (S, B, C,
// H, W) that K4 wrote (each step's input state) and the output, per step s
// from the last:
//   recompute u_mix = mix . res[s], x1 = x-sweep(u_mix, t0) and, for Strang,
//     x2 = y-sweep(x1, t1), as K2 does;
//   adjoints, last sweep first (Strang: x at t2 on the step's output, y at t1
//     on x2, x at t0 on x1; Lie: y at t1 on the output, x at t0 on x1).
//     Each is lam = T^-T cot per line, then grad_r folded onto the Neumann
//     structure (2gb - ga - gc inside the line, gb - gc on the first row,
//     gb - ga on the last, with gb = -lam*x, ga[i] = -lam[i]x[i-1],
//     gc[i] = -lam[i]x[i+1]), summed over the block's images, times dtf,
//     gated by the strict clamp mask eps < base + tc*t < cmax, and added to
//     the base gradient and, times t, to the time-coefficient gradient;
//     cot <- lam;
//   the mixing adjoint: grad_mix[k, c] += sum cot[:, k] * res[s][:, c];
//     cot <- mix^T . cot.
//
// What bounds it.  Bytes: g, the output and the S residuals read once,
// grad u written once, the fields and their gradients; the per-image work
// (two recompute sweeps, three adjoint sweeps with their grad_r folds, the
// mixing and its adjoint) is a few tens of flops an element and step, about
// the card's flop-per-byte ratio; the batch-free work (coefficients, bands
// and the factorisation of five systems a step) is the same for every
// image of the batch.  As for K2, the serial line recurrences and the
// sequence of sweeps, not bytes or flops, set the time.
//
// What the design does about it (channel_lines.cuh).
// - Three buffers of the block's images in shared memory, rows of W | 1
//   floats: the cotangent, the recomputed state x and a residual buffer
//   that holds the step's output (res[s+1], or the layer's output) for the
//   first adjoint and is then refilled with res[s] by cp.async, behind the
//   y adjoint, for the recomputation of x1 and the mixing adjoint (and so
//   holds the next step's output).  res[s-1] comes into x behind the mixing
//   adjoint.  For Strang x holds x1, then x2 = y-sweep(x1) in place for the
//   y adjoint, then x1 again from res[s]: one more mixing and x-sweep a step
//   in place of a fourth buffer, which would halve the images a block.
// - Every sweep and adjoint is factored once a block by the factor threads
//   (the adjoint on the transposed bands lower'[i] = c[i-1], upper'[i] =
//   a[i+1]) and applied by the workers, a (line, image) each, as in K2; a
//   sweep's factors are made during the phases before it, into the other of
//   two buffers where two fit (one, and a phase of their own, otherwise).
// - Field gradients stay in registers.  alpha's come only from x-adjoints
//   and beta's only from y-adjoints, and a worker owns the same field
//   elements in every step: it folds grad_r from lam and x in shared memory,
//   sums over the block's images in image order, gates, and accumulates in
//   registers across all steps (its first kRegElems elements; a shape with
//   more accumulates the rest in the block's partials in device memory, the
//   same owner each step).
// - The mixing gradient: each worker warp sums cot[k] u[c] over its pixels,
//   per step, by shuffles into its own C x C slot in shared memory; the
//   slots are added in warp order once, at the end.
// - Each block writes one partial per field element and gradient (4 C H W)
//   and C*C for the mixing, once, into a scratch the wrapper allocates; the
//   second kernel sums them over blocks in a fixed order (eight interleaved
//   slices, then the slices in order), as K3's sum_partials does.  No
//   atomics: two runs on the same inputs give the same bits.

#include <cuda_runtime.h>

#include "channel_lines.cuh"

namespace {

using channel_lines::Field;
using channel_lines::Sweep;
using channel_lines::Tile;

constexpr int kBuffers = 3;   // image buffers: cotangent, state, residual
constexpr int kRegElems = 8;  // field elements a worker holds in registers

// Floats of the workers' (warps, C, C) mixing-gradient slots.
__host__ __device__ __forceinline__ int slot_floats(int C, int H, int W) {
  const int nw =
      channel_lines::kThreads - channel_lines::factor_threads(C, H, W);
  return nw / 32 * C * C;
}

// Workers: the field gradient of one element of a sweep whose output was
// xo, from lam in cot: its word o in an image buffer, its row i along the
// sweep's line and e in the (C, H, W) field.  grad_r folded onto the
// Neumann rows (2gb - ga - gc inside the line, gb - gc on its first row,
// gb - ga on its last; gb = -lam x, ga = -lam x[i-1], gc = -lam x[i+1])
// summed over the block's images in image order, times dtf; ``on``: the
// strict clamp gate eps < raw < cmax at time tt.
__device__ __forceinline__ float element_grad(const float* cot,
                                              const float* xo, const Tile& t,
                                              bool y, const Field f, float tt,
                                              float dtf, float eps,
                                              float cmax, int o, int i, int e,
                                              bool& on) {
  const int n = y ? t.H : t.W;
  const int st = y ? t.ld : 1;
  float sum = 0.0f;
  for (int g = 0; g < t.nimg; ++g) {
    const int og = g * t.img + o;
    const float l = cot[og];
    const float gb = -l * xo[og];
    const float ga = i > 0 ? -l * xo[og - st] : 0.0f;
    const float gc = i + 1 < n ? -l * xo[og + st] : 0.0f;
    sum += i == 0 ? gb - gc : (i == n - 1 ? gb - ga : 2.0f * gb - ga - gc);
  }
  const int fe = f.staged ? o : e;
  const float raw = f.base[fe] + f.tc[fe] * tt;
  on = raw > eps && raw < cmax;
  return sum * dtf;
}

// Workers: call fn(k, o, i, e) for the k-th field element (c, h, w) of a
// worker: o its word in an image buffer, i its row along the sweep (y: h,
// x: w), e its index in a (C, H, W) field.  Worker wi*W + w takes column w
// of rows c*H + h = wi, wi + R, ..., R = nw / W rows at a time, with no
// division per element; the same elements each call.
template <typename Fn>
__device__ __forceinline__ void for_elements(const Tile& t, bool y,
                                             int worker, int nw, Fn&& fn) {
  const int R = nw / t.W;
  const int wi = worker / t.W;
  if (wi >= R) return;
  const int w = worker - wi * t.W;
  int h = wi;
  while (h >= t.H) h -= t.H;
  int k = 0;
  for (int r = wi; r < t.C * t.H; r += R, ++k) {
    fn(k, r * t.ld + w, y ? h : w, r * t.W + w);
    h += R;
    while (h >= t.H) h -= t.H;
  }
}

// Workers: the gated field gradients of a sweep's adjoint added to the
// base and, times tt, to the time-coefficient gradient: in registers (acc)
// for a worker's first kRegElems elements, in the block's partials gpart
// (base at e, time coefficient at chw + e) beyond them.
__device__ __forceinline__ void grad_pass(const float* cot, const float* xo,
                                          const Tile& t, bool y,
                                          const Field f, float tt, float dtf,
                                          float eps, float cmax,
                                          float (&acc)[kRegElems][2],
                                          float* gpart, int worker, int nw) {
  const int chw = t.C * t.hw;
  for_elements(t, y, worker, nw, [&](int k, int o, int i, int e) {
    bool on;
    const float gf =
        element_grad(cot, xo, t, y, f, tt, dtf, eps, cmax, o, i, e, on);
    if (!on) return;
    if (k < kRegElems) {
#pragma unroll
      for (int q = 0; q < kRegElems; ++q) {
        if (q == k) {
          acc[q][0] += gf;
          acc[q][1] += gf * tt;
        }
      }
    } else {
      gpart[e] += gf;
      gpart[chw + e] += gf * tt;
    }
  });
}

// Workers: the mixing adjoint at every pixel of the block's images, u the
// step's input state: grad_mix[k, c] += sum cot[k] u[c] over the warp's
// pixels, reduced by shuffles into the warp's C x C slot mg; then
// cot <- m^T cot (channel_lines::mix_tile, the same pixels a worker).  With
// kC the C*C sums are made in registers in one pass over the pixels, else
// in one pass a (k, c).
template <int kC>
__device__ __forceinline__ void mix_adjoint(float* cot, const float* u,
                                            const Tile& t, const float* m,
                                            float* mg, int worker, int nw) {
  const int C = kC > 0 ? kC : t.C;
  const int cstep = t.H * t.ld;
  const int lane = threadIdx.x & 31;
  float* slot = mg + (worker >> 5) * C * C;
  if constexpr (kC > 0) {
    float acc[kC * kC];
#pragma unroll
    for (int kc = 0; kc < kC * kC; ++kc) acc[kc] = 0.0f;
    channel_lines::for_pixels(t, worker, nw, [&](int o, int, int, int) {
      float ck[kC], uc[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        ck[k] = cot[o + k * cstep];
        uc[k] = u[o + k * cstep];
      }
#pragma unroll
      for (int k = 0; k < kC; ++k)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[k * kC + c] += ck[k] * uc[c];
    });
#pragma unroll
    for (int kc = 0; kc < kC * kC; ++kc) {
      float v = acc[kc];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) slot[kc] += v;
    }
  } else {
    for (int kc = 0; kc < C * C; ++kc) {
      const int k = kc / C;
      const int c = kc - k * C;
      float v = 0.0f;
      channel_lines::for_pixels(t, worker, nw, [&](int o, int, int, int) {
        v += cot[o + k * cstep] * u[o + c * cstep];
      });
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) slot[kc] += v;
    }
  }
  channel_lines::mix_tile<true, kC>(cot, cot, t, m, nullptr, worker, nw);
}

// The sweeps of one step, in the order the backward runs them: for Strang
// (0) x at t0 and (1) y at t1 recomputing x1 and x2 from the step's input,
// (2) the x adjoint at t2, (3) the y adjoint at t1, (4) x at t0 again,
// recomputing x1, (5) the x adjoint at t0; for Lie (0) x at t0, (1) the y
// adjoint at t1, (2) the x adjoint at t0.  ``time``: the column of ts.
struct StepSweep {
  bool y, adjoint;
  int time;
};

__device__ __forceinline__ StepSweep step_sweep(bool strang, int q) {
  if (strang)
    return StepSweep{q == 1 || q == 3, q == 2 || q == 3 || q == 5,
                     q == 2 ? 2 : (q == 1 || q == 3 ? 1 : 0)};
  return StepSweep{q == 1, q > 0, q == 1 ? 1 : 0};
}

// kC: the channel count at compile time (3, the flagship's), or 0 for any.
template <int kC>
__global__ void __launch_bounds__(channel_lines::kThreads, 1)
    fused_channel_bwd_kernel(
        const float* __restrict__ g, const float* __restrict__ res,
        const float* __restrict__ out, const float* __restrict__ alpha_base,
        const float* __restrict__ alpha_tc,
        const float* __restrict__ beta_base,
        const float* __restrict__ beta_tc, const float* __restrict__ mix,
        const float* __restrict__ ts, float* __restrict__ gu,
        float* __restrict__ partials, int B, int C, int H, int W,
        int num_steps, int strang, float dtf_x, float dtf_y, float eps,
        float cmax, channel_lines::Layout l) {
  extern __shared__ float smem[];
  int first, count;
  channel_lines::block_images(B, first, count);
  const Tile t = channel_lines::make_tile(C, H, W, count);
  const int tile = (B + gridDim.x - 1) / gridDim.x;
  const int chw = C * t.hw;
  // the first warps factor, one thread a line; the others work on images
  const int nf = channel_lines::factor_threads(C, H, W);
  const int nw = blockDim.x - nf;
  const int worker = (int)threadIdx.x - nf;
  // the mixing matrix, the workers' (warps, C, C) mixing-gradient slots,
  // the factor buffers, alpha's staged fields, then the image buffers
  const int extra = slot_floats(C, H, W);
  const float* m = smem;
  float* mg = smem + C * C;
  // sweep n's factors: at F0, or alternately F0 and the buffer after it
  float* F0 = mg + extra;
  const int fnext = (l.nbuf - 1) * channel_lines::factor_floats(C, H, W);
  auto factors = [&](int n) { return F0 + (n & 1) * fnext; };
  float* cot =
      smem + channel_lines::fixed_floats(C, H, W, extra, l.nbuf, l.staged);
  float* x = cot + tile * t.img;   // the recomputed state: x1, then x2
  float* ures = x + tile * t.img;  // the step's output, then its input

  // this block's partials: (4, C, H, W) field gradients, then (C, C)
  float* part = partials + (long long)blockIdx.x * (4 * chw + C * C);
  for (int e = threadIdx.x; e < 4 * chw + C * C; e += blockDim.x)
    part[e] = 0.0f;
  for (int e = threadIdx.x; e < extra; e += blockDim.x) mg[e] = 0.0f;
  float acc_a[kRegElems][2], acc_b[kRegElems][2];
#pragma unroll
  for (int k = 0; k < kRegElems; ++k)
    acc_a[k][0] = acc_a[k][1] = acc_b[k][0] = acc_b[k][1] = 0.0f;

  const long long plane = (long long)B * chw;  // one step of res
  const long long tile0 = (long long)first * chw;
  Field alpha, beta;
  channel_lines::stage(smem, extra, alpha_base, alpha_tc, beta_base, beta_tc,
                       mix, t, l, alpha, beta);
  channel_lines::load_rows<true>(cot, g + tile0, t, nf, nw);
  channel_lines::load_rows<true>(ures, out + tile0, t, nf, nw);
  channel_lines::load_rows<true>(x, res + (num_steps - 1) * plane + tile0, t,
                                 nf, nw);
  channel_sweep::cp_async_commit();
  channel_sweep::cp_async_wait<0>();
  __syncthreads();

  const Sweep sx = channel_lines::sweep_of(t, false);
  const Sweep sy = channel_lines::sweep_of(t, true);
  const int k = strang ? 6 : 3;  // sweeps a step
  const int total = num_steps * k;
  // Sweep n runs in step num_steps - 1 - n / k.  Its factors go to factors(n)
  // once sweep n - nbuf has been applied: each phase, the factor threads
  // make the next ones that may be made while the workers do the phase's
  // work.  A phase ends with the workers' copies waited for (``wait``) and
  // a barrier.
  int applied = 0, factored = 0;
  auto may_factor = [&] {
    return factored < total && factored < applied + l.nbuf;
  };
  auto phase = [&](bool wait, auto&& work) {
    if (worker < 0) {
      if (may_factor()) {
        const int n = factored;
        const StepSweep q = step_sweep(strang, n % k);
        const float tt = __ldg(ts + 3 * (num_steps - 1 - n / k) + q.time);
        channel_lines::factor_sweep(factors(n), t, q.y ? sy : sx, q.adjoint,
                                    q.y ? beta : alpha, tt,
                                    q.y ? dtf_y : dtf_x, eps, cmax);
      }
    } else {
      work();
      if (wait) channel_sweep::cp_async_wait<0>();
    }
    if (may_factor()) ++factored;
    __syncthreads();
  };
  // Workers start copying res[step] into buf.
  auto fetch = [&](float* buf, int step) {
    channel_lines::load_rows<true>(buf, res + step * plane + tile0, t, nf,
                                   nw);
    channel_sweep::cp_async_commit();
  };
  // Workers apply the next sweep of the sequence to buf, after a phase of
  // its own for its factors if they are not made yet; with fetch_to, they
  // first start copying res[fetch_step] into it.
  auto apply = [&](float* buf, bool wait, float* fetch_to = nullptr,
                   int fetch_step = 0) {
    const int n = applied;
    while (factored <= n) phase(false, [] {});
    phase(wait, [&] {
      if (fetch_to != nullptr) fetch(fetch_to, fetch_step);
      const StepSweep q = step_sweep(strang, n % k);
      if (q.adjoint)
        channel_lines::apply_sweep<true>(factors(n), buf, t, q.y ? sy : sx,
                                         worker, nw);
      else
        channel_lines::apply_sweep<false>(factors(n), buf, t, q.y ? sy : sx,
                                          worker, nw);
    });
    ++applied;
  };
  // Workers add the field gradients of the adjoint just applied, whose
  // sweep output was xo, at ts[step, time].
  auto grad = [&](const float* xo, bool y, int step, int time, bool wait) {
    const float tt = __ldg(ts + 3 * step + time);
    phase(wait, [&] {
      if (y)
        grad_pass(cot, xo, t, true, beta, tt, dtf_y, eps, cmax, acc_b,
                  part + 2 * chw, worker, nw);
      else
        grad_pass(cot, xo, t, false, alpha, tt, dtf_x, eps, cmax, acc_a,
                  part, worker, nw);
    });
  };

  for (int s = num_steps - 1; s >= 0; --s) {
    // x <- mix . res[s], then x1
    phase(false, [&] {
      channel_lines::mix_tile<false, kC>(x, x, t, m, nullptr, worker, nw);
    });
    apply(x, false);
    if (strang) {
      apply(x, false);                // x2
      apply(cot, false);              // the x adjoint at t2, on the output
      grad(ures, false, s, 2, false);
      apply(cot, false, ures, s);     // the y adjoint at t1, on x2; res[s]
      grad(x, true, s, 1, true);      // ... and res[s] is in
      phase(false, [&] {              // x1 again, from res[s]
        channel_lines::mix_tile<false, kC>(ures, x, t, m, nullptr, worker,
                                           nw);
      });
      apply(x, false);
      apply(cot, false);              // the x adjoint at t0, on x1
    } else {
      apply(cot, false);              // the y adjoint at t1, on the output
      grad(ures, true, s, 1, false);
      apply(cot, false, ures, s);     // the x adjoint at t0, on x1; res[s]
    }
    grad(x, false, s, 0, true);       // ... and res[s] is in (Lie)
    // the mixing adjoint on res[s]; res[s - 1] comes in behind it
    phase(true, [&] {
      if (s > 0) fetch(x, s - 1);
      mix_adjoint<kC>(cot, ures, t, m, mg, worker, nw);
    });
  }

  channel_lines::store_rows(gu + tile0, cot, t, 0, blockDim.x);
  if ((int)threadIdx.x < C * C) {
    float v = 0.0f;
    for (int w = 0; w < nw / 32; ++w) v += mg[w * C * C + threadIdx.x];
    part[4 * chw + threadIdx.x] = v;
  }
  if (worker >= 0) {
    for_elements(t, false, worker, nw, [&](int k, int, int, int e) {
#pragma unroll
      for (int q = 0; q < kRegElems; ++q) {
        if (q == k) {
          part[e] = acc_a[q][0];
          part[chw + e] = acc_a[q][1];
          part[2 * chw + e] = acc_b[q][0];
          part[3 * chw + e] = acc_b[q][1];
        }
      }
    });
  }
}

// The second pass: the sum of the blocks' partials, element e of the
// (4 C H W + C*C) row, in a fixed order: slice k of a block's kSumSlices
// sums blocks k, k + kSumSlices, ... in order, then the slices are added in
// order (ops/fused_channel_vjp.py::_sum_tile_partials).  Neighbouring
// threads read neighbouring words.
constexpr int kSumLanes = 32;
constexpr int kSumSlices = 8;

__global__ void __launch_bounds__(kSumLanes * kSumSlices)
    sum_partials(const float* __restrict__ partials, int row, int chw,
                 int blocks, float* __restrict__ g_ab,
                 float* __restrict__ g_atc, float* __restrict__ g_bb,
                 float* __restrict__ g_btc, float* __restrict__ g_mix) {
  __shared__ float slices[kSumSlices][kSumLanes];
  const int e = blockIdx.x * kSumLanes + threadIdx.x;
  float acc = 0.0f;
  if (e < row)
    for (int b = threadIdx.y; b < blocks; b += kSumSlices)
      acc += partials[(long long)b * row + e];
  slices[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < row) {
    float sum = slices[0][threadIdx.x];
    for (int k = 1; k < kSumSlices; ++k) sum += slices[k][threadIdx.x];
    const int which = e / chw;
    float* dst = which == 0 ? g_ab : which == 1 ? g_atc : which == 2 ? g_bb
                                                   : which == 3 ? g_btc
                                                                : g_mix;
    dst[which < 4 ? e - which * chw : e - 4 * chw] = sum;
  }
}

template <int kC>
cudaError_t launch(const float* g, const float* res, const float* out,
                   const float* alpha_base, const float* alpha_tc,
                   const float* beta_base, const float* beta_tc,
                   const float* mix, const float* ts, float* gu,
                   float* partials, int B, int C, int H, int W, int grid,
                   channel_lines::Layout l, int num_steps, int strang,
                   float dtf_x, float dtf_y, float eps, float cmax,
                   cudaStream_t stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  if (!channel_lines::valid(l)) return cudaErrorInvalidValue;
  const int tile = (B + grid - 1) / grid;
  const size_t smem = (size_t)channel_lines::block_bytes(
      C, H, W, tile, kBuffers, slot_floats(C, H, W), l);
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_channel_bwd_kernel<kC>, smem, smem_allowed);
  if (err != cudaSuccess) return err;
  fused_channel_bwd_kernel<kC><<<grid, channel_lines::kThreads, smem,
                                 stream>>>(
      g, res, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, gu,
      partials, B, C, H, W, num_steps, strang, dtf_x, dtf_y, eps, cmax, l);
  return cudaGetLastError();
}

}  // namespace

// The launch shape of a plan of the wrapper (ops/fused_channel_vjp.py::
// bwd_plan), checked the first time the wrapper launches that plan, as
// fused_channel_layout: threads a block and bytes of shared memory a block.
// Beside three image buffers a block holds the mixing matrix, C*C floats a
// worker warp, the factor buffers and the staged fields.
extern "C" int fused_channel_bwd_layout(int C, int H, int W, int tile,
                                        int nbuf, int staged, int* threads,
                                        int* smem) {
  *threads = channel_lines::kThreads;
  *smem = (int)channel_lines::block_bytes(
      C, H, W, tile, kBuffers, slot_floats(C, H, W),
      channel_lines::Layout{nbuf, staged});
  return 0;
}

// K5: grad u into gu, the blocks' partials into ``partials`` (grid rows of
// 4 C H W + C*C floats), then their sum into the five parameter gradients;
// two kernels on one stream.  ``grid``, ``nbuf`` and ``staged`` as for
// fused_channel_diffusion.
// Returns the error of the shared-memory opt-in or cudaGetLastError() after
// each launch; the caller raises if it is not 0.
extern "C" int fused_channel_diffusion_bwd(
    const float* g, const float* res, const float* out,
    const float* alpha_base, const float* alpha_tc, const float* beta_base,
    const float* beta_tc, const float* mix, const float* ts, float* gu,
    float* g_ab, float* g_atc, float* g_bb, float* g_btc, float* g_mix,
    float* partials, int B, int C, int H, int W, int grid, int nbuf,
    int staged, int num_steps, int strang, float dtf_x, float dtf_y,
    float eps, float cmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const channel_lines::Layout l{nbuf, staged};
  const cudaError_t err =
      C == 3 ? launch<3>(g, res, out, alpha_base, alpha_tc, beta_base,
                         beta_tc, mix, ts, gu, partials, B, C, H, W, grid, l,
                         num_steps, strang, dtf_x, dtf_y, eps, cmax, s)
             : launch<0>(g, res, out, alpha_base, alpha_tc, beta_base,
                         beta_tc, mix, ts, gu, partials, B, C, H, W, grid, l,
                         num_steps, strang, dtf_x, dtf_y, eps, cmax, s);
  if (err != cudaSuccess) return (int)err;
  const int chw = C * H * W;
  const int row = 4 * chw + C * C;
  const dim3 blocks((unsigned)((row + kSumLanes - 1) / kSumLanes));
  sum_partials<<<blocks, dim3(kSumLanes, kSumSlices), 0, s>>>(
      partials, row, chw, grid, g_ab, g_atc, g_bb, g_btc, g_mix);
  return (int)cudaGetLastError();
}
