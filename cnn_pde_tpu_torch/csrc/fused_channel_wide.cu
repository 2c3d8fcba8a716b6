// K2, K4 and K5 for the shapes that one block's shared memory cannot hold
// (the "wide" scheme), for Hopper (sm_90a).
//
// Replaces, past the shapes of fused_channel.cu and fused_channel_vjp.cu:
// cnn_pde_tpu/ops/pallas_fused_channel.py::fused_channel_diffusion_fwd
// (pallas_call at :102; K2), and
// cnn_pde_tpu/ops/pallas_fused_channel_vjp.py::_fwd_call (:195; K4) and
// _bwd_call (:233; K5).  The wrapper (ops/fused_channel.py::choose_scheme)
// takes this scheme where the first one cannot: an image (with its factors)
// over the shared memory a block may use, a line over 64 rows, more than 8
// channels, or too few threads left beside the factor warps to work on the
// images.  It takes C <= 64 and H, W <= 1,440 (ops/tridiag.py::MAX_N).
//
// The same arithmetic as the first scheme: each sweep solves, per line, the
// Neumann system a = c = -r, b = 1 + 2r (1 + r on the edge rows) + eps,
// r = clamp(base + tc * t, eps, cmax) * dtf, or its transpose for K5's
// adjoints, by the Thomas recurrence with the reciprocal of
// channel_lines.cuh (ops/fused_channel.py::thomas_factors/thomas_apply are
// its plain mirror); K5 folds grad_r onto the Neumann rows, gates it by the
// strict clamp eps < raw < cmax and weights the time coefficients by t.
//
// What bounds it.  The same bytes and flops as K2/K4/K5 (the state in and
// out once, K4's residuals, K5's S residuals), a few tens of flops a byte:
// the bound is bytes.  What holds it far above the bound: an image is one
// block's, on one SM, whose L1 serves every row of every line (measured on
// an H100, the time follows the cache-line requests a row: 32 for a warp's
// x-line row by scalar loads, 4 for a y-line row), and the sweeps of a
// layer follow one another.
//
// The design, simple first.
// - One block takes a tile of whole images (ops/fused_channel.py::
//   wide_plan: at most two blocks an SM, within a workspace budget) and
//   walks them one at a time through every step; an image's state lives in
//   device memory (the output, or for K5 the cotangent in grad u), close to
//   the L2 (a (3, 96, 96) image is 110.6 KB; the H100 has 50 MB of L2).
// - A sweep gives each thread a line (threads: one a line of the longer
//   sweep, whole warps, at most 512; more lines loop), which makes its
//   Thomas factors as it eliminates and keeps the multipliers for the
//   back-substitution in a workspace in device memory, laid out row by row
//   so that neighbouring lines' threads touch neighbouring words; a barrier
//   ends each sweep.  y-lines read the state coalesced, x-lines with the
//   stride of a row, so a warp's load of an x-line row touches 32 cache
//   lines; rows move through registers eight at a time, and along x-lines
//   by float4 where the row length and the buffers allow (load_chunk).
// - The mixing is a loop over C a pixel, one thread a pixel, from one buffer
//   into another (the mixed state is the x-sweep's right-hand side), with
//   the matrix in shared memory; up to 8 channels in registers.
// - K5's gradient passes load a few elements' operands and partials
//   together before their arithmetic: one element at a time, each waited
//   two round trips, and the passes took most of K5's time.
// - K5: the recomputed x1 and x2 each have a workspace image, so no sweep is
//   recomputed twice.  The field gradients are added, element by element and
//   always by the same thread, to the block's partial row in device memory
//   (4 C H W field gradients, then C*C for the mixing), image after image
//   and step after step; the mixing gradient is summed over the image's
//   pixels a pass of eight (k, c) pairs at a time, by shuffles and then over
//   the warps in order.  A second kernel sums the rows over the blocks in a
//   fixed order, as fused_channel_vjp.cu does
//   (ops/fused_channel_vjp.py::fused_channel_bwd_streamed is the plain
//   mirror).  No atomics: two runs give the same bits.
// - The wrapper allocates the workspace (and K5's partials) with
//   torch.empty, so a CUDA graph draws it from its pool.
// A thread-block cluster with distributed shared memory is the design that
// would keep an image on chip; it is later work.

#include <cuda_runtime.h>

#include "channel_lines.cuh"

namespace {

constexpr int kMaxThreads = 512;  // threads a block, at most
constexpr int kPairs = 8;         // (k, c) mixing-gradient pairs a pass
constexpr int kChunk = 8;         // rows of a line in registers at once
constexpr int kBatch = 4;         // elements a thread loads at once
constexpr int kSmallC = 8;        // channels whose mixing stays in registers
constexpr int kSumLanes = 32;
constexpr int kSumSlices = 8;

// Threads a block: one a line of the longer sweep, whole warps, at most
// kMaxThreads.
__host__ __device__ __forceinline__ int wide_threads(int C, int H, int W) {
  const long long lines = (long long)C * (H > W ? H : W);
  const long long t = (lines + 31) / 32 * 32;
  return (int)(t < kMaxThreads ? t : kMaxThreads);
}

// Floats of shared memory a block: the mixing matrix and, for K5, the
// warps' mixing-gradient slots.
__host__ __device__ __forceinline__ int wide_smem_floats(int C, int threads,
                                                         bool backward) {
  return C * C + (backward ? threads / 32 * kPairs : 0);
}

// Floats of device-memory workspace a block: K2/K4 the mixed state and the
// multipliers; K5 x1, x2, the mixed cotangent and the multipliers.
__host__ __device__ __forceinline__ long long wide_workspace(int C, int H,
                                                             int W,
                                                             bool backward) {
  return (backward ? 4LL : 2LL) * C * H * W;
}

struct Img {
  int C, H, W, hw, chw;
};

__device__ __forceinline__ Img make_img(int C, int H, int W) {
  return Img{C, H, W, H * W, C * H * W};
}

// This block's images [first, last): B split over the grid as evenly as
// whole images allow (channel_lines::block_images).
__device__ __forceinline__ void tile_of(int B, long long& first,
                                        long long& last) {
  const long long b = blockIdx.x;
  first = b * B / gridDim.x;
  last = (b + 1) * B / gridDim.x;
}

// Rows [0, count) of a line from p (rows ss apart), the rest 0; kVec:
// ss == 1, p 16-byte aligned and count 4 or 8, by float4 loads.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const float* p, int ss, int count,
                                           float (&v)[kChunk]) {
  if constexpr (kVec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = count > 4 ? *reinterpret_cast<const float4*>(p + 4)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < kChunk; ++q) v[q] = q < count ? p[q * ss] : 0.0f;
  }
}

// Rows [0, count) of v to a line at p, as load_chunk reads them.
template <bool kVec>
__device__ __forceinline__ void store_chunk(float* p, int ss, int count,
                                            const float (&v)[kChunk]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    if (count > 4)
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (q < count) p[q * ss] = v[q];
  }
}

// One line of a sweep: x = T^-1 d (kT: T^-T d) from src into dst (the same
// buffer, or another), rows s0 + i*ss of an image and of the (C, H, W)
// fields; the multiplier of row i of line j of L at mult[i*L + j].  The
// first scheme's factor_line and solve_line in one pass: rd[i] =
// 1/(b[i] - rs[i] up[i-1]), up[i] = ru[i] rd[i], dp[i] = rd[i] d[i] +
// lo[i] dp[i-1] (lo: r[i] rd[i] for T, r[i-1] rd[i] for its transpose),
// then x[i] = dp[i] + up[i] x[i+1].  Rows move kChunk at a time: their
// loads, the recurrence, their stores, so that no load waits behind the
// previous row's store (src and dst may be one buffer); the back-
// substitution takes the same aligned chunks, last first.  kVec (an
// x-line, ss == 1, n a multiple of 4, every pointer 16-byte aligned): the
// chunks of the state and the fields by float4: a warp's x-lines are 32
// rows of the image apart, so each of its loads touches 32 cache lines,
// and a float4 brings four rows for each.
template <bool kT, bool kVec>
__device__ __forceinline__ void solve_line(
    const float* src, float* dst, float* __restrict__ mult, int L, int j,
    int n, int s0, int ss, const float* __restrict__ base,
    const float* __restrict__ tc, float tt, float dtf, float eps,
    float cmax) {
  auto clamped = [&](float b, float t) {
    return fminf(fmaxf(b + t * tt, eps), cmax) * dtf;
  };
  auto coef = [&](int i) {
    const int e = s0 + i * ss;
    return clamped(base[e], tc[e]);
  };
  float rp = 0.0f;  // r[i - 1]
  float rc = coef(0);
  float up = 0.0f;
  float dp = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int count = n - i0 < kChunk ? n - i0 : kChunk;
    float d[kChunk], rn[kChunk];  // rn[q] = r[i0 + q + 1]
    load_chunk<kVec>(src + s0 + i0 * ss, ss, count, d);
    if constexpr (kVec) {
      float rb[kChunk], rt[kChunk];
      load_chunk<true>(base + s0 + i0, 1, count, rb);
      load_chunk<true>(tc + s0 + i0, 1, count, rt);
#pragma unroll
      for (int q = 0; q + 1 < kChunk; ++q)
        rn[q] = i0 + q + 1 < n ? clamped(rb[q + 1], rt[q + 1]) : 0.0f;
      rn[kChunk - 1] = i0 + kChunk < n ? coef(i0 + kChunk) : 0.0f;
    } else {
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        rn[q] = i0 + q + 1 < n ? coef(i0 + q + 1) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int i = i0 + q;
      if (i < n) {
        const float b =
            ((i == 0 || i == n - 1) ? 1.0f + rc : 1.0f + 2.0f * rc) + eps;
        const float rs = i > 0 ? (kT ? rp : rc) : 0.0f;
        const float ru = i + 1 < n ? (kT ? rn[q] : rc) : 0.0f;
        const float rd = channel_lines::reciprocal(b - rs * up);
        const float lo = (kT ? rp : rc) * rd;  // the first row has dp = 0
        dp = fmaf(lo, dp, rd * d[q]);
        d[q] = dp;
        up = ru * rd;
        mult[i * L + j] = up;
        rp = rc;
        rc = rn[q];
      }
    }
    store_chunk<kVec>(dst + s0 + i0 * ss, ss, count, d);
  }
  // x[n-1] = dp[n-1] is in place; rows n-2 down to 0
  float x = dp;
  for (int c0 = (n - 1) / kChunk * kChunk; c0 >= 0; c0 -= kChunk) {
    const int count = n - c0 < kChunk ? n - c0 : kChunk;
    float v[kChunk], mu[kChunk];
    load_chunk<kVec>(dst + s0 + c0 * ss, ss, count, v);
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      mu[q] = c0 + q < n - 1 ? mult[(c0 + q) * L + j] : 0.0f;
#pragma unroll
    for (int q = kChunk - 1; q >= 0; --q) {
      if (c0 + q < n - 1) {
        x = fmaf(mu[q], x, v[q]);
        v[q] = x;
      }
    }
    store_chunk<kVec>(dst + s0 + c0 * ss, ss, count, v);
  }
}

// Every line of a sweep of one image, a thread a line: along W (x, line
// j = c*H + h) or down the columns (y, j = c*W + w); ``vec``: the x-lines
// by float4 (W a multiple of 4, the buffers and fields 16-byte aligned).
// The caller synchronises.  Out of line, so that the kernels' many call
// sites share one copy of the unrolled solve.
template <bool kT>
__device__ __noinline__ void sweep(const float* src, float* dst,
                                   float* mult, const Img& im, bool y,
                                   bool vec, const float* base,
                                   const float* tc, float tt, float dtf,
                                   float eps, float cmax) {
  const int L = im.C * (y ? im.W : im.H);
  const int n = y ? im.H : im.W;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    if (y) {
      const int c = j / im.W;
      solve_line<kT, false>(src, dst, mult, L, j, n,
                            c * im.hw + (j - c * im.W), im.W, base, tc, tt,
                            dtf, eps, cmax);
    } else if (vec) {
      solve_line<kT, true>(src, dst, mult, L, j, n, j * im.W, 1, base, tc,
                           tt, dtf, eps, cmax);
    } else {
      solve_line<kT, false>(src, dst, mult, L, j, n, j * im.W, 1, base, tc,
                            tt, dtf, eps, cmax);
    }
  }
}

// Whether p is 16-byte aligned (the float4 rows of an x-line).
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// dst[c] = sum_k m[c, k] src[k] (kTrans: m[k, c]) at every pixel of one
// image, a thread a pixel, src and dst distinct; with res, src is first
// copied there (K4's residual).  Up to kSmallC channels a pixel's values
// stay in registers, loaded together.  The caller synchronises.
template <bool kTrans>
__device__ __forceinline__ void mix_image(const float* __restrict__ src,
                                          float* __restrict__ dst,
                                          float* __restrict__ res,
                                          const float* m, const Img& im) {
  const int C = im.C;
  if (C <= kSmallC) {
#pragma unroll 2
    for (int p = threadIdx.x; p < im.hw; p += blockDim.x) {
      float v[kSmallC];
#pragma unroll
      for (int k = 0; k < kSmallC; ++k)
        v[k] = k < C ? src[k * im.hw + p] : 0.0f;
      if (res != nullptr) {
#pragma unroll
        for (int k = 0; k < kSmallC; ++k)
          if (k < C) res[k * im.hw + p] = v[k];
      }
#pragma unroll
      for (int c = 0; c < kSmallC; ++c) {
        if (c < C) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < kSmallC; ++k)
            if (k < C) acc += m[kTrans ? k * C + c : c * C + k] * v[k];
          dst[c * im.hw + p] = acc;
        }
      }
    }
    return;
  }
  for (int p = threadIdx.x; p < im.hw; p += blockDim.x) {
    if (res != nullptr)
      for (int k = 0; k < C; ++k) res[k * im.hw + p] = src[k * im.hw + p];
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
      for (int k = 0; k < C; ++k)
        acc += m[kTrans ? k * C + c : c * C + k] * src[k * im.hw + p];
      dst[c * im.hw + p] = acc;
    }
  }
}

__device__ __forceinline__ void copy_image(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           const Img& im) {
  for (int e = threadIdx.x; e < im.chw; e += blockDim.x) dst[e] = src[e];
}

__global__ void __launch_bounds__(kMaxThreads)
    wide_forward_kernel(const float* __restrict__ u, float* __restrict__ out,
                        const float* __restrict__ alpha_base,
                        const float* __restrict__ alpha_tc,
                        const float* __restrict__ beta_base,
                        const float* __restrict__ beta_tc,
                        const float* __restrict__ mix,
                        const float* __restrict__ ts,
                        float* __restrict__ res, float* __restrict__ ws,
                        int B, int C, int H, int W, int num_steps, int strang,
                        float dtf_x, float dtf_y, float eps, float cmax) {
  extern __shared__ float m[];
  const Img im = make_img(C, H, W);
  for (int k = threadIdx.x; k < C * C; k += blockDim.x) m[k] = mix[k];
  __syncthreads();
  float* mixed = ws + (long long)blockIdx.x * wide_workspace(C, H, W, false);
  float* mult = mixed + im.chw;
  const bool vec = (W & 3) == 0 && aligned16(u) && aligned16(out) &&
                   aligned16(ws) && aligned16(alpha_base) &&
                   aligned16(alpha_tc);
  long long first, last;
  tile_of(B, first, last);
  for (long long b = first; b < last; ++b) {
    const float* in = u + b * im.chw;
    float* x = out + b * im.chw;
    if (num_steps == 0) copy_image(in, x, im);
    for (int s = 0; s < num_steps; ++s) {
      mix_image<false>(
          s == 0 ? in : x, mixed,
          res == nullptr ? nullptr : res + ((long long)s * B + b) * im.chw, m,
          im);
      __syncthreads();
      sweep<false>(mixed, x, mult, im, false, vec, alpha_base, alpha_tc,
                   __ldg(ts + 3 * s), dtf_x, eps, cmax);
      __syncthreads();
      sweep<false>(x, x, mult, im, true, vec, beta_base, beta_tc,
                   __ldg(ts + 3 * s + 1), dtf_y, eps, cmax);
      __syncthreads();
      if (strang) {
        sweep<false>(x, x, mult, im, false, vec, alpha_base, alpha_tc,
                     __ldg(ts + 3 * s + 2), dtf_x, eps, cmax);
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

// The gated field gradients of an adjoint sweep just applied (lam, its
// sweep's output xo) added to the block's partials: base at pb[e] and,
// times tt, time coefficient at pt[e].  grad_r folded onto the Neumann rows
// (2gb - ga - gc inside the line, gb - gc on its first row, gb - ga on its
// last; gb = -lam x, ga = -lam x[i-1], gc = -lam x[i+1]) times dtf, where
// eps < base + tc*tt < cmax.  A thread an element, the same elements every
// call; kBatch elements' loads (the partials' too) go out together, so
// that a thread waits one round trip for them, not two for each.  The
// caller synchronises.
__device__ __forceinline__ void grad_pass(const float* __restrict__ lam,
                                          const float* __restrict__ xo,
                                          float* __restrict__ pb,
                                          float* __restrict__ pt,
                                          const Img& im, bool y,
                                          const float* __restrict__ base,
                                          const float* __restrict__ tc,
                                          float tt, float dtf, float eps,
                                          float cmax) {
  const int n = y ? im.H : im.W;
  const int st = y ? im.W : 1;
  for (int e0 = threadIdx.x; e0 < im.chw; e0 += kBatch * blockDim.x) {
    int row[kBatch];  // the element's row along its line, or -1
    float l[kBatch], xc[kBatch], xa[kBatch], xb[kBatch], raw[kBatch];
    float vb[kBatch], vt[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      const bool in = e < im.chw;
      const int r = e / im.W;  // c*H + h
      const int i = y ? r - (r / im.H) * im.H : e - r * im.W;
      row[k] = in ? i : -1;
      l[k] = in ? lam[e] : 0.0f;
      xc[k] = in ? xo[e] : 0.0f;
      xa[k] = in && i > 0 ? xo[e - st] : 0.0f;
      xb[k] = in && i + 1 < n ? xo[e + st] : 0.0f;
      raw[k] = in ? base[e] + tc[e] * tt : 0.0f;
      vb[k] = in ? pb[e] : 0.0f;
      vt[k] = in ? pt[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = row[k];
      if (i >= 0 && raw[k] > eps && raw[k] < cmax) {
        const float gb = -l[k] * xc[k];
        const float ga = i > 0 ? -l[k] * xa[k] : 0.0f;
        const float gc = i + 1 < n ? -l[k] * xb[k] : 0.0f;
        const float v =
            i == 0 ? gb - gc : (i == n - 1 ? gb - ga : 2.0f * gb - ga - gc);
        const float gf = v * dtf;
        const int e = e0 + k * blockDim.x;
        pb[e] = vb[k] + gf;
        pt[e] = vt[k] + gf * tt;
      }
    }
  }
}

// grad_mix[k, c] += sum over the image's pixels of cot[k] u[c], into the
// block's partials pm[k*C + c]: kPairs pairs a pass, each thread over its
// pixels, then shuffles, then the warps in order (slots: kPairs floats a
// warp in shared memory).  Synchronises.
__device__ __forceinline__ void mix_grad(const float* __restrict__ cot,
                                         const float* __restrict__ u,
                                         float* __restrict__ pm,
                                         float* slots, const Img& im) {
  const int CC = im.C * im.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int kc0 = 0; kc0 < CC; kc0 += kPairs) {
    int ko[kPairs], co[kPairs];
    float acc[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int kc = kc0 + q < CC ? kc0 + q : CC - 1;
      const int k = kc / im.C;
      ko[q] = k * im.hw;
      co[q] = (kc - k * im.C) * im.hw;
      acc[q] = 0.0f;
    }
#pragma unroll 2
    for (int p = threadIdx.x; p < im.hw; p += blockDim.x) {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) acc[q] += cot[ko[q] + p] * u[co[q] + p];
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) slots[warp * kPairs + q] = v;
    }
    __syncthreads();
    if ((int)threadIdx.x < kPairs && kc0 + (int)threadIdx.x < CC) {
      float v = 0.0f;
      for (int w = 0; w < warps; ++w) v += slots[w * kPairs + threadIdx.x];
      pm[kc0 + threadIdx.x] += v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    wide_backward_kernel(const float* __restrict__ g,
                         const float* __restrict__ res,
                         const float* __restrict__ out,
                         const float* __restrict__ alpha_base,
                         const float* __restrict__ alpha_tc,
                         const float* __restrict__ beta_base,
                         const float* __restrict__ beta_tc,
                         const float* __restrict__ mix,
                         const float* __restrict__ ts,
                         float* __restrict__ gu, float* __restrict__ partials,
                         float* __restrict__ ws, int B, int C, int H, int W,
                         int num_steps, int strang, float dtf_x, float dtf_y,
                         float eps, float cmax) {
  extern __shared__ float smem[];
  float* m = smem;
  float* slots = smem + C * C;
  const Img im = make_img(C, H, W);
  const int chw = im.chw;
  const long long row = 4LL * chw + C * C;
  // this block's partials: (4, C, H, W) field gradients, then (C, C)
  float* part = partials + (long long)blockIdx.x * row;
  for (int k = threadIdx.x; k < C * C; k += blockDim.x) m[k] = mix[k];
  for (long long e = threadIdx.x; e < row; e += blockDim.x) part[e] = 0.0f;
  float* x1 = ws + (long long)blockIdx.x * wide_workspace(C, H, W, true);
  float* x2 = x1 + chw;
  float* mixed = x2 + chw;  // mix^T . cot, the next step's cotangent
  float* mult = mixed + chw;
  const bool vec = (W & 3) == 0 && aligned16(g) && aligned16(gu) &&
                   aligned16(ws) && aligned16(alpha_base) &&
                   aligned16(alpha_tc);
  __syncthreads();

  const long long plane = (long long)B * chw;  // one step of res
  long long first, last;
  tile_of(B, first, last);
  for (long long b = first; b < last; ++b) {
    const float* cot_in = g + b * chw;
    float* cot = gu + b * chw;
    for (int s = num_steps - 1; s >= 0; --s) {
      const float* us = res + s * plane + b * chw;
      const float* os =
          s == num_steps - 1 ? out + b * chw : res + (s + 1) * plane + b * chw;
      const float t0 = __ldg(ts + 3 * s);
      const float t1 = __ldg(ts + 3 * s + 1);
      // recompute x1 = x-sweep(mix . res[s]) and, for Strang, x2
      mix_image<false>(us, x1, nullptr, m, im);
      __syncthreads();
      sweep<false>(x1, x1, mult, im, false, vec, alpha_base, alpha_tc, t0,
                   dtf_x, eps, cmax);
      __syncthreads();
      if (strang) {
        sweep<false>(x1, x2, mult, im, true, vec, beta_base, beta_tc, t1,
                     dtf_y, eps, cmax);
        __syncthreads();
        const float t2 = __ldg(ts + 3 * s + 2);
        sweep<true>(cot_in, cot, mult, im, false, vec, alpha_base, alpha_tc,
                    t2, dtf_x, eps, cmax);
        __syncthreads();
        grad_pass(cot, os, part, part + chw, im, false, alpha_base, alpha_tc,
                  t2, dtf_x, eps, cmax);
        __syncthreads();
        sweep<true>(cot, cot, mult, im, true, vec, beta_base, beta_tc, t1,
                    dtf_y, eps, cmax);
        __syncthreads();
        grad_pass(cot, x2, part + 2 * chw, part + 3 * chw, im, true,
                  beta_base, beta_tc, t1, dtf_y, eps, cmax);
      } else {
        sweep<true>(cot_in, cot, mult, im, true, vec, beta_base, beta_tc, t1,
                    dtf_y, eps, cmax);
        __syncthreads();
        grad_pass(cot, os, part + 2 * chw, part + 3 * chw, im, true,
                  beta_base, beta_tc, t1, dtf_y, eps, cmax);
      }
      __syncthreads();
      sweep<true>(cot, cot, mult, im, false, vec, alpha_base, alpha_tc, t0,
                  dtf_x, eps, cmax);
      __syncthreads();
      grad_pass(cot, x1, part, part + chw, im, false, alpha_base, alpha_tc,
                t0, dtf_x, eps, cmax);
      __syncthreads();
      mix_grad(cot, us, part + 4 * chw, slots, im);
      mix_image<true>(cot, mixed, nullptr, m, im);
      __syncthreads();
      cot_in = mixed;
    }
    copy_image(cot_in, cot, im);
    __syncthreads();
  }
}

// The second pass: the sum of the blocks' partials, element e of the
// (4 C H W + C*C) row, in a fixed order: slice k of a block's kSumSlices
// sums blocks k, k + kSumSlices, ... in order, then the slices are added in
// order (fused_channel_vjp.cu::sum_partials; ops/fused_channel_vjp.py::
// _sum_tile_partials).
__global__ void __launch_bounds__(kSumLanes * kSumSlices)
    wide_sum_partials(const float* __restrict__ partials, long long row,
                      int chw, int blocks, float* __restrict__ g_ab,
                      float* __restrict__ g_atc, float* __restrict__ g_bb,
                      float* __restrict__ g_btc, float* __restrict__ g_mix) {
  __shared__ float slices[kSumSlices][kSumLanes];
  const long long e = (long long)blockIdx.x * kSumLanes + threadIdx.x;
  float acc = 0.0f;
  if (e < row)
    for (int b = threadIdx.y; b < blocks; b += kSumSlices)
      acc += partials[(long long)b * row + e];
  slices[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < row) {
    float sum = slices[0][threadIdx.x];
    for (int k = 1; k < kSumSlices; ++k) sum += slices[k][threadIdx.x];
    const int which = (int)(e / chw);
    float* dst = which == 0 ? g_ab : which == 1 ? g_atc : which == 2 ? g_bb
                                                   : which == 3 ? g_btc
                                                                : g_mix;
    dst[which < 4 ? e - (long long)which * chw : e - 4LL * chw] = sum;
  }
}

}  // namespace

// The launch shape of the wide scheme for (C, H, W) images, checked the
// first time the wrapper launches a plan of ops/fused_channel.py::wide_plan:
// threads a block, bytes of shared memory a block and floats of workspace a
// block (``backward``: K5's, else K2/K4's).
extern "C" int fused_channel_wide_layout(int C, int H, int W, int backward,
                                         int* threads, int* smem,
                                         long long* workspace) {
  *threads = wide_threads(C, H, W);
  *smem = 4 * wide_smem_floats(C, *threads, backward != 0);
  *workspace = wide_workspace(C, H, W, backward != 0);
  return 0;
}

// K2 (res null) and K4 (res: the (num_steps, B, C, H, W) residuals) by the
// wide scheme: ``grid`` blocks, each a tile of whole images, each with
// fused_channel_wide_layout's workspace at ws + block * workspace.  Returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.
// The wrapper checks C <= 64, H, W <= 1,440 and the workspace.
extern "C" int fused_channel_wide_forward(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* mix, const float* ts, float* res, float* ws, int B, int C,
    int H, int W, int grid, int num_steps, int strang, float dtf_x,
    float dtf_y, float eps, float cmax, void* stream) {
  const int threads = wide_threads(C, H, W);
  const size_t smem = 4 * (size_t)wide_smem_floats(C, threads, false);
  wide_forward_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      u, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, res, ws, B,
      C, H, W, num_steps, strang, dtf_x, dtf_y, eps, cmax);
  return (int)cudaGetLastError();
}

// K5 by the wide scheme: grad u into gu, the blocks' partials into
// ``partials`` (grid rows of 4 C H W + C*C floats), then their sum into the
// five parameter gradients; two kernels on one stream.  Returns
// cudaGetLastError() after each launch.
extern "C" int fused_channel_wide_backward(
    const float* g, const float* res, const float* out,
    const float* alpha_base, const float* alpha_tc, const float* beta_base,
    const float* beta_tc, const float* mix, const float* ts, float* gu,
    float* g_ab, float* g_atc, float* g_bb, float* g_btc, float* g_mix,
    float* partials, float* ws, int B, int C, int H, int W, int grid,
    int num_steps, int strang, float dtf_x, float dtf_y, float eps,
    float cmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = wide_threads(C, H, W);
  const size_t smem = 4 * (size_t)wide_smem_floats(C, threads, true);
  wide_backward_kernel<<<grid, threads, smem, s>>>(
      g, res, out, alpha_base, alpha_tc, beta_base, beta_tc, mix, ts, gu,
      partials, ws, B, C, H, W, num_steps, strang, dtf_x, dtf_y, eps, cmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chw = C * H * W;
  const long long row = 4LL * chw + C * C;
  const dim3 blocks((unsigned)((row + kSumLanes - 1) / kSumLanes));
  wide_sum_partials<<<blocks, dim3(kSumLanes, kSumSlices), 0, s>>>(
      partials, row, chw, grid, g_ab, g_atc, g_bb, g_btc, g_mix);
  return (int)cudaGetLastError();
}
