// K6, K7 and K8 for the images that one block's shared memory cannot hold
// (the "wide" scheme), for Hopper (sm_90a).
//
// Replaces, past the shapes of fused_grayscale.cu and fused_grayscale_vjp.cu:
// cnn_pde_tpu/ops/pallas_fused_adi.py::fused_grayscale_diffusion_fwd
// (pallas_call at :119; K6), and
// cnn_pde_tpu/ops/pallas_fused_adi_vjp.py::_fwd_call (:196; K7) and
// _bwd_call (:228; K8).  The wrapper (ops/fused_grayscale.py::
// choose_gray_scheme) takes this scheme for every image with a side over 64
// pixels, up to H, W <= 1,440 (ops/tridiag.py::MAX_N): the first scheme keeps
// a tile of whole images and a ring of factor buffers in a block's shared
// memory, and at 96 x 96 its factor ring alone would take about 298 KB.
//
// The same arithmetic as the first scheme (grayscale_lines.cuh): each sweep
// solves, per line, the Neumann system a = c = -r, b = 1 + 2r (1 + r on the
// edge rows) + eps, r = smooth3(max(base + tc * t, eps)) * dtf along the
// sweep axis, by the twisted factorisation of the batch-free factor table
// (m, piv, r a row, each line factored from both ends toward its middle row
// k = n / 2; ops/fused_grayscale.py::gray_factors and gray_solve are its
// plain mirror), or its transpose for K8's adjoints; K8 folds grad_r onto
// the Neumann rows, applies the adjoint of smooth3 (with one more third on
// a line's two edge elements), gates by raw > eps and weights the time
// coefficients by t.
//
// What bounds it.  The same bytes and flops as K6/K7/K8: the state in and
// out once (K7's S residual states, K8's S residuals read), the four fields
// and their gradients; about 5 flops an element and sweep forward, 46 an
// element and step backward, a few a byte: the bound is bytes.  What holds
// it far above the bound: an image is one block's, on one SM, and its state
// lives in device memory (L2), read and written once a sweep; a thread's
// recurrence is serial, half a line long; the 3S sweeps (5S backward) of an
// image follow one another, each ending in barriers.  A design that read
// the table and the state straight from device memory was several times
// slower on an H100: a warp's load of an x-line row, or of a row of the
// table (lines n|1 floats apart), touches 32 cache lines (16 lines, two
// ends each), which the L1 serves one by one.
//
// The design, simple first.
// - A first kernel makes the factor table of all 3S sweeps, the first
//   scheme's layout (sweep n a slab of three slots, lines n|1 floats
//   apart), reading the clamped fields from device memory: two threads a
//   line, as many blocks as the longest sweep's lines need (blockIdx.y the
//   sweep).  The table stays whole in device memory for the call (3.35 MB at
//   96 x 96 and 10 steps, in L2; about 0.75 GB at 1,440 x 1,440; the
//   wrapper checks its bytes against the free memory).
// - One block takes a tile of whole images (ops/fused_grayscale.py::
//   gray_wide_plan: at most two blocks an SM, within a workspace budget)
//   and walks them one at a time through every step.  Every sweep is out
//   of place, between the block's workspace images and the outputs, so no
//   line reads what another pair of threads wrote in the same sweep; two
//   threads a line (grayscale_lines.cuh::twisted_line; its halves move 16
//   rows at a time through registers, so a line has no length limit), a
//   barrier after each sweep.
// - A sweep goes in strips of lines (wide_sweep): the block copies a
//   strip's two factor slots, and for an x-sweep its rows of the state,
//   into shared memory, coalesced (as many lines as fit 113 KB: all 96 at
//   96 x 96, 6 at 1,440 x 1,440; two blocks an SM); the pairs solve from
//   there (x-lines in place, rows W | 1 floats apart; y-lines between the
//   device-memory buffers, a warp's pairs on neighbouring columns), and an
//   x-strip is copied back, coalesced.
// - K6: x at t0 from the step's input into workspace 1, y at t1 into
//   workspace 2, x at t2 into the output (the next step's input).  K7 the
//   same, with the last x-sweep of each step but the last writing res[s + 1]
//   instead, which the next step then reads (res[0] is a copy of u).
// - K8: per image, the steps in reverse: x1 and x2 recomputed from res[s]
//   into two workspace images, then the three adjoints out of place between
//   grad u and a third workspace image (by parity, so that the last lands in
//   grad u), each followed by a pass that writes the grad_r fold of the
//   image into a fourth workspace image and a pass that applies the smooth3
//   adjoint and the gate to it and adds it to the block's partial row (4 H W
//   floats in device memory), each element by the same thread every time;
//   that pass runs beside the next sweep.  A last kernel sums the rows over
//   the blocks in a fixed order (fused_grayscale_vjp.cu::sum_partials;
//   ops/fused_grayscale_vjp.py::fused_grayscale_bwd_tiled(per_image=True)
//   is the plain mirror).  No atomics: two runs give the same bits.
// - The wrapper allocates the table, the workspace and the partials with
//   torch.empty, so a CUDA graph draws them from its pool.
// A thread-block cluster with distributed shared memory is the design that
// would keep an image on chip; it is later work.

#include <cuda_runtime.h>

#include "grayscale_lines.cuh"

namespace {

namespace gl = grayscale_lines;

constexpr int kMaxThreads = 512;     // threads a block of a main kernel
constexpr int kMinThreads = 64;
// shared memory a block of a main kernel stages a strip in, at most: two
// blocks an SM (each with the 1 KB the card reserves) in its 228 KB
constexpr int kSmemBudget = 113 * 1024;
constexpr int kFactorThreads = 256;  // the factor kernel: two a line
constexpr int kBatch = 4;            // elements a thread loads at once
constexpr int kSumLanes = 32;
constexpr int kSumSlices = 8;

// Threads a block of a main kernel: two a line of the longer sweep, whole
// warps, between kMinThreads and kMaxThreads (more lines loop).
__host__ __device__ __forceinline__ int wide_threads(int H, int W) {
  const int t = (2 * (H > W ? H : W) + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : (t > kMaxThreads ? kMaxThreads : t);
}

// Floats of device-memory workspace a block: K6/K7 two images (the sweeps'
// ping and pong); K8 x1, x2, the cotangent's second buffer and the fold.
__host__ __device__ __forceinline__ long long wide_workspace(int H, int W,
                                                             bool backward) {
  return (backward ? 4LL : 2LL) * H * W;
}

// This block's images [first, last): B split over the grid as evenly as
// whole images allow (channel_lines::block_images).
__device__ __forceinline__ void tile_of(int B, long long& first,
                                        long long& last) {
  const long long b = blockIdx.x;
  first = b * B / gridDim.x;
  last = (b + 1) * B / gridDim.x;
}

// The factor kernel: sweep blockIdx.y into the table, two threads a line
// (lines blockIdx.x * kFactorThreads / 2 on), as grayscale_lines.cuh::
// factor_table makes it from shared memory: r[i] = (c[i-1]/3 + c[i]/3 +
// c[i+1]/3) dtf with c = max(base + tc t, eps) and the line's ends
// replicated, factored from both ends toward the twist row k = len / 2.
__global__ void __launch_bounds__(kFactorThreads)
    wide_factor_table(const float* __restrict__ alpha_base,
                      const float* __restrict__ alpha_tc,
                      const float* __restrict__ beta_base,
                      const float* __restrict__ beta_tc,
                      const float* __restrict__ ts, float* __restrict__ table,
                      int H, int W, float dtf_x, float dtf_y, float eps) {
  const int n = blockIdx.y;
  const bool y = gl::sweep_is_y(n);
  const int lines = y ? W : H;
  const int len = y ? H : W;
  const int j = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 1);
  if (j >= lines) return;  // both threads of the pair
  const bool second = threadIdx.x & 1;
  const int fld = len | 1;
  const int slot = gl::slot_floats(H, W, y);
  const float tt = __ldg(ts + n);  // ts is (S, 3): sweep n is ts[n / 3, n % 3]
  const float dtf = y ? dtf_y : dtf_x;
  // row i of line j is field element j*W + i (x) or i*W + j (y)
  const long long line = y ? j : (long long)j * W;
  const int es = y ? W : 1;
  const float* base = (y ? beta_base : alpha_base) + line;
  const float* tc = (y ? beta_tc : alpha_tc) + line;
  const float third = 1.0f / 3.0f;
  auto clamped = [&](int i) {
    return fmaxf(__ldg(base + (long long)i * es) +
                     __ldg(tc + (long long)i * es) * tt,
                 eps);
  };
  auto r_at = [&](int i) {
    const float l = clamped(i > 0 ? i - 1 : 0);
    const float r = clamped(i + 1 < len ? i + 1 : len - 1);
    return (l * third + clamped(i) * third + r * third) * dtf;
  };
  float* F = table + (long long)n * gl::slab_floats(H, W) +
             (long long)j * fld;
  float* fm = F;             // m[i]
  float* fp = F + slot;      // piv[i]
  float* fr = F + 2 * slot;  // r[i]
  const int k = len >> 1;
  const int dir = second ? -1 : 1;
  const int cnt = second ? len - 1 - k : k;
  int i = second ? len - 1 : 0;
  float m = 0.0f;  // m of the row before, toward this end
  for (int q = 0; q < cnt; ++q, i += dir) {
    const float rc = r_at(i);
    const float b =
        ((i == 0 || i == len - 1) ? 1.0f + rc : 1.0f + 2.0f * rc) + eps;
    const float p = channel_lines::reciprocal(b - rc * m);
    m = rc * p;
    fm[i] = m;
    fp[i] = p;
    fr[i] = rc;
  }
  // the twist row, from both ends' last multipliers (the first's first)
  const float other = __shfl_xor_sync(gl::pair_mask(), m, 1);
  if (!second) {
    const float rc = r_at(k);
    const float b =
        ((k == 0 || k == len - 1) ? 1.0f + rc : 1.0f + 2.0f * rc) + eps;
    const float p = channel_lines::reciprocal(b - rc * (m + other));
    fm[k] = rc * p;
    fp[k] = p;
    fr[k] = rc;
  }
}

// Lines a strip of a sweep (the lines whose factors, and for an x-sweep
// whose state, a block stages in shared memory at once): one a pair of
// threads, at most the longer sweep's lines, and no more than fit
// kSmemBudget with two factor slots of the longer line and an x-line's
// state each.
__host__ __device__ __forceinline__ int strip_lines(int H, int W,
                                                    int threads) {
  const int n = H > W ? H : W;
  const int per_line = 2 * (n | 1) + (W | 1);
  int p = threads / 2;
  if (p > n) p = n;
  const int fit = kSmemBudget / (4 * per_line);
  return p < fit ? p : fit;
}

// Bytes of shared memory a block of a main kernel: a strip's factors and
// x-line state.
__host__ __device__ __forceinline__ int wide_smem(int H, int W,
                                                  int threads) {
  const int n = H > W ? H : W;
  return 4 * strip_lines(H, W, threads) * (2 * (n | 1) + (W | 1));
}

// One line of a sweep from the factors piv and f2 (twisted_line, with the
// presets' length instantiated on its own).
template <bool kT>
__device__ __forceinline__ void solve_line(const float* piv, const float* f2,
                                           const float* in, float* out,
                                           int ss, int len, bool second) {
  if (len == gl::kMnist)
    gl::twisted_line<kT, gl::kMnist>(piv, f2, in, out, ss, len, second,
                                     true);
  else
    gl::twisted_line<kT, 0>(piv, f2, in, out, ss, len, second, true);
}

// Every line of sweep n of one (H, W) image, x = T^-1 d (kT: T^-T d), d
// from ``in`` and x into ``out`` (another buffer), along W (x: H lines) or
// down the columns (y: W lines); two threads a line (the halves that meet
// at its twist row), from the table's (piv, m) (kT: (piv, r)).  The lines
// go in strips of ``P`` (strip_lines): the block copies the strip's two
// factor slots (P lines of the table, contiguous) into ``smem``, and for an
// x-sweep the strip's state too (P rows of the image, contiguous; rows
// W | 1 floats apart), coalesced, by cp.async (a thread's copies in flight
// together); each pair then solves its line, an
// x-line in place in shared memory, a y-line between in and out (a warp's
// pairs on neighbouring columns); an x-strip is copied back to out,
// coalesced.  The caller synchronises.  Out of line, so that the kernels'
// call sites share one copy of the unrolled solve.
template <bool kT>
__device__ __noinline__ void wide_sweep(const float* __restrict__ table,
                                        int n, const float* in, float* out,
                                        int H, int W, bool y, float* smem,
                                        int P) {
  const int lines = y ? W : H;
  const int len = y ? H : W;
  const int fld = len | 1;
  const int ld = W | 1;
  const int slot = gl::slot_floats(H, W, y);
  const float* F = table + (long long)n * gl::slab_floats(H, W);
  const float* gpiv = F + slot;
  const float* gf2 = kT ? F + 2 * slot : F;
  float* piv = smem;
  float* f2 = piv + P * fld;
  float* st = f2 + P * fld;  // an x-strip's state
  const int pair = threadIdx.x >> 1;
  const bool second = threadIdx.x & 1;
  for (int j0 = 0; j0 < lines; j0 += P) {
    const int np = lines - j0 < P ? lines - j0 : P;
    const float* sp = gpiv + j0 * fld;
    const float* sf = gf2 + j0 * fld;
    for (int e = threadIdx.x; e < np * fld; e += blockDim.x) {
      channel_sweep::cp_async4(piv + e, sp + e);
      channel_sweep::cp_async4(f2 + e, sf + e);
    }
    if (!y) {
      const float* src = in + (long long)j0 * W;
      for (int e = threadIdx.x; e < np * W; e += blockDim.x) {
        const int r = e / W;
        channel_sweep::cp_async4(st + r * ld + e - r * W, src + e);
      }
    }
    channel_sweep::cp_async_commit();
    channel_sweep::cp_async_wait<0>();
    __syncthreads();
    if (pair < np) {
      if (y)
        solve_line<kT>(piv + pair * fld, f2 + pair * fld, in + j0 + pair,
                       out + j0 + pair, W, len, second);
      else
        solve_line<kT>(piv + pair * fld, f2 + pair * fld, st + pair * ld,
                       st + pair * ld, 1, len, second);
    }
    __syncthreads();
    if (!y) {
      float* dst = out + (long long)j0 * W;
      for (int e = threadIdx.x; e < np * W; e += blockDim.x) {
        const int r = e / W;
        dst[e] = st[r * ld + e - r * W];
      }
      __syncthreads();  // before the next strip overwrites st
    }
  }
}

__device__ __forceinline__ void copy_image(const float* __restrict__ src,
                                           float* __restrict__ dst, int hw) {
  for (int e = threadIdx.x; e < hw; e += blockDim.x) dst[e] = src[e];
}

__global__ void __launch_bounds__(kMaxThreads)
    wide_forward_kernel(const float* __restrict__ u, float* __restrict__ out,
                        const float* __restrict__ table,
                        float* __restrict__ res, float* __restrict__ ws,
                        int B, int H, int W, int num_steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = strip_lines(H, W, blockDim.x);
  const int hw = H * W;
  float* w1 = ws + blockIdx.x * wide_workspace(H, W, false);
  float* w2 = w1 + hw;
  long long first, last;
  tile_of(B, first, last);
  for (long long b = first; b < last; ++b) {
    const float* src = u + b * hw;
    float* dst = out + b * hw;
    if (res != nullptr) copy_image(src, res + b * hw, hw);  // res[0]
    if (num_steps == 0) copy_image(src, dst, hw);
    for (int s = 0; s < num_steps; ++s) {
      wide_sweep<false>(table, 3 * s, src, w1, H, W, false, smem, P);
      __syncthreads();
      wide_sweep<false>(table, 3 * s + 1, w1, w2, H, W, true, smem, P);
      __syncthreads();
      float* next = res != nullptr && s + 1 < num_steps
                        ? res + ((long long)(s + 1) * B + b) * hw
                        : dst;
      wide_sweep<false>(table, 3 * s + 2, w2, next, H, W, false, smem, P);
      __syncthreads();
      src = next;
    }
  }
}

// The grad_r fold of the adjoint just solved (lam) of a sweep whose output
// was xo, for one image, times dtf, into fold: 2gb - ga - gc inside the line,
// gb - gc on its first row, gb - ga on its last, with gb = -lam x,
// ga = -lam x[i-1], gc = -lam x[i+1].  A thread an element, kBatch elements'
// loads at once (one element at a time, each waits two round trips).  The
// caller synchronises.
__device__ __forceinline__ void fold_pass(const float* __restrict__ lam,
                                          const float* __restrict__ xo,
                                          float* __restrict__ fold, int H,
                                          int W, bool y, float dtf) {
  const int hw = H * W;
  const int n = y ? H : W;
  const int st = y ? W : 1;
  for (int e0 = threadIdx.x; e0 < hw; e0 += kBatch * blockDim.x) {
    int row[kBatch];  // the element's row along its line, or -1
    float l[kBatch], xc[kBatch], xa[kBatch], xb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      const bool in = e < hw;
      const int h = e / W;
      const int i = y ? h : e - h * W;
      row[k] = in ? i : -1;
      l[k] = in ? lam[e] : 0.0f;
      xc[k] = in ? xo[e] : 0.0f;
      xa[k] = in && i > 0 ? xo[e - st] : 0.0f;
      xb[k] = in && i + 1 < n ? xo[e + st] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = row[k];
      if (i < 0) continue;
      const float gb = -l[k] * xc[k];
      const float ga = i > 0 ? -l[k] * xa[k] : 0.0f;
      const float gc = i + 1 < n ? -l[k] * xb[k] : 0.0f;
      const float v =
          i == 0 ? gb - gc : (i == n - 1 ? gb - ga : 2.0f * gb - ga - gc);
      fold[e0 + k * blockDim.x] = v * dtf;
    }
  }
}

// The smooth3 adjoint of fold along the sweep axis (the 3-tap sum with zeros
// outside the line, over 3, plus one more third on the line's two edge
// elements), gated by base + tc*tt > eps, added to pb[e] (base) and, times
// tt, to pt[e] (time coefficient).  A thread an element, the same elements
// every call (no other thread touches them), kBatch elements' loads (the
// partials' too) at once.
__device__ __forceinline__ void accumulate_pass(
    const float* __restrict__ fold, float* __restrict__ pb,
    float* __restrict__ pt, const float* __restrict__ base,
    const float* __restrict__ tc, int H, int W, bool y, float tt, float eps) {
  const int hw = H * W;
  const int n = y ? H : W;
  const int es = y ? W : 1;
  const float third = 1.0f / 3.0f;
  for (int e0 = threadIdx.x; e0 < hw; e0 += kBatch * blockDim.x) {
    int row[kBatch];
    float g[kBatch], left[kBatch], right[kBatch], raw[kBatch], vb[kBatch],
        vt[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      const bool in = e < hw;
      const int h = e / W;
      const int i = y ? h : e - h * W;
      row[k] = in ? i : -1;
      g[k] = in ? fold[e] : 0.0f;
      left[k] = in && i > 0 ? fold[e - es] : 0.0f;
      right[k] = in && i < n - 1 ? fold[e + es] : 0.0f;
      raw[k] = in ? __ldg(base + e) + __ldg(tc + e) * tt : 0.0f;
      vb[k] = in ? pb[e] : 0.0f;
      vt[k] = in ? pt[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = row[k];
      if (i < 0 || !(raw[k] > eps)) continue;
      float gsm = (left[k] + g[k] + right[k]) * third;
      if (i == 0 || i == n - 1) gsm += g[k] * third;
      const int e = e0 + k * blockDim.x;
      pb[e] = vb[k] + gsm;
      pt[e] = vt[k] + gsm * tt;
    }
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
                         const float* __restrict__ ts,
                         const float* __restrict__ table,
                         float* __restrict__ gu, float* __restrict__ partials,
                         float* __restrict__ ws, int B, int H, int W,
                         int num_steps, float dtf_x, float dtf_y, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = strip_lines(H, W, blockDim.x);
  const int hw = H * W;
  float* x1 = ws + blockIdx.x * wide_workspace(H, W, true);
  float* x2 = x1 + hw;
  float* c2 = x2 + hw;  // the cotangent's buffer beside grad u
  float* fold = c2 + hw;
  // this block's partials: (4, H, W), ab, atc, bb, btc
  float* part = partials + blockIdx.x * 4LL * hw;
  for (int q = 0; q < 4; ++q)
    for (int e = threadIdx.x; e < hw; e += blockDim.x) part[q * hw + e] = 0.0f;
  __syncthreads();
  const long long plane = (long long)B * hw;  // one step of res
  long long first, last;
  tile_of(B, first, last);
  for (long long b = first; b < last; ++b) {
    const float* cot = g + b * hw;
    float* gub = gu + b * hw;
    if (num_steps == 0) copy_image(cot, gub, hw);
    // adjoint a of the image's 3S writes grad u where 3S - 1 - a is even,
    // so that they alternate with c2 and the last lands in grad u
    int a = 0;
    auto lam_buffer = [&]() { return (3 * num_steps - 1 - a++) % 2 == 0
                                         ? gub : c2; };
    for (int s = num_steps - 1; s >= 0; --s) {
      const float* rs = res + s * plane + b * hw;
      const float* x3 = s == num_steps - 1 ? out + b * hw
                                           : res + (s + 1) * plane + b * hw;
      const float t0 = __ldg(ts + 3 * s);
      const float t1 = __ldg(ts + 3 * s + 1);
      const float t2 = __ldg(ts + 3 * s + 2);
      // recompute x1 = x-sweep(res[s]) and x2 = y-sweep(x1)
      wide_sweep<false>(table, 3 * s, rs, x1, H, W, false, smem, P);
      __syncthreads();
      wide_sweep<false>(table, 3 * s + 1, x1, x2, H, W, true, smem, P);
      __syncthreads();
      // the x adjoint at t2, on x3
      float* lam = lam_buffer();
      wide_sweep<true>(table, 3 * s + 2, cot, lam, H, W, false, smem,
                       P);
      __syncthreads();
      fold_pass(lam, x3, fold, H, W, false, dtf_x);
      __syncthreads();
      accumulate_pass(fold, part, part + hw, alpha_base, alpha_tc, H, W,
                      false, t2, eps);
      cot = lam;
      // the y adjoint at t1, on x2 (beside the accumulation above)
      lam = lam_buffer();
      wide_sweep<true>(table, 3 * s + 1, cot, lam, H, W, true, smem,
                       P);
      __syncthreads();
      fold_pass(lam, x2, fold, H, W, true, dtf_y);
      __syncthreads();
      accumulate_pass(fold, part + 2 * hw, part + 3 * hw, beta_base, beta_tc,
                      H, W, true, t1, eps);
      cot = lam;
      // the x adjoint at t0, on x1
      lam = lam_buffer();
      wide_sweep<true>(table, 3 * s, cot, lam, H, W, false, smem, P);
      __syncthreads();
      fold_pass(lam, x1, fold, H, W, false, dtf_x);
      __syncthreads();
      accumulate_pass(fold, part, part + hw, alpha_base, alpha_tc, H, W,
                      false, t0, eps);
      cot = lam;
    }
  }
}

// The second pass: the sum of the blocks' partial rows (4 H W floats),
// element e, in a fixed order: slice k of kSumSlices sums blocks k,
// k + kSumSlices, ... in order, then the slices are added in order
// (fused_grayscale_vjp.cu::sum_partials; ops/fused_channel_vjp.py::
// _sum_tile_partials).
__global__ void __launch_bounds__(kSumLanes * kSumSlices)
    wide_sum_partials(const float* __restrict__ partials, int hw, int blocks,
                      float* __restrict__ g_ab, float* __restrict__ g_atc,
                      float* __restrict__ g_bb, float* __restrict__ g_btc) {
  __shared__ float slices[kSumSlices][kSumLanes];
  const int row = 4 * hw;
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
    const int which = e / hw;
    float* dst = which == 0 ? g_ab : which == 1 ? g_atc : which == 2 ? g_bb
                                                                     : g_btc;
    dst[e - which * hw] = sum;
  }
}

// The factor table of ``sweeps`` sweeps into ``table``.
cudaError_t make_wide_table(const float* alpha_base, const float* alpha_tc,
                            const float* beta_base, const float* beta_tc,
                            const float* ts, float* table, int H, int W,
                            int sweeps, float dtf_x, float dtf_y, float eps,
                            cudaStream_t stream) {
  if (sweeps == 0) return cudaSuccess;
  const int lanes = 2 * (H > W ? H : W);
  const dim3 grid((unsigned)((lanes + kFactorThreads - 1) / kFactorThreads),
                  (unsigned)sweeps);
  wide_factor_table<<<grid, kFactorThreads, 0, stream>>>(
      alpha_base, alpha_tc, beta_base, beta_tc, ts, table, H, W, dtf_x, dtf_y,
      eps);
  return cudaGetLastError();
}

}  // namespace

// The launch shape of the wide scheme for (H, W) images, checked the first
// time the wrapper launches a plan of ops/fused_grayscale.py::gray_wide_plan:
// threads a block, bytes of shared memory a block (none), floats of
// workspace a block (``backward``: K8's, else K6/K7's) and floats a sweep
// takes in the factor table.
extern "C" int fused_grayscale_wide_layout(int H, int W, int backward,
                                           int* threads, int* smem,
                                           long long* workspace, int* slab) {
  *threads = wide_threads(H, W);
  *smem = wide_smem(H, W, *threads);
  *workspace = wide_workspace(H, W, backward != 0);
  *slab = gl::slab_floats(H, W);
  return 0;
}

// K6 (res null) and K7 (res: the (num_steps, B, H, W) residuals) by the wide
// scheme: the factor table into ``table`` (3 num_steps slabs of the layout's
// floats), then ``grid`` blocks, each a tile of whole images, each with
// fused_grayscale_wide_layout's workspace at ws + block * workspace.  Returns
// cudaGetLastError() after each launch; the caller raises if it is not 0.
// The wrapper checks H, W <= 1,440 and the table and workspace bytes.
extern "C" int fused_grayscale_wide_forward(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* ts, float* res, float* table, float* ws, int B, int H, int W,
    int grid, int num_steps, float dtf_x, float dtf_y, float eps,
    void* stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = wide_threads(H, W);
  const size_t smem = (size_t)wide_smem(H, W, threads);
  cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)wide_forward_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  err = make_wide_table(alpha_base, alpha_tc, beta_base, beta_tc, ts, table,
                        H, W, 3 * num_steps, dtf_x, dtf_y, eps, st);
  if (err != cudaSuccess) return (int)err;
  wide_forward_kernel<<<grid, threads, smem, st>>>(
      u, out, table, res, ws, B, H, W, num_steps);
  return (int)cudaGetLastError();
}

// K8 by the wide scheme: the factor table, grad u into gu and the blocks'
// partials into ``partials`` (grid rows of 4 H W floats), then their sum
// into the four field gradients; three kernels on one stream.  Returns
// cudaGetLastError() after each launch.
extern "C" int fused_grayscale_wide_backward(
    const float* g, const float* res, const float* out,
    const float* alpha_base, const float* alpha_tc, const float* beta_base,
    const float* beta_tc, const float* ts, float* gu, float* g_ab,
    float* g_atc, float* g_bb, float* g_btc, float* table, float* partials,
    float* ws, int B, int H, int W, int grid, int num_steps, float dtf_x,
    float dtf_y, float eps, void* stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = wide_threads(H, W);
  const size_t smem = (size_t)wide_smem(H, W, threads);
  cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)wide_backward_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  err = make_wide_table(alpha_base, alpha_tc, beta_base, beta_tc, ts, table,
                        H, W, 3 * num_steps, dtf_x, dtf_y, eps, st);
  if (err != cudaSuccess) return (int)err;
  wide_backward_kernel<<<grid, threads, smem, st>>>(
      g, res, out, alpha_base, alpha_tc, beta_base, beta_tc, ts, table, gu,
      partials, ws, B, H, W, num_steps, dtf_x, dtf_y, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row = 4 * H * W;
  wide_sum_partials<<<(row + kSumLanes - 1) / kSumLanes,
                      dim3(kSumLanes, kSumSlices), 0, st>>>(
      partials, H * W, grid, g_ab, g_atc, g_bb, g_btc);
  return (int)cudaGetLastError();
}
