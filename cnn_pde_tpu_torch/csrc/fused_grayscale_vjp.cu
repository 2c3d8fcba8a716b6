// K8: the backward of a whole GrayscaleDiffusion layer in one C call, for
// Hopper (sm_90a): the layer's factor table (as K6/K7 make it), the kernel
// that walks each block's images through the steps in reverse, and a small
// one that sums the blocks' partial field gradients in a fixed order.
//
// Replaces: cnn_pde_tpu/ops/pallas_fused_adi_vjp.py::_bwd_call (the Pallas
// kernel built by _make_bwd_kernel, pallas_call at :228, with _sweepT_rows
// and _grad_r).
//
// Given the cotangent g of the layer's output, the residuals res (S, B, H,
// W) that K7 wrote (each step's input state) and the output, per step s
// from the last:
//   recompute x1 = x-sweep(res[s], t0) and x2 = y-sweep(x1, t1), as K6 does;
//     x3 is the step's output: res[s + 1], or the layer's output at S - 1;
//   adjoints, last sweep first: x at t2 on x3, y at t1 on x2, x at t0 on x1.
//     Each is lam = T^-T cot per line, then grad_r folded onto the Neumann
//     structure (2gb - ga - gc inside the line, gb - gc on the first row,
//     gb - ga on the last, with gb = -lam*x, ga[i] = -lam[i]x[i-1],
//     gc[i] = -lam[i]x[i+1]) summed over the block's images in image order,
//     times dtf; then the adjoint of smooth3 along the sweep axis (the 3-tap
//     sum with zero outside the line, over 3, plus one more third of the
//     element itself on the line's two edge elements: the replicate pad, as
//     B5 writes it), gated by the one-sided clamp mask base + tc*t > eps,
//     added to the base gradient and, times t, to the time-coefficient
//     gradient; cot <- lam.
//
// What bounds it.  Bytes: g, the output and the S residuals read once,
// grad u written once, the fields and their gradients.  Operations: per
// element, step and image two recompute sweeps, three adjoint solves and
// three grad_r folds with their image sums, about 46 flops; the bands and
// factors of the five solves a step are the same for every image and are
// counted once.  At the mnist layer the bound is a few microseconds to
// about 12 at B = 1024, set by bytes.  What holds the kernel above it is
// latency: five serial line sweeps a step and the barriers between them.
//
// What the design does about it (grayscale_lines.cuh).
// - The factor table is K6's, made once a call by the same first kernel:
//   the recompute sweeps read (piv, m) of T and the adjoints (piv, r) of
//   its transpose, whose pivots are T's.  No factor code runs in the main
//   kernel; each sweep's two slots come into one of two shared buffers by
//   cp.async while the threads apply the previous sweep (and, before an
//   adjoint, fold the one before).  Every line is solved by two threads
//   that meet in its middle row, as in K6.  The main kernel is a
//   programmatic dependent launch: its blocks load their images while the
//   factor kernel runs.
// - Five buffers of the block's images in shared memory, rows of W | 1
//   floats: the cotangent, x1, x2 and two that take turns as the step's
//   input res[s] and its output x3.  x1 and x2 are solved out of place
//   (res[s] -> x1 -> x2), so no copy sits between them and res[s] stays to
//   be the next step's x3.  res[s - 1] comes by cp.async into the buffer
//   of x3 as soon as the x adjoint at t2 has used it.
// - Field gradients: a pass with a thread a field element sums the grad_r
//   fold over the block's images in image order into an (H, W) buffer; the
//   smooth3 adjoint, the gate and the accumulation into the block's (4, H,
//   W) partials in shared memory run in the same phase as the next
//   adjoint's solve, on the threads that solve no line where a small tile
//   leaves them idle.  Each partial element has one owner, the same every
//   step; the block writes its row once.
// - A second kernel sums the rows over blocks in a fixed order (eight
//   interleaved slices, then the slices in order), as K5's does.  No
//   atomics: two runs on the same inputs give the same bits.

#include <cuda_runtime.h>

#include "grayscale_lines.cuh"

namespace {

using channel_lines::Tile;
namespace gl = grayscale_lines;

constexpr int kBuffers = 5;  // image buffers: cot, x1, x2, res[s], x3

// Floats beside the images: two factor buffers of two slots, the (4, H, W)
// partials and the (H, W) fold.
__host__ __device__ __forceinline__ int fixed_floats(int H, int W) {
  return 4 * gl::max_slot(H, W) + 5 * H * W;
}

long long block_bytes(int H, int W, int tile) {
  return 4LL * (fixed_floats(H, W) +
                (long long)kBuffers * tile *
                    channel_lines::image_floats(1, H, W));
}

constexpr int kPass = 4;  // field elements a thread moves at once

// All threads: the grad_r fold of the adjoint just solved (lam in cot) of a
// sweep whose output was xo, summed over the block's images in image order,
// times dtf, into fold (H, W); a thread a field element, kPass elements'
// loads at once.  magic_w = ceil(2^32 / W): e / W = (e magic_w) >> 32.
__device__ void fold_pass(const float* cot, const float* xo, float* fold,
                          const Tile& t, bool y, float dtf,
                          unsigned long long magic_w) {
  const int n = y ? t.H : t.W;
  const int st = y ? t.ld : 1;
  for (int e0 = threadIdx.x; e0 < t.hw; e0 += kPass * blockDim.x) {
    float sum[kPass];
    int i[kPass], o[kPass];
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int e = min(e0 + u * (int)blockDim.x, t.hw - 1);
      const int h = (int)(((unsigned long long)e * magic_w) >> 32);
      const int w = e - h * t.W;
      i[u] = y ? h : w;
      o[u] = h * t.ld + w;
      sum[u] = 0.0f;
    }
    for (int g = 0; g < t.nimg; ++g) {
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int og = g * t.img + o[u];
        const float l = cot[og];
        const float gb = -l * xo[og];
        const float ga = i[u] > 0 ? -l * xo[og - st] : 0.0f;
        const float gc = i[u] + 1 < n ? -l * xo[og + st] : 0.0f;
        sum[u] += i[u] == 0 ? gb - gc
                            : (i[u] == n - 1 ? gb - ga
                                             : 2.0f * gb - ga - gc);
      }
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int e = e0 + u * (int)blockDim.x;
      if (e < t.hw) fold[e] = sum[u] * dtf;
    }
  }
}

// Threads [first, first + count) of the block: the smooth3 adjoint of fold
// along the sweep axis, gated by base + tc*tt > eps, added to acc[e] (base)
// and, times tt, to acc[hw + e] (time coefficient); a thread a field
// element, kPass elements' loads at once.
__device__ void accumulate_pass(const float* fold, float* acc,
                                const float* __restrict__ base,
                                const float* __restrict__ tc, const Tile& t,
                                bool y, float tt, float eps,
                                unsigned long long magic_w, int first,
                                int count) {
  const int me = (int)threadIdx.x - first;
  if (me < 0 || me >= count) return;
  const int n = y ? t.H : t.W;
  const int es = y ? t.W : 1;
  const float third = 1.0f / 3.0f;
  for (int e0 = me; e0 < t.hw; e0 += kPass * count) {
    float gsm[kPass];
    bool on[kPass];
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int e = min(e0 + u * count, t.hw - 1);
      const int h = (int)(((unsigned long long)e * magic_w) >> 32);
      const int i = y ? h : e - h * t.W;
      const float g = fold[e];
      const float left = i > 0 ? fold[e - es] : 0.0f;
      const float right = i < n - 1 ? fold[e + es] : 0.0f;
      gsm[u] = (left + g + right) * third;
      if (i == 0 || i == n - 1) gsm[u] += g * third;
      on[u] = __ldg(base + e) + __ldg(tc + e) * tt > eps;
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int e = e0 + u * count;
      if (e < t.hw && on[u]) {
        acc[e] += gsm[u];
        acc[t.hw + e] += gsm[u] * tt;
      }
    }
  }
}

__global__ void __launch_bounds__(gl::kMaxThreads, 1)
    fused_grayscale_bwd_kernel(
        const float* __restrict__ g, const float* __restrict__ res,
        const float* __restrict__ out, const float* __restrict__ alpha_base,
        const float* __restrict__ alpha_tc,
        const float* __restrict__ beta_base,
        const float* __restrict__ beta_tc, const float* __restrict__ ts,
        const float* __restrict__ table, float* __restrict__ gu,
        float* __restrict__ partials, int B, int H, int W, int num_steps,
        float dtf_x, float dtf_y, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int first, count;
  channel_lines::block_images(B, first, count);
  const Tile t = channel_lines::make_tile(1, H, W, count);
  const int tile = (B + gridDim.x - 1) / gridDim.x;
  const int fbuf = 2 * gl::max_slot(H, W);
  auto factors = [&](int a) { return smem + (a & 1) * fbuf; };
  float* acc = smem + 2 * fbuf;  // (4, H, W): ab, atc, bb, btc
  float* fold = acc + 4 * t.hw;  // (H, W)
  float* cot = smem + fixed_floats(H, W);
  float* x1 = cot + tile * t.img;
  float* x2 = x1 + tile * t.img;
  float* rs = x2 + tile * t.img;  // the step's input res[s]
  float* xo = rs + tile * t.img;  // the step's output x3

  const long long hw = t.hw;
  const long long plane = (long long)B * hw;  // one step of res
  const long long tile0 = (long long)first * hw;
  for (int e = threadIdx.x; e < 4 * t.hw; e += blockDim.x) acc[e] = 0.0f;

  // Apply a (5 a step, from the last step): the recompute x at t0 and y at
  // t1 with T, then the adjoints x at t2, y at t1 and x at t0 with T^T.
  auto sweep_of = [&](int a, bool& adjoint) {
    const int s = num_steps - 1 - a / 5;
    const int k = a % 5;
    adjoint = k >= 2;
    return 3 * s + (k < 2 ? k : 4 - k);
  };
  auto fetch = [&](int a) {
    if (a < 5 * num_steps) {
      bool adjoint;
      const int n = sweep_of(a, adjoint);
      gl::fetch_factors(factors(a), table, n, adjoint, H, W);
      channel_sweep::cp_async_commit();
    }
  };

  // the images in while the factor kernel runs; then the first factors
  channel_lines::load_rows<true>(cot, g + tile0, t, 0, blockDim.x);
  channel_lines::load_rows<true>(xo, out + tile0, t, 0, blockDim.x);
  channel_lines::load_rows<true>(rs, res + (num_steps - 1) * plane + tile0, t,
                                 0, blockDim.x);
  channel_sweep::cp_async_commit();
  gl::wait_for_table();
  fetch(0);
  channel_sweep::cp_async_wait<0>();
  __syncthreads();

  const gl::Lines lx = gl::lines_of(t, false);
  const gl::Lines ly = gl::lines_of(t, true);
  const gl::Group grp = gl::group_of(tile, t.nimg);
  const unsigned long long magic_w = (0x100000000ULL + W - 1) / W;
  // The accumulation of an adjoint's fold runs in the phase of the next
  // solve: by the threads that solve no line where enough are left over
  // (small tiles), so that it runs beside the solves, else by all.
  const int busy = min((int)blockDim.x,
                       (grp.lanes * max(H, W) + 31) / 32 * 32);
  const int acc_first = (int)blockDim.x - busy >= 64 ? busy : 0;
  const int acc_count = (int)blockDim.x - acc_first;
  // the fold of the last adjoint of the step before, not yet accumulated
  float pending_t = 0.0f;
  bool pending = false;
  for (int s = num_steps - 1; s >= 0; --s) {
    const int a0 = 5 * (num_steps - 1 - s);
    const float t0 = __ldg(ts + 3 * s);
    const float t1 = __ldg(ts + 3 * s + 1);
    const float t2 = __ldg(ts + 3 * s + 2);
    // x1 = x-sweep(res[s]); the last fold of step s + 1 (alpha at its t0)
    fetch(a0 + 1);
    if (pending)
      accumulate_pass(fold, acc, alpha_base, alpha_tc, t, false, pending_t,
                      eps, magic_w, acc_first, acc_count);
    gl::apply_sweep<false>(factors(a0), rs, x1, t, lx, grp);
    channel_sweep::cp_async_wait<0>();
    __syncthreads();
    // x2 = y-sweep(x1)
    fetch(a0 + 2);
    gl::apply_sweep<false>(factors(a0 + 1), x1, x2, t, ly, grp);
    channel_sweep::cp_async_wait<0>();
    __syncthreads();
    // the x adjoint at t2, on x3
    fetch(a0 + 3);
    gl::apply_sweep<true>(factors(a0 + 2), cot, cot, t, lx, grp);
    __syncthreads();
    fold_pass(cot, xo, fold, t, false, dtf_x, magic_w);
    channel_sweep::cp_async_wait<0>();
    __syncthreads();
    // the y adjoint at t1, on x2; res[s - 1] comes into x3's buffer
    fetch(a0 + 4);
    if (s > 0) {
      channel_lines::load_rows<true>(xo, res + (s - 1) * plane + tile0, t, 0,
                                     blockDim.x);
      channel_sweep::cp_async_commit();
    }
    accumulate_pass(fold, acc, alpha_base, alpha_tc, t, false, t2, eps,
                    magic_w, acc_first, acc_count);
    gl::apply_sweep<true>(factors(a0 + 3), cot, cot, t, ly, grp);
    __syncthreads();
    fold_pass(cot, x2, fold, t, true, dtf_y, magic_w);
    channel_sweep::cp_async_wait<0>();
    __syncthreads();
    // the x adjoint at t0, on x1
    fetch(a0 + 5);
    accumulate_pass(fold, acc + 2 * t.hw, beta_base, beta_tc, t, true, t1,
                    eps, magic_w, acc_first, acc_count);
    gl::apply_sweep<true>(factors(a0 + 4), cot, cot, t, lx, grp);
    __syncthreads();
    fold_pass(cot, x1, fold, t, false, dtf_x, magic_w);
    channel_sweep::cp_async_wait<0>();
    __syncthreads();
    pending = true;
    pending_t = t0;
    // res[s - 1] is the next step's input, res[s] its output
    float* next = xo;
    xo = rs;
    rs = next;
  }
  accumulate_pass(fold, acc, alpha_base, alpha_tc, t, false, pending_t, eps,
                  magic_w, 0, blockDim.x);
  channel_lines::store_rows(gu + tile0, cot, t, 0, blockDim.x);
  __syncthreads();
  float* part = partials + (long long)blockIdx.x * 4 * hw;
  for (int e = threadIdx.x; e < 4 * t.hw; e += blockDim.x) part[e] = acc[e];
}

// The second pass: the sum of the blocks' partial rows (4 H W floats),
// element e, in a fixed order: slice k of kSumSlices sums blocks k,
// k + kSumSlices, ... in order, then the slices are added in order
// (ops/fused_channel_vjp.py::_sum_tile_partials).  Neighbouring threads
// read neighbouring words.
constexpr int kSumLanes = 32;
constexpr int kSumSlices = 8;

__global__ void __launch_bounds__(kSumLanes * kSumSlices)
    sum_partials(const float* __restrict__ partials, int hw, int blocks,
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

}  // namespace

// The launch shape of a plan of the wrapper (ops/fused_grayscale.py::
// plan_grayscale with backward), checked as fused_grayscale_layout: threads
// a block, bytes of shared memory a block and floats a sweep takes in the
// factor table.  Beside five image buffers a block holds two factor
// buffers, its (4, H, W) partials and an (H, W) fold.
extern "C" int fused_grayscale_bwd_layout(int H, int W, int tile,
                                          int* threads, int* smem,
                                          int* slab) {
  *threads = gl::block_threads(H, W, tile);
  *smem = (int)block_bytes(H, W, tile);
  *slab = gl::slab_floats(H, W);
  return 0;
}

// K8: the factor table into ``table`` (as fused_grayscale_diffusion),
// grad u into gu and the blocks' partials into ``partials`` (grid rows of
// 4 H W floats), then their sum into the four field gradients; three
// kernels on one stream.  ``grid`` and the returned error as for
// fused_grayscale_diffusion.
extern "C" int fused_grayscale_diffusion_bwd(
    const float* g, const float* res, const float* out,
    const float* alpha_base, const float* alpha_tc, const float* beta_base,
    const float* beta_tc, const float* ts, float* gu, float* g_ab,
    float* g_atc, float* g_bb, float* g_btc, float* table, float* partials,
    int B, int H, int W, int grid, int num_steps, float dtf_x, float dtf_y,
    float eps, void* stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = (B + grid - 1) / grid;
  if (tile > gl::kMaxTile) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)block_bytes(H, W, tile);
  cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_grayscale_bwd_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  err = gl::make_table(alpha_base, alpha_tc, beta_base, beta_tc, ts, table,
                       H, W, 3 * num_steps, dtf_x, dtf_y, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = gl::launch_after_table(
      fused_grayscale_bwd_kernel, grid, gl::block_threads(H, W, tile), smem,
      st, g, res, out, alpha_base, alpha_tc, beta_base, beta_tc, ts,
      (const float*)table, gu, partials, B, H, W, num_steps, dtf_x, dtf_y,
      eps);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row = 4 * H * W;
  sum_partials<<<(row + kSumLanes - 1) / kSumLanes,
                 dim3(kSumLanes, kSumSlices), 0, st>>>(
      partials, H * W, grid, g_ab, g_atc, g_bb, g_btc);
  return (int)cudaGetLastError();
}
