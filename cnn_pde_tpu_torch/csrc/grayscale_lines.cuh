// The batch-free factor table of a GrayscaleDiffusion layer and the line
// machinery around it, shared by K6/K7 (fused_grayscale.cu) and K8
// (fused_grayscale_vjp.cu), for Hopper (sm_90a).
//
// A grayscale layer's sweep systems depend only on the four (H, W) fields
// and the substep times, not on the images.  So one small kernel
// (factor_table) makes the factors of all 3S sweeps of a layer at once,
// before any image is touched: a block a sweep, two threads a line.  The
// block stages the field clamped below at eps (max(base + tc*t, eps)),
// smooths it along the sweep's lines (the 3-tap replicate average
// l/3 + c/3 + r/3 of ops/smoothing.py::smooth3) and scales it by the
// sweep's dtf into r; then each line of the Neumann system a = c = -r,
// b = 1 + 2r (1 + r on the edge rows) + eps is factored from both ends
// toward its middle row k = n / 2 (a twisted factorisation): one thread
// runs rows 0 .. k-1 downward, d[i] = b[i] - r[i] m[i-1], the other rows
// n-1 .. k+1 upward, d[i] = b[i] - r[i] m[i+1], with piv = 1/d (a
// Newton-refined reciprocal, channel_lines::reciprocal) and m = r piv; row
// k takes the twist pivot 1 / (b[k] - r[k] (m[k-1] + m[k+1])).  The
// transposed system (sub'[i] = -r[i-1], super'[i] = -r[i+1]) has the same
// pivots, so one table serves the forward sweeps, from (piv, m), and K8's
// adjoints, from (piv, r).
//
// The table: sweep n (step n / 3; x at ts[s, 0], y at ts[s, 1], x at
// ts[s, 2]) is a slab of three slots, m, piv and r, each holding its lines
// j = 0 .. L-1 (L = H for x, W for y) n|1 floats apart (odd, so that
// neighbouring lines fall in different banks once in shared memory), slots
// and slabs a multiple of four floats apart (16-byte copies).  A block
// copies each sweep's two slots it needs into a factor buffer by cp.async,
// sweeps ahead of the one it applies.
//
// A block keeps its images in shared memory as rows of ld = W | 1 floats
// (channel_lines::Tile with C = 1).  Its threads solve a sweep's lines in
// groups (Group): 2P lanes a line, P the smallest power of two not below
// the block's images, two lanes (the two halves of the line, meeting at
// row k) an image.  A line's images thus sit in one warp and read its
// factors together; each lane's serial chain is half a line.

#pragma once

#include <cuda_runtime.h>

#include "channel_lines.cuh"

namespace grayscale_lines {

using channel_sweep::kMaxN;

constexpr int kFactorThreads = 128;  // the factor kernel: two a line
constexpr int kMaxThreads = 512;     // a main kernel's block (more leave
                                     // under 128 registers a thread)
constexpr int kMinThreads = 256;
constexpr int kMaxTile = 4;          // images a block (the wrapper's plan)

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) / 4 * 4;
}

// Floats of one slot of a sweep along W (x: H lines of W rows) or down the
// columns (y: W lines of H rows).
__host__ __device__ __forceinline__ int slot_floats(int H, int W, bool y) {
  return y ? round4(W * (H | 1)) : round4(H * (W | 1));
}

// Floats of the larger sweep's slot: a factor buffer holds two.
__host__ __device__ __forceinline__ int max_slot(int H, int W) {
  const int x = slot_floats(H, W, false);
  const int y = slot_floats(H, W, true);
  return x > y ? x : y;
}

// Floats a sweep takes in the table: three slots of the larger sweep.
__host__ __device__ __forceinline__ int slab_floats(int H, int W) {
  return 3 * max_slot(H, W);
}

// The smallest power of two >= n (n <= kMaxTile: the planner's largest
// tile).
__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Threads a block of a main kernel: a group of 2 pow2_at_least(tile)
// lanes a line of the longer sweep (Group), whole warps, at least
// kMinThreads (the copies and the per-element passes use them), at most
// kMaxThreads (the groups then take lines in turn).
__host__ __device__ __forceinline__ int block_threads(int H, int W,
                                                     int tile) {
  const int lanes = 2 * pow2_at_least(tile) * (H > W ? H : W);
  int t = (lanes + 31) / 32 * 32;
  if (t < kMinThreads) t = kMinThreads;
  return t > kMaxThreads ? kMaxThreads : t;
}

// Sweep n of the layer: step n / 3; y for the middle one.
__device__ __forceinline__ bool sweep_is_y(int n) { return n % 3 == 1; }

// Lanes 2q and 2q + 1 of a warp: the pair that shares a line.
__device__ __forceinline__ unsigned pair_mask() {
  return 3u << ((threadIdx.x & 31) & ~1u);
}

// The factor kernel: block n factors sweep n into the table (see above).
// Its threads stage the clamped field (coalesced), smooth it along the
// sweep's lines into r, then two threads a line factor it from both ends
// toward the twist row k = len / 2: the first rows 0 .. k-1 downward
// (d[i] = b[i] - r[i] m[i-1]), the second rows len-1 .. k+1 upward
// (d[i] = b[i] - r[i] m[i+1]), piv = 1/d, m = r piv; at k the twist pivot
// 1 / (b[k] - r[k] (m[k-1] + m[k+1])).
__global__ void __launch_bounds__(kFactorThreads)
    factor_table(const float* __restrict__ alpha_base,
                 const float* __restrict__ alpha_tc,
                 const float* __restrict__ beta_base,
                 const float* __restrict__ beta_tc,
                 const float* __restrict__ ts, float* __restrict__ table,
                 int H, int W, float dtf_x, float dtf_y, float eps) {
  __shared__ float c[kMaxN * kMaxN];        // the clamped field (H, W)
  __shared__ float rs[kMaxN * (kMaxN + 1)];  // r, line-major, fld apart
  // the kernel launched after this one may start; it waits for the table
  // in wait_for_table
  asm volatile("griddepcontrol.launch_dependents;");
  const int n = blockIdx.x;
  const bool y = sweep_is_y(n);
  const int lines = y ? W : H;
  const int len = y ? H : W;
  const int fld = len | 1;
  const int slot = slot_floats(H, W, y);
  const float* base = y ? beta_base : alpha_base;
  const float* tc = y ? beta_tc : alpha_tc;
  const float tt = __ldg(ts + n);  // ts is (S, 3): sweep n is ts[n / 3, n % 3]
  const float dtf = y ? dtf_y : dtf_x;
  const int hw = H * W;
  for (int e = threadIdx.x; e < hw; e += blockDim.x)
    c[e] = fmaxf(__ldg(base + e) + __ldg(tc + e) * tt, eps);
  __syncthreads();
  // row i of line j is field element j*W + i (x) or i*W + j (y)
  const int ls = y ? 1 : W;
  const int es = y ? W : 1;
  const float third = 1.0f / 3.0f;
  for (int q = threadIdx.x; q < lines * len; q += blockDim.x) {
    const int j = q / len;
    const int i = q - j * len;
    const float* cl = c + j * ls;
    const float l = cl[(i > 0 ? i - 1 : 0) * es];
    const float r = cl[(i + 1 < len ? i + 1 : len - 1) * es];
    rs[j * fld + i] = (l * third + cl[i * es] * third + r * third) * dtf;
  }
  __syncthreads();
  const int j = threadIdx.x >> 1;
  if (j >= lines) return;
  const bool second = threadIdx.x & 1;
  const float* r = rs + j * fld;
  float* F = table + (long long)n * slab_floats(H, W) + j * fld;
  float* fm = F;             // m[i]
  float* fp = F + slot;      // piv[i]
  float* fr = F + 2 * slot;  // r[i]
  const int k = len >> 1;
  const int dir = second ? -1 : 1;
  const int cnt = second ? len - 1 - k : k;
  int i = second ? len - 1 : 0;
  float m = 0.0f;  // m of the row before, toward this end
  for (int q = 0; q < cnt; ++q, i += dir) {
    const float rc = r[i];
    const float b =
        ((i == 0 || i == len - 1) ? 1.0f + rc : 1.0f + 2.0f * rc) + eps;
    const float p = channel_lines::reciprocal(b - rc * m);
    m = rc * p;
    fm[i] = m;
    fp[i] = p;
    fr[i] = rc;
  }
  // the twist row, from both ends' last multipliers (the first's first)
  const float other = __shfl_xor_sync(pair_mask(), m, 1);
  if (!second) {
    const float rc = r[k];
    const float b =
        ((k == 0 || k == len - 1) ? 1.0f + rc : 1.0f + 2.0f * rc) + eps;
    const float p = channel_lines::reciprocal(b - rc * (m + other));
    fm[k] = rc * p;
    fp[k] = p;
    fr[k] = rc;
  }
}

// Launch the factor kernel for a layer of ``sweeps`` sweeps.  The kernel
// that reads the table is launched after it with launch_after_table.
inline cudaError_t make_table(const float* alpha_base, const float* alpha_tc,
                              const float* beta_base, const float* beta_tc,
                              const float* ts, float* table, int H, int W,
                              int sweeps, float dtf_x, float dtf_y, float eps,
                              cudaStream_t stream) {
  factor_table<<<sweeps, kFactorThreads, 0, stream>>>(
      alpha_base, alpha_tc, beta_base, beta_tc, ts, table, H, W, dtf_x,
      dtf_y, eps);
  return cudaGetLastError();
}

// Launch ``kernel``, which reads the factor table, after the factor
// kernel on the same stream as a programmatic dependent launch: its blocks
// may start while the factor kernel runs and wait for the table in
// wait_for_table, so the launch and the blocks' first loads overlap it.
template <typename... Args>
cudaError_t launch_after_table(void (*kernel)(Args...), int grid,
                               int threads, size_t smem, cudaStream_t stream,
                               Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// In a kernel launched by launch_after_table: wait until the factor kernel
// has finished and its table is visible.
__device__ __forceinline__ void wait_for_table() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// All threads: start copying sweep n's two slots into the factor buffer
// F (T: m and rd; kT, its transpose: rd and r), 16 bytes a copy; the
// caller commits and waits.
__device__ __forceinline__ void fetch_factors(float* F,
                                              const float* __restrict__ table,
                                              int n, bool kT, int H, int W) {
  const int slot = slot_floats(H, W, sweep_is_y(n));
  const float* src =
      table + (long long)n * slab_floats(H, W) + (kT ? slot : 0);
  for (int k = 4 * threadIdx.x; k < 2 * slot; k += 4 * blockDim.x)
    cp_async16(F + k, src + k);
}

// The lines of one sweep of a block's images: along W (x: H lines of W
// rows an image) or down the columns (y: W lines of H rows); ``ls`` and
// ``ss`` the words between lines and between rows in an image buffer,
// ``fld`` between lines in the factors, ``slot`` the factors' second slot.
struct Lines {
  int lines, len, ls, ss, fld, slot;
};

__device__ __forceinline__ Lines lines_of(const channel_lines::Tile& t,
                                          bool y) {
  Lines l;
  l.lines = y ? t.W : t.H;
  l.len = y ? t.H : t.W;
  l.ls = y ? 1 : t.ld;
  l.ss = y ? t.ld : 1;
  l.fld = l.len | 1;
  l.slot = slot_floats(t.H, t.W, y);
  return l;
}

// A thread's place in the block's solves: the threads are cut into groups
// of 2P lanes (P = pow2_at_least(tile)), a group a line at a time; lane
// 2g + half of a group takes image g (the last image again, and stores
// nothing, where g >= nimg) and the half ``second`` of the line.  The
// images of a line sit in one warp, so the lanes read the line's factors
// together (broadcast) and can sum over the images by shuffles.
struct Group {
  int first, count;  // the group's first line, and groups a block
  int lanes;         // 2P
  int g;             // this lane's image
  bool active, second;
  unsigned mask;     // the group's lanes in the warp
};

__device__ __forceinline__ Group group_of(int tile, int nimg) {
  const int lanes = 2 * pow2_at_least(tile);
  Group q;
  q.lanes = lanes;
  q.first = threadIdx.x / lanes;
  q.count = blockDim.x / lanes;
  const int g = (threadIdx.x % lanes) >> 1;
  q.active = g < nimg;
  q.g = q.active ? g : nimg - 1;
  q.second = threadIdx.x & 1;
  const int lane = threadIdx.x & 31;
  q.mask = lanes == 32 ? 0xffffffffu
                       : ((1u << lanes) - 1) << (lane & ~(lanes - 1));
  return q;
}

constexpr int kHalf = 16;   // rows of a half-line held in registers

constexpr int kMnist = 28;  // the grayscale presets' line length

// One half of a line's solve, for the pair of threads that share the line
// (``second``: the half below the twist row k = n / 2), d read from ``in``
// and x written to ``out`` (rows ss apart; the same line in place, or
// another buffer's; nothing stored unless ``active``), from the line's
// table rows: piv and f2 (T: m; kT, the transpose: r).  The first thread
// eliminates rows 0 .. k-1 downward, the second rows n-1 .. k+1 upward (T:
// v[i] = piv[i] d[i] + m[i] v[i-+1]; T^T: v[i] = piv[i] d[i] +
// r[i-+1] piv[i] v[i-+1]); both take row k from the two ends' last values,
// exchanged by a shuffle, and each substitutes its half back outward from
// k (T: x[i] = v[i] + m[i] x[i+-1]; T^T: x[i] = v[i] + r[i+-1] piv[i]
// x[i+-1]).  A half of up to kHalf rows (every line up to 33 rows: mnist's
// 28) stays in registers from its loads to its stores: each row is read
// and written once.  A longer half moves kHalf rows at a time through
// registers, its elimination stored and read back.  Loads come first and
// are unconditional (a row past the half's end loads its last row again);
// the recurrence leaves its value as it was on such a row.
// kN: the line's length at compile time (mnist's 28), so that the halves'
// row counts are known and their chains carry no selects; 0 for any.
template <bool kT, int kN>
__device__ __forceinline__ void twisted_line(const float* __restrict__ piv,
                                             const float* __restrict__ f2,
                                             const float* in, float* out,
                                             int ss, int n_, bool second,
                                             bool active) {
  const int n = kN > 0 ? kN : n_;
  const int k = n >> 1;
  const int dir = second ? -1 : 1;
  const int start = second ? n - 1 : 0;
  const int cnt = second ? n - 1 - k : k;
  // row k's inputs, read before the first half writes row k
  const float dk = in[k * ss];
  const float pk = piv[k];
  const float fk = f2[k];
  const float fa = k > 0 ? f2[k - 1] : 0.0f;
  const float fb = k + 1 < n ? f2[k + 1] : 0.0f;
  auto row = [&](int c) { return start + c * dir; };
  auto twist = [&](float v) {
    const float other = __shfl_xor_sync(pair_mask(), v, 1);
    const float va = second ? other : v;  // v[k-1] (0 when k == 0)
    const float vb = second ? v : other;  // v[k+1] (0 when k == n-1)
    const float x = kT ? pk * fmaf(fb, vb, fmaf(fa, va, dk))
                       : fmaf(fk, va + vb, pk * dk);
    if (active && !second) out[k * ss] = x;
    return x;
  };
  float xv[kHalf], pv[kHalf], fv[kHalf];
  if (cnt <= kHalf) {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const int i = row(max(min(q, cnt - 1), 0));
      xv[q] = in[i * ss];
      pv[q] = piv[i];
      fv[q] = f2[i];
    }
    float v = 0.0f;
    float rp = 0.0f;  // kT: r of the row before
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const bool on = q < cnt;
      // the first row has v = 0, whatever lo is
      const float lo = kT ? rp * pv[q] : fv[q];
      const float nv = fmaf(lo, v, pv[q] * xv[q]);
      v = on ? nv : v;
      rp = on ? fv[q] : rp;
      xv[q] = v;
    }
    float x = twist(v);
    float rn = fk;  // kT: r of the row after, toward k
#pragma unroll
    for (int q = kHalf - 1; q >= 0; --q) {
      const bool on = q < cnt;
      const float up = kT ? rn * pv[q] : fv[q];
      const float nx = fmaf(up, x, xv[q]);
      x = on ? nx : x;
      rn = on ? fv[q] : rn;
      xv[q] = x;
    }
    if (!active) return;
#pragma unroll
    for (int q = 0; q < kHalf; ++q)
      if (q < cnt) out[row(q) * ss] = xv[q];
    return;
  }
  float v = 0.0f;
  float rp = 0.0f;
  for (int c0 = 0; c0 < cnt; c0 += kHalf) {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const int i = row(min(c0 + q, cnt - 1));
      xv[q] = in[i * ss];
      pv[q] = piv[i];
      fv[q] = f2[i];
    }
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const bool on = c0 + q < cnt;
      const float lo = kT ? rp * pv[q] : fv[q];
      const float nv = fmaf(lo, v, pv[q] * xv[q]);
      v = on ? nv : v;
      rp = on ? fv[q] : rp;
      xv[q] = v;
    }
    // the elimination goes to out; an inactive lane's stays in registers
    // and is not read back (the lane's own stores are all it would read)
    if (active) {
#pragma unroll
      for (int q = 0; q < kHalf; ++q)
        if (c0 + q < cnt) out[row(c0 + q) * ss] = xv[q];
    }
  }
  float x = twist(v);
  if (!active) return;
  float rn = fk;
  for (int c0 = cnt - 1; c0 >= 0; c0 -= kHalf) {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const int i = row(max(c0 - q, 0));
      xv[q] = out[i * ss];
      pv[q] = piv[i];
      fv[q] = f2[i];
    }
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const bool on = c0 - q >= 0;
      const float up = kT ? rn * pv[q] : fv[q];
      const float nx = fmaf(up, x, xv[q]);
      x = on ? nx : x;
      rn = on ? fv[q] : rn;
      xv[q] = x;
    }
#pragma unroll
    for (int q = 0; q < kHalf; ++q)
      if (c0 - q >= 0) out[row(c0 - q) * ss] = xv[q];
  }
}

// All threads: solve every line of a sweep on the block's images, d from
// ``in`` and x into ``out`` (the same buffer for a sweep in place), with
// the sweep's factors in F as fetch_factors left them; each group takes a
// line at a time, its lanes the line's images and halves (Group).
template <bool kT>
__device__ __forceinline__ void apply_sweep(const float* __restrict__ F,
                                            const float* in, float* out,
                                            const channel_lines::Tile& t,
                                            const Lines& l, const Group& q) {
  // T: (piv, m) = (F + slot, F); T^T: (piv, r) = (F, F + slot)
  const float* piv = kT ? F : F + l.slot;
  const float* f2 = kT ? F + l.slot : F;
  for (int j = q.first; j < l.lines; j += q.count) {
    const int o = q.g * t.img + j * l.ls;
    if (l.len == kMnist)
      twisted_line<kT, kMnist>(piv + j * l.fld, f2 + j * l.fld, in + o,
                               out + o, l.ss, l.len, q.second, q.active);
    else
      twisted_line<kT, 0>(piv + j * l.fld, f2 + j * l.fld, in + o, out + o,
                          l.ss, l.len, q.second, q.active);
  }
}

}  // namespace grayscale_lines
