// Batched tridiagonal solve for Hopper (sm_90a) and its adjoint, by
// parallel cyclic reduction (PCR) with the batch-free factorisation hoisted
// out of the per-image path.
//
// K1, thomas_solve: x = T^-1 d along one axis of d, with batch-free
// tridiagonal bands (a, b, c) broadcast over the batch.
// Replaces: cnn_pde_tpu/ops/pallas_thomas.py::_thomas_kernel, launched by
// _solve_2d for pallas_tridiag_solve's forward.
//
// K3, thomas_adjoint: the backward of K1.  lam = T^-T g along the same axis,
// then the band gradients summed over the batch onto the batch-free shape:
// grad_b = -sum lam*x, grad_a[i] = -sum lam[i]*x[i-1], grad_c[i] =
// -sum lam[i]*x[i+1] (grad_a[0] = grad_c[N-1] = 0), and grad_d = lam.
// Replaces: pallas_thomas.py::_bwd, which calls the same Pallas kernel on
// transposed bands and forms the band gradients with XLA ops outside it.
//
// Layout.  d, x, g and lam are (B, P, N, Q) row-major and the solve runs
// along N with element stride Q; a, b, c are (P, N, Q), the same layout
// without the batch.  The ADI x-sweep of a (B, C, H, W) state is P = C*H,
// N = W, Q = 1; the y-sweep is P = C, N = H, Q = W, solved down the columns
// in place.  1 <= N <= kMaxN (1440): pcr_lines below for N <= 64, and
// long_lines_kernel (partition + PCR, further down) past it, chosen by N at
// launch.
//
// What bounds it.  Bytes: K1 must read d and write x once (8 bytes an
// element; the bands are batch-free, a few tens of KB); K3 must read g and x
// and write lam once (12 bytes an element) plus the batch-free bands and
// their gradients.  The arithmetic (2 fmas a PCR level and element, 5-6
// levels) is far below the card's f32 rate.  So the design has to keep
// enough loads in flight and do nothing per image that is the same for
// every image.
//
// What the design does about it.
// - A block owns a tile of kLines band lines (x-sweep: kLines consecutive p,
//   each N contiguous floats; y-sweep: one p and kLines consecutive q, each
//   tile row kLines contiguous floats) and a chunk of consecutive images.
//   One warp a line, lane = row (rows lane and lane + 32 when N > 32).
// - The warp first factors its line once, in registers, by PCR: for level
//   l < L = max(1, ceil(log2 N)) with stride s = 2^l, alpha_l[i] =
//   -a_l[i] / b_l[i-s] and gamma_l[i] = -c_l[i] / b_l[i+s] and the reduced
//   bands, neighbours exchanged with shuffles; finally 1/b_L.  Every image
//   of the chunk reuses these factors: the per-image path has no division.
// - Per image the apply is L levels of d[i] += alpha_l[i] d[i-s] +
//   gamma_l[i] d[i+s] (out-of-range neighbours are 0), then x = d / b_L as a
//   product: two fmas a level and element, depth L, against a 2N-step chain
//   per line in a serial Thomas solve.
// - The images stream through shared memory in stages of kStage images, a
//   ring of kBufs stage buffers filled by cp.async: while one stage is
//   solved, the next kBufs - 1 stages' loads are in flight, and the first
//   ones are started before the factorisation.  A stage's images are solved
//   level by level side by side, so their shuffles interleave.  Loads are
//   coalesced in global order (x: the tile is contiguous; y: rows of kLines
//   floats) with no runtime division per element; the y tile's row stride
//   kLines + 1 is odd, so a warp reading a column hits 32 banks.  x-sweep
//   results go straight from registers to global memory (a warp's line is
//   contiguous); the y tile goes back through shared memory and out in
//   rows.  Masks cover ragged tiles and the last stage of a chunk.
// - K3 applies the same PCR to the transposed bands read on the fly
//   (lower'[i] = c[i-1], upper'[i] = a[i+1]; no transposed copy).  Its band
//   sums run in the same block: the x tile is staged beside g, and each
//   lane accumulates lam[i] x[i], lam[i] x[i-1] and lam[i] x[i+1] in
//   registers, in image order, over the chunk; one partial per (chunk, band
//   element) goes to a scratch the wrapper allocates, and a second small
//   kernel of the same C call sums the partials over chunks in a fixed
//   order (eight interleaved slices, then the slices) and negates them.
//   Deterministic, no atomics; g and x are read and lam written once each.
// - The wrapper (ops/tridiag.py::_plan) picks the chunk so that the grid has
//   about two blocks an SM wherever the batch allows it.  Measured on an
//   H100 (thomas_ab.py, PERF.md): more, smaller chunks repeat the per-block
//   factorisation and pipeline start, and were slower at 4, 8 and 16; a
//   stage of 8 images beat 4 at B = 512 and 1024; a deeper ring did not
//   help.
//
// Numerics.  The same system as the Thomas recurrence of
// ops/tridiag.py::tridiag_solve_plain, solved by another elimination
// order; the arithmetic is that of ops/tridiag.py::pcr_factor and
// pcr_apply (past 64 rows: partition_factor and partition_apply), up to
// fma contraction and the product by 1/b_L (formed once a block) in place
// of their division by b_L.

#include <cuda_runtime.h>

#include "channel_sweep.cuh"

namespace {

constexpr int kLines = 8;              // band lines a block, one warp each
constexpr int kThreads = 32 * kLines;
constexpr int kLd = kLines + 1;        // y tile row stride in shared memory
constexpr int kStage = 8;              // images a pipeline stage
constexpr int kBufs = 3;               // stage buffers: kBufs - 1 in flight
constexpr unsigned kFull = 0xffffffffu;

using channel_sweep::cp_async4;
using channel_sweep::cp_async_commit;
using channel_sweep::cp_async_wait;

// Row lane + 32k of a line held K rows a lane.  v[i - s] and v[i + s] for
// s <= 32, with ``fill`` outside rows [0, 32K).  Every lane of the warp
// must call them.
template <int K>
__device__ __forceinline__ void shift_down(const float (&v)[K], int s,
                                           float fill, float (&out)[K]) {
  const int lane = threadIdx.x & 31;
  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = __shfl_sync(kFull, v[k], (lane - s) & 31);
  // (the inner k > 0 ? k - 1 : 0 keeps a dead index in range once unrolled)
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k] = lane >= s ? w[k] : (k > 0 ? w[k > 0 ? k - 1 : 0] : fill);
}

template <int K>
__device__ __forceinline__ void shift_up(const float (&v)[K], int s,
                                         float fill, float (&out)[K]) {
  const int lane = threadIdx.x & 31;
  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = __shfl_sync(kFull, v[k], (lane + s) & 31);
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k] = lane + s < 32 ? w[k]
                           : (k + 1 < K ? w[k + 1 < K ? k + 1 : k] : fill);
}

// N <= 32: one row a lane and at most 5 levels; N <= 64: two and 6.
template <int K>
struct Pcr {
  static constexpr int kMaxLevels = K == 1 ? 5 : 6;
  float alpha[K][kMaxLevels];
  float gamma[K][kMaxLevels];
  float inv[K];

  // lo, di, up: the lane's rows of the line's sub-, main and
  // super-diagonal, with lo = up = 0 outside the matrix and identity rows
  // (0, 1, 0) past N.
  __device__ __forceinline__ void factor(float (&lo)[K], float (&di)[K],
                                         float (&up)[K], int levels) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l < levels) {
        const int s = 1 << l;
        float bd[K], bu[K], ad[K], au[K], cd[K], cu[K];
        shift_down<K>(di, s, 1.0f, bd);
        shift_up<K>(di, s, 1.0f, bu);
        shift_down<K>(lo, s, 0.0f, ad);
        shift_up<K>(lo, s, 0.0f, au);
        shift_down<K>(up, s, 0.0f, cd);
        shift_up<K>(up, s, 0.0f, cu);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float al = -lo[k] / bd[k];
          const float ga = -up[k] / bu[k];
          alpha[k][l] = al;
          gamma[k][l] = ga;
          di[k] = di[k] + al * cd[k] + ga * au[k];
          lo[k] = al * ad[k];
          up[k] = ga * cu[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) inv[k] = 1.0f / di[k];
  }

  // d (the lane's rows of G images' lines) becomes x in place, level by
  // level across the images, so that their shuffles and fmas interleave.
  template <int G>
  __device__ __forceinline__ void apply(float (&d)[G][K], int levels) const {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l < levels) {
        float dn[G][K], dp[G][K];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          shift_down<K>(d[g], 1 << l, 0.0f, dn[g]);
          shift_up<K>(d[g], 1 << l, 0.0f, dp[g]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < K; ++k)
            d[g][k] = d[g][k] + alpha[k][l] * dn[g][k] + gamma[k][l] * dp[g][k];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < K; ++k) d[g][k] *= inv[k];
  }
};

// The block's tile: band element (line l, row i) sits at band0 + l*ls +
// i*rs of the (P, N, Q) band, and at the same offset plus n*P*N*Q in image n.
struct Tile {
  long long band0;
  int ls, rs, nlines;
};

template <bool kY>
__device__ __forceinline__ Tile block_tile(int P, int N, int Q) {
  Tile t;
  if (!kY) {
    const int p0 = blockIdx.x * kLines;
    t.nlines = min(kLines, P - p0);
    t.band0 = (long long)p0 * N;
    t.ls = N;
    t.rs = 1;
  } else {
    const int qtiles = (Q + kLines - 1) / kLines;
    const int p = blockIdx.x / qtiles;
    const int q0 = (blockIdx.x - p * qtiles) * kLines;
    t.nlines = min(kLines, Q - q0);
    t.band0 = (long long)p * N * Q + q0;
    t.ls = 1;
    t.rs = Q;
  }
  return t;
}

// Offset of (line l, row i) in an image's slot of shared memory: the x
// tile keeps its global layout, the y tile has rows of kLd floats.
template <bool kY>
__device__ __forceinline__ int smem_at(int l, int i, int N) {
  return kY ? i * kLd + l : l * N + i;
}

// Start the cp.async copies of ``count`` images, from image n0 of ``src``,
// into consecutive slots of ``buf``.
template <bool kY>
__device__ __forceinline__ void load_stage(float* buf, const float* src,
                                           const Tile& t, long long img,
                                           long long n0, int count, int N,
                                           int Q) {
  const int slot = kLd * N;
  for (int g = 0; g < count; ++g) {
    const float* s = src + (n0 + g) * img + t.band0;
    float* dst = buf + g * slot;
    if (!kY) {
      const int cnt = t.nlines * N;
      for (int k = threadIdx.x; k < cnt; k += kThreads) cp_async4(dst + k, s + k);
    } else {
      const int cnt = N * kLines;
      for (int k = threadIdx.x; k < cnt; k += kThreads) {
        const int i = k / kLines, l = k % kLines;  // a power of two: shifts
        if (l < t.nlines) cp_async4(dst + i * kLd + l, s + (long long)i * Q + l);
      }
    }
  }
}

// Store ``count`` solved images of a y tile from consecutive slots of
// ``buf`` in rows of kLines floats (the x-sweep stores from registers).
__device__ __forceinline__ void store_rows(float* __restrict__ dst_base,
                                           const float* __restrict__ buf,
                                           const Tile& t, long long img,
                                           long long n0, int count, int N,
                                           int Q) {
  const int slot = kLd * N;
  for (int g = 0; g < count; ++g) {
    float* dst = dst_base + (n0 + g) * img + t.band0;
    const float* s = buf + g * slot;
    for (int k = threadIdx.x; k < N * kLines; k += kThreads) {
      const int i = k / kLines, l = k % kLines;  // a power of two: shifts
      if (l < t.nlines) dst[(long long)i * Q + l] = s[i * kLd + l];
    }
  }
}

// One kernel for K1 (kAdj false: src = d, out = x) and K3's solve and
// partial band sums (kAdj true: src = g, xin = x, out = lam, partials of
// shape (chunks, 3, P, N, Q)).
template <bool kY, bool kAdj, int K>
__global__ void __launch_bounds__(kThreads, K == 1 ? 4 : 2)
    pcr_lines(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c, const float* __restrict__ src,
              const float* __restrict__ xin, float* __restrict__ out,
              float* __restrict__ partials, long long batch, int P, int N,
              int Q, int chunk) {
  // A ring of kBufs stage buffers for d (or g), then kBufs for x (K3).
  extern __shared__ float smem[];
  const int slot = kLd * N;
  const int buf = kStage * slot;
  const int xoff = kBufs * buf;

  const Tile t = block_tile<kY>(P, N, Q);
  const long long band = (long long)P * N * Q;
  const long long n_begin = (long long)blockIdx.y * chunk;
  const int count = (int)min((long long)chunk, batch - n_begin);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = warp < t.nlines;  // uniform across the warp

  // Stage st (images n_begin + st*kStage on) goes to ring slot st % kBufs;
  // while stage s is solved, stages s+1 .. s+kBufs-1 are in flight.
  const int stages = (count + kStage - 1) / kStage;
  auto fetch = [&](int st, float* dst) {
    if (st < stages) {
      const long long n0 = n_begin + (long long)st * kStage;
      const int cnt = min(kStage, count - st * kStage);
      load_stage<kY>(dst, src, t, band, n0, cnt, N, Q);
      if (kAdj) load_stage<kY>(dst + xoff, xin, t, band, n0, cnt, N, Q);
    }
    cp_async_commit();  // an empty group past the last stage keeps the count
  };
#pragma unroll
  for (int st = 0; st < kBufs - 1; ++st) fetch(st, smem + st * buf);

  // The factorisation runs while the first stages' copies are in flight.
  int levels = 1;
  while ((1 << levels) < N) ++levels;

  Pcr<K> f;
  if (active) {
    float lo[K], di[K], up[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      const long long e = t.band0 + (long long)warp * t.ls + (long long)i * t.rs;
      if (i < N) {
        di[k] = __ldg(b + e);
        if (!kAdj) {
          lo[k] = i > 0 ? __ldg(a + e) : 0.0f;
          up[k] = i + 1 < N ? __ldg(c + e) : 0.0f;
        } else {  // the bands of T^T
          lo[k] = i > 0 ? __ldg(c + e - t.rs) : 0.0f;
          up[k] = i + 1 < N ? __ldg(a + e + t.rs) : 0.0f;
        }
      } else {
        lo[k] = 0.0f;
        di[k] = 1.0f;
        up[k] = 0.0f;
      }
    }
    f.factor(lo, di, up, levels);
  }

  float sa[K], sb[K], sc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sa[k] = sb[k] = sc[k] = 0.0f;

  int rd = 0, wr = kBufs - 1;  // ring slots of stage s and of s + kBufs - 1
  for (int s = 0; s < stages; ++s) {
    float* cur = smem + rd * buf;
    const long long n0 = n_begin + (long long)s * kStage;
    const int here = min(kStage, count - s * kStage);
    fetch(s + kBufs - 1, smem + wr * buf);
    cp_async_wait<kBufs - 1>();  // stage s's copies, not the later ones
    __syncthreads();
    rd = rd + 1 == kBufs ? 0 : rd + 1;
    wr = wr + 1 == kBufs ? 0 : wr + 1;

    if (active) {
      // The stage's images side by side, so that their level chains
      // interleave; slots past ``here`` hold zeros and are not stored.
      float d[kStage][K];
#pragma unroll
      for (int g = 0; g < kStage; ++g) {
        const float* line = cur + g * slot;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = lane + 32 * k;
          d[g][k] = (g < here && i < N) ? line[smem_at<kY>(warp, i, N)] : 0.0f;
        }
      }
      f.apply(d, levels);
#pragma unroll
      for (int g = 0; g < kStage; ++g) {
        if (g < here) {
          float* line = cur + g * slot;
          const float* xl = cur + xoff + g * slot;
          // x-sweep: a warp's line is contiguous in global memory too, so
          // it stores straight from registers; the y tile goes back
          // through shared memory and out in rows.
          float* xrow = out + (n0 + g) * band + t.band0 + warp * t.ls;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int i = lane + 32 * k;
            if (i < N) {
              if (kY)
                line[smem_at<kY>(warp, i, N)] = d[g][k];
              else
                xrow[i] = d[g][k];
              if (kAdj) {
                const float lam = d[g][k];
                sb[k] += lam * xl[smem_at<kY>(warp, i, N)];
                if (i > 0) sa[k] += lam * xl[smem_at<kY>(warp, i - 1, N)];
                if (i + 1 < N) sc[k] += lam * xl[smem_at<kY>(warp, i + 1, N)];
              }
            }
          }
        }
      }
    }
    if (kY) {
      __syncthreads();
      store_rows(out, cur, t, band, n0, here, N, Q);
    }
    __syncthreads();  // before a later stage's copies reuse this buffer
  }

  if (kAdj && active) {
    float* part = partials + (long long)blockIdx.y * 3 * band;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      if (i < N) {
        const long long e =
            t.band0 + (long long)warp * t.ls + (long long)i * t.rs;
        part[e] = sa[k];
        part[band + e] = sb[k];
        part[2 * band + e] = sc[k];
      }
    }
  }
}

// ---- lines longer than kShortN rows: partition + PCR ---------------------
//
// One warp a line still, but lane k owns the m = rows_a_lane(N)
// consecutive rows s = k*m .. e = s + m - 1 of the line padded with
// identity rows to 32*m (ops/tridiag.py::partition_factor and
// partition_apply are the plain mirror).  The factor phase, once a block:
// the bands are staged in shared memory, each lane runs the modified
// Thomas elimination over its rows (f, g, c', a' a row, kept in shared
// memory), the upward pass on the factors alone gives row s's interface
// coefficients, and the 64-row interface system (rows s and e of every
// lane) is factored by Pcr<2> in registers.  Per image, no division: a
// downward pass d' = f*d - g*d'_prev in place, with the dot product that
// gives row s's right-hand side; the interface solve (Pcr<2>::apply, the
// values moved between the lane-pair layout and Pcr<2>'s by shuffles);
// then x = d' - a'*x_s - c'*x_next upward.  kLongStage images go side by
// side; a ring of kLongBufs stages.  Every line's rows sit in shared
// memory at i + i/32 (one pad word every 32 rows), so a warp stepping
// through its lanes' rows at stride m hits at most two words a bank for
// every m but 31 (rows_a_lane takes 32 there).  Results go back through
// shared memory and out in coalesced rows.  Lines a block: the most of 8,
// 4, 2, 1 whose shared memory fits (long_lines).

constexpr int kShortN = 64;       // the longest line of pcr_lines
constexpr int kLongStage = 4;     // images a stage
constexpr int kLongBufs = 2;      // stage buffers a ring
constexpr int kLongMaxLines = 8;
constexpr int kCoefs = 4;         // f, g, c', a' a row
constexpr int kSums = 3;          // K3's band sums a row
constexpr int kF = 0, kG = 1, kC = 2, kA = 3;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use (sm_90)
constexpr int kMaxN = 1440;       // the longest line that fits one warp a block

__host__ __device__ __forceinline__ int rows_a_lane(int N) {
  const int m = (N + 31) / 32;
  return m == 31 ? 32 : m;
}

// Floats of shared memory of a block of ``lines`` lines of N rows: the
// factors (and K3's band sums) of every row, then the ring of stage
// buffers (K3: one for g, one for x), each slot (lines + 1) * 33 * m.
inline size_t long_floats(int N, int lines, bool adj) {
  const size_t m = rows_a_lane(N);
  return (size_t)(kCoefs + (adj ? kSums : 0)) * lines * 32 * m +
         (size_t)(adj ? 2 : 1) * kLongBufs * kLongStage * 33 * m *
             (lines + 1);
}

inline int long_lines(int N, bool adj) {
  int lines = kLongMaxLines;
  while (lines > 1 && sizeof(float) * long_floats(N, lines, adj) > kSmemLimit)
    lines /= 2;
  return lines;
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Lane k holds interface rows 2k (v0) and 2k + 1 (v1); Pcr<2> wants row r
// at lane r & 31, slot r >> 5.
__device__ __forceinline__ void to_pcr(float v0, float v1, float (&out)[2]) {
  const int lane = threadIdx.x & 31;
  const int src = lane >> 1;
  const float a0 = __shfl_sync(kFull, v0, src);
  const float a1 = __shfl_sync(kFull, v1, src);
  const float b0 = __shfl_sync(kFull, v0, src + 16);
  const float b1 = __shfl_sync(kFull, v1, src + 16);
  out[0] = (lane & 1) ? a1 : a0;
  out[1] = (lane & 1) ? b1 : b0;
}

__device__ __forceinline__ void from_pcr(const float (&x)[2], float& v0,
                                         float& v1) {
  const int lane = threadIdx.x & 31;
  const int r0 = (2 * lane) & 31;
  const float p0 = __shfl_sync(kFull, x[0], r0);
  const float p1 = __shfl_sync(kFull, x[1], r0);
  const float q0 = __shfl_sync(kFull, x[0], r0 + 1);
  const float q1 = __shfl_sync(kFull, x[1], r0 + 1);
  v0 = lane < 16 ? p0 : p1;
  v1 = lane < 16 ? q0 : q1;
}

template <bool kY>
__device__ __forceinline__ Tile long_tile(int P, int N, int Q, int lines) {
  Tile t;
  if (!kY) {
    const int p0 = blockIdx.x * lines;
    t.nlines = min(lines, P - p0);
    t.band0 = (long long)p0 * N;
    t.ls = N;
    t.rs = 1;
  } else {
    const int qtiles = (Q + lines - 1) / lines;
    const int p = blockIdx.x / qtiles;
    const int q0 = (blockIdx.x - p * qtiles) * lines;
    t.nlines = min(lines, Q - q0);
    t.band0 = (long long)p * N * Q + q0;
    t.ls = 1;
    t.rs = Q;
  }
  return t;
}

// K1 (kAdj false) and K3's solve and partial band sums (kAdj true) on
// lines of kShortN < N <= kMaxN rows, ``lines`` (a power of two) a block.
template <bool kY, bool kAdj>
__global__ void __launch_bounds__(32 * kLongMaxLines)
    long_lines_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ src,
                      const float* __restrict__ xin, float* __restrict__ out,
                      float* __restrict__ partials, long long batch, int P,
                      int N, int Q, int chunk, int lines) {
  extern __shared__ float smem[];
  const int m = rows_a_lane(N);
  const int M = 32 * m;
  const int rows = 33 * m;  // a line's rows in a slot, padded
  const int ld = lines + 1;  // the y tile's row stride
  const int lsh = __ffs(lines) - 1;
  const int slot = rows * ld;
  const int buf = kLongStage * slot;
  const int nthreads = 32 * lines;
  float* coef = smem;  // [line][kCoefs][M]: row (lane k, j) at j*32 + k
  float* sums = coef + kCoefs * lines * M;  // K3: [line][kSums][M]
  float* ring = sums + (kAdj ? kSums * lines * M : 0);
  const int xoff = kLongBufs * buf;  // K3: the x ring after the g ring

  const Tile t = long_tile<kY>(P, N, Q, lines);
  const long long band = (long long)P * N * Q;
  const long long n_begin = (long long)blockIdx.y * chunk;
  const int count = (int)min((long long)chunk, batch - n_begin);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = warp < t.nlines;  // uniform across the warp

  auto at = [&](int l, int i) {
    return kY ? padded(i) * ld + l : l * rows + padded(i);
  };
  auto load = [&](float* dst0, const float* src0, long long n0, int cnt) {
    for (int g = 0; g < cnt; ++g) {
      const float* s = src0 + (n0 + g) * band + t.band0;
      float* dst = dst0 + g * slot;
      if (!kY) {
        for (int l = 0; l < t.nlines; ++l)
          for (int i = threadIdx.x; i < N; i += nthreads)
            cp_async4(dst + l * rows + padded(i), s + (long long)l * N + i);
      } else {
        for (int k = threadIdx.x; k < N * lines; k += nthreads) {
          const int i = k >> lsh, l = k & (lines - 1);
          if (l < t.nlines)
            cp_async4(dst + padded(i) * ld + l, s + (long long)i * Q + l);
        }
      }
    }
  };
  const int stages = (count + kLongStage - 1) / kLongStage;
  auto fetch = [&](int st, float* dst) {
    if (st < stages) {
      const long long n0 = n_begin + (long long)st * kLongStage;
      const int cnt = min(kLongStage, count - st * kLongStage);
      load(dst, src, n0, cnt);
      if (kAdj) load(dst + xoff, xin, n0, cnt);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kLongBufs - 1; ++st) fetch(st, ring + st * buf);

  // The bands, staged in the factor arrays (lo in a', b in f, up in c'),
  // with identity rows past N; K3 reads the bands of T^T.  Coalesced along
  // the line (x) or along rows of ``lines`` floats (y).
  for (int e = threadIdx.x; e < lines * M; e += nthreads) {
    int l, i;
    if (kY) {
      i = e >> lsh;
      l = e & (lines - 1);
    } else {
      l = e / M;
      i = e - l * M;
    }
    if (l >= t.nlines) continue;
    float lo = 0.0f, di = 1.0f, up = 0.0f;
    if (i < N) {
      const long long g0 = t.band0 + (long long)l * t.ls + (long long)i * t.rs;
      di = __ldg(b + g0);
      if (!kAdj) {
        if (i > 0) lo = __ldg(a + g0);
        if (i + 1 < N) up = __ldg(c + g0);
      } else {
        if (i > 0) lo = __ldg(c + g0 - t.rs);
        if (i + 1 < N) up = __ldg(a + g0 + t.rs);
      }
    }
    const int k = i / m, j = i - k * m;
    float* cl = coef + l * kCoefs * M + j * 32 + k;
    cl[kA * M] = lo;
    cl[kF * M] = di;
    cl[kC * M] = up;
    if (kAdj) {
      float* sl = sums + l * kSums * M + j * 32 + k;
      sl[0] = sl[M] = sl[2 * M] = 0.0f;
    }
  }
  __syncthreads();

  Pcr<2> f;
  float rho = 0.0f, rhoc = 0.0f;
  float* cl = coef + warp * kCoefs * M + lane;  // this lane's rows: + j*32
  if (active) {
    // downward over the lane's rows: row i > s becomes
    // a'_i x_s + x_i + c'_i x_{i+1} = d'_i (row s keeps x_{s-1} in a')
    float pa = 0.0f, pc = 0.0f;
    for (int j = 0; j < m; ++j) {
      float* r_ = cl + j * 32;
      const float lo = r_[kA * M], di = r_[kF * M], up = r_[kC * M];
      float r, g, ap;
      if (j < 2) {
        r = 1.0f / di;
        g = 0.0f;
        ap = lo * r;
      } else {
        r = 1.0f / (di - lo * pc);
        g = lo * r;
        ap = -g * pa;
      }
      pc = up * r;
      pa = ap;
      r_[kF * M] = r;
      r_[kG * M] = g;
      r_[kC * M] = pc;
      r_[kA * M] = ap;
    }
    // upward on the factors: row s+1 as x_{s+1} = d'' - A x_s - C x_e
    float A = cl[kA * M + (m - 2) * 32], C = cl[kC * M + (m - 2) * 32];
    for (int j = m - 3; j >= 1; --j) {
      const float cpj = cl[kC * M + j * 32];
      A = cl[kA * M + j * 32] - cpj * A;
      C = -cpj * C;
    }
    const float cp0 = cl[kC * M];
    rho = 1.0f / (1.0f - cp0 * A);
    rhoc = rho * cp0;
    float lo2[2], di2[2] = {1.0f, 1.0f}, up2[2];
    to_pcr(rho * cl[kA * M], pa, lo2);
    to_pcr(-rhoc * C, pc, up2);
    f.factor(lo2, di2, up2, 6);
  }

  int rd = 0, wr = kLongBufs - 1;
  for (int s = 0; s < stages; ++s) {
    float* cur = ring + rd * buf;
    const long long n0 = n_begin + (long long)s * kLongStage;
    const int here = min(kLongStage, count - s * kLongStage);
    fetch(s + kLongBufs - 1, ring + wr * buf);
    cp_async_wait<kLongBufs - 1>();
    __syncthreads();
    rd = rd + 1 == kLongBufs ? 0 : rd + 1;
    wr = wr + 1 == kLongBufs ? 0 : wr + 1;

    if (active) {
      // downward: d' in place, row s's dot product, rows s and e kept
      float prev[kLongStage], acc[kLongStage], d0[kLongStage];
#pragma unroll
      for (int g = 0; g < kLongStage; ++g) prev[g] = acc[g] = d0[g] = 0.0f;
      float pi = 1.0f;
      for (int j = 0; j < m; ++j) {
        const int i = lane * m + j;
        const int o = at(warp, i);
        const float fj = cl[kF * M + j * 32], gj = cl[kG * M + j * 32];
        const bool mid = j >= 1 && j <= m - 2;
#pragma unroll
        for (int g = 0; g < kLongStage; ++g) {
          const float v = (g < here && i < N) ? cur[g * slot + o] : 0.0f;
          const float dp = fj * v - gj * prev[g];
          prev[g] = dp;
          if (j == 0) d0[g] = dp;
          if (mid) {
            acc[g] += pi * dp;
            cur[g * slot + o] = dp;
          }
        }
        if (mid) pi *= -cl[kC * M + j * 32];
      }
      float D[kLongStage][2];
#pragma unroll
      for (int g = 0; g < kLongStage; ++g)
        to_pcr(rho * d0[g] - rhoc * acc[g], prev[g], D[g]);
      f.apply(D, 6);
      float xs[kLongStage], nxt[kLongStage];
#pragma unroll
      for (int g = 0; g < kLongStage; ++g) from_pcr(D[g], xs[g], nxt[g]);

      // x (or lam) of row j into the slot, and K3's band sums of it
      auto emit = [&](int j, const float (&v)[kLongStage]) {
        const int i = lane * m + j;
        const int o = at(warp, i);
#pragma unroll
        for (int g = 0; g < kLongStage; ++g) cur[g * slot + o] = v[g];
        if (kAdj && i < N) {
          float* sl = sums + warp * kSums * M + j * 32 + lane;
          float sa = sl[0], sb = sl[M], sc = sl[2 * M];
          const int om = i > 0 ? at(warp, i - 1) : o;
          const int op = i + 1 < N ? at(warp, i + 1) : o;
#pragma unroll
          for (int g = 0; g < kLongStage; ++g) {
            if (g < here) {
              const float* xl = cur + xoff + g * slot;
              sb += v[g] * xl[o];
              if (i > 0) sa += v[g] * xl[om];
              if (i + 1 < N) sc += v[g] * xl[op];
            }
          }
          sl[0] = sa;
          sl[M] = sb;
          sl[2 * M] = sc;
        }
      };
      emit(m - 1, nxt);
      for (int j = m - 2; j >= 1; --j) {
        const int o = at(warp, lane * m + j);
        const float apj = cl[kA * M + j * 32], cpj = cl[kC * M + j * 32];
#pragma unroll
        for (int g = 0; g < kLongStage; ++g)
          nxt[g] = cur[g * slot + o] - apj * xs[g] - cpj * nxt[g];
        emit(j, nxt);
      }
      emit(0, xs);
    }
    __syncthreads();
    for (int g = 0; g < here; ++g) {
      float* dst = out + (n0 + g) * band + t.band0;
      const float* sg = cur + g * slot;
      if (!kY) {
        for (int l = 0; l < t.nlines; ++l)
          for (int i = threadIdx.x; i < N; i += nthreads)
            dst[(long long)l * N + i] = sg[l * rows + padded(i)];
      } else {
        for (int k = threadIdx.x; k < N * lines; k += nthreads) {
          const int i = k >> lsh, l = k & (lines - 1);
          if (l < t.nlines) dst[(long long)i * Q + l] = sg[padded(i) * ld + l];
        }
      }
    }
    __syncthreads();  // before a later stage's copies reuse this buffer
  }

  if (kAdj && active) {
    float* part = partials + (long long)blockIdx.y * 3 * band;
    const float* sl = sums + warp * kSums * M + lane;
    for (int j = 0; j < m; ++j) {
      const int i = lane * m + j;
      if (i < N) {
        const long long e =
            t.band0 + (long long)warp * t.ls + (long long)i * t.rs;
        part[e] = sl[j * 32];
        part[band + e] = sl[M + j * 32];
        part[2 * band + e] = sl[2 * M + j * 32];
      }
    }
  }
}

// K3's second pass: grad = -(the sum of the chunks' partials), in a fixed
// order: slice k of a block's kSumSlices sums chunks k, k + kSumSlices, ...
// in order, then the slices are added in order (ops/tridiag.py::
// _sum_band_partials).  A block takes kSumLanes band elements of one of the
// three gradients; neighbouring threads read neighbouring words.
constexpr int kSumLanes = 32;
constexpr int kSumSlices = 8;

__global__ void __launch_bounds__(kSumLanes * kSumSlices)
    sum_partials(const float* __restrict__ partials, float* __restrict__ ga,
                 float* __restrict__ gb, float* __restrict__ gc,
                 long long band, int chunks) {
  __shared__ float slices[kSumSlices][kSumLanes];
  const int j = blockIdx.y;  // 0: grad_a, 1: grad_b, 2: grad_c
  const long long e = (long long)blockIdx.x * kSumLanes + threadIdx.x;
  float acc = 0.0f;
  if (e < band)
    for (int n = threadIdx.y; n < chunks; n += kSumSlices)
      acc += partials[((long long)n * 3 + j) * band + e];
  slices[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < band) {
    float sum = slices[0][threadIdx.x];
    for (int k = 1; k < kSumSlices; ++k) sum += slices[k][threadIdx.x];
    (j == 0 ? ga : j == 1 ? gb : gc)[e] = -sum;
  }
}

template <bool kAdj, int K>
cudaError_t launch_lines(const float* a, const float* b, const float* c,
                         const float* src, const float* xin, float* out,
                         float* partials, long long batch, int P, int N,
                         int Q, int chunk, cudaStream_t stream) {
  // each instantiation's opt-in above 48 KB, once per device
  static size_t smem_allowed[2][channel_sweep::kMaxDevices];
  const size_t smem =
      sizeof(float) * (kAdj ? 2 : 1) * kBufs * kStage * kLd * N;
  const unsigned chunks = (unsigned)((batch + chunk - 1) / chunk);
  const bool y = Q > 1;
  auto kernel = y ? pcr_lines<true, kAdj, K> : pcr_lines<false, kAdj, K>;
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)kernel, smem, smem_allowed[y]);
  if (err != cudaSuccess) return err;
  const dim3 grid(y ? (unsigned)P * ((Q + kLines - 1) / kLines)
                    : (unsigned)((P + kLines - 1) / kLines),
                  chunks);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, src, xin, out, partials,
                                           batch, P, N, Q, chunk);
  return cudaGetLastError();
}

template <bool kAdj>
cudaError_t launch_long(const float* a, const float* b, const float* c,
                        const float* src, const float* xin, float* out,
                        float* partials, long long batch, int P, int N,
                        int Q, int chunk, cudaStream_t stream) {
  static size_t smem_allowed[2][channel_sweep::kMaxDevices];
  const int lines = long_lines(N, kAdj);
  const size_t smem = sizeof(float) * long_floats(N, lines, kAdj);
  const unsigned chunks = (unsigned)((batch + chunk - 1) / chunk);
  const bool y = Q > 1;
  auto kernel =
      y ? long_lines_kernel<true, kAdj> : long_lines_kernel<false, kAdj>;
  const cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)kernel, smem, smem_allowed[y]);
  if (err != cudaSuccess) return err;
  const dim3 grid(y ? (unsigned)P * ((Q + lines - 1) / lines)
                    : (unsigned)((P + lines - 1) / lines),
                  chunks);
  kernel<<<grid, 32 * lines, smem, stream>>>(a, b, c, src, xin, out,
                                             partials, batch, P, N, Q, chunk,
                                             lines);
  return cudaGetLastError();
}

template <bool kAdj>
cudaError_t launch(const float* a, const float* b, const float* c,
                   const float* src, const float* xin, float* out,
                   float* partials, long long batch, int P, int N, int Q,
                   int chunk, cudaStream_t stream) {
  if (N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  if (N <= 32)
    return launch_lines<kAdj, 1>(a, b, c, src, xin, out, partials, batch, P,
                                 N, Q, chunk, stream);
  if (N <= kShortN)
    return launch_lines<kAdj, 2>(a, b, c, src, xin, out, partials, batch, P,
                                 N, Q, chunk, stream);
  return launch_long<kAdj>(a, b, c, src, xin, out, partials, batch, P, N, Q,
                           chunk, stream);
}

}  // namespace

// The tiling of a launch on lines of N rows, K1's (adjoint 0) or K3's
// (adjoint 1): band lines a block, images a stage, stage buffers, and
// shared-memory bytes a block.  ops/tridiag.py::layout computes the same
// and checks it against this for every N once, when it binds the kernels.
// Returns cudaErrorInvalidValue for N outside [1, kMaxN].
extern "C" int thomas_layout(int N, int adjoint, int* lines, int* stage,
                             int* buffers, long long* smem) {
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  if (N <= kShortN) {
    *lines = kLines;
    *stage = kStage;
    *buffers = kBufs;
    *smem = (long long)sizeof(float) * (adjoint ? 2 : 1) * kBufs * kStage *
            kLd * N;
  } else {
    *lines = long_lines(N, adjoint != 0);
    *stage = kLongStage;
    *buffers = kLongBufs;
    *smem = (long long)sizeof(float) * long_floats(N, *lines, adjoint != 0);
  }
  return 0;
}

// K1.  ``chunk``: images a block (ops/tridiag.py::_plan).  Returns the
// error of the shared-memory opt-in or cudaGetLastError() after the
// launch; the caller raises if it is not 0.
// N must lie in [1, kMaxN]; the wrapper checks it (cudaErrorInvalidValue
// here otherwise).
extern "C" int thomas_solve(const float* a, const float* b, const float* c,
                            const float* d, float* x, long long batch, int P,
                            int N, int Q, int chunk, void* stream) {
  return (int)launch<false>(a, b, c, d, nullptr, x, nullptr, batch, P, N, Q,
                            chunk, static_cast<cudaStream_t>(stream));
}

// K3: the adjoint solve into lam with the chunks' partial band sums into
// ``partials`` ((batch + chunk - 1) / chunk * 3 * P*N*Q floats), then their
// sum into the band gradients ga, gb, gc; two kernels on one stream.  Same
// contract as thomas_solve.
extern "C" int thomas_adjoint(const float* a, const float* b, const float* c,
                              const float* g, const float* x, float* lam,
                              float* ga, float* gb, float* gc,
                              float* partials, long long batch, int P, int N,
                              int Q, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch<true>(a, b, c, g, x, lam, partials, batch, P, N, Q, chunk, s);
  if (err != cudaSuccess) return (int)err;
  const long long band = (long long)P * N * Q;
  const dim3 grid((unsigned)((band + kSumLanes - 1) / kSumLanes), 3);
  sum_partials<<<grid, dim3(kSumLanes, kSumSlices), 0, s>>>(
      partials, ga, gb, gc, band, (int)((batch + chunk - 1) / chunk));
  return (int)cudaGetLastError();
}
