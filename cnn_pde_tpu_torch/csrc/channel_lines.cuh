// The line machinery of the fused channel-diffusion kernels K2, K4
// (fused_channel.cu) and K5 (fused_channel_vjp.cu), for Hopper (sm_90a).
//
// A block holds its images' (C, H, W) state in shared memory as rows of
// ld = W | 1 floats (odd, so that threads walking neighbouring rows or
// neighbouring columns touch different banks).  A sweep solves C*H lines
// along W (x) or C*W lines down the columns along H (y), each the Neumann
// system of ops/fused_channel.py::_abc_nosmooth, T, or its transpose
// (ops/tridiag.py::_transpose_system), by the Thomas recurrence split in
// two phases:
// - factor: one thread a line, once a block, walks the line's rows and
//   leaves two factors a row in shared memory (1/denominator, and the
//   multiplier of the elimination for T or the coefficient r for its
//   transpose), batch-free: they are the same for every image;
// - apply: one thread a (line, image) runs the elimination and the
//   back-substitution with those factors, two fmas and a product a row,
//   no division, in place in the state.
// The threads of a block are split into factor threads (the first warps,
// one thread a line) and workers (the rest), so that the factors of the
// next sweep are made while the workers apply the current one, into the
// other of two factor buffers (one buffer, and no overlap, where two do
// not fit).
//
// The raw coefficient fields are staged once a block into shared memory in
// the images' layout where they fit beside everything else, alpha's first
// (the wrapper's plan, ops/fused_channel.py::plan_tiles, decides, and the
// kernels take the decision as a Layout):
// an x-line's factor thread walks along a row, which in device memory is a
// strided read across the warp, while a y-line's walk down a column is a
// coalesced one.

#pragma once

#include <cuda_runtime.h>

#include "channel_sweep.cuh"

namespace channel_lines {

using channel_sweep::kMaxC;

constexpr int kThreads = 512;                   // threads a block
constexpr int kChunk = 8;                       // rows a line moves at once

// One block's images in shared memory: (nimg, C, H, ld).
struct Tile {
  int C, H, W, ld, hw, img;  // img: floats an image
  int nimg;
};

__device__ __forceinline__ Tile make_tile(int C, int H, int W, int nimg) {
  Tile t;
  t.C = C;
  t.H = H;
  t.W = W;
  t.ld = W | 1;
  t.hw = H * W;
  t.img = C * H * t.ld;
  t.nimg = nimg;
  return t;
}

// The floats of shared memory one image takes (make_tile's layout).
__host__ __device__ __forceinline__ int image_floats(int C, int H, int W) {
  return C * H * (W | 1);
}

// The floats of one factor buffer: two factors a row of every line of
// either sweep, each line's rows contiguous, lines n | 1 floats apart.
__host__ __device__ __forceinline__ int factor_floats(int C, int H, int W) {
  const int x = C * H * (W | 1);
  const int y = C * W * (H | 1);
  return 2 * (x > y ? x : y);
}

// Factor threads a block: one a line of the longer sweep, whole warps.
__host__ __device__ __forceinline__ int factor_threads(int C, int H, int W) {
  const int lines = C * (H > W ? H : W);
  return (lines + 31) / 32 * 32;
}

// Floats of shared memory a block holds beside its image buffers: the
// mixing matrix, ``extra`` more, ``nbuf`` factor buffers and the fields of
// ``staged`` coefficients (0, alpha's, or alpha's and beta's).
__host__ __device__ __forceinline__ int fixed_floats(int C, int H, int W,
                                                     int extra, int nbuf,
                                                     int staged) {
  return C * C + extra + nbuf * factor_floats(C, H, W) +
         2 * staged * image_floats(C, H, W);
}

// A block's layout, as the wrapper's plan gives it
// (ops/fused_channel.py::plan_tiles): ``nbuf`` factor buffers (1 or 2) and
// the fields of ``staged`` coefficients in shared memory (0, alpha's, or
// alpha's and beta's).
struct Layout {
  int nbuf, staged;
};

__host__ __device__ __forceinline__ bool valid(const Layout& l) {
  return (l.nbuf == 1 || l.nbuf == 2) && l.staged >= 0 && l.staged <= 2;
}

// Bytes of shared memory a block takes: ``tile`` images of ``buffers``
// image buffers beside fixed_floats(..., extra, l.nbuf, l.staged).
__host__ __device__ __forceinline__ long long block_bytes(int C, int H, int W,
                                                          int tile,
                                                          int buffers,
                                                          int extra,
                                                          const Layout& l) {
  return 4LL * (fixed_floats(C, H, W, extra, l.nbuf, l.staged) +
                (long long)tile * buffers * image_floats(C, H, W));
}

// This block's images [first, first + count): B images split over the grid
// as evenly as whole images allow (counts differ by at most one).
__device__ __forceinline__ void block_images(int B, int& first, int& count) {
  const long long b = blockIdx.x;
  first = (int)(b * B / gridDim.x);
  count = (int)((b + 1) * B / gridDim.x) - first;
}

// A raw coefficient field and its time coefficient: staged in shared memory
// in the images' layout, or the (C, H, W) tensors in device memory.
struct Field {
  const float* base;
  const float* tc;
  bool staged;
};

// One sweep: along W (x) or down the columns (y), its line count and
// length, and the stride between lines in a factor buffer (odd, so that
// threads on neighbouring lines touch different banks).
struct Sweep {
  bool y;
  int lines, n, fld;
};

__device__ __forceinline__ Sweep sweep_of(const Tile& t, bool y) {
  const int n = y ? t.H : t.W;
  return Sweep{y, t.C * (y ? t.W : t.H), n, n | 1};
}

// Row i of line j: the field element f0 + i*fs of a (C, H, W) field, and the
// word s0 + i*ss of an image in shared memory.  x: j = c*H + h, rows along
// W; y: j = c*W + w, rows down the column.
struct Line {
  int f0, fs, s0, ss;
};

__device__ __forceinline__ Line line_at(const Tile& t, bool y, int j) {
  if (!y) return Line{j * t.W, 1, j * t.ld, 1};
  const int c = j / t.W;
  const int w = j - c * t.W;
  return Line{c * t.hw + w, t.W, c * t.H * t.ld + w, t.ld};
}

// The raw coefficient base + tc*t of row i of a line.
__device__ __forceinline__ float raw_at(const Field f, const Line ln, int i,
                                        float tt) {
  const int e = f.staged ? ln.s0 + i * ln.ss : ln.f0 + i * ln.fs;
  return f.base[e] + f.tc[e] * tt;
}

// 1/d to within about an ulp, for the positive, well-scaled denominators of
// the diagonally dominant sweep systems: the hardware's approximate
// reciprocal refined by one Newton step, with no branch for special cases.
__device__ __forceinline__ float reciprocal(float d) {
  const float r = __fdividef(1.0f, d);
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}

// Factor line j of a sweep into F: rd[i] = 1/denominator at
// F[j*fld + i] and, at F[(lines + j)*fld + i], for T (kT false: sub- and
// super-diagonal -r[i]) the multiplier m[i] = r[i] rd[i], for its
// transpose (sub'[i] = -r[i-1], super'[i] = -r[i+1]) r[i].  The diagonal
// is b = 1 + 2r (1 + r on the edge rows) + eps, with r = clamp(raw, eps,
// cmax) * dtf.  The Thomas recurrence with rs and ru the negated sub- and
// super-diagonal: d[i] = b[i] - rs[i] up[i-1], up[i] = ru[i] / d[i].
__device__ __forceinline__ void factor_line(float* F, const Sweep sw, int j,
                                            bool kT, const Line ln,
                                            const Field f, float tt,
                                            float dtf, float eps, float cmax) {
  const int n = sw.n;
  float* rdp = F + j * sw.fld;
  float* rr = F + (sw.lines + j) * sw.fld;  // r[i], then m[i] for T
  // the coefficients first, 16 rows' loads in flight at a time; then the
  // recurrence, one reciprocal a row
  int i0 = 0;
  for (; i0 + 16 <= n; i0 += 16) {
    float raw[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) raw[q] = raw_at(f, ln, i0 + q, tt);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      rr[i0 + q] = fminf(fmaxf(raw[q], eps), cmax) * dtf;
  }
  for (; i0 < n; ++i0)
    rr[i0] = fminf(fmaxf(raw_at(f, ln, i0, tt), eps), cmax) * dtf;
  float rp = 0.0f;  // r[i - 1]
  float up = 0.0f;  // up[i - 1]
  float rc = rr[0];
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float rn = i + 1 < n ? rr[i + 1] : 0.0f;
    const float b =
        ((i == 0 || i == n - 1) ? 1.0f + rc : 1.0f + 2.0f * rc) + eps;
    const float rs = i > 0 ? (kT ? rp : rc) : 0.0f;
    const float ru = i + 1 < n ? (kT ? rn : rc) : 0.0f;
    const float rd = reciprocal(b - rs * up);
    up = ru * rd;
    rdp[i] = rd;
    if (!kT) rr[i] = rc * rd;
    rp = rc;
    rc = rn;
  }
}

// Factor threads (threadIdx.x < lines): factor every line of a sweep into
// F.  Out of line, so that the kernels' many call sites share one copy of
// the unrolled code.
__device__ __noinline__ void factor_sweep(float* F, const Tile& t,
                                          const Sweep sw, bool kT,
                                          const Field f, float tt, float dtf,
                                          float eps, float cmax) {
  const int j = threadIdx.x;
  if (j < sw.lines)
    factor_line(F, sw, j, kT, line_at(t, sw.y, j), f, tt, dtf, eps, cmax);
}

// x = T^-1 d (kT: T^-T d) in place on one line of an image (rows ss
// apart), from its factors (rd and f2, rows contiguous): the elimination
// dp[i] = rd[i] d[i] + lo[i] dp[i-1], then x[i] = dp[i] + up[i] x[i+1],
// with lo = up = m for T, and lo[i] = r[i-1] rd[i], up[i] = r[i+1] rd[i] for
// its transpose.  Rows move kChunk at a time: their loads, the recurrence,
// their stores, so that no load waits behind the previous row's store.
template <bool kT>
__device__ __forceinline__ void solve_line(const float* __restrict__ rd,
                                           const float* __restrict__ f2,
                                           float* x, int ss, int n) {
  float dp = 0.0f;
  float rp = 0.0f;  // r[i - 1]
  int i = 0;
  for (; i + kChunk <= n; i += kChunk) {
    float xv[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) xv[q] = x[(i + q) * ss];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      // the first row has dp = 0, whatever lo is
      const float lo = kT ? rp * rd[i + q] : f2[i + q];
      dp = fmaf(lo, dp, rd[i + q] * xv[q]);
      xv[q] = dp;
      rp = f2[i + q];
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) x[(i + q) * ss] = xv[q];
  }
  for (; i < n; ++i) {
    const float lo = kT ? rp * rd[i] : f2[i];
    dp = fmaf(lo, dp, rd[i] * x[i * ss]);
    x[i * ss] = dp;
    rp = f2[i];
  }
  float rn = kT ? f2[n - 1] : 0.0f;  // r[i + 1]
  i = n - 2;
  for (; i + 1 >= kChunk; i -= kChunk) {
    float xv[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) xv[q] = x[(i - q) * ss];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const float up = kT ? rn * rd[i - q] : f2[i - q];
      dp = fmaf(up, dp, xv[q]);
      xv[q] = dp;
      rn = f2[i - q];
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) x[(i - q) * ss] = xv[q];
  }
  for (; i >= 0; --i) {
    const float up = kT ? rn * rd[i] : f2[i];
    dp = fmaf(up, dp, x[i * ss]);
    x[i * ss] = dp;
    rn = f2[i];
  }
}

// Workers (worker = threadIdx.x - nf, of nw): solve every (line, image) of
// the block's images in ``buf`` with the sweep's factors F (kT: of the
// transpose).
template <bool kT>
__device__ __forceinline__ void apply_sweep(const float* __restrict__ F,
                                            float* buf, const Tile& t,
                                            const Sweep sw, int worker,
                                            int nw) {
  for (int p = worker; p < sw.lines * t.nimg; p += nw) {
    const int g = p / sw.lines;
    const int j = p - g * sw.lines;
    const Line ln = line_at(t, sw.y, j);
    solve_line<kT>(F + j * sw.fld, F + (sw.lines + j) * sw.fld,
                   buf + g * t.img + ln.s0, ln.ss, sw.n);
  }
}

// Workers (worker of nw): call fn(o, img, h, w) for each pixel (img, h, w)
// of the block's images, o its channel-0 word in an image buffer (channel c
// is c*H*ld further).  Worker wi*W + w takes column w of rows wi, wi + R, ...,
// R = nw / W rows at a time, with no division per pixel; the same pixels
// each call.
template <typename Fn>
__device__ __forceinline__ void for_pixels(const Tile& t, int worker, int nw,
                                           Fn&& fn) {
  const int R = nw / t.W;
  const int wi = worker / t.W;
  if (wi >= R) return;
  const int w = worker - wi * t.W;
  int img = 0, h = wi;
  while (h >= t.H) {
    h -= t.H;
    ++img;
  }
  for (int r = wi; r < t.nimg * t.H; r += R) {
    fn(img * t.img + h * t.ld + w, img, h, w);
    h += R;
    while (h >= t.H) {
      h -= t.H;
      ++img;
    }
  }
}

// Workers: apply the C x C matrix m (row-major; kTrans: its transpose) to
// the channel vector at every pixel of the images in src, into dst (in
// place when they are the same), one worker a pixel.  kC: C known at
// compile time (0: read from the tile).  With res, each pixel's input is
// first written to res, the images' (nimg, C, H, W) slab in device memory:
// the stores depend on nothing that follows.
template <bool kTrans, int kC>
__device__ __forceinline__ void mix_tile(const float* src, float* dst,
                                         const Tile& t, const float* m,
                                         float* __restrict__ res, int worker,
                                         int nw) {
  const int C = kC > 0 ? kC : t.C;
  const int cstep = t.H * t.ld;
  for_pixels(t, worker, nw, [&](int o, int img, int h, int w) {
    float v[kMaxC];
#pragma unroll
    for (int k = 0; k < kMaxC; ++k)
      if (k < C) v[k] = src[o + k * cstep];
    if (res != nullptr) {
      float* out = res + (long long)img * C * t.hw + h * t.W + w;
#pragma unroll
      for (int k = 0; k < kMaxC; ++k)
        if (k < C) out[k * t.hw] = v[k];
    }
    float y[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxC; ++k)
          if (k < C) acc += m[kTrans ? k * C + c : c * C + k] * v[k];
        y[c] = acc;
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) dst[o + c * cstep] = y[c];
  });
}

// Device memory (nimg, C, H, W) -> images in shared memory, by the
// threads [first, first + count) of the block; kAsync: by cp.async, to be
// committed and waited for by the caller.
template <bool kAsync>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Tile& t, int first,
                                          int count) {
  const int me = (int)threadIdx.x - first;
  if (me < 0 || me >= count) return;
  for (int k = me; k < t.nimg * t.C * t.hw; k += count) {
    const int row = k / t.W;
    const int w = k - row * t.W;
    if constexpr (kAsync)
      channel_sweep::cp_async4(dst + row * t.ld + w, src + k);
    else
      dst[row * t.ld + w] = src[k];
  }
}

// Images in shared memory -> device memory (nimg, C, H, W), by the threads
// [first, first + count).
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           const Tile& t, int first,
                                           int count) {
  const int me = (int)threadIdx.x - first;
  if (me < 0 || me >= count) return;
  for (int k = me; k < t.nimg * t.C * t.hw; k += count) {
    const int row = k / t.W;
    dst[k] = src[row * t.ld + k - row * t.W];
  }
}

// The block's shared memory from its start: the mixing matrix, ``extra``
// floats of the caller's, the factor buffers, then the staged fields.
// Copies the matrix and the staged fields there (all threads) and returns
// the fields, alpha and beta, each in shared or device memory.  The caller
// synchronises.
__device__ __forceinline__ void stage(float* smem, int extra, const float* ab,
                                      const float* atc, const float* bb,
                                      const float* btc, const float* mix,
                                      const Tile& t, const Layout& l,
                                      Field& alpha, Field& beta) {
  for (int k = threadIdx.x; k < t.C * t.C; k += blockDim.x) smem[k] = mix[k];
  float* sf = smem + t.C * t.C + extra + l.nbuf * factor_floats(t.C, t.H, t.W);
  Tile one = t;
  one.nimg = 1;
  alpha = Field{ab, atc, false};
  beta = Field{bb, btc, false};
  if (l.staged >= 1) {
    load_rows<false>(sf, ab, one, 0, blockDim.x);
    load_rows<false>(sf + t.img, atc, one, 0, blockDim.x);
    alpha = Field{sf, sf + t.img, true};
  }
  if (l.staged >= 2) {
    load_rows<false>(sf + 2 * t.img, bb, one, 0, blockDim.x);
    load_rows<false>(sf + 3 * t.img, btc, one, 0, blockDim.x);
    beta = Field{sf + 2 * t.img, sf + 3 * t.img, true};
  }
}

}  // namespace channel_lines
