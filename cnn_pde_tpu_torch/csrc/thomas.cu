// Batched Thomas solve for Hopper (sm_90a) and its adjoint.
//
// K1, thomas_solve: x = T^-1 d along one axis of d, with batch-free
// tridiagonal bands (a, b, c) broadcast over the batch.
// Replaces: cnn_pde_tpu/ops/pallas_thomas.py::pallas_tridiag_solve (forward),
// the Pallas kernel _thomas_kernel launched by _solve_2d.
//
// K3, thomas_adjoint: the backward of K1.  lam = T^-T g along the same axis,
// then the band gradients summed over the batch onto the batch-free shape:
// grad_b = -sum lam*x, grad_a[i] = -sum lam[i]*x[i-1], grad_c[i] =
// -sum lam[i]*x[i+1] (grad_a[0] = grad_c[N-1] = 0), and grad_d = lam.
// Replaces: the custom VJP of pallas_tridiag_solve (pallas_thomas.py::_bwd),
// which calls the same Pallas kernel on transposed bands and forms the band
// gradients with XLA ops outside it.
//
// Layout.  d, x, g and lam are (B, P, N, Q) row-major and the solve runs
// along N with element stride Q; a, b, c are (P, N, Q), the same layout
// without the batch.  The ADI x-sweep of a (B, C, H, W) state is P = C*H,
// N = W, Q = 1; the y-sweep is P = C, N = H, Q = W, so it solves down the
// columns in place and needs none of the two transposes the JAX sweep_y pays.
//
// What bounds it.  Per element of d the recurrence needs about five flops
// (the c* chain of the batch-free bands is the same for every image) against
// eight bytes of d and x that must cross device memory once, so the solves
// are bound by bytes (an H100 SXM moves 3.35 TB/s against 67 TFLOP/s of f32),
// and by how well those bytes coalesce: one thread per line reads its line
// with a stride of N floats when Q = 1.  The bands are batch-free (a few tens
// of KB) and stay in L1/L2 after the first line touches them.  The adjoint
// also reads lam and x once more for the band sums (6 flops an element).
//
// What the design does about it.  One thread per line; c* lives in a
// per-thread local array (N <= 64), which the compiler keeps interleaved so
// neighbouring threads touch neighbouring words.  For Q = 1 a block of 128
// lines is staged through shared memory with a row stride of N + 1 (no bank
// conflicts), so device memory is read and written in whole coalesced rows;
// d* is written in place in the staged tile.  For Q > 1 neighbouring threads
// own neighbouring columns, so direct global access is already coalesced.
// The adjoint solve is the same kernel reading the transposed bands on the
// fly (lower'[i] = c[i-1], upper'[i] = a[i+1]); no transposed copy exists.
// The band sums take one thread per band element looping over the batch in
// order, neighbouring threads on neighbouring words: deterministic, with no
// atomics.  The recurrence is the one of ops/tridiag.py::_thomas_last_axis
// (divide, not multiply by a reciprocal), so the two differ only in fma
// contraction.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kLinesPerBlock = 128;
constexpr int kBandThreads = 128;

// Sub- and super-diagonal of row i, whose band element sits at k, in a line
// of element stride q: of T itself, or of T^T when kT.
template <bool kT>
__device__ __forceinline__ float lower_at(const float* a, const float* c,
                                          long long k, long long q) {
  return kT ? __ldg(c + k - q) : __ldg(a + k);
}

template <bool kT>
__device__ __forceinline__ float upper_at(const float* a, const float* c,
                                          long long k, long long q,
                                          bool last) {
  if (last) return 0.0f;  // outside the matrix
  return kT ? __ldg(a + k + q) : __ldg(c + k);
}

template <bool kT>
__global__ void thomas_contiguous(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ c,
                                  const float* __restrict__ d,
                                  float* __restrict__ x,
                                  long long lines, int P, int N) {
  extern __shared__ float tile[];  // kLinesPerBlock rows of N + 1 floats
  const int ld = N + 1;
  const long long first = (long long)blockIdx.x * kLinesPerBlock;
  const long long left = lines - first;
  const int nlines = left < kLinesPerBlock ? (int)left : kLinesPerBlock;
  const int count = nlines * N;
  const float* dsrc = d + first * N;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    tile[(k / N) * ld + k % N] = dsrc[k];
  }
  __syncthreads();

  if (threadIdx.x < nlines) {
    float* row = tile + threadIdx.x * ld;
    const long long coef = ((first + threadIdx.x) % P) * N;
    float cs[kMaxN];
    const float b0 = __ldg(b + coef);
    cs[0] = upper_at<kT>(a, c, coef, 1, N == 1) / b0;
    row[0] = row[0] / b0;
    for (int i = 1; i < N; ++i) {
      const long long k = coef + i;
      const float ai = lower_at<kT>(a, c, k, 1);
      const float denom = __ldg(b + k) - ai * cs[i - 1];
      cs[i] = upper_at<kT>(a, c, k, 1, i == N - 1) / denom;
      row[i] = (row[i] - ai * row[i - 1]) / denom;
    }
    for (int i = N - 2; i >= 0; --i) {
      row[i] = row[i] - cs[i] * row[i + 1];
    }
  }
  __syncthreads();

  float* xdst = x + first * N;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    xdst[k] = tile[(k / N) * ld + k % N];
  }
}

template <bool kT>
__global__ void thomas_strided(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ c,
                               const float* __restrict__ d,
                               float* __restrict__ x,
                               long long lines, int P, int N, int Q) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= lines) return;
  const long long q = line % Q;
  const long long bp = line / Q;      // batch * P + p
  const long long p = bp % P;
  const long long base = bp * N * Q + q;
  const long long coef = p * N * Q + q;
  const float* dp = d + base;
  float* xp = x + base;
  float cs[kMaxN];
  const float b0 = __ldg(b + coef);
  cs[0] = upper_at<kT>(a, c, coef, Q, N == 1) / b0;
  float dprev = dp[0] / b0;
  xp[0] = dprev;
  for (int i = 1; i < N; ++i) {
    const long long k = coef + (long long)i * Q;
    const float ai = lower_at<kT>(a, c, k, Q);
    const float denom = __ldg(b + k) - ai * cs[i - 1];
    cs[i] = upper_at<kT>(a, c, k, Q, i == N - 1) / denom;
    dprev = (dp[(long long)i * Q] - ai * dprev) / denom;
    xp[(long long)i * Q] = dprev;
  }
  float xnext = dprev;
  for (int i = N - 2; i >= 0; --i) {
    xnext = xp[(long long)i * Q] - cs[i] * xnext;
    xp[(long long)i * Q] = xnext;
  }
}

// One thread per band element e of (P, N, Q), summing over the batch in
// order.  Row i = (e / Q) % N; its neighbours along the line are e -+ Q.
__global__ void thomas_band_grads(const float* __restrict__ lam,
                                  const float* __restrict__ x,
                                  float* __restrict__ ga,
                                  float* __restrict__ gb,
                                  float* __restrict__ gc, long long batch,
                                  long long band, int N, int Q) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= band) return;
  const int i = (int)((e / Q) % N);
  const bool prev = i > 0;
  const bool next = i < N - 1;
  float sa = 0.0f, sb = 0.0f, sc = 0.0f;
  for (long long n = 0; n < batch; ++n) {
    const long long k = n * band + e;
    const float l = lam[k];
    sb += l * x[k];
    if (prev) sa += l * x[k - Q];
    if (next) sc += l * x[k + Q];
  }
  ga[e] = -sa;
  gb[e] = -sb;
  gc[e] = -sc;
}

template <bool kT>
void launch_solve(const float* a, const float* b, const float* c,
                  const float* d, float* x, long long batch, int P, int N,
                  int Q, cudaStream_t s) {
  if (Q == 1) {
    const long long lines = batch * P;
    const unsigned blocks =
        (unsigned)((lines + kLinesPerBlock - 1) / kLinesPerBlock);
    const size_t smem = sizeof(float) * kLinesPerBlock * (N + 1);
    thomas_contiguous<kT><<<blocks, kLinesPerBlock, smem, s>>>(
        a, b, c, d, x, lines, P, N);
  } else {
    const long long lines = batch * P * Q;
    const int threads = 128;
    const unsigned blocks = (unsigned)((lines + threads - 1) / threads);
    thomas_strided<kT><<<blocks, threads, 0, s>>>(a, b, c, d, x, lines, P,
                                                   N, Q);
  }
}

}  // namespace

// K1.  Returns cudaGetLastError() after the launch; the caller raises if it
// is not 0.  N must lie in [1, 64]; the wrapper checks it.
extern "C" int thomas_solve(const float* a, const float* b, const float* c,
                            const float* d, float* x, long long batch, int P,
                            int N, int Q, void* stream) {
  launch_solve<false>(a, b, c, d, x, batch, P, N, Q,
                      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K3: the adjoint solve into lam, then the band gradients (ga, gb, gc of the
// band shape), two kernels on one stream.  Same contract as thomas_solve.
extern "C" int thomas_adjoint(const float* a, const float* b, const float* c,
                              const float* g, const float* x, float* lam,
                              float* ga, float* gb, float* gc,
                              long long batch, int P, int N, int Q,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_solve<true>(a, b, c, g, lam, batch, P, N, Q, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long band = (long long)P * N * Q;
  const unsigned blocks =
      (unsigned)((band + kBandThreads - 1) / kBandThreads);
  thomas_band_grads<<<blocks, kBandThreads, 0, s>>>(lam, x, ga, gb, gc,
                                                    batch, band, N, Q);
  return (int)cudaGetLastError();
}
