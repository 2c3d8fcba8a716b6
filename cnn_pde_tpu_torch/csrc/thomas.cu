// Batched Thomas solve for Hopper (sm_90a): x = T^-1 d along one axis of d,
// with batch-free tridiagonal bands (a, b, c) broadcast over the batch.
//
// Replaces: cnn_pde_tpu/ops/pallas_thomas.py::pallas_tridiag_solve (forward),
// the Pallas kernel _thomas_kernel launched by _solve_2d.
//
// Layout.  d and x are (B, P, N, Q) row-major and the solve runs along N with
// element stride Q; a, b, c are (P, N, Q), the same layout without the batch.
// The ADI x-sweep of a (B, C, H, W) state is P = C*H, N = W, Q = 1; the
// y-sweep is P = C, N = H, Q = W, so it solves down the columns in place and
// needs none of the two transposes the JAX sweep_y pays.
//
// What bounds it.  Per element of d the recurrence needs about five flops
// (the c* chain of the batch-free bands is the same for every image) against
// eight bytes of d and x that must cross device memory once, so the kernel is
// bound by bytes (an H100 SXM moves 3.35 TB/s against 67 TFLOP/s of f32), and
// by how well those bytes coalesce: one thread per line reads its line with a
// stride of N floats when Q = 1.  The bands are batch-free (a few tens of KB)
// and stay in L1/L2 after the first line touches them.
//
// What the design does about it.  One thread per line; c* lives in a
// per-thread local array (N <= 64), which the compiler keeps interleaved so
// neighbouring threads touch neighbouring words.  For Q = 1 a block of 128
// lines is staged through shared memory with a row stride of N + 1 (no bank
// conflicts), so device memory is read and written in whole coalesced rows;
// d* is written in place in the staged tile.  For Q > 1 neighbouring threads
// own neighbouring columns, so direct global access is already coalesced.
// The recurrence is the one of ops/tridiag.py::thomas_plain (divide, not
// multiply by a reciprocal), so the two differ only in fma contraction.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kLinesPerBlock = 128;

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
    const float* ap = a + coef;
    const float* bp = b + coef;
    const float* cp = c + coef;
    float cs[kMaxN];
    float b0 = __ldg(bp);
    cs[0] = __ldg(cp) / b0;
    row[0] = row[0] / b0;
    for (int i = 1; i < N; ++i) {
      const float ai = __ldg(ap + i);
      const float denom = __ldg(bp + i) - ai * cs[i - 1];
      cs[i] = __ldg(cp + i) / denom;
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
  cs[0] = __ldg(c + coef) / b0;
  float dprev = dp[0] / b0;
  xp[0] = dprev;
  for (int i = 1; i < N; ++i) {
    const long long k = coef + (long long)i * Q;
    const float ai = __ldg(a + k);
    const float denom = __ldg(b + k) - ai * cs[i - 1];
    cs[i] = __ldg(c + k) / denom;
    dprev = (dp[(long long)i * Q] - ai * dprev) / denom;
    xp[(long long)i * Q] = dprev;
  }
  float xnext = dprev;
  for (int i = N - 2; i >= 0; --i) {
    xnext = xp[(long long)i * Q] - cs[i] * xnext;
    xp[(long long)i * Q] = xnext;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is
// not 0.  N must lie in [1, 64]; the wrapper checks it.
extern "C" int thomas_solve(const float* a, const float* b, const float* c,
                            const float* d, float* x, long long batch, int P,
                            int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 1) {
    const long long lines = batch * P;
    const unsigned blocks =
        (unsigned)((lines + kLinesPerBlock - 1) / kLinesPerBlock);
    const size_t smem = sizeof(float) * kLinesPerBlock * (N + 1);
    thomas_contiguous<<<blocks, kLinesPerBlock, smem, s>>>(a, b, c, d, x,
                                                          lines, P, N);
  } else {
    const long long lines = batch * P * Q;
    const int threads = 128;
    const unsigned blocks = (unsigned)((lines + threads - 1) / threads);
    thomas_strided<<<blocks, threads, 0, s>>>(a, b, c, d, x, lines, P, N, Q);
  }
  return (int)cudaGetLastError();
}
