// A whole GrayscaleDiffusion forward in one C call, for Hopper (sm_90a): a
// small kernel that makes the layer's batch-free factor table, then the
// kernel that applies it to the images.
//
// K6 (res == nullptr): the eval forward.  Replaces
// cnn_pde_tpu/ops/pallas_fused_adi.py::fused_grayscale_diffusion_fwd (the
// Pallas kernel built by _make_kernel, pallas_call at :119, with
// _sweep_rows, _smooth3_edge and _pcr_rows).
//
// K7 (res != nullptr): the trainable forward, the same kernels with one
// more output.  Before each step the block writes its images' state to
// res[step] of a (num_steps, B, H, W) tensor: the residuals that K8
// (fused_grayscale_vjp.cu) recomputes the step from.  Replaces
// cnn_pde_tpu/ops/pallas_fused_adi_vjp.py::_fwd_call (_make_fwd_kernel,
// pallas_call at :196).
//
// Per Strang step, for each image: an x-sweep at ts[s, 0] with dt/2, a
// y-sweep at ts[s, 1] with dt, an x-sweep at ts[s, 2] with dt/2.  Each
// sweep solves, per line, the Neumann system a = c = -r, b = 1 + 2r (1 + r
// on the two edge rows) + eps with r = smooth3(max(base + tc*t, eps)) * dtf,
// the smoothing along the sweep axis: W for x, H for y.
//
// What bounds it.  Bytes: u read and the output written once (8 bytes an
// element), K7's S residual states written once more (32 MB at B = 1024 on
// the mnist layer, most of its bound), the four fields.  Operations: about
// 5 flops an element and sweep (the elimination and the back-substitution);
// the clamped, smoothed coefficients, the bands and their factorisation are
// the same for every image and are counted once, a few thousand flops a
// step.  At the mnist layer's sizes the bound is a few microseconds and
// bytes set it.  What holds the kernel above it is latency: a line's
// recurrence is serial, 2N dependent steps, and the 3S sweeps of a layer
// follow one another, each ending in a barrier.
//
// What the design does about it (grayscale_lines.cuh).
// - The batch-free chain is done once a call, off every block's path: a
//   first kernel makes the factors of all 3S sweeps at once (a block a
//   sweep, two threads a line, 1,680 half chains at mnist), into a table of
//   3 floats a row (m, piv, r; 280 KB at mnist, which stays in L2).
// - The main kernel only applies: the block's images stay in shared memory
//   for the whole layer (rows of W | 1 floats, x and y lines free of bank
//   conflicts), and two threads a (line, image) solve it from both ends
//   toward its middle row (a twisted factorisation: each thread's chain is
//   half the line), with two fmas and a product a row, no division.  A
//   half of up to 16 rows (every line of the presets' 28 x 28) stays in
//   registers from its loads to its stores, and lines of 28 rows have their
//   own instantiation, whose chains carry no selects.  A line's images sit
//   in one warp and read its factors together.
// - The block copies each sweep's factors from the table into a ring of
//   four shared buffers by cp.async, 16 bytes a copy, three sweeps ahead
//   of the sweep it applies: a copy from L2 takes about as long as a sweep.
// - The main kernel is a programmatic dependent launch: its blocks start
//   and load their images while the factor kernel runs.
// - The batch is spread over at least one block an SM where it allows (one
//   image a block at B <= 132), at most four images a block (at B = 1024
//   two blocks of four an SM beat one of eight, whose solves queue on its
//   shared memory), whole images, as evenly as they split (the wrapper's
//   plan, ops/fused_grayscale.py::plan_grayscale; fused_grayscale_layout
//   reports the block's threads and bytes, which the wrapper holds against
//   its plan).
// - Two buffers of the block's images: each step's first x-sweep solves
//   out of place into the second and its last back into the first, so a
//   step's input stays in the first through its first two sweeps.  K7
//   stores it to res[step] from there in those two phases, coalesced, half
//   in each, after the solves: no pass or barrier of its own, and nothing
//   waits for the stores.

#include <cuda_runtime.h>

#include "grayscale_lines.cuh"

namespace {

using channel_lines::Tile;
namespace gl = grayscale_lines;

constexpr int kBuffers = 2;  // image buffers: the state, and its copy
constexpr int kRing = 4;     // factor buffers: sweeps in flight

// Bytes of shared memory a block of ``tile`` images takes: kRing factor
// buffers of two slots, then the images' two buffers.
long long block_bytes(int H, int W, int tile) {
  return 4LL * (2 * kRing * gl::max_slot(H, W) +
                (long long)kBuffers * tile *
                    channel_lines::image_floats(1, H, W));
}

__global__ void __launch_bounds__(gl::kMaxThreads, 1)
    fused_grayscale_kernel(const float* __restrict__ u,
                           float* __restrict__ out,
                           const float* __restrict__ table,
                           float* __restrict__ res, int B, int H, int W,
                           int num_steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int first, count;
  channel_lines::block_images(B, first, count);
  const Tile t = channel_lines::make_tile(1, H, W, count);
  const int tile = (B + gridDim.x - 1) / gridDim.x;
  const int fbuf = 2 * gl::max_slot(H, W);
  auto factors = [&](int n) { return smem + (n % kRing) * fbuf; };
  // the state at each step's start, and between its first and last sweep
  float* s = smem + kRing * fbuf;
  float* s2 = s + tile * t.img;
  const long long hw = (long long)H * W;
  const int total = 3 * num_steps;

  // the images in while the factor kernel runs; then the first sweeps'
  // factors, one copy group a sweep
  channel_lines::load_rows<false>(s, u + first * hw, t, 0, blockDim.x);
  gl::wait_for_table();
  for (int n = 0; n < kRing - 1; ++n) {
    if (n < total) gl::fetch_factors(factors(n), table, n, false, H, W);
    channel_sweep::cp_async_commit();
  }
  channel_sweep::cp_async_wait<kRing - 2>();
  __syncthreads();

  // K7: the step's input stays in s through its first two sweeps; half of
  // it goes to res[step] in each of their phases, coalesced (16 bytes a
  // store where an image is a whole number of them), and nothing waits for
  // the stores
  const int elems = count * H * W;
  const int mid = elems / 8 * 4;
  auto store_res = [&](int step, int from, int to) {
    float* dst = res + ((long long)step * B + first) * hw;
    if (hw % 4 == 0) {
      for (int k = from + 4 * (int)threadIdx.x; k < to;
           k += 4 * blockDim.x) {
        int row = k / W;
        int col = k - row * W;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = s[row * t.ld + col];
          if (++col == W) {
            col = 0;
            ++row;
          }
        }
        *reinterpret_cast<float4*>(dst + k) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      }
    } else {
      for (int k = from + threadIdx.x; k < to; k += blockDim.x) {
        const int row = k / W;
        dst[k] = s[row * t.ld + k - row * W];
      }
    }
  };
  const gl::Group grp = gl::group_of(tile, t.nimg);
  for (int n = 0; n < total; ++n) {
    // sweep n + kRing - 1's factors into the buffer of sweep n - 1
    if (n + kRing - 1 < total)
      gl::fetch_factors(factors(n + kRing - 1), table, n + kRing - 1, false,
                        H, W);
    channel_sweep::cp_async_commit();
    // x at t0: s -> s2; y at t1: s2 in place; x at t2: s2 -> s
    const int q = n % 3;
    gl::apply_sweep<false>(factors(n), q == 0 ? s : s2, q == 2 ? s : s2, t,
                           gl::lines_of(t, q == 1), grp);
    if (res != nullptr && q < 2)
      store_res(n / 3, q == 0 ? 0 : mid, q == 0 ? mid : elems);
    channel_sweep::cp_async_wait<kRing - 2>();  // sweep n + 1's are in
    __syncthreads();
  }
  channel_lines::store_rows(out + first * hw, s, t, 0, blockDim.x);
}

}  // namespace

// The launch shape of a plan of the wrapper (ops/fused_grayscale.py::
// plan_grayscale), checked the first time the wrapper launches that plan:
// threads a block, bytes of shared memory a block for (H, W) images,
// ``tile`` a block, and floats a sweep takes in the factor table.
extern "C" int fused_grayscale_layout(int H, int W, int tile, int* threads,
                                      int* smem, int* slab) {
  *threads = gl::block_threads(H, W, tile);
  *smem = (int)block_bytes(H, W, tile);
  *slab = gl::slab_floats(H, W);
  return 0;
}

// K6 (res null) and K7 (res: the (num_steps, B, H, W) residuals): the
// factor table into ``table`` (3 num_steps slabs of the layout's floats,
// 16-byte aligned), then the layer over ``grid`` blocks, 1 <= grid <= B,
// each taking B / grid images rounded up or down, at most kMaxTile.
// Returns cudaErrorInvalidValue for a larger tile, else the error of the
// shared-memory opt-in or of each launch; the caller raises if it is not
// 0.  The wrapper checks H, W <= 64 and the plan's shared memory.
extern "C" int fused_grayscale_diffusion(
    const float* u, float* out, const float* alpha_base,
    const float* alpha_tc, const float* beta_base, const float* beta_tc,
    const float* ts, float* res, float* table, int B, int H, int W, int grid,
    int num_steps, float dtf_x, float dtf_y, float eps, void* stream) {
  static size_t smem_allowed[channel_sweep::kMaxDevices];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = (B + grid - 1) / grid;
  if (tile > gl::kMaxTile) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)block_bytes(H, W, tile);
  cudaError_t err = channel_sweep::allow_shared_memory(
      (const void*)fused_grayscale_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  err = gl::make_table(alpha_base, alpha_tc, beta_base, beta_tc, ts, table,
                       H, W, 3 * num_steps, dtf_x, dtf_y, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = gl::launch_after_table(fused_grayscale_kernel, grid,
                               gl::block_threads(H, W, tile), smem, st, u,
                               out, (const float*)table, res, B, H, W,
                               num_steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
