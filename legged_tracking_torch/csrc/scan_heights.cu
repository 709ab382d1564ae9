// Observation height scan: nearest-cell [ceiling, floor] heights at the
// base-local scan grid of every env, read straight from the bf16 tile table.
//
// Replaces the TPU kernel legged_tracking_tpu/terrain/pallas_scan.py
// (scan_heights_pallas, body _scan_kernel), which DMAs each env's tile into
// VMEM and samples it with one-hot MXU dots.  On Hopper the natural shape is
// a direct gather: one thread per (env, point), one block per env and run of
// points.  A block reads its env's tile index and frame itself and writes
// the f32 output coalesced along the point axis.
//
// What bounds it: bytes.  Each point does a handful of flops and two 2-byte
// reads; the output alone is N*2*P*4 bytes (7.6 MB at 4096 envs and the
// 21x11 grid), and of the tile table (13 MB for 32x32 tiles of 2x80x40
// bf16, small enough for the 50 MB L2) only the touched cells are read.
//
// Exactness: the op order is the JAX path's, ((grid + base) + cam - origin)
// * inv_hs, then truncation toward zero and the clip.  The JAX source writes
// "/ hs"; XLA compiles a division by that constant to a multiply by its
// float32 reciprocal, and a point on a cell boundary (every grid-aligned
// spawn) lands in the cell that rounding picks, so the kernel multiplies by
// the same reciprocal.  The _rn intrinsics keep nvcc from contracting the
// subtract and multiply into an FMA or reassociating the sums; build without
// --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scan_heights_kernel(const __nv_bfloat16* __restrict__ tiles,  // (T, 2, h, w)
                                    const int32_t* __restrict__ env_tile,     // (N,)
                                    const float* __restrict__ frames,         // (N, 3, 2)
                                    const float* __restrict__ grid,           // (P, 2)
                                    float* __restrict__ out,                  // (N, 2, P)
                                    int P, int h, int w, float inv_hs) {
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float* fr = frames + 6 * static_cast<int64_t>(n);  // base, cam, origin
  const float px = __fadd_rn(__fadd_rn(grid[2 * p], fr[0]), fr[2]);
  const float py = __fadd_rn(__fadd_rn(grid[2 * p + 1], fr[1]), fr[3]);
  const float lx = __fmul_rn(__fsub_rn(px, fr[4]), inv_hs);
  const float ly = __fmul_rn(__fsub_rn(py, fr[5]), inv_hs);
  const int x0 = min(max(static_cast<int>(lx), 0), h - 2);
  const int y0 = min(max(static_cast<int>(ly), 0), w - 2);
  const int64_t cell = static_cast<int64_t>(env_tile[n]) * 2 * h * w
                       + static_cast<int64_t>(x0) * w + y0;
  float* o = out + static_cast<int64_t>(n) * 2 * P;
  o[p] = __bfloat162float(tiles[cell]);
  o[P + p] = __bfloat162float(tiles[cell + static_cast<int64_t>(h) * w]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int scan_heights(const void* tiles, const void* env_tile, const void* frames,
                            const void* grid, void* out, int N, int P, int h, int w,
                            float inv_hs, void* stream) {
  if (N == 0 || P == 0) return 0;
  const dim3 blocks(N, (P + kThreads - 1) / kThreads);
  scan_heights_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tiles), static_cast<const int32_t*>(env_tile),
      static_cast<const float*>(frames), static_cast<const float*>(grid),
      static_cast<float*>(out), P, h, w, inv_hs);
  return static_cast<int>(cudaGetLastError());
}
