// Observation height scan: nearest-cell [ceiling, floor] heights at the
// base-local scan grid of every env, read straight from the bf16 tile table.
//
// Replaces the TPU kernel legged_tracking_tpu/terrain/pallas_scan.py
// (scan_heights_pallas, body _scan_kernel), which DMAs each env's whole
// (2, h, w) tile into VMEM and samples it with one-hot MXU dots.  Here that
// would copy 12.8 KB of tile per env to use 2 x P cells of it, and spend
// h * w multiply-adds of the tensor cores per value read: the function has
// no product in it, so this kernel gathers the cells directly.
//
// What bounds it: bytes.  Each point does a handful of flops and two 2-byte
// reads; the output alone is N*2*P*4 bytes (7.6 MB at 4096 envs and the
// 21x11 grid), and of the tile table (13 MB for 32x32 tiles of 2x80x40
// bf16, small enough for the 50 MB L2) only the touched cells are read.
// At that size a launch takes a few microseconds, and its time goes to
// starting blocks, one round trip for the inputs, the index arithmetic,
// the gathers and writing the output.  The design:
//
// - One resident wave.  A block takes E envs (E even, chosen with the grid
//   size by terrain/scan.py:launch_shape so that the grid fits one wave of
//   kResident blocks per SM): the card starts a few hundred blocks, not
//   one per env; starting blocks has a cost of its own.
// - Shared memory for the per-block inputs.  The block stages the P-point
//   grid, its E frames and its E tile pointers with coalesced loads, all
//   issued before the first store, so the staging costs one round trip.
// - A warp per env.  Warp w takes envs w, w + kWarps, ...; its lanes walk
//   the points, kBatch to a lane, and issue every table read of a batch
//   before writing any height into the block's output span, staged in
//   shared memory.  The env's frame lives in registers, so an item costs
//   one shared-memory read of its grid point, about 20 instructions of
//   arithmetic, two gathers and two shared-memory writes.  At a million
//   items the arithmetic takes issue time of its own, so it is kept lean
//   (no division, 32-bit offsets, no float-to-int conversion).
// - Bulk-async output.  The span (E, 2, P) f32 is contiguous in the
//   output.  After each round (one env per warp) the block hands the
//   round's envs, an even count and so a multiple of 16 bytes at a
//   16-byte-aligned address, to one TMA bulk store
//   (cp.async.bulk.global.shared::cta), which drains while the next round
//   gathers.  An odd env left over in a tail block is copied out with
//   ordinary stores.
//
// Exactness: the op order is the JAX path's, ((grid + base) + cam - origin)
// * inv_hs, then truncation toward zero and the clip.  The JAX source writes
// "/ hs"; XLA compiles a division by that constant to a multiply by its
// float32 reciprocal, and a point on a cell boundary (every grid-aligned
// spawn) lands in the cell that rounding picks, so the kernel multiplies by
// the same reciprocal.  The _rn intrinsics keep nvcc from contracting the
// subtract and multiply into an FMA or reassociating the sums; build without
// --use_fast_math.  Clipping before truncating picks the same cell as
// truncating first (cell_index).  The bf16 -> f32 widening is exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kResident = 4;     // blocks per SM the registers must allow
constexpr int kBatch = 8;        // points a lane gathers at once
constexpr int kStage = 4;        // input floats a thread loads at once
constexpr int kDefaultSmem = 48 * 1024;

// Dynamic shared memory of a block of E envs, in this order (every part
// starts 16-byte aligned when E is even): the output span (E, 2, P) f32,
// the E tile pointers, the E frames (3, 2) f32, the grid (P, 2) f32.
// terrain/scan.py:staging_bytes computes the same sum.
__host__ __device__ inline int64_t staging_bytes(int E, int P) {
  return 8LL * E * P + 8LL * E + 24LL * E + 8LL * P;
}

// s1[i] = g1[i] for i < n1 and s2[i] = g2[i] for i < n2, each pass issuing
// all its loads before its stores
__device__ __forceinline__ void stage(float* s1, const float* __restrict__ g1, int n1,
                                      float* s2, const float* __restrict__ g2, int n2) {
  for (int i0 = threadIdx.x; i0 < n1 + n2; i0 += kThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n1) v[j] = g1[i];
      else if (i < n1 + n2) v[j] = g2[i - n1];
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n1) s1[i] = v[j];
      else if (i < n1 + n2) s2[i - n1] = v[j];
    }
  }
}

// clip(trunc(l), 0, top) for an integer top < 2^23, without the
// float-to-int conversion (a quarter-rate instruction on this card): clip
// in float, then add 2^23 rounding toward zero, which leaves floor(x) =
// trunc(x) in the low mantissa bits.  NaN clips to 0, as the conversion
// gives 0 for it.
__device__ __forceinline__ uint32_t cell_index(float l, float top) {
  return __float_as_uint(__fadd_rz(fminf(fmaxf(l, 0.f), top), 8388608.f)) - 0x4B000000u;
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kResident)
scan_heights_kernel(const uint16_t* __restrict__ tiles,   // (T, 2, h, w) bf16 bits
                    const int32_t* __restrict__ env_tile,  // (N,)
                    const float* __restrict__ frames,      // (N, 3, 2)
                    const float* __restrict__ grid,        // (P, 2)
                    float* __restrict__ out,               // (N, 2, P)
                    int N, int P, int h, int w, float inv_hs, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_out = reinterpret_cast<float*>(smem);
  const uint16_t** s_tile = reinterpret_cast<const uint16_t**>(smem + 8LL * E * P);
  float* s_frames = reinterpret_cast<float*>(s_tile + E);
  const float2* s_grid = reinterpret_cast<const float2*>(s_frames + 6 * E);

  const int n0 = blockIdx.x * E;
  const int ne = min(E, N - n0);
  const uint32_t hw = static_cast<uint32_t>(h) * w;
  int32_t tile = 0;                           // E <= kThreads
  if (threadIdx.x < ne) tile = env_tile[n0 + threadIdx.x];
  stage(s_frames, frames + 6LL * n0, 6 * ne, s_frames + 6 * E, grid, 2 * P);
  if (threadIdx.x < ne) s_tile[threadIdx.x] = tiles + static_cast<int64_t>(tile) * 2 * hw;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float hmax = static_cast<float>(h - 2), wmax = static_cast<float>(w - 2);
  float* o = out + 2LL * n0 * P;
  uint32_t issued = 0;
  for (int first = 0; first < ne; first += kWarps) {
    const int e = first + warp;
    if (e < ne) {
      const float* fr = s_frames + 6 * e;     // base, cam, origin
      const float bx = fr[0], by = fr[1], cx = fr[2], cy = fr[3], ox = fr[4], oy = fr[5];
      const uint16_t* ceil_row = s_tile[e];
      const uint16_t* floor_row = ceil_row + hw;
      float* d = s_out + 2 * e * P;
      for (int p0 = lane; p0 < P; p0 += 32 * kBatch) {
        uint32_t c[kBatch], f[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const float2 g = s_grid[min(p0 + 32 * k, P - 1)];
          const float px = __fadd_rn(__fadd_rn(g.x, bx), cx);
          const float py = __fadd_rn(__fadd_rn(g.y, by), cy);
          const float lx = __fmul_rn(__fsub_rn(px, ox), inv_hs);
          const float ly = __fmul_rn(__fsub_rn(py, oy), inv_hs);
          const uint32_t x0 = cell_index(lx, hmax);
          const uint32_t y0 = cell_index(ly, wmax);
          const uint32_t cell = x0 * w + y0;
          c[k] = __ldg(ceil_row + cell);
          f[k] = __ldg(floor_row + cell);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int p = p0 + 32 * k;
          if (p < P) {
            d[p] = __uint_as_float(c[k] << 16);
            d[P + p] = __uint_as_float(f[k] << 16);
          }
        }
      }
    }
    // hand this round's envs to the bulk store, an odd last one to plain stores
    const int count = min(kWarps, ne - first), even = count & ~1;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && even > 0) {
      bulk_store(o + 2LL * first * P, s_out + 2 * first * P, 8u * even * P);
      ++issued;
    }
    if (count != even)
      for (int i = 2 * (first + even) * P + threadIdx.x; i < 2 * (first + count) * P; i += kThreads)
        o[i] = s_out[i];
  }
  // the span must be read out before the block's shared memory goes
  if (issued) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace

// Launches `blocks` blocks of `E` envs each with `smem` bytes of dynamic
// shared memory (terrain/scan.py:launch_shape) on `stream` of card
// `device`, and returns the CUDA error code (0 on success).
extern "C" int scan_heights(const void* tiles, const void* env_tile, const void* frames,
                            const void* grid, void* out, int N, int P, int h, int w,
                            float inv_hs, int E, int blocks, int smem, int device,
                            void* stream) {
  if (N == 0 || P == 0) return 0;
  if (E < 2 || E % 2 != 0 || E > kThreads || static_cast<int64_t>(blocks) * E < N
      || static_cast<int64_t>(blocks - 1) * E >= N || smem < staging_bytes(E, P))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem)
    err = cudaFuncSetAttribute(scan_heights_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    scan_heights_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(tiles), static_cast<const int32_t*>(env_tile),
        static_cast<const float*>(frames), static_cast<const float*>(grid),
        static_cast<float*>(out), N, P, h, w, inv_hs, E);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
