// Weight and bias gradients of a 3x3, stride 1, zero-padded ("SAME")
// convolution on NHWC float32 maps: kernel W1 of the port.
//
//   dW[co][ci][kh][kw] = sum over frames f and positions (y, x) of
//                        dY[f][y][x][co] * X[f][y + kh - 1][x + kw - 1][ci]
//   db[co]             = sum over f, y, x of dY[f][y][x][co]
//
// It replaces no kernel of the JAX package, which leaves the convolutions
// of its height encoder (learn/actor_critic_cnn.py) to XLA.  It exists
// because the library's choice for these shapes, cuDNN's generic
// wgrad_alg1_engine_NHWC, ran the two weight gradients of the conv + GRU
// policy's update at about 1.6 TFLOP/s, the largest block of device time
// in its training iteration.
//
// The product is a skinny GEMM over a huge reduction: M = COUT (16 or 32)
// output channels by N = CIN * 9 taps (18 or 144), reduced over K = frames
// x positions (40.6 M or 9.2 M in the policy's update).  What bounds it on
// this card: for 2 -> 16 channels bytes (each dY element is used for 18
// multiply-adds only; dY is 2.6 GB a launch), for 16 -> 32 the float32
// FMA pipes (144 multiply-adds an element).  TF32 is out: the program
// states float32.  The design:
//
// - Split-K over a persistent grid.  Block b takes a contiguous range of
//   frames and walks it in stages of S whole frames.  Each block writes
//   its partial sums to a scratch row; a second kernel adds the rows in a
//   fixed order.  No atomics, so the result is bitwise the same from run
//   to run.
// - A ring of kStages stages in shared memory, filled by cp.async.  In
//   NHWC a stage's dY is one contiguous span, copied 16 bytes at a time;
//   its X frames are copied row by row (16 bytes a copy for 16 channels,
//   4 for 2) into zero-padded (h + 2) x (w + 2) maps, so the taps need no
//   bounds checks.  X is read in place with any frame stride (the
//   encoder's first conv reads a slice of the observation history), and
//   never copied in device memory.
// - A thread owns one row y of a frame (a stage's frames go to `slots`
//   groups of h rows, so every thread gets the same work) and a register
//   tile of CO_T output channels x CI_T input channels x 9 taps.  It walks
//   the row's w positions with a 3 x 3 x CI_T window of X in registers,
//   loading one new column a position, and its CO_T dY values as float4s:
//   per position CO_T * CI_T * 9 FMAs against CI_T * 3 + CO_T / 4 shared
//   loads (72 FMAs against 4 or 5 loads for both tiles below).  The walk
//   is unrolled for the encoder's widths (11, and 5 after the pool), so
//   the window slides by renaming registers.
// - Tiles by shape: 2 -> 16 takes CO_T = 4, CI_T = 2 (a thread reads its
//   dY elements once and only it reads them); 16 -> 32 takes CO_T = 8,
//   CI_T = 1 (the 16 threads of one channel group share their dY float4s
//   by broadcast).
// - The bias gradient is fused: the kernel reads dY anyway.  Where one
//   thread sees all of its channels' dY (CI_T = CIN) it adds its CO_T
//   values; otherwise thread ci < CO_T of a channel group adds channel
//   g * CO_T + ci with one more shared load a position.
// - At the end a block adds its threads' tiles over the rows in a fixed
//   order through shared memory and writes one partial row of
//   COUT * CIN * 9 + COUT floats in the output's (co, ci, kh, kw) order,
//   then the biases.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;

template <int CIN, int COUT, int CO_T, int CI_T>
struct Tile {
  static_assert(COUT % CO_T == 0 && CIN % CI_T == 0 && CO_T % 4 == 0, "tile");
  static constexpr int kCoGroups = COUT / CO_T;
  static constexpr int kCiGroups = CIN / CI_T;
  static constexpr int kRoles = kCoGroups * kCiGroups;     // threads a row
  static constexpr int kAcc = CO_T * CI_T * 9;
  static constexpr bool kSplitBias = kCiGroups > 1;
  static_assert(!kSplitBias || kCiGroups >= CO_T, "bias owners");
  static constexpr int kBias = kSplitBias ? 1 : CO_T;
  static constexpr int kSlots = kAcc + kBias;                // floats a thread reduces
  static constexpr int kEntries = COUT * CIN * 9 + COUT;     // a partial row
};

// floats of one stage: S frames of dY (h, w, COUT), then S zero-padded
// frames of X (h + 2, w + 2, CIN), rounded up to 16 bytes
__host__ __device__ inline int stage_floats(int S, int h, int w, int cin, int cout) {
  return (S * (h * w * cout + (h + 2) * (w + 2) * cin) + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row of one frame: w positions (W of them where W > 0, a constant
// the loop unrolls by), the window sliding along x.  dyp points at
// dY[y][0][g * CO_T], xp at the padded X[y - 1 + 1][0][cg * CI_T] (the
// window's top row), both in shared memory.
template <int CIN, int COUT, int CO_T, int CI_T, int W>
__device__ __forceinline__ void accumulate_row(float (&acc)[Tile<CIN, COUT, CO_T, CI_T>::kAcc],
                                               float (&bacc)[Tile<CIN, COUT, CO_T, CI_T>::kBias],
                                               const float* dyp, const float* xp, int w,
                                               int bias_co) {
  using T = Tile<CIN, COUT, CO_T, CI_T>;
  constexpr int kUnroll = W > 0 ? W : 1;
  const int n = W > 0 ? W : w;
  const int xrow = (n + 2) * CIN;
  float win[3][3][CI_T];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kw = 0; kw < 2; ++kw)
#pragma unroll
      for (int c = 0; c < CI_T; ++c) win[kh][kw][c] = xp[kh * xrow + kw * CIN + c];
#pragma unroll kUnroll
  for (int x = 0; x < n; ++x) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const float* col = xp + kh * xrow + (x + 2) * CIN;
      if constexpr (CI_T == 2) {
        const float2 v = *reinterpret_cast<const float2*>(col);
        win[kh][2][0] = v.x;
        win[kh][2][1] = v.y;
      } else {
#pragma unroll
        for (int c = 0; c < CI_T; ++c) win[kh][2][c] = col[c];
      }
    }
    float d[CO_T];
#pragma unroll
    for (int q = 0; q < CO_T / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(dyp + x * COUT + 4 * q);
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int o = 0; o < CO_T; ++o)
#pragma unroll
      for (int c = 0; c < CI_T; ++c)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float& a = acc[(o * CI_T + c) * 9 + kh * 3 + kw];
            a = fmaf(d[o], win[kh][kw][c], a);
          }
    if constexpr (T::kSplitBias) {
      bacc[0] += dyp[x * COUT + bias_co];
    } else {
#pragma unroll
      for (int o = 0; o < CO_T; ++o) bacc[o] += d[o];
    }
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int c = 0; c < CI_T; ++c) {
        win[kh][0][c] = win[kh][1][c];
        win[kh][1][c] = win[kh][2][c];
      }
  }
}

// The block's thread t owns role t % kRoles (channel group g, input group
// cg) of row t / kRoles = slot * h + y.  Block size kRoles * h * slots;
// dynamic shared memory Conv::smem_bytes().
template <int CIN, int COUT, int CO_T, int CI_T, int MAXT>
__global__ void __launch_bounds__(MAXT)
    wgrad_kernel(const float* __restrict__ x, long long x_stride, const float* __restrict__ dy,
                 float* __restrict__ partial, int frames, int h, int w, int slots, int per_slot) {
  using T = Tile<CIN, COUT, CO_T, CI_T>;
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int S = slots * per_slot;
  const int hw = h * w;
  const int dy_frame = hw * COUT;
  const int sf = stage_floats(S, h, w, CIN, COUT);

  // zero the ring once: the copies never write the X maps' padding
  for (int i = tid; i < kStages * sf; i += nthreads) smem[i] = 0.f;
  __syncthreads();

  const long long f_begin = static_cast<long long>(frames) * blockIdx.x / gridDim.x;
  const long long f_end = static_cast<long long>(frames) * (blockIdx.x + 1) / gridDim.x;
  const int nstage = static_cast<int>((f_end - f_begin + S - 1) / S);

  auto fetch = [&](int s) {
    float* dys = smem + (s % kStages) * sf;
    float* xs = dys + S * dy_frame;
    const long long f0 = f_begin + static_cast<long long>(s) * S;
    const int nf = static_cast<int>(min(static_cast<long long>(S), f_end - f0));
    const float* src = dy + f0 * dy_frame;
    const int chunks = nf * dy_frame / 4;
    for (int i = tid; i < chunks; i += nthreads) cp_async16(dys + 4 * i, src + 4 * i);
    // X a row (w * CIN floats) to each group of 4 threads, into the
    // padded map; 16 bytes a copy where a row's floats come in fours
    const int rw = w * CIN;
    for (int row = tid >> 2; row < nf * h; row += nthreads >> 2) {
      const int fl = row / h, yy = row - fl * h;
      const float* xsrc = x + (f0 + fl) * x_stride + yy * rw;
      float* xdst = xs + ((fl * (h + 2) + yy + 1) * (w + 2) + 1) * CIN;
      if constexpr (CIN % 4 == 0) {
        for (int k = (tid & 3) * 4; k < rw; k += 16) cp_async16(xdst + k, xsrc + k);
      } else {
        for (int k = tid & 3; k < rw; k += 4) cp_async4(xdst + k, xsrc + k);
      }
    }
  };

  const int r = tid % T::kRoles, row = tid / T::kRoles;
  const int y = row % h, slot = row / h;
  const int g = r / T::kCiGroups, cg = r % T::kCiGroups;
  float acc[T::kAcc];
  float bacc[T::kBias];
#pragma unroll
  for (int j = 0; j < T::kAcc; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < T::kBias; ++j) bacc[j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstage) fetch(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();     // stage s is in; every thread is done with stage s - 1
    if (s + kStages - 1 < nstage) fetch(s + kStages - 1);
    cp_async_commit();
    const float* dys = smem + (s % kStages) * sf;
    const float* xs = dys + S * dy_frame;
    const long long f0 = f_begin + static_cast<long long>(s) * S;
    const int nf = static_cast<int>(min(static_cast<long long>(S), f_end - f0));
    for (int j = 0; j < per_slot; ++j) {
      const int fl = slot + j * slots;
      if (fl >= nf) continue;
      const float* dyp = dys + (fl * h + y) * w * COUT + g * CO_T;
      const float* xp = xs + (fl * (h + 2) + y) * (w + 2) * CIN + cg * CI_T;
      // the encoder's widths (11, then 5 after the pool) unrolled
      if (w == 11)
        accumulate_row<CIN, COUT, CO_T, CI_T, 11>(acc, bacc, dyp, xp, w, cg % CO_T);
      else if (w == 5)
        accumulate_row<CIN, COUT, CO_T, CI_T, 5>(acc, bacc, dyp, xp, w, cg % CO_T);
      else
        accumulate_row<CIN, COUT, CO_T, CI_T, 0>(acc, bacc, dyp, xp, w, cg % CO_T);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's sum over its rows, in row order
  float* red = smem;
#pragma unroll
  for (int j = 0; j < T::kAcc; ++j) red[tid * T::kSlots + j] = acc[j];
#pragma unroll
  for (int j = 0; j < T::kBias; ++j) red[tid * T::kSlots + T::kAcc + j] = bacc[j];
  __syncthreads();
  const int rows = nthreads / T::kRoles;
  constexpr int kW = COUT * CIN * 9;
  for (int e = tid; e < T::kEntries; e += nthreads) {
    int role, j;
    if (e < kW) {
      const int co = e / (CIN * 9), rem = e - co * (CIN * 9);
      const int ci = rem / 9, tap = rem - ci * 9;
      role = (co / CO_T) * T::kCiGroups + ci / CI_T;
      j = ((co % CO_T) * CI_T + ci % CI_T) * 9 + tap;
    } else {
      const int co = e - kW;
      role = T::kSplitBias ? (co / CO_T) * T::kCiGroups + co % CO_T : co / CO_T;
      j = T::kAcc + (T::kSplitBias ? 0 : co % CO_T);
    }
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += red[(k * T::kRoles + role) * T::kSlots + j];
    partial[static_cast<long long>(blockIdx.x) * T::kEntries + e] = sum;
  }
}

// dw (kW floats) and db (the rest) from the blocks' partial rows: entry e
// of 32 a block, 8 strands of the rows each, added in a fixed order
__global__ void sum_partials(const float* __restrict__ partial, int blocks, int entries, int kW,
                             float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, strand = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (e < entries)
    for (int b = strand; b < blocks; b += 8)
      sum += partial[static_cast<long long>(b) * entries + e];
  part[strand][lane] = sum;
  __syncthreads();
  if (strand == 0 && e < entries) {
    float t = part[0][lane];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += part[k][lane];
    if (e < kW) dw[e] = t;
    else db[e - kW] = t;
  }
}

// A launch: a block holds `slots` frames' rows at once and a stage
// `slots * per_slot` frames; `blocks` blocks, all resident at once
struct Plan {
  int slots, per_slot, blocks;
};

// the ring's target size
constexpr int kRingBytes = 192 * 1024;

// One tile's launches: at most MAXT threads a block (its
// __launch_bounds__), aiming for BLOCK
template <int CIN, int COUT, int CO_T, int CI_T, int MAXT, int BLOCK>
struct Conv {
  using T = Tile<CIN, COUT, CO_T, CI_T>;

  static int threads(int h, int slots) { return T::kRoles * h * slots; }

  static int smem_bytes(int h, int w, int slots, int per_slot) {
    const int ring = kStages * stage_floats(slots * per_slot, h, w, CIN, COUT);
    const int red = threads(h, slots) * T::kSlots;
    return 4 * (ring > red ? ring : red);
  }

  // The launch for an h x w map of `frames` frames on `device`: as many
  // frames' rows a block as BLOCK threads hold, and frames a stage so that
  // the ring comes near kRingBytes, fewer where the block's shared memory
  // is short; -1 where a map's rows pass MAXT threads or one frame a stage
  // passes the shared memory, else a CUDA error code (0 on success).
  static int plan(int h, int w, int frames, int device, Plan* p) {
    const int per_frame = T::kRoles * h;
    if (per_frame > MAXT) return -1;
    int smem_max = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&smem_max,
                                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int frame = 4 * (h * w * COUT + (h + 2) * (w + 2) * CIN);
    int slots = BLOCK / per_frame > 1 ? BLOCK / per_frame : 1;
    int per_slot = kRingBytes / (kStages * slots * frame);
    if (per_slot < 1) per_slot = 1;
    while (smem_bytes(h, w, slots, per_slot) > smem_max && slots * per_slot > 1) {
      if (per_slot > 1) --per_slot;
      else --slots;
    }
    const int smem = smem_bytes(h, w, slots, per_slot);
    if (smem > smem_max) return -1;
    // the launch that follows a plan relies on this opt-in too
    err = cudaFuncSetAttribute(wgrad_kernel<CIN, COUT, CO_T, CI_T, MAXT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wgrad_kernel<CIN, COUT, CO_T, CI_T, MAXT>, threads(h, slots), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return -1;
    *p = {slots, per_slot, per_sm * sms < frames ? per_sm * sms : frames};
    return 0;
  }

  static cudaError_t launch(const float* x, long long x_stride, const float* dy, float* partial,
                            float* dw, float* db, int frames, int h, int w, const Plan& p,
                            cudaStream_t stream) {
    wgrad_kernel<CIN, COUT, CO_T, CI_T, MAXT>
        <<<p.blocks, threads(h, p.slots), smem_bytes(h, w, p.slots, p.per_slot), stream>>>(
            x, x_stride, dy, partial, frames, h, w, p.slots, p.per_slot);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_partials<<<(T::kEntries + 31) / 32, 256, 0, stream>>>(partial, p.blocks, T::kEntries,
                                                               COUT * CIN * 9, dw, db);
    return cudaGetLastError();
  }
};

// the height encoder's Conv_0, 2 -> 16, and Conv_1, 16 -> 32.  An H100 ran
// Conv_0 fastest at 6 frames' rows a block (240 threads; of 1 to 12) and
// Conv_1 at 2 (640); Conv_1's bound of 640 threads holds its registers to
// 96 a thread, so that its 5 rows of 64 threads run two frames at once
using Conv0 = Conv<2, 16, 4, 2, 512, 256>;
using Conv1 = Conv<16, 32, 8, 1, 640, 640>;

// plan() of the tile for cin -> cout on `device`, made current
int plan(int cin, int cout, int h, int w, int frames, int device, Plan* p) {
  if (h < 1 || w < 1 || h > 4096 || w > 4096 || frames < 1) return -1;
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  int rc = -1;
  if (cin == 2 && cout == 16) rc = Conv0::plan(h, w, frames, device, p);
  else if (cin == 16 && cout == 32) rc = Conv1::plan(h, w, frames, device, p);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

// W1's launch for `frames` maps of h x w, cin -> cout, on `device`:
// plan[0..2] = frames' rows a block, frames a stage per slot, blocks.
// Returns 0; -1 where W1 has no launch for these arguments (a channel
// pair without a tile, a map too large for a block); else a CUDA error.
extern "C" int conv3x3_wgrad_plan(int cin, int cout, int h, int w, int frames, int device,
                                  int* out) {
  Plan p{};
  const int rc = plan(cin, cout, h, w, frames, device, &p);
  if (rc == 0) {
    out[0] = p.slots;
    out[1] = p.per_slot;
    out[2] = p.blocks;
  }
  return rc;
}

// Kernel W1 and its reduction on `stream`, at conv3x3_wgrad_plan's launch:
// dw (cout, cin, 3, 3) and db (cout) from x (frames, h, w, cin) at frame
// stride x_stride floats and dy (frames, h, w, cout) contiguous, through
// `partial` of partial_rows x (cout * cin * 9 + cout) floats of scratch, at
// least the plan's blocks.  Returns conv3x3_wgrad_plan's codes.
extern "C" int conv3x3_wgrad(const void* x, long long x_stride, const void* dy, void* partial,
                             int partial_rows, void* dw, void* db, int frames, int cin, int cout,
                             int h, int w, int device, void* stream) {
  Plan p{};
  int rc = plan(cin, cout, h, w, frames, device, &p);
  if (rc != 0) return rc;
  if (p.blocks > partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* dyf = static_cast<const float*>(dy);
  auto* pf = static_cast<float*>(partial);
  auto* dwf = static_cast<float*>(dw);
  auto* dbf = static_cast<float*>(db);
  const cudaError_t err =
      cin == 2 ? Conv0::launch(xf, x_stride, dyf, pf, dwf, dbf, frames, h, w, p, s)
               : Conv1::launch(xf, x_stride, dyf, pf, dwf, dbf, frames, h, w, p, s);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
