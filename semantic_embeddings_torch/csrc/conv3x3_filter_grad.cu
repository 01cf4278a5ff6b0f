// Filter gradient of a 3x3 SAME stride-1 convolution, for Hopper.
//
// Replaces the Pallas kernel `conv3x3_filter_grad` of
// tools/conv_filter_grad_prototype.py (`_kernel` at :50):
//
//   dw[f, c, kh, kw] = sum_{n, h, w} x[n, c, h + kh - 1, w + kw - 1] * dy[n, f, h, w]
//                      (x is zero outside the image)
//
// x and dy share a dtype (f32, or bf16 under autocast, where dy is the
// cotangent already rounded to x's dtype, as the prototype's reference
// takes it: conv_filter_grad_prototype.py:36-37); every sum is f32 and dw
// comes out f32.  Layout: NCHW x and dy, dw (F, C, 3, 3) as the port's
// weights.  The dtype selects one of two instances, both on the tensor
// cores; neither stands in for the other.
//
// What bounds it: 2 * N*H*W * 9*C * F operations on N*H*W * (C + F) input
// elements and 9*C*F outputs.  At the ResNet-50 stage shapes (batch 128,
// 56x56x64 ... 7x7x512) that is 29.6 GFLOP each.  bf16 (102.8 / 51.4 / 25.7
// / 12.8 MB of inputs): on an H100 (989 TFLOP/s bf16 tensor cores, 3.35
// TB/s) about 0.030 ms either way.  f32: the tensor cores take f32 only as
// TF32 (10-bit mantissas), so an f32-exact product costs three TF32
// products (below): 3 x 29.6 GFLOP at 495 TFLOP/s is 0.179 ms, above the
// bytes (0.061 ms at stage 1) and below the 0.442 ms of the f32 FMA units.
// The shape is awkward for a GEMM: the contraction runs over N*H*W (up to
// 401,408 pixels) into only 9*C*F outputs (36,864 at the 64-channel stage),
// too few output tiles to fill 132 SMs, so both instances split the pixels
// across blocks (split-K) into f32 partials part[split, F, 9C], which a
// second kernel adds in the order of the splits.  No atomics: dw is bitwise
// the same on every run.  Any N, C, H, W, F >= 1 work: pixels, channels and
// taps past their ends are masked, nothing assumes divisibility.
//
// Both instances: a warp-level tensor-core GEMM (mma.sync, f32 accumulate)
// fed by a 3-stage cp.async ring.
//   - Both operands are K-major in NCHW: for a fixed f, dy's pixels are
//     contiguous (the A operand, row-major, read with ldmatrix); for a fixed
//     (c, kh, kw), x's pixels are contiguous, shifted by (kh-1)*W + (kw-1)
//     (the B operand, column-major).  No transpose.
//   - A block owns 64 output channels f and 16 input channels c with all 9
//     taps of each c: 64 x 144 f32 accumulators over 4 warps (2 x 32 f, 2 x
//     8 c; 72 registers a thread).  An n8 tile of the mma is 8 channels of
//     one tap, so each x value staged in shared memory serves all 9 taps.
//   - One pipeline step is 64 pixels of one image (a step never straddles
//     two images; the plane's tail is zero-filled and its empty slices are
//     skipped).  A step stages dy (64 f x 64 pixels) and, for each c and
//     kh, the x window of conv3x3_common.cuh: the rows above and below come
//     from the plane itself, so shared memory does not grow with W.
//   - Tap fragments: output pixel p and tap (kh, kw) read window element
//     p + kw.  The shift by kw breaks the alignment ldmatrix needs, so x's
//     fragments come from plain shared loads, and each load serves the
//     three kw, masking kw = 0 at the image's left column and kw = 2 at its
//     right one (a per-pixel table staged with the step).
//   - The split count comes from the device's resident blocks (below).
//
// bf16 instance: mma.sync m16n8k16 (bf16 products are exact in f32).  Each
// thread reads its 4 window elements p .. p+3 with 16-bit ld.shared and
// forms the pairs of all three kw from them (4 loads for 3 taps).  Rows are
// 176 bytes apart, so the 8 channels of a warp's loads fall on distinct
// banks.  Copies: a window starts at an arbitrary pixel, so it is rounded
// down to the copy width and the fragment reads carry the remainder.  The
// width is chosen per launch: 16-byte cp.async where H*W % 8 == 0 (stages
// 1, 2), 8 bytes where % 4 == 0 (stage 3), each also limited by the
// alignment of the x and dy pointers.  A chunk of the width lies wholly
// inside or wholly outside a plane, so out-of-plane chunks are zero-filled
// whole (cp.async's src-size 0).  Where neither fits (H*W % 4 != 0, as at
// stage 4's 7x7 = 49, or a pointer less than 8-byte aligned), a first
// kernel copies x and dy into planes padded to a multiple of 8 elements
// (two launches, 27.5 MB of traffic at stage 4) and the GEMM runs on those
// with 16-byte copies: cp.async has no 2-byte form, and 2-byte loads
// through registers left every step waiting on some 57 round trips to
// memory (1.15 ms at stage 4).
//
// f32 instance: 3xTF32 on mma.sync m16n8k8 (the split and the mma in
// conv3x3_common.cuh, shared with the conv + statistics kernel).  Each f32
// operand a is split in registers, as it is loaded, into a_big = tf32(a),
// rounded to nearest with ties away (as cvt.rna.tf32.f32 rounds, but by an
// integer add and mask), and a_small = a - a_big (exact in f32) truncated
// to tf32 by a mask, so a_big + a_small is a to 2^-21; the product is
// a_small*b_big + a_big*b_small + a_big*b_big (a_small*b_small, 2^-22 of
// it, is dropped), f32-exact to about 2^-20 relative at worst.  This is
// not "TF32 on": one
// TF32 product is 2^-11 off.  Integer operations, because conversions run
// at a fraction of the rate: with cvt.rna for both parts every call took
// 9% longer, and rounding a_small too 7% (each pair timed in turns on an
// H100).
// The tensor cores' own accumulation rounds toward zero, and summing a
// whole split in it put dw 3.9e-5 of max |dw| from f64 at the 56x56x64
// stage, past the 1e-5 bound; so the products of two k8 slices (6 mma a
// tile) sum in the tensor cores from zero, and the running sums take them
// with one rounded f32 add: 0.3-1.0e-6 of max |dw| at the stage shapes.
// dy's A fragments come from ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 tf32
// one), 272-byte rows; x's B fragments are 32-bit ld.shared of window
// elements p, p+1, p+2 and p+4, p+5, p+6 (the k and k+4 of m16n8k8's B), 6
// loads for 3 taps, and x rows are 76 floats apart, so 3 rows (the channel
// stride) are 4 banks apart and the 32 lanes read 32 banks.  Copies:
// 16-byte cp.async where H*W % 4 == 0 and both pointers allow it; else
// (stage 4's 49 pixels, odd ragged planes) x and dy are repacked into
// planes padded to 8 floats, as bf16's are: 4-byte cp.async, which fits
// every plane, took 1.097 ms at stage 4 against 0.838 ms for the repack
// and 16-byte copies (4 times the copy instructions).  A stage holds 32,064
// bytes, so 3 stages take 96,192 bytes and 2 blocks fit an SM.
//
// ptxas (sm_90a, CUDA 12.9): no spills anywhere; the bf16 kernel 142
// registers (16-byte copies) and 148 (8-byte), 53,184 bytes of dynamic
// shared memory (3 stages of 17,728), 3 blocks an SM; the f32 kernel 225
// registers and 96,192 bytes, 2 blocks an SM; the repack and the ordered
// reduction 16 and 32 registers.
//
// Halo rows (spatial partitioning): x's rows -1 and H may be given as
// (N, C, 1, W) tensors in place of the zero padding; dy covers x's own
// rows.  The x windows read them as the conv + statistics kernel does
// (stage_x_chunk in conv3x3_common.cuh); a null pointer changes nothing.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;

constexpr int kReduceThreads = 256;

// dw[i] = sum over splits of part[split, i], in order of split.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ dw,
                         int splits, int outputs) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= outputs) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += part[static_cast<size_t>(s) * outputs + i];
  dw[i] = total;
}

int reduce_splits(void* part, void* dw, int splits, int outputs, cudaStream_t stream) {
  reduce_splits_kernel<<<(outputs + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, outputs);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTcF = 64;          // output channels per block
constexpr int kTcC = 16;          // input channels per block (x 9 taps = 144 columns)
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kTcThreads = 128;   // 4 warps: 2 (32 f each) x 2 (8 c each)

// ---------------------------------------------------------------------------
// bf16 instance
// ---------------------------------------------------------------------------

constexpr int kDyPitch = kStep + 8;  // 144-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kXPitch = 88;          // 176-byte rows: 44 words = 12 mod 32 banks
constexpr int kDyElems = kTcF * kDyPitch;
constexpr int kXElems = kTcC * 3 * kXPitch;
constexpr int kStageBytes = (kDyElems + kXElems) * 2 + kStep;  // + the edge table
constexpr int kTcSmem = kStages * kStageBytes;
static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
static_assert(window_len<8>() <= kXPitch, "x window exceeds its row");

// Block (cx, fy, split) owns channels f0 .. f0+63, c0 .. c0+15 (all 9 taps)
// and the pipeline steps [split * chunk, (split + 1) * chunk) of the
// N * ceil(H*W / 64) steps, image by image.  Planes of H*W pixels lie
// `pitch` elements apart (H*W, or more in a repacked copy).
template <int VEC>
__global__ void __launch_bounds__(kTcThreads, 3)
    filter_grad_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ top,
                            const uint16_t* __restrict__ bottom, const uint16_t* __restrict__ dy,
                            float* __restrict__ part, int N, int C, int H, int W,
                            int F, int chunk, int pitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // mma group: row of A / C, column of B
  const int tig = lane & 3;   // thread in group
  const int wf = warp & 1;    // this warp's 32 f: wf * 32 ..
  const int wc = warp >> 1;   // this warp's 8 c: wc * 8 ..
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int total = N * per_image;
  const int c0 = blockIdx.x * kTcC;
  const int f0 = blockIdx.y * kTcF;
  const int t_begin = blockIdx.z * chunk;
  const int t_end = t_begin + chunk < total ? t_begin + chunk : total;
  const int steps = t_end - t_begin;

  auto stage_dy = [&](int slot) {
    return reinterpret_cast<uint16_t*>(smem + slot * kStageBytes);
  };

  // Stages step t (image n, pixels p0 .. p0+63) into ring slot `slot`.
  auto load_step = [&](int t, int slot) {
    uint16_t* dys = stage_dy(slot);
    uint16_t* xs = dys + kDyElems;
    uint8_t* edge = reinterpret_cast<uint8_t*>(xs + kXElems);
    const int n = t / per_image;
    const int p0 = (t - n * per_image) * kStep;
    constexpr int dy_row_chunks = kStep / VEC;
    for (int i = tid; i < kTcF * dy_row_chunks; i += kTcThreads) {
      const int r = i / dy_row_chunks;
      const int q = (i - r * dy_row_chunks) * VEC;
      const int f = f0 + r;
      const bool ok = f < F && p0 + q < HW;
      const uint16_t* src = ok ? dy + (static_cast<size_t>(n) * F + f) * pitch + p0 + q : dy;
      copy_chunk<VEC * 2>(dys + r * kDyPitch + q, src, ok);
    }
    constexpr int x_row_chunks = window_len<VEC>() / VEC;
    for (int i = tid; i < kTcC * 3 * x_row_chunks; i += kTcThreads) {
      const int row = i / x_row_chunks;  // c * 3 + kh
      const int q = (i - row * x_row_chunks) * VEC;
      const int cl = row / 3;
      const int kh = row - cl * 3;
      const int c = c0 + cl;
      const int pix = ((p0 + (kh - 1) * W - 1) & ~(VEC - 1)) + q;
      const bool ok = c < C;
      const size_t plane = static_cast<size_t>(n) * C + c;
      stage_x_chunk<VEC>(xs + row * kXPitch + q, ok ? x + plane * pitch : x,
                         top ? top + plane * W : nullptr, bottom ? bottom + plane * W : nullptr,
                         pix, HW, W, ok);
    }
    if (tid < kStep) {  // bit 0: the pixel has a left neighbour, bit 1: a right one
      const int w = (p0 + tid) % W;
      edge[tid] = static_cast<uint8_t>((w >= 1 ? 1 : 0) | (w <= W - 2 ? 2 : 0));
    }
  };

  float acc[2][9][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(t_begin + s, s);
    cp_async_commit();
  }

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step i has landed; slot (i - 1) % kStages is free
    {
      const int next = i + kStages - 1;
      if (next < steps) load_step(t_begin + next, next % kStages);
      cp_async_commit();
    }

    const int slot = i % kStages;
    const uint16_t* dys = stage_dy(slot);
    const uint16_t* xs = dys + kDyElems;
    const uint8_t* edge = reinterpret_cast<const uint8_t*>(xs + kXElems);
    const int t = t_begin + i;
    const int n = t / per_image;
    const int p0 = (t - n * per_image) * kStep;
    const int slices = (min(kStep, HW - p0) + 15) / 16;
    // each kh window's start remainder below the copy width
    int shift[3];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) shift[kh] = (p0 + (kh - 1) * W - 1) & (VEC - 1);

#pragma unroll
    for (int ks = 0; ks < kStep / 16; ++ks) {
      if (ks >= slices) break;
      const int k0 = ks * 16;
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], dys + (wf * 32 + mt * 16 + (lane & 15)) * kDyPitch + k0 +
                               (lane >> 4) * 8);
      // masks of kw = 0 (left) and kw = 2 (right) for pixels p, p + 1 of each half
      unsigned left[2], right[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = k0 + h * 8 + tig * 2;
        const unsigned e0 = edge[p], e1 = edge[p + 1];
        left[h] = ((e0 & 1) ? 0x0000ffffu : 0u) | ((e1 & 1) ? 0xffff0000u : 0u);
        right[h] = ((e0 & 2) ? 0x0000ffffu : 0u) | ((e1 & 2) ? 0xffff0000u : 0u);
      }
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const uint16_t* row = xs + ((wc * 8 + g) * 3 + kh) * kXPitch + shift[kh];
        unsigned b[3][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = k0 + h * 8 + tig * 2;
          const unsigned v0 = row[p], v1 = row[p + 1], v2 = row[p + 2], v3 = row[p + 3];
          b[0][h] = (v0 | (v1 << 16)) & left[h];
          b[1][h] = v1 | (v2 << 16);
          b[2][h] = (v2 | (v3 << 16)) & right[h];
        }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][kh * 3 + kw], a[mt], b[kw][0], b[kw][1]);
      }
    }
  }
  cp_async_wait<0>();

  const int K = C * 9;
  float* out = part + static_cast<size_t>(blockIdx.z) * F * K;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = f0 + wf * 32 + mt * 16 + g + r * 8;
      if (f >= F) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + wc * 8 + tig * 2 + e;
        if (c >= C) continue;
#pragma unroll
        for (int j = 0; j < 9; ++j)
          out[static_cast<size_t>(f) * K + c * 9 + j] = acc[mt][j][r * 2 + e];
      }
    }
}

template <int VEC>
int launch_bf16(const void* x, const void* top, const void* bottom, const void* dy, void* part,
                int N, int C, int H, int W, int F, int splits, int chunk, int pitch,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(filter_grad_bf16_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kTcC - 1) / kTcC, (F + kTcF - 1) / kTcF, splits);
  filter_grad_bf16_kernel<VEC><<<grid, kTcThreads, kTcSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(top),
      static_cast<const uint16_t*>(bottom), static_cast<const uint16_t*>(dy),
      static_cast<float*>(part), N, C, H, W, F, chunk, pitch);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32 instance (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kF32DyPitch = kStep + 4;  // 272-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kF32XPitch = 76;          // 3 rows (one channel) = 228 words = 4 mod 32 banks
constexpr int kF32DyElems = kTcF * kF32DyPitch;
constexpr int kF32XElems = kTcC * 3 * kF32XPitch;
constexpr int kF32StageBytes = (kF32DyElems + kF32XElems) * 4 + kStep;  // + the edge table
constexpr int kF32Smem = kStages * kF32StageBytes;
static_assert(kF32StageBytes % 16 == 0, "stages must stay 16-byte aligned");
constexpr int kF32Vec = 4;             // floats a 16-byte cp.async copies
static_assert(window_len<kF32Vec>() <= kF32XPitch, "x window exceeds its row");

// As filter_grad_bf16_kernel, on f32 operands with 16-byte copies and planes
// `pitch` floats apart (H*W, or more in a repacked copy).
__global__ void __launch_bounds__(kTcThreads, 2)
    filter_grad_f32_kernel(const float* __restrict__ x, const float* __restrict__ top,
                           const float* __restrict__ bottom, const float* __restrict__ dy,
                           float* __restrict__ part, int N, int C, int H, int W, int F,
                           int chunk, int pitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wf = warp & 1;
  const int wc = warp >> 1;
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int total = N * per_image;
  const int c0 = blockIdx.x * kTcC;
  const int f0 = blockIdx.y * kTcF;
  const int t_begin = blockIdx.z * chunk;
  const int t_end = t_begin + chunk < total ? t_begin + chunk : total;
  const int steps = t_end - t_begin;

  auto stage_dy = [&](int slot) { return reinterpret_cast<float*>(smem + slot * kF32StageBytes); };

  auto load_step = [&](int t, int slot) {
    float* dys = stage_dy(slot);
    float* xs = dys + kF32DyElems;
    uint8_t* edge = reinterpret_cast<uint8_t*>(xs + kF32XElems);
    const int n = t / per_image;
    const int p0 = (t - n * per_image) * kStep;
    constexpr int dy_row_chunks = kStep / kF32Vec;
    for (int i = tid; i < kTcF * dy_row_chunks; i += kTcThreads) {
      const int r = i / dy_row_chunks;
      const int q = (i - r * dy_row_chunks) * kF32Vec;
      const int f = f0 + r;
      const bool ok = f < F && p0 + q < HW;
      const float* src = ok ? dy + (static_cast<size_t>(n) * F + f) * pitch + p0 + q : dy;
      copy_chunk<kF32Vec * 4>(dys + r * kF32DyPitch + q, src, ok);
    }
    constexpr int x_row_chunks = window_len<kF32Vec>() / kF32Vec;
    for (int i = tid; i < kTcC * 3 * x_row_chunks; i += kTcThreads) {
      const int row = i / x_row_chunks;  // c * 3 + kh
      const int q = (i - row * x_row_chunks) * kF32Vec;
      const int cl = row / 3;
      const int kh = row - cl * 3;
      const int c = c0 + cl;
      const int pix = ((p0 + (kh - 1) * W - 1) & ~(kF32Vec - 1)) + q;
      const bool ok = c < C;
      const size_t plane = static_cast<size_t>(n) * C + c;
      stage_x_chunk<kF32Vec>(xs + row * kF32XPitch + q, ok ? x + plane * pitch : x,
                             top ? top + plane * W : nullptr,
                             bottom ? bottom + plane * W : nullptr, pix, HW, W, ok);
    }
    if (tid < kStep) {
      const int w = (p0 + tid) % W;
      edge[tid] = static_cast<uint8_t>((w >= 1 ? 1 : 0) | (w <= W - 2 ? 2 : 0));
    }
  };

  float acc[2][9][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(t_begin + s, s);
    cp_async_commit();
  }

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int next = i + kStages - 1;
      if (next < steps) load_step(t_begin + next, next % kStages);
      cp_async_commit();
    }

    const int slot = i % kStages;
    const float* dys = stage_dy(slot);
    const float* xs = dys + kF32DyElems;
    const uint8_t* edge = reinterpret_cast<const uint8_t*>(xs + kF32XElems);
    const int t = t_begin + i;
    const int n = t / per_image;
    const int p0 = (t - n * per_image) * kStep;
    int shift[3];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) shift[kh] = (p0 + (kh - 1) * W - 1) & (kF32Vec - 1);

    // Slices of 8 pixels (the k of m16n8k8), KCH = 2 a round (1 for an odd
    // last one): the round's 3 x KCH products of each tile sum in the
    // tensor cores from zero, in rounds of 6 independent mma, and the
    // running sums take them with one rounded f32 add.
    const int slices = (min(kStep, HW - p0) + 7) / 8;
    auto slice_round = [&](const int ks, auto kch) {
      constexpr int KCH = decltype(kch)::value;
      unsigned a_big[KCH][2][4], a_small[KCH][2][4], edge_bits[KCH][2];
#pragma unroll
      for (int u = 0; u < KCH; ++u) {
        const int k0 = (ks + u) * 8;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned raw[4];
          ldmatrix_x4(raw, dys + (wf * 32 + mt * 16 + (lane & 15)) * kF32DyPitch + k0 +
                               (lane >> 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(raw[e]), a_big[u][mt][e], a_small[u][mt][e]);
        }
        edge_bits[u][0] = edge[k0 + tig];
        edge_bits[u][1] = edge[k0 + tig + 4];
      }
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const float* row = xs + ((wc * 8 + g) * 3 + kh) * kF32XPitch + shift[kh] + ks * 8 + tig;
        unsigned b_big[KCH][3][2], b_small[KCH][3][2];
#pragma unroll
        for (int u = 0; u < KCH; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              const unsigned e = edge_bits[u][h];
              const bool ok = kw == 1 || (kw == 0 ? (e & 1) : (e & 2));
              split_tf32(ok ? row[u * 8 + h * 4 + kw] : 0.f, b_big[u][kw][h],
                                    b_small[u][kw][h]);
            }
        float t[3][2][4];
        constexpr float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < KCH; ++u) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              if (u == 0)
                mma_tf32(t[kw][mt], a_small[u][mt], b_big[u][kw][0], b_big[u][kw][1], zero);
              else
                mma_tf32(t[kw][mt], a_small[u][mt], b_big[u][kw][0], b_big[u][kw][1], t[kw][mt]);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_tf32(t[kw][mt], a_big[u][mt], b_small[u][kw][0], b_small[u][kw][1], t[kw][mt]);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_tf32(t[kw][mt], a_big[u][mt], b_big[u][kw][0], b_big[u][kw][1], t[kw][mt]);
        }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][kh * 3 + kw][e] += t[kw][mt][e];
      }
    };
    int ks = 0;
    for (; ks + 1 < slices; ks += 2) slice_round(ks, std::integral_constant<int, 2>{});
    if (ks < slices) slice_round(ks, std::integral_constant<int, 1>{});
  }
  cp_async_wait<0>();

  const int K = C * 9;
  float* out = part + static_cast<size_t>(blockIdx.z) * F * K;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = f0 + wf * 32 + mt * 16 + g + r * 8;
      if (f >= F) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + wc * 8 + tig * 2 + e;
        if (c >= C) continue;
#pragma unroll
        for (int j = 0; j < 9; ++j)
          out[static_cast<size_t>(f) * K + c * 9 + j] = acc[mt][j][r * 2 + e];
      }
    }
}

int launch_f32(const void* x, const void* top, const void* bottom, const void* dy, void* part,
               int N, int C, int H, int W, int F, int splits, int chunk, int pitch,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(filter_grad_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kTcC - 1) / kTcC, (F + kTcF - 1) / kTcF, splits);
  filter_grad_f32_kernel<<<grid, kTcThreads, kF32Smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(top),
      static_cast<const float*>(bottom), static_cast<const float*>(dy), static_cast<float*>(part),
      N, C, H, W, F, chunk, pitch);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Choosing the instance's path and its splits
// ---------------------------------------------------------------------------

// The copy width, in elements, the instance takes: bf16 8 or 4, f32 4; 1
// where none fits and the operands are repacked into padded planes.
int copy_width_of(const void* x, const void* dy, int HW, bool bf16) {
  if (!bf16) return copy_width<4>(HW, x, dy) >= 4 ? 4 : 1;
  return copy_width<2>(HW, x, dy);
}

long long resident_bf16[64] = {};
long long resident_f32[64] = {};

// Blocks of the instance resident at once on the current device (0 if the
// device cannot be queried); the 16-byte variant stands for both widths.
long long resident_blocks_of(bool bf16) {
  if (bf16) return resident_blocks(filter_grad_bf16_kernel<8>, kTcThreads, kTcSmem, resident_bf16);
  return resident_blocks(filter_grad_f32_kernel, kTcThreads, kF32Smem, resident_f32);
}

}  // namespace

extern "C" {


// How conv3x3_filter_grad splits its contraction: returns the number of
// splits and writes to *chunk the pipeline steps (64 pixels of one image)
// of each; the last split may be shorter.
//
// The split count s minimizes an estimate of the time in units of one
// block's pipeline step: the waves of blocks (as many resident at once as
// the current device's SMs times the blocks an SM holds of the instance: 3
// x 132 bf16 and 2 x 132 f32 on an H100 SXM) times the steps of a split,
// plus writing and re-reading the s partial tiles.  The one constant fitted
// to the card, per instance, is what a step costs in partial floats (8
// bytes each moved at 3.35 TB/s): a bf16 step takes about 3.4 us at 3
// blocks an SM (0.215 ms for 64 steps a block at the 56x56x64 stage,
// chip_smoke.py phase 4), the time of 1.4 M partial floats; an f32 step
// about 6.5 us at 2 blocks an SM (0.618 ms for 95 steps), 2.7 M.  This keeps the grid from spilling
// a few blocks into a second wave.  Returns -1 if the device cannot be
// queried.
int conv3x3_filter_grad_splits(int N, int C, int H, int W, int F, int is_bf16, int* chunk) {
  const long long slots = resident_blocks_of(is_bf16 != 0);
  if (slots <= 0) return -1;
  const double steps_per_partial = is_bf16 ? 1.0 / 1.4e6 : 1.0 / 2.7e6;
  const long long work =
      static_cast<long long>(N) * ((static_cast<long long>(H) * W + kStep - 1) / kStep);
  const long long tiles = static_cast<long long>((C + kTcC - 1) / kTcC) * ((F + kTcF - 1) / kTcF);
  const double partial = static_cast<double>(F) * 9 * C * steps_per_partial;
  const long long most = 8 * ((slots + tiles - 1) / tiles);
  long long splits = 1;
  double best = -1.0;
  for (long long s = 1; s <= most && s <= work; ++s) {
    const long long waves = (tiles * s + slots - 1) / slots;
    const double cost = static_cast<double>(waves * ((work + s - 1) / s)) + s * partial;
    if (best < 0 || cost < best) {
      best = cost;
      splits = s;
    }
  }
  const long long each = (work + splits - 1) / splits;
  *chunk = static_cast<int>(each);
  return static_cast<int>((work + each - 1) / each);
}

// Bytes of scratch that conv3x3_filter_grad needs for these operands:
// N * (C + F) padded planes where no copy width fits, else 0.
long long conv3x3_filter_grad_scratch(const void* x, const void* dy, int N, int C, int H,
                                      int W, int F, int is_bf16) {
  if (copy_width_of(x, dy, H * W, is_bf16 != 0) > 1) return 0;
  return static_cast<long long>(N) * (C + F) * padded_pitch(H * W) * (is_bf16 ? 2 : 4);
}

// dw[F, C, 3, 3] (f32) from x[N, C, H, W] and dy[N, F, H, W], both bf16
// when is_bf16, else f32.  top and bottom are x's rows -1 and H, (N, C, 1,
// W) in x's dtype, or null for zeros (the image's own edge); dy covers x's
// H rows.  The work is split as conv3x3_filter_grad_splits
// gives it for the same dtype; part is f32 scratch of splits x F x 9C;
// scratch holds the bytes that conv3x3_filter_grad_scratch asks for (or is
// null when it asks for none).
int conv3x3_filter_grad(const void* x, const void* dy, const void* top, const void* bottom,
                        void* part, void* dw,
                        int N, int C, int H, int W, int F, int splits,
                        int chunk, int is_bf16, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  int err;
  if (is_bf16) {
    switch (copy_width_of(x, dy, HW, true)) {
      case 8: err = launch_bf16<8>(x, top, bottom, dy, part, N, C, H, W, F, splits, chunk, HW, st); break;
      case 4: err = launch_bf16<4>(x, top, bottom, dy, part, N, C, H, W, F, splits, chunk, HW, st); break;
      default: {
        if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const int pitch = padded_pitch(HW);
        uint16_t* xp = static_cast<uint16_t*>(scratch);
        uint16_t* dyp = xp + static_cast<size_t>(N) * C * pitch;
        err = pad_planes<uint16_t>(x, xp, static_cast<long long>(N) * C, HW, pitch, st);
        if (err == 0)
          err = pad_planes<uint16_t>(dy, dyp, static_cast<long long>(N) * F, HW, pitch, st);
        if (err == 0)
          err = launch_bf16<8>(xp, top, bottom, dyp, part, N, C, H, W, F, splits, chunk, pitch, st);
      }
    }
  } else if (copy_width_of(x, dy, HW, false) == 4) {
    err = launch_f32(x, top, bottom, dy, part, N, C, H, W, F, splits, chunk, HW, st);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int pitch = padded_pitch(HW);
    float* xp = static_cast<float*>(scratch);
    float* dyp = xp + static_cast<size_t>(N) * C * pitch;
    err = pad_planes<float>(x, xp, static_cast<long long>(N) * C, HW, pitch, st);
    if (err == 0) err = pad_planes<float>(dy, dyp, static_cast<long long>(N) * F, HW, pitch, st);
    if (err == 0) err = launch_f32(xp, top, bottom, dyp, part, N, C, H, W, F, splits, chunk, pitch, st);
  }
  if (err != 0) return err;
  return reduce_splits(part, dw, splits, F * C * 9, st);
}

// The copy width, in elements, that the instance of this dtype takes for
// these operands, so that a caller can see which path ran: bf16 8 or 4
// (16- or 8-byte cp.async), f32 4 (16-byte cp.async), or 1 (the repack
// into padded planes).
int conv3x3_filter_grad_copy_width(const void* x, const void* dy, int H, int W, int is_bf16) {
  return copy_width_of(x, dy, H * W, is_bf16 != 0);
}

// Which instance conv3x3_filter_grad runs for a dtype, for a caller to report.
const char* conv3x3_filter_grad_instance(int is_bf16) {
  return is_bf16 ? "tensor cores: mma.sync m16n8k16 bf16" : "tensor cores: mma.sync m16n8k8 3xTF32";
}

}  // extern "C"
