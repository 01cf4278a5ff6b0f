// 3x3 SAME stride-1 convolution that also returns the BatchNorm statistics
// of its output, for Hopper.
//
// Replaces the Pallas kernel `conv3x3_bn_stats` of
// tools/fused_conv_bn_prototype.py (`_kernel` at :32):
//
//   y[b, f, h, w] = sum_{c, kh, kw} x[b, c, h + kh - 1, w + kw - 1] * wt[f, c, kh, kw]
//                   (x is zero outside the image)
//   s[f]  = sum_{b, h, w} y[b, f, h, w]
//   ss[f] = sum_{b, h, w} y[b, f, h, w]^2
//
// y is stored in x's dtype and the sums are taken, in f32, over that rounded
// y: the statistics are those of the tensor BatchNorm reads, as in the
// prototype (:48-54).
//
// Layout: NCHW x and y, (F, C, 3, 3) weights, as the port's layers hold
// them, so the caller transposes nothing.
//
// What bounds it: 2 * B*H*W * 9*C * F operations on (B*H*W) * (C + F)
// elements.  At the ResNet-50 shapes (C = F = 64 .. 512) that is over 100
// operations per byte of f32, so the kernel is bound by arithmetic, and
// without tensor cores (this kernel uses none) by the f32 FMA rate and by
// how many shared-memory reads feed each FMA.
//
// Design: an implicit GEMM with M = B*H*W pixels, N = F channels and
// K = 9*C taps, k = c*9 + kh*3 + kw, the weight's own row-major order, so a
// weight row is one K-vector.  A 256-thread block owns a 64 x 64 tile of
// (pixels x channels).  For each step of 16 taps it stages the im2col tile of
// x (16 x 64, zero where a tap falls outside the image, past M or past K) and
// the weight tile (16 x 64) in shared memory as f32; each thread then
// accumulates a 4 x 4 sub-tile in f32 registers: pixels tx + 16 i and
// channels ty + 16 j, so that 16 neighbouring threads read neighbouring
// shared words and write neighbouring pixels of y.  Each thread's im2col
// pixel is fixed for the whole K loop, so its (b, h, w) is computed once.
//
// Epilogue: round the accumulator to y's dtype, store it, and sum the rounded
// values and their squares per channel over the block's 64 pixels (a shuffle
// tree within each half-warp, whose 16 threads share a channel set) into
// per-block partials of shape (ceil(M / 64), F).  A second kernel adds each
// channel's partials in a fixed order.  No atomics: the result is the same on
// every run.  Pixels past M, channels past F and taps past K are masked, so
// any B, C, H, W, F >= 1 work.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;    // pixels per block
constexpr int kTileN = 64;    // output channels per block
constexpr int kTileK = 16;    // taps per shared-memory step
constexpr int kThreads = 256;
constexpr int kReduceChannels = 32;  // channels per block of the second pass
constexpr int kReduceRows = 32;      // row phases per block of the second pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                         T* __restrict__ y, float* __restrict__ part_s,
                         float* __restrict__ part_ss, int B, int C, int H,
                         int W, int F) {
  __shared__ float a_tile[kTileK][kTileM];       // im2col of x: [tap][pixel]
  __shared__ float b_tile[kTileK][kTileN + 1];   // weights: [tap][channel]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // pixel lane of the 4 x 4 sub-tile
  const int ty = tid / 16;  // channel lane of the 4 x 4 sub-tile
  const int HW = H * W;
  const long long M = static_cast<long long>(B) * HW;
  const int K = C * 9;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;

  // This thread's im2col loads: pixel a_m of the tile, taps a_k0 + 4 r.
  const int a_m = tid % kTileM;
  const int a_k0 = tid / kTileM;
  const long long a_pix = m0 + a_m;
  const bool a_valid = a_pix < M;
  int a_h = 0, a_w = 0;
  const T* x_img = x;
  if (a_valid) {
    const int b = static_cast<int>(a_pix / HW);
    const int r = static_cast<int>(a_pix - static_cast<long long>(b) * HW);
    a_h = r / W;
    a_w = r - a_h * W;
    x_img = x + static_cast<size_t>(b) * C * HW;
  }
  // This thread's weight loads: tap b_k, channels b_n0 + 16 r.
  const int b_k = tid % kTileK;
  const int b_n0 = tid / kTileK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int r = 0; r < kTileK / 4; ++r) {
      const int kk = a_k0 + 4 * r;
      const int k = k0 + kk;
      float v = 0.f;
      if (a_valid && k < K) {
        const int c = k / 9;
        const int tap = k - c * 9;
        const int kh = tap / 3;
        const int hh = a_h + kh - 1;
        const int ww = a_w + (tap - kh * 3) - 1;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = to_f32(x_img[static_cast<size_t>(c) * HW + hh * W + ww]);
      }
      a_tile[kk][a_m] = v;
    }
#pragma unroll
    for (int r = 0; r < kTileN / 16; ++r) {
      const int n = b_n0 + 16 * r;
      const int k = k0 + b_k;
      float v = 0.f;
      if (n0 + n < F && k < K) v = to_f32(wt[static_cast<size_t>(n0 + n) * K + k]);
      b_tile[b_k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_tile[kk][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_tile[kk][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: store the rounded y; per-channel sums of what was stored.
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long pix = m0 + tx + 16 * i;
    if (pix >= M) continue;
    const int b = static_cast<int>(pix / HW);
    const int r = static_cast<int>(pix - static_cast<long long>(b) * HW);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 16 * j;
      if (n >= F) continue;
      const T v = from_f32<T>(acc[i][j]);
      y[(static_cast<size_t>(b) * F + n) * HW + r] = v;
      const float f = to_f32(v);
      s[j] += f;
      ss[j] = fmaf(f, f, ss[j]);
    }
  }
  // The 16 threads of a half-warp share ty: reduce over their tx.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], off);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 16 * j;
      if (n < F) {
        part_s[static_cast<size_t>(blockIdx.x) * F + n] = s[j];
        part_ss[static_cast<size_t>(blockIdx.x) * F + n] = ss[j];
      }
    }
  }
}

// s[f] = sum over rows of part_s[row, f] (and ss likewise), in a fixed
// order: thread (lane, phase) adds rows phase, phase + 32, ... of channel
// f0 + lane (neighbouring lanes read neighbouring words), then the 32 phase
// sums are added in order of phase.
__global__ void __launch_bounds__(kReduceChannels * kReduceRows)
    reduce_partials_kernel(const float* __restrict__ part_s,
                           const float* __restrict__ part_ss,
                           float* __restrict__ s, float* __restrict__ ss,
                           int rows, int F) {
  __shared__ float red_s[kReduceRows][kReduceChannels + 1];
  __shared__ float red_ss[kReduceRows][kReduceChannels + 1];
  const int lane = threadIdx.x;
  const int phase = threadIdx.y;
  const int f = blockIdx.x * kReduceChannels + lane;
  float a = 0.f, b = 0.f;
  if (f < F) {
    for (int row = phase; row < rows; row += kReduceRows) {
      a += part_s[static_cast<size_t>(row) * F + f];
      b += part_ss[static_cast<size_t>(row) * F + f];
    }
  }
  red_s[phase][lane] = a;
  red_ss[phase][lane] = b;
  __syncthreads();
  if (phase == 0 && f < F) {
    float ta = 0.f, tb = 0.f;
    for (int p = 0; p < kReduceRows; ++p) {
      ta += red_s[p][lane];
      tb += red_ss[p][lane];
    }
    s[f] = ta;
    ss[f] = tb;
  }
}

template <typename T>
int launch(const void* x, const void* wt, void* y, void* part_s, void* part_ss,
           void* s, void* ss, int B, int C, int H, int W, int F,
           cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const int m_blocks = static_cast<int>((M + kTileM - 1) / kTileM);
  const dim3 grid(m_blocks, (F + kTileN - 1) / kTileN);
  conv3x3_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<T*>(y),
      static_cast<float*>(part_s), static_cast<float*>(part_ss), B, C, H, W, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(F + kReduceChannels - 1) / kReduceChannels,
                           dim3(kReduceChannels, kReduceRows), 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const float*>(part_ss),
      static_cast<float*>(s), static_cast<float*>(ss), m_blocks, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of the partial sums the caller allocates: ceil(B*H*W / 64).
int conv3x3_bn_stats_partial_rows(int B, int H, int W) {
  const long long M = static_cast<long long>(B) * H * W;
  return static_cast<int>((M + kTileM - 1) / kTileM);
}

// y[B, F, H, W] (x's dtype), s[F], ss[F] (f32) from x[B, C, H, W] and
// wt[F, C, 3, 3], both bf16 when is_bf16, else f32.  part_s and part_ss are
// f32 scratch of conv3x3_bn_stats_partial_rows(B, H, W) x F each.
int conv3x3_bn_stats(const void* x, const void* wt, void* y, void* part_s,
                     void* part_ss, void* s, void* ss, int B, int C, int H,
                     int W, int F, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, wt, y, part_s, part_ss, s, ss, B, C, H, W, F, st);
  return launch<float>(x, wt, y, part_s, part_ss, s, ss, B, C, H, W, F, st);
}

}  // extern "C"
