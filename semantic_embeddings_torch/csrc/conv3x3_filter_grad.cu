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
// takes it: conv_filter_grad_prototype.py:36-37); every product and sum is
// f32 and dw comes out f32.
//
// Layout: NCHW x and dy, dw (F, C, 3, 3) as the port's weights.
//
// What bounds it: 2 * N*H*W * 9*C * F operations on N*H*W * (C + F)
// elements, the same count as the forward convolution: bound by arithmetic
// at the ResNet-50 shapes, here by the f32 FMA rate (no tensor cores).  Its
// shape is awkward for a GEMM: the contraction runs over N*H*W (up to
// 401,408 rows at 224 px, batch 128) into only 9*C*F outputs (36,864 for
// the 64-channel stage), too few output tiles to fill 132 SMs.
//
// Design: a GEMM dw[F, K] = dy^T[F, M] * im2col(x)[M, K], with K = 9*C
// taps in the weight's order k = c*9 + kh*3 + kw, split over M across
// blocks (split-K).  Block (kx, fy, split) owns a 64 x 64 tile of
// (channels f x taps k) and the rows [split * chunk, (split + 1) * chunk)
// of M.  For each step of 16 rows it stages dy (16 x 64) and the im2col of x
// (16 x 64, zero outside the image and past the block's rows) in shared
// memory as f32; each thread accumulates a 4 x 4 sub-tile in f32 registers
// (channels ty + 16 i, taps tx + 16 j).  Each thread's taps are fixed for the
// whole loop, so their (c, kh, kw) are computed once; neighbouring threads
// load neighbouring rows, i.e. neighbouring pixels of one channel plane.
// The block writes its f32 partial tile to part[split, F, K]; a second
// kernel adds the splits of each output in a fixed order.  No atomics: the
// result is the same on every run.  N need not divide any tile: rows, taps
// and channels past their ends are masked, so any N, C, H, W, F >= 1 work.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileF = 64;   // output channels per block
constexpr int kTileK = 64;   // taps per block
constexpr int kTileR = 16;   // rows of M per shared-memory step
constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    filter_grad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ part, int N, int C, int H, int W,
                       int F, int chunk) {
  __shared__ float dy_tile[kTileR][kTileF + 1];  // [row][channel]
  __shared__ float x_tile[kTileR][kTileK + 1];   // [row][tap]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // tap lane of the 4 x 4 sub-tile
  const int ty = tid / 16;  // channel lane of the 4 x 4 sub-tile
  const int HW = H * W;
  const long long M = static_cast<long long>(N) * HW;
  const int K = C * 9;
  const int k0 = blockIdx.x * kTileK;
  const int f0 = blockIdx.y * kTileF;
  const long long row_begin = static_cast<long long>(blockIdx.z) * chunk;
  const long long row_end = row_begin + chunk < M ? row_begin + chunk : M;

  // Loads: this thread's row of each step is ld_row; its channels of dy are
  // f0 + ld_col + 16 r and its taps of x are k0 + ld_col + 16 r.
  const int ld_row = tid % kTileR;
  const int ld_col = tid / kTileR;
  int tap_c[4], tap_dh[4], tap_dw[4];
  bool tap_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ld_col + 16 * r;
    tap_ok[r] = k < K;
    const int c = k / 9;
    const int tap = k - c * 9;
    tap_c[r] = c;
    tap_dh[r] = tap / 3 - 1;
    tap_dw[r] = tap % 3 - 1;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = row_begin; r0 < row_end; r0 += kTileR) {
    const long long m = r0 + ld_row;
    const bool row_ok = m < row_end;
    int n = 0, h = 0, w = 0, p = 0;
    if (row_ok) {
      n = static_cast<int>(m / HW);
      p = static_cast<int>(m - static_cast<long long>(n) * HW);
      h = p / W;
      w = p - h * W;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int f = f0 + ld_col + 16 * r;
      float v = 0.f;
      if (row_ok && f < F) v = to_f32(dy[(static_cast<size_t>(n) * F + f) * HW + p]);
      dy_tile[ld_row][ld_col + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = 0.f;
      const int hh = h + tap_dh[r];
      const int ww = w + tap_dw[r];
      if (row_ok && tap_ok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = to_f32(x[(static_cast<size_t>(n) * C + tap_c[r]) * HW + hh * W + ww]);
      x_tile[ld_row][ld_col + 16 * r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kTileR; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dy_tile[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = x_tile[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(blockIdx.z) * F * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) out[static_cast<size_t>(f) * K + k] = acc[i][j];
    }
  }
}

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

template <typename T>
int launch(const void* x, const void* dy, void* part, void* dw, int N, int C,
           int H, int W, int F, int splits, int chunk, cudaStream_t stream) {
  const int K = C * 9;
  const dim3 grid((K + kTileK - 1) / kTileK, (F + kTileF - 1) / kTileF, splits);
  filter_grad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(part), N, C, H, W, F, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = F * K;
  reduce_splits_kernel<<<(outputs + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, outputs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// How conv3x3_filter_grad splits the N*H*W rows: returns the number of
// splits and writes the rows of each (a multiple of 16; the last split may
// be shorter) to *chunk.  Enough splits that the grid has about
// kTargetBlocks blocks, but no split shorter than kMinRowsPerSplit rows,
// whose partial tile would cost more to write and add than to compute.
int conv3x3_filter_grad_splits(int N, int C, int H, int W, int F, int* chunk) {
  constexpr long long kTargetBlocks = 1024;  // about 8 for each of 132 SMs
  constexpr long long kMinRowsPerSplit = 512;
  const long long M = static_cast<long long>(N) * H * W;
  const long long tiles = static_cast<long long>((C * 9 + kTileK - 1) / kTileK) *
                          ((F + kTileF - 1) / kTileF);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (M + kMinRowsPerSplit - 1) / kMinRowsPerSplit;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  long long rows = (M + splits - 1) / splits;
  rows = (rows + kTileR - 1) / kTileR * kTileR;
  *chunk = static_cast<int>(rows);
  return static_cast<int>((M + rows - 1) / rows);
}

// dw[F, C, 3, 3] (f32) from x[N, C, H, W] and dy[N, F, H, W], both bf16
// when is_bf16, else f32.  The rows N*H*W are split into `splits` chunks of
// `chunk` rows, as conv3x3_filter_grad_splits gives them; part is f32
// scratch of splits x F x 9C.
int conv3x3_filter_grad(const void* x, const void* dy, void* part, void* dw,
                        int N, int C, int H, int W, int F, int splits,
                        int chunk, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dy, part, dw, N, C, H, W, F, splits, chunk, st);
  return launch<float>(x, dy, part, dw, N, C, H, W, F, splits, chunk, st);
}

}  // extern "C"
