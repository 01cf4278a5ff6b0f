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
// prototype (:48-54).  Layout: NCHW x and y, (F, C, 3, 3) weights, as the
// port's layers hold them.  The dtype selects one of two instances; neither
// stands in for the other.
//
// What bounds it: 2 * B*H*W * 9*C * F operations on (B*H*W) * (C + F)
// elements.  At the ResNet-50 stage shapes (batch 128, 56x56x64 ...
// 7x7x512) that is 29.6 GFLOP each: in bf16 on an H100 (989 TFLOP/s tensor
// cores, 3.35 TB/s) about 0.030 ms, bound about equally by arithmetic and by
// bytes; in f32 0.179 ms as 3xTF32 on the tensor cores (0.442 ms on the f32
// FMA units).
//
// bf16 instance: a warp-level tensor-core GEMM (mma.sync m16n8k16, bf16 in,
// f32 accumulate), M = output channels f, N = pixels, K = 9C, fed by a
// 2-stage cp.async ring (3 blocks an SM cover one another's waits).
//   - A block owns 64 f x one pipeline step of conv3x3_common.cuh (64
//     pixels of one image; a step never straddles two images) and runs the
//     whole K = 9C itself, in chunks of 16 input channels x 9 taps: no
//     split-K, so y and the block's partial statistics come out of its
//     registers.  4 warps, 2 (32 f) x 2 (32 pixels): 2 x 4 m16n8 tiles, 32
//     accumulators a thread.  The grid is ceil(F / 64) x B * ceil(H*W / 64)
//     blocks (6,272 at the 56x56x64 stage, 1,024 at 7x7x512).
//   - A: the weight, permuted once a call by a small kernel into
//     wp[f][c / 16][kh, kw][c % 16] (zero past C), so that a chunk's 144
//     K values of one f are 288 contiguous bytes, staged with 16-byte
//     cp.async and read with ldmatrix (304-byte rows, conflict-free).
//   - B: the x windows of the chunk (16 c x 3 kh, from pixel p0 + (kh-1)*W
//     - 1 on, zero outside the plane), staged with cp.async in NCHW order
//     and transposed once a chunk in shared memory to [kh][pixel][c]
//     (48-byte rows).  An n8 x k16 B fragment is then 8 pixels x 16
//     channels at a fixed tap, and ldmatrix takes one row address per
//     pixel: the shift by kw and the window's remainder below the copy
//     width cost nothing, and a tap that wraps across the image's left or
//     right edge points its row at a row of zeros.  Chosen over the two
//     alternatives by counting, not by building them: three shifted copies
//     of each window cannot be aligned by cp.async (the shift is any pixel),
//     and 16-bit loads in pairs take 12 shared loads for 3 taps of one n8
//     tile, where the transposed window takes one ldmatrix for 2 tiles of
//     one tap plus a transpose (8 32-bit loads, 2 16-byte stores for 16
//     values) once a chunk.  Measured: 0.21-0.27 ms a call at the stage
//     shapes (chip_smoke.py phase 4), 5.5-7x the SIMT kernel it replaced.
//   - Copies: x as in the filter gradient: 16-byte cp.async where H*W % 8
//     == 0, 8-byte where % 4 == 0, each also limited by the x pointer's
//     alignment, else a first kernel repacks x into planes padded to a
//     multiple of 8 elements (stage 4's 7x7 = 49).
//   - Epilogue: round the accumulators to bf16, store y (32-bit stores of
//     pixel pairs where the plane's parity allows, else 16-bit), and sum
//     the rounded values and their squares per channel: 8 a thread in
//     order, then across the 4 lanes of a row (__shfl_xor_sync 1, 2), then
//     the block's two pixel halves through shared memory, into per-block
//     partials of shape (B * ceil(H*W / 64), F).
//
// f32 instance: the bf16 instance's design as 3xTF32 on mma.sync m16n8k8
// (TF32 in, f32 accumulate; the split and the mma in conv3x3_common.cuh):
// three TF32 products for each f32-exact one.
//   - Chunks of 8 input channels x 9 taps, so that one tap is one k8 slice;
//     the weight is permuted once a call to (c / 8, kh, kw, c % 8).  Steps,
//     ring and grid are the bf16 instance's.  A block owns 64 f (4 warps, 3
//     blocks an SM) or, where F >= 128, 128 f (8 warps, 2 blocks an SM),
//     which stages and transposes each x window for twice the outputs:
//     7-8% faster than the 64 f block at the ResNet-50 stages 2-4 (below).
//     Each output is the same sum in the same order in either.
//   - ldmatrix reads f32 as it reads bf16: an 8 x 8 b16 matrix is an 8 x 4
//     f32 one, so one ldmatrix.x4 over weight rows [f][k] gives a0-a3, and
//     over the transposed rows [pixel][c] the matrices at c and c + 4 give
//     b0 and b1 of an n8 tile.  Weight rows of 72 + 4 floats (304 bytes)
//     and transposed rows of 20 floats (80 bytes) are conflict-free.
//   - The split: x is split once a chunk, in the transpose, into its TF32
//     big and small parts, stored side by side in each transposed row
//     ([kh][pixel][8 big, 8 small]).  Each x value serves 3 kw and every
//     warp of its pixels, so splitting it there and not after each ldmatrix
//     took a third of the instructions per mma away.  The weight is split in
//     registers after ldmatrix: split once a call, it would double the bytes
//     that every block of pixels stages again.
//   - The tensor cores' own accumulation truncates, so the running sums stay
//     out of it: the three products of the 3 taps of one kh (24 channels x
//     taps) sum in the tensor cores from zero, and the running sums take
//     them with one rounded f32 add, 3C / 8 adds for each y.
//   - Copies: 16-byte cp.async where H*W % 4 == 0, 8-byte where H*W is even,
//     each also limited by x's alignment, else the repack into planes padded
//     to 8 floats (stage 4's 49 pixels, odd ragged planes).
//   - Epilogue as in bf16, on y as f32 (64-bit stores of pixel pairs).
//   - Measured (chip_smoke.py phase 4, H100 80GB HBM3 at 700 W; per-stage
//     times in PERF.md): 0.62-0.79 ms a call at the ResNet-50 stage
//     shapes, 23-29% of the 3xTF32 bound, 2.0-2.5x the SIMT kernel it
//     replaced (1.52-1.58 ms); the 64 f block, timed against it in one run
//     on that card through a switch since removed, 0.672 / 0.822 / 0.851 ms
//     at stages 2-4 against 0.624 / 0.760 / 0.782.  Stages 3-4
//     compute nearly a quarter of padding: 196 = 3 x 64 + 4 pixels, and 49
//     of 64.  Tried in temporary variants on an H100 and dropped, each
//     slower at every stage shape: both operands split after each ldmatrix
//     with one rounded add a tap (the first build); warps of 32 f x 64
//     pixels (half the weight splits per mma, but 255 registers and
//     spills).
//
// Both: a second kernel adds each channel's partials in a fixed order.  No
// atomics: y, s and ss are the same on every run.  Pixels, channels and
// taps past their ends are masked, so any B, C, H, W, F >= 1 work.
//
// Halo rows (spatial partitioning, where x is a block of an image's rows):
// x's rows -1 and H may be given as (B, C, 1, W) tensors in place of the
// SAME padding's zeros.  Only the window chunks that reach outside x's plane
// read them, element by element (stage_x_chunk in conv3x3_common.cuh), so
// x's planes keep the copy width chosen for them, and a null pointer leaves
// every path as it was.  y and the partial sums cover x's own H rows; each
// pixel's products are summed in the same order as in a launch on the whole
// image, so y is the same, bit for bit (chip_smoke.py phase 17a).
//
// ptxas (sm_90a, CUDA 12.9): the bf16 kernel 120 registers for each copy
// width, no spills, 66,864 bytes of dynamic shared memory (2 stages of
// 27,136, the transposed windows and a zero row, the halves' sums), so
// shared memory holds it to 3 blocks an SM; the f32 kernel with 64 f 155
// registers, no spills, 71,120 bytes (2 stages of 26,368, the split
// windows of 17,280), 3 blocks an SM; with 128 f 128 registers (its bound
// for 2 blocks of 256 threads an SM), 56-64 bytes of spills, 111,056
// bytes; the weight permutation, the repack 16; the second pass 32
// registers and 8,448 bytes.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;

constexpr int kTcStages = 2;         // depth of the cp.async ring (both instances)
constexpr int kReduceChannels = 32;  // channels per block of the second pass
constexpr int kReduceRows = 32;      // row phases per block of the second pass

// wp[f][ch][tap][cl] = wt[f][ch * CC + cl][tap], 0 past C: the A operand's
// K order, (c / CC, kh, kw, c % CC), for chunks of CC input channels.
template <typename T, int CC>
__global__ void __launch_bounds__(256)
    permute_weights_kernel(const T* __restrict__ wt, T* __restrict__ wp, int C, int F,
                           int chunks) {
  constexpr int kK = CC * 9;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long per_f = static_cast<long long>(chunks) * kK;
  if (i >= per_f * F) return;
  const int f = static_cast<int>(i / per_f);
  const int rem = static_cast<int>(i - f * per_f);
  const int ch = rem / kK;
  const int k = rem - ch * kK;
  const int tap = k / CC;
  const int c = ch * CC + k - tap * CC;
  wp[i] = c < C ? wt[(static_cast<size_t>(f) * C + c) * 9 + tap] : static_cast<T>(0);
}

template <typename T, int CC>
int permute_weights(const void* wt, T* wp, int C, int F, cudaStream_t stream) {
  const int chunks = (C + CC - 1) / CC;
  const long long elems = static_cast<long long>(F) * chunks * CC * 9;
  permute_weights_kernel<T, CC><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(wt), wp, C, F, chunks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 instance
// ---------------------------------------------------------------------------

constexpr int kTcF = 64;            // output channels per block
constexpr int kTcC = 16;            // input channels per K chunk (x 9 taps)
constexpr int kTcK = kTcC * 9;      // K values per chunk
constexpr int kTcThreads = 128;     // 4 warps: 2 (32 f each) x 2 (32 pixels each)
constexpr int kWPitch = kTcK + 8;   // 304-byte rows: ldmatrix conflict-free
constexpr int kXWin = window_len<8>();  // 80: the window of the widest copy
constexpr int kRawPitch = kXWin;    // raw x rows [c * 3 + kh][pixel], 160 bytes
constexpr int kTPitch = kTcC + 8;   // transposed rows [kh][pixel][c], 48 bytes
constexpr int kWElems = kTcF * kWPitch;
constexpr int kRawElems = kTcC * 3 * kRawPitch;
constexpr int kStageBytes = (kWElems + kRawElems) * 2;
constexpr int kTElems = 3 * kXWin * kTPitch;
constexpr int kTcSmem = kTcStages * kStageBytes + (kTElems + kTPitch) * 2 +  // + a zero row
                        2 * 2 * kTcF * 4;  // the two pixel halves' sums
static_assert(kStageBytes % 16 == 0 && (kTElems * 2) % 16 == 0, "16-byte alignment");
static_assert(window_len<4>() <= kXWin, "x window exceeds its row");

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi, float& rlo, float& rhi) {
  const __nv_bfloat16 a = __float2bfloat16(lo), b = __float2bfloat16(hi);
  rlo = __bfloat162float(a);
  rhi = __bfloat162float(b);
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// Block (f tile, step t) of a 1-D grid: f tile = blockIdx.x % ceil(F / 64),
// t = blockIdx.x / ceil(F / 64), so the blocks of one step are neighbours
// and share its x windows in L2.  x planes lie `pitch` elements apart (H*W,
// or more in a repacked copy).
template <int VEC>
__global__ void __launch_bounds__(kTcThreads, 3)
    conv3x3_stats_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ top,
                              const uint16_t* __restrict__ bottom,
                              const uint16_t* __restrict__ wp, uint16_t* __restrict__ y, float* __restrict__ part_s,
                              float* __restrict__ part_ss, int C, int H, int W, int F,
                              int pitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xt = reinterpret_cast<uint16_t*>(smem + kTcStages * kStageBytes);
  uint16_t* zero_row = xt + kTElems;
  float* half_sums = reinterpret_cast<float*>(zero_row + kTPitch);  // [2][2][kTcF]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wf = warp & 1;    // this warp's 32 f: wf * 32 ..
  const int wpx = warp >> 1;  // this warp's 32 pixels: wpx * 32 ..
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int f_tiles = (F + kTcF - 1) / kTcF;
  const int f0 = (blockIdx.x % f_tiles) * kTcF;
  const int t = blockIdx.x / f_tiles;
  const int n = t / per_image;
  const int p0 = (t - n * per_image) * kStep;
  const int chunks = (C + kTcC - 1) / kTcC;

  auto stage_w = [&](int slot) { return reinterpret_cast<uint16_t*>(smem + slot * kStageBytes); };

  // Stages chunk ch (channels ch * 16 .. + 15, all taps) into ring slot `slot`.
  auto load_chunk = [&](int ch, int slot) {
    uint16_t* ws = stage_w(slot);
    uint16_t* raw = ws + kWElems;
    constexpr int w_row_chunks = kTcK / 8;
    for (int i = tid; i < kTcF * w_row_chunks; i += kTcThreads) {
      const int r = i / w_row_chunks;
      const int q = (i - r * w_row_chunks) * 8;
      const int f = f0 + r;
      const bool ok = f < F;
      const uint16_t* src = ok ? wp + (static_cast<size_t>(f) * chunks + ch) * kTcK + q : wp;
      copy_chunk<16>(ws + r * kWPitch + q, src, ok);
    }
    constexpr int x_row_chunks = window_len<VEC>() / VEC;
    for (int i = tid; i < kTcC * 3 * x_row_chunks; i += kTcThreads) {
      const int row = i / x_row_chunks;  // cl * 3 + kh
      const int q = (i - row * x_row_chunks) * VEC;
      const int cl = row / 3;
      const int kh = row - cl * 3;
      const int c = ch * kTcC + cl;
      const int pix = ((p0 + (kh - 1) * W - 1) & ~(VEC - 1)) + q;
      const bool ok = c < C;
      const size_t plane = static_cast<size_t>(n) * C + c;
      stage_x_chunk<VEC>(raw + row * kRawPitch + q, ok ? x + plane * pitch : x,
                         top ? top + plane * W : nullptr, bottom ? bottom + plane * W : nullptr,
                         pix, HW, W, ok);
    }
  };

  // raw[cl * 3 + kh][q] -> xt[kh][q][cl]: a unit is 8 channels at 2 pixels,
  // 8 32-bit loads and 2 16-byte stores.
  auto transpose = [&](const uint16_t* raw) {
    constexpr int pairs = kXWin / 2;
    for (int u = tid; u < 3 * 2 * pairs; u += kTcThreads) {
      const int qp = u % pairs;
      const int rest = u / pairs;
      const int kh = rest % 3;
      const int half = rest / 3;  // channels half * 8 ..
      unsigned w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = *reinterpret_cast<const unsigned*>(raw + ((half * 8 + j) * 3 + kh) * kRawPitch +
                                                  qp * 2);
      uint4 lo, hi;  // pixel 2 qp, pixel 2 qp + 1
      lo.x = __byte_perm(w[0], w[1], 0x5410);
      lo.y = __byte_perm(w[2], w[3], 0x5410);
      lo.z = __byte_perm(w[4], w[5], 0x5410);
      lo.w = __byte_perm(w[6], w[7], 0x5410);
      hi.x = __byte_perm(w[0], w[1], 0x7632);
      hi.y = __byte_perm(w[2], w[3], 0x7632);
      hi.z = __byte_perm(w[4], w[5], 0x7632);
      hi.w = __byte_perm(w[6], w[7], 0x7632);
      uint16_t* dst = xt + (kh * kXWin + qp * 2) * kTPitch + half * 8;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + kTPitch) = hi;
    }
  };

  // This lane's ldmatrix rows of B: pixel op[np] of the warp's n8 tiles
  // 2 np, 2 np + 1 (row lane & 7 of matrix lane >> 3), channels c_off ..
  // + 7; whether the pixel has a left and a right neighbour in its row.
  const int mat = lane >> 3;  // the 8 x 8 matrix whose row this lane addresses
  const int c_off = (mat & 1) * 8;
  int op[2];
  bool has_left[2], has_right[2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    op[np] = wpx * 32 + np * 16 + (mat >> 1) * 8 + (lane & 7);
    const int w = (p0 + op[np]) % W;
    has_left[np] = w >= 1;
    has_right[np] = w <= W - 2;
  }
  int shift[3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) shift[kh] = (p0 + (kh - 1) * W - 1) & (VEC - 1);

  if (tid < kTPitch / 8) reinterpret_cast<uint4*>(zero_row)[tid] = make_uint4(0, 0, 0, 0);

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < chunks) load_chunk(s, s);
    cp_async_commit();
  }

  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // chunk i has landed; xt and slot (i - 1) % kTcStages are free
    {
      const int next = i + kTcStages - 1;
      if (next < chunks) load_chunk(next, next % kTcStages);
      cp_async_commit();
    }
    const uint16_t* ws = stage_w(i % kTcStages);
    transpose(ws + kWElems);
    __syncthreads();

#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw;
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], ws + (wf * 32 + mt * 16 + (lane & 15)) * kWPitch + tap * kTcC +
                                 (lane >> 4) * 8);
        unsigned b[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const bool ok = kw == 1 || (kw == 0 ? has_left[np] : has_right[np]);
          const uint16_t* rowp =
              ok ? xt + (kh * kXWin + op[np] + kw + shift[kh]) * kTPitch + c_off
                 : zero_row + c_off;
          ldmatrix_x4(b[np], rowp);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: y rounded to bf16; per-channel sums of the rounded values.
  const bool pairs_aligned = (HW % 2 == 0) && (reinterpret_cast<uintptr_t>(y) % 4 == 0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int fl = wf * 32 + mt * 16 + g + r * 8;  // f - f0
      const int f = f0 + fl;
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = p0 + wpx * 32 + nt * 8 + tig * 2;
        float v0, v1;
        const unsigned packed = pack_bf16(acc[mt][nt][r * 2], acc[mt][nt][r * 2 + 1], v0, v1);
        const bool ok0 = f < F && p < HW, ok1 = f < F && p + 1 < HW;
        if (ok0) {
          uint16_t* dst = y + (static_cast<size_t>(n) * F + f) * HW + p;
          if (ok1 && pairs_aligned) {
            *reinterpret_cast<unsigned*>(dst) = packed;
          } else {
            dst[0] = static_cast<uint16_t>(packed & 0xffffu);
            if (ok1) dst[1] = static_cast<uint16_t>(packed >> 16);
          }
        }
        if (ok0) {
          s += v0;
          ss = fmaf(v0, v0, ss);
        }
        if (ok1) {
          s += v1;
          ss = fmaf(v1, v1, ss);
        }
      }
      // the 4 lanes of a row (tig) hold its pixels
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (tig == 0) {
        half_sums[(wpx * 2 + 0) * kTcF + fl] = s;
        half_sums[(wpx * 2 + 1) * kTcF + fl] = ss;
      }
    }
  __syncthreads();
  if (tid < kTcF && f0 + tid < F) {
    const size_t at = static_cast<size_t>(t) * F + f0 + tid;
    part_s[at] = half_sums[0 * kTcF + tid] + half_sums[2 * kTcF + tid];
    part_ss[at] = half_sums[1 * kTcF + tid] + half_sums[3 * kTcF + tid];
  }
}

template <int VEC>
int launch_bf16(const void* x, const void* top, const void* bottom, const void* wp, void* y,
                void* part_s, void* part_ss, int B, int C, int H, int W, int F, int pitch,
                cudaStream_t stream) {
  const auto kernel = conv3x3_stats_bf16_kernel<VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long steps = static_cast<long long>(B) * ((H * W + kStep - 1) / kStep);
  const long long blocks = steps * ((F + kTcF - 1) / kTcF);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, kTcSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(top),
      static_cast<const uint16_t*>(bottom), static_cast<const uint16_t*>(wp),
      static_cast<uint16_t*>(y), static_cast<float*>(part_s), static_cast<float*>(part_ss), C,
      H, W, F, pitch);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32 instance (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kF32C = 8;                 // input channels per K chunk (x 9 taps)
constexpr int kF32K = kF32C * 9;         // 72 K values per chunk, one k8 slice a tap
constexpr int kF32WPitch = kF32K + 4;    // 304-byte rows: ldmatrix conflict-free
constexpr int kF32XWin = window_len<4>();  // 72: the window of the widest copy
constexpr int kF32RawPitch = kF32XWin;   // raw x rows [c * 3 + kh][pixel], 288 bytes
constexpr int kF32TPitch = 2 * kF32C + 4;  // transposed rows [kh][pixel][big c, small c], 80 bytes
constexpr int kF32RawElems = kF32C * 3 * kF32RawPitch;
constexpr int kF32TElems = 3 * kF32XWin * kF32TPitch;
static_assert(window_len<2>() <= kF32XWin, "x window exceeds its row");

// The block for FT output channels: FT / 32 x 2 warps (32 f x 32 pixels
// each), and its shared memory.
template <int FT>
struct F32Block {
  static constexpr int kThreads = FT * 2;
  static constexpr int kWElems = FT * kF32WPitch;
  static constexpr int kStageBytes = (kWElems + kF32RawElems) * 4;
  static constexpr int kSmem = kTcStages * kStageBytes +
                               (kF32TElems + kF32TPitch) * 4 +  // + a zero row
                               2 * 2 * FT * 4;                  // the two pixel halves' sums
  static_assert(kStageBytes % 16 == 0 && (kF32TElems * 4) % 16 == 0, "16-byte alignment");
};

// As conv3x3_stats_bf16_kernel, on f32 operands as 3xTF32: chunks of 8
// input channels (one m16n8k8 slice a tap), FT output channels a block.
template <int VEC, int FT>
__global__ void __launch_bounds__(FT * 2, FT == 64 ? 3 : 2)
    conv3x3_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ top,
                             const float* __restrict__ bottom, const float* __restrict__ wp,
                             float* __restrict__ y, float* __restrict__ part_s,
                             float* __restrict__ part_ss, int C, int H, int W, int F,
                             int pitch) {
  using Block = F32Block<FT>;
  constexpr int kWarpsF = FT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xt = reinterpret_cast<float*>(smem + kTcStages * Block::kStageBytes);
  float* zero_row = xt + kF32TElems;
  float* half_sums = zero_row + kF32TPitch;  // [2][2][FT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wf = warp % kWarpsF;   // this warp's 32 f: wf * 32 ..
  const int wpx = warp / kWarpsF;  // this warp's 32 pixels: wpx * 32 ..
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int f_tiles = (F + FT - 1) / FT;
  const int f0 = (blockIdx.x % f_tiles) * FT;
  const int t = blockIdx.x / f_tiles;
  const int n = t / per_image;
  const int p0 = (t - n * per_image) * kStep;
  const int chunks = (C + kF32C - 1) / kF32C;

  auto stage_w = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * Block::kStageBytes);
  };

  // Stages chunk ch (channels ch * 8 .. + 7, all taps) into ring slot `slot`.
  auto load_chunk = [&](int ch, int slot) {
    float* ws = stage_w(slot);
    float* raw = ws + Block::kWElems;
    constexpr int w_row_chunks = kF32K / 4;
    for (int i = tid; i < FT * w_row_chunks; i += Block::kThreads) {
      const int r = i / w_row_chunks;
      const int q = (i - r * w_row_chunks) * 4;
      const int f = f0 + r;
      const bool ok = f < F;
      const float* src = ok ? wp + (static_cast<size_t>(f) * chunks + ch) * kF32K + q : wp;
      copy_chunk<16>(ws + r * kF32WPitch + q, src, ok);
    }
    constexpr int x_row_chunks = window_len<VEC>() / VEC;
    for (int i = tid; i < kF32C * 3 * x_row_chunks; i += Block::kThreads) {
      const int row = i / x_row_chunks;  // cl * 3 + kh
      const int q = (i - row * x_row_chunks) * VEC;
      const int cl = row / 3;
      const int kh = row - cl * 3;
      const int c = ch * kF32C + cl;
      const int pix = ((p0 + (kh - 1) * W - 1) & ~(VEC - 1)) + q;
      const bool ok = c < C;
      const size_t plane = static_cast<size_t>(n) * C + c;
      stage_x_chunk<VEC>(raw + row * kF32RawPitch + q, ok ? x + plane * pitch : x,
                         top ? top + plane * W : nullptr, bottom ? bottom + plane * W : nullptr,
                         pix, HW, W, ok);
    }
  };

  // raw[cl * 3 + kh][q] -> xt[kh][q][cl] (TF32 big) and xt[kh][q][8 + cl]
  // (small), split once a chunk: a unit is 4 channels at 2 pixels, 4 64-bit
  // loads and 4 16-byte stores.
  auto transpose = [&](const float* raw) {
    constexpr int pairs = kF32XWin / 2;
    for (int u = tid; u < 3 * 2 * pairs; u += Block::kThreads) {
      const int qp = u % pairs;
      const int rest = u / pairs;
      const int kh = rest % 3;
      const int half = rest / 3;  // channels half * 4 ..
      float2 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const float2*>(raw + ((half * 4 + j) * 3 + kh) * kF32RawPitch +
                                                qp * 2);
      uint4 big[2], small[2];  // pixel 2 qp, pixel 2 qp + 1
      split_tf32(v[0].x, big[0].x, small[0].x);
      split_tf32(v[1].x, big[0].y, small[0].y);
      split_tf32(v[2].x, big[0].z, small[0].z);
      split_tf32(v[3].x, big[0].w, small[0].w);
      split_tf32(v[0].y, big[1].x, small[1].x);
      split_tf32(v[1].y, big[1].y, small[1].y);
      split_tf32(v[2].y, big[1].z, small[1].z);
      split_tf32(v[3].y, big[1].w, small[1].w);
      float* dst = xt + (kh * kF32XWin + qp * 2) * kF32TPitch + half * 4;
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        *reinterpret_cast<uint4*>(dst + px * kF32TPitch) = big[px];
        *reinterpret_cast<uint4*>(dst + px * kF32TPitch + kF32C) = small[px];
      }
    }
  };

  // This lane's ldmatrix rows of B: pixel op[np] of the warp's n8 tiles
  // 2 np, 2 np + 1 (row lane & 7 of matrix lane >> 3), channels c_off ..
  // + 3 of the big parts, and 8 floats on of the small ones: an 8 x 8 b16
  // matrix is 8 pixels x 4 f32 channels, so matrices 0 and 1 are b0 and b1
  // of tile 2 np, 2 and 3 those of tile 2 np + 1.  And whether the pixel
  // has a left and a right neighbour in its row.
  const int mat = lane >> 3;
  const int c_off = (mat & 1) * 4;
  int op[2];
  bool has_left[2], has_right[2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    op[np] = wpx * 32 + np * 16 + (mat >> 1) * 8 + (lane & 7);
    const int w = (p0 + op[np]) % W;
    has_left[np] = w >= 1;
    has_right[np] = w <= W - 2;
  }
  int shift[3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) shift[kh] = (p0 + (kh - 1) * W - 1) & (VEC - 1);

  if (tid < kF32TPitch / 4)
    reinterpret_cast<float4*>(zero_row)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr float zero[4] = {0.f, 0.f, 0.f, 0.f};

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < chunks) load_chunk(s, s);
    cp_async_commit();
  }

  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // chunk i has landed; xt and slot (i - 1) % kTcStages are free
    {
      const int next = i + kTcStages - 1;
      if (next < chunks) load_chunk(next, next % kTcStages);
      cp_async_commit();
    }
    const float* ws = stage_w(i % kTcStages);
    transpose(ws + Block::kWElems);
    __syncthreads();

    // The three products of the 3 taps of one kh (24 channel-taps) sum in
    // the tensor cores from zero; the running sums take them with one
    // rounded f32 add.  The loop stays rolled in the 64 f block: unrolled,
    // it spilled and ran slower; the 128 f block, held to 128 registers
    // either way, runs faster unrolled (both timed in temporary variants).
#pragma unroll(FT == 64 ? 1 : 3)
    for (int kh = 0; kh < 3; ++kh) {
      float d[2][4][4];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw;
        unsigned a_big[2][4], a_small[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned raw[4];
          ldmatrix_x4(raw, ws + (wf * 32 + mt * 16 + (lane & 15)) * kF32WPitch + tap * kF32C +
                               (lane >> 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(raw[e]), a_big[mt][e], a_small[mt][e]);
        }
        unsigned b_big[2][4], b_small[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const bool ok = kw == 1 || (kw == 0 ? has_left[np] : has_right[np]);
          const float* rowp =
              ok ? xt + (kh * kF32XWin + op[np] + kw + shift[kh]) * kF32TPitch + c_off
                 : zero_row + c_off;
          ldmatrix_x4(b_big[np], rowp);
          ldmatrix_x4(b_small[np], rowp + kF32C);
        }
        // in rounds of 8 independent mma: small * big, big * small, big * big
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (kw == 0)
              mma_tf32(d[mt][nt], a_small[mt], b_big[nt >> 1][(nt & 1) * 2],
                       b_big[nt >> 1][(nt & 1) * 2 + 1], zero);
            else
              mma_tf32(d[mt][nt], a_small[mt], b_big[nt >> 1][(nt & 1) * 2],
                       b_big[nt >> 1][(nt & 1) * 2 + 1], d[mt][nt]);
          }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(d[mt][nt], a_big[mt], b_small[nt >> 1][(nt & 1) * 2],
                     b_small[nt >> 1][(nt & 1) * 2 + 1], d[mt][nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(d[mt][nt], a_big[mt], b_big[nt >> 1][(nt & 1) * 2],
                     b_big[nt >> 1][(nt & 1) * 2 + 1], d[mt][nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[mt][nt][e];
    }
  }
  cp_async_wait<0>();

  // Epilogue: y as f32; per-channel sums of the stored values.
  const bool pairs_aligned = (HW % 2 == 0) && (reinterpret_cast<uintptr_t>(y) % 8 == 0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int fl = wf * 32 + mt * 16 + g + r * 8;  // f - f0
      const int f = f0 + fl;
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = p0 + wpx * 32 + nt * 8 + tig * 2;
        const float v0 = acc[mt][nt][r * 2], v1 = acc[mt][nt][r * 2 + 1];
        const bool ok0 = f < F && p < HW, ok1 = f < F && p + 1 < HW;
        if (ok0) {
          float* dst = y + (static_cast<size_t>(n) * F + f) * HW + p;
          if (ok1 && pairs_aligned) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (ok1) dst[1] = v1;
          }
          s += v0;
          ss = fmaf(v0, v0, ss);
        }
        if (ok1) {
          s += v1;
          ss = fmaf(v1, v1, ss);
        }
      }
      // the 4 lanes of a row (tig) hold its pixels
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (tig == 0) {
        half_sums[(wpx * 2 + 0) * FT + fl] = s;
        half_sums[(wpx * 2 + 1) * FT + fl] = ss;
      }
    }
  __syncthreads();
  if (tid < FT && f0 + tid < F) {
    const size_t at = static_cast<size_t>(t) * F + f0 + tid;
    part_s[at] = half_sums[0 * FT + tid] + half_sums[2 * FT + tid];
    part_ss[at] = half_sums[1 * FT + tid] + half_sums[3 * FT + tid];
  }
}

template <int VEC, int FT>
int launch_f32_block(const void* x, const void* top, const void* bottom, const float* wp, void* y,
                     void* part_s, void* part_ss, int B, int C, int H, int W, int F, int pitch,
                     cudaStream_t stream) {
  using Block = F32Block<FT>;
  const auto kernel = conv3x3_stats_f32_kernel<VEC, FT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Block::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long steps = static_cast<long long>(B) * ((H * W + kStep - 1) / kStep);
  const long long blocks = steps * ((F + FT - 1) / FT);
  kernel<<<static_cast<unsigned>(blocks), Block::kThreads, Block::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(top),
      static_cast<const float*>(bottom), wp, static_cast<float*>(y), static_cast<float*>(part_s),
      static_cast<float*>(part_ss), C, H, W, F, pitch);
  return static_cast<int>(cudaGetLastError());
}

// A block of the f32 instance owns 128 output channels where F >= 128
// (faster than 64 at the ResNet-50 stages 2-4, see the header: half the x
// windows staged and transposed per output, 16 warps an SM against 12),
// else 64.
template <int VEC>
int launch_f32(const void* x, const void* top, const void* bottom, const float* wp, void* y,
               void* part_s, void* part_ss, int B, int C, int H, int W, int F, int pitch,
               cudaStream_t stream) {
  if (F >= 128)
    return launch_f32_block<VEC, 128>(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F,
                                      pitch, stream);
  return launch_f32_block<VEC, 64>(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F,
                                   pitch, stream);
}

// ---------------------------------------------------------------------------
// The second pass (both instances)
// ---------------------------------------------------------------------------

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

int reduce_partials(void* part_s, void* part_ss, void* s, void* ss, int rows, int F,
                    cudaStream_t stream) {
  reduce_partials_kernel<<<(F + kReduceChannels - 1) / kReduceChannels,
                           dim3(kReduceChannels, kReduceRows), 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const float*>(part_ss),
      static_cast<float*>(s), static_cast<float*>(ss), rows, F);
  return static_cast<int>(cudaGetLastError());
}

// Elements of the permuted weight: F x ceil(C / CC) chunks x 9 CC, with CC
// = 16 input channels a chunk in bf16 and 8 in f32.
long long permuted_weight_elems(int C, int F, bool bf16) {
  const int cc = bf16 ? kTcC : kF32C;
  return static_cast<long long>(F) * ((C + cc - 1) / cc) * cc * 9;
}

// The copy width, in elements, that the instance takes for x: bf16 8 or 4,
// f32 4 or 2 (16- or 8-byte cp.async); 1 where neither fits and x is
// repacked into padded planes.
int copy_width_of(const void* x, int HW, bool bf16) {
  return bf16 ? copy_width<2>(HW, x) : copy_width<4>(HW, x);
}

}  // namespace

extern "C" {

// Rows of the partial sums the caller allocates: one per pipeline step of
// 64 pixels, B * ceil(H*W / 64) (steps never straddle two images).
int conv3x3_bn_stats_partial_rows(int B, int H, int W) {
  const long long HW = static_cast<long long>(H) * W;
  return static_cast<int>(B * ((HW + kStep - 1) / kStep));
}

// Bytes of scratch the instance needs: the permuted weight, and x repacked
// into planes padded to 8 elements where no copy width fits.
long long conv3x3_bn_stats_scratch(const void* x, int B, int C, int H, int W, int F,
                                   int is_bf16) {
  const int elem = is_bf16 ? 2 : 4;
  long long bytes = permuted_weight_elems(C, F, is_bf16 != 0) * elem;
  if (copy_width_of(x, H * W, is_bf16 != 0) == 1)
    bytes += static_cast<long long>(B) * C * padded_pitch(H * W) * elem;
  return bytes;
}

// The copy width, in elements, that the instance of this dtype takes for x
// (bf16 8 or 4, f32 4 or 2, or 1 for the repack), so that a caller can see
// which path ran.
int conv3x3_bn_stats_copy_width(const void* x, int H, int W, int is_bf16) {
  return copy_width_of(x, H * W, is_bf16 != 0);
}

// y[B, F, H, W] (x's dtype), s[F], ss[F] (f32) from x[B, C, H, W] and
// wt[F, C, 3, 3], both bf16 when is_bf16, else f32.  top and bottom are x's
// rows -1 and H, (B, C, 1, W) in x's dtype, or null for zeros (the image's
// own edge); y and the sums cover x's H rows only.  part_s and part_ss are
// f32 scratch of conv3x3_bn_stats_partial_rows(B, H, W) x F each; scratch
// holds the bytes conv3x3_bn_stats_scratch asks for.
int conv3x3_bn_stats(const void* x, const void* wt, const void* top, const void* bottom,
                     void* y, void* part_s, void* part_ss,
                     void* s, void* ss, int B, int C, int H, int W, int F, int is_bf16,
                     void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int HW = H * W;
  const long long w_elems = permuted_weight_elems(C, F, is_bf16 != 0);
  const int pitch = padded_pitch(HW);
  int err;
  if (is_bf16) {
    uint16_t* wp = static_cast<uint16_t*>(scratch);
    err = permute_weights<uint16_t, kTcC>(wt, wp, C, F, st);
    if (err != 0) return err;
    switch (copy_width_of(x, HW, true)) {
      case 8: err = launch_bf16<8>(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, HW, st); break;
      case 4: err = launch_bf16<4>(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, HW, st); break;
      default: {
        uint16_t* xp = wp + w_elems;
        err = pad_planes<uint16_t>(x, xp, static_cast<long long>(B) * C, HW, pitch, st);
        if (err == 0) err = launch_bf16<8>(xp, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, pitch, st);
      }
    }
  } else {
    float* wp = static_cast<float*>(scratch);
    err = permute_weights<float, kF32C>(wt, wp, C, F, st);
    if (err != 0) return err;
    switch (copy_width_of(x, HW, false)) {
      case 4: err = launch_f32<4>(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, HW, st); break;
      case 2: err = launch_f32<2>(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, HW, st); break;
      default: {
        float* xp = wp + w_elems;
        err = pad_planes<float>(x, xp, static_cast<long long>(B) * C, HW, pitch, st);
        if (err == 0) err = launch_f32<4>(xp, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, pitch, st);
      }
    }
  }
  if (err != 0) return err;
  return reduce_partials(part_s, part_ss, s, ss, conv3x3_bn_stats_partial_rows(B, H, W), F, st);
}

// Which instance conv3x3_bn_stats runs for a dtype, for a caller to report.
const char* conv3x3_bn_stats_instance(int is_bf16) {
  return is_bf16 ? "tensor cores: mma.sync m16n8k16 bf16" : "tensor cores: mma.sync m16n8k8 3xTF32";
}

}  // extern "C"
