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
// f32 and dw comes out f32.  Layout: NCHW x and dy, dw (F, C, 3, 3) as the
// port's weights.  The dtype selects one of two instances; neither stands
// in for the other.
//
// What bounds it: 2 * N*H*W * 9*C * F operations on N*H*W * (C + F) input
// elements and 9*C*F outputs.  At the ResNet-50 stage shapes (batch 128,
// 56x56x64 ... 7x7x512) that is 29.6 GFLOP each, on 102.8 / 51.4 / 25.7 /
// 12.8 MB of bf16 inputs: on an H100 (989 TFLOP/s bf16 tensor cores,
// 3.35 TB/s) about 0.030 ms either way, so bf16 is bound about equally by
// arithmetic and by bytes; f32 without tensor cores is bound by the 67
// TFLOP/s FMA rate (0.44 ms).  The shape is awkward for a GEMM: the
// contraction runs over N*H*W (up to 401,408 pixels) into only 9*C*F
// outputs (36,864 at the 64-channel stage), too few output tiles to fill
// 132 SMs, so both instances split the pixels across blocks (split-K) into
// f32 partials part[split, F, 9C], which a second kernel adds in the order
// of the splits.  No atomics: dw is bitwise the same on every run.  Any
// N, C, H, W, F >= 1 work: pixels, channels and taps past their ends are
// masked, nothing assumes divisibility.
//
// bf16 instance: warp-level tensor-core GEMM (mma.sync m16n8k16, bf16 in,
// f32 accumulate) fed by a 3-stage cp.async ring.
//   - Both operands are K-major in NCHW: for a fixed f, dy's pixels are
//     contiguous (the A operand, row-major, read with ldmatrix); for a fixed
//     (c, kh, kw), x's pixels are contiguous, shifted by (kh-1)*W + (kw-1)
//     (the B operand, column-major).  No transpose.
//   - A block owns 64 output channels f and 16 input channels c with all 9
//     taps of each c: 64 x 144 f32 accumulators over 4 warps (2 x 32 f, 2 x
//     8 c; 72 registers a thread).  An n8 tile of the mma is 8 channels of
//     one tap, so each x value staged in shared memory serves all 9 taps.
//   - One pipeline step is 64 pixels of one image (a step never straddles
//     two images; the plane's tail is zero-filled and its empty 16-pixel
//     slices are skipped).  A step stages dy (64 f x 64 pixels) and, for
//     each c and kh, a window of x from pixel p0 + (kh-1)*W - 1 on, zero
//     outside the image plane: the rows above and below come from the
//     plane itself, so smem does not grow with W.
//   - Tap fragments: output pixel p and tap (kh, kw) read window element
//     p + kw.  The shift by kw breaks the 16-byte alignment ldmatrix
//     needs, so each thread reads its 4 window elements p .. p+3 with
//     16-bit ld.shared and forms the pairs of all three kw from them (4
//     loads for 3 taps), masking kw = 0 at the image's left column and
//     kw = 2 at its right one (a per-pixel table staged with the step).
//     Rows are 176 bytes apart, so the 8 channels of a warp's loads fall on
//     distinct banks.
//   - Copies: a window starts at an arbitrary pixel, so it is rounded down
//     to the copy width and the fragment reads carry the remainder.  The
//     width is chosen per launch: 16-byte cp.async where H*W % 8 == 0
//     (stages 1, 2), 8 bytes where % 4 == 0 (stage 3), each also limited by
//     the alignment of the x and dy pointers.  A chunk of the width lies
//     wholly inside or wholly outside a plane, so out-of-plane chunks are
//     zero-filled whole (cp.async's src-size 0).  Where neither fits (H*W %
//     4 != 0, as at stage 4's 7x7 = 49, or a pointer less than 8-byte
//     aligned), a first kernel copies x and dy into planes padded to a
//     multiple of 8 elements (two launches, 27.5 MB of traffic at stage 4)
//     and the GEMM runs on those with 16-byte copies: cp.async has no 2-byte
//     form, and 2-byte loads through registers left every step waiting on
//     some 57 round trips to memory (1.15 ms at stage 4).
// ptxas (sm_90a, CUDA 12.8): 141 registers for each copy width, no spills,
// 53,184 bytes of dynamic shared memory (3 stages of 17,728); registers
// hold it to 3 blocks an SM (12 warps).  The repack kernel and the ordered
// reduction are small; the f32 instance takes 64 registers and 8,320
// bytes of shared memory, no spills.
//
// f32 instance: a SIMT implicit GEMM (tensor cores
// take f32 only as TF32, which would change the numbers).  Block (kx, fy,
// split) owns a 64 x 64 tile of (channels f x taps k = c*9 + kh*3 + kw)
// and a chunk of rows of N*H*W; for each step of 16 rows it stages dy and
// the im2col of x in shared memory as f32, and each thread accumulates a
// 4 x 4 sub-tile with f32 FMAs.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// f32 instance (SIMT)
// ---------------------------------------------------------------------------

constexpr int kTileF = 64;   // output channels per block
constexpr int kTileK = 64;   // taps per block
constexpr int kTileR = 16;   // rows of M per shared-memory step
constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kThreads)
    filter_grad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
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
      if (row_ok && f < F) v = dy[(static_cast<size_t>(n) * F + f) * HW + p];
      dy_tile[ld_row][ld_col + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = 0.f;
      const int hh = h + tap_dh[r];
      const int ww = w + tap_dw[r];
      if (row_ok && tap_ok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = x[(static_cast<size_t>(n) * C + tap_c[r]) * HW + hh * W + ww];
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

int reduce_splits(void* part, void* dw, int splits, int outputs, cudaStream_t stream) {
  reduce_splits_kernel<<<(outputs + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, outputs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 instance (tensor cores)
// ---------------------------------------------------------------------------

constexpr int kTcF = 64;          // output channels per block
constexpr int kTcC = 16;          // input channels per block (x 9 taps = 144 columns)
constexpr int kStep = 64;         // pixels of one image per pipeline step
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kTcThreads = 128;   // 4 warps: 2 (32 f each) x 2 (8 c each)
constexpr int kDyPitch = kStep + 8;  // 144-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kXPitch = 88;          // 176-byte rows: 44 words = 12 mod 32 banks
constexpr int kDyElems = kTcF * kDyPitch;
constexpr int kXElems = kTcC * 3 * kXPitch;
constexpr int kStageBytes = (kDyElems + kXElems) * 2 + kStep;  // + the edge table
constexpr int kTcSmem = kStages * kStageBytes;
static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");

// Window length for copy width VEC: element p + 3 (p <= kStep - 2) past a
// start rounded down by up to VEC - 1, rounded up to whole chunks.
template <int VEC>
__host__ __device__ constexpr int window_len() { return (kStep + VEC + 1 + VEC - 1) / VEC * VEC; }
static_assert(window_len<8>() <= kXPitch, "x window exceeds its row");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// VEC bf16 elements from src to dst, or zeros when !ok (src is then not read).
template <int VEC>
__device__ __forceinline__ void copy_chunk(uint16_t* dst, const uint16_t* src, bool ok) {
  static_assert(VEC == 4 || VEC == 8, "cp.async copies 8 or 16 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(VEC * 2), "r"(ok ? VEC * 2 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (cx, fy, split) owns channels f0 .. f0+63, c0 .. c0+15 (all 9 taps)
// and the pipeline steps [split * chunk, (split + 1) * chunk) of the
// N * ceil(H*W / 64) steps, image by image.  Planes of H*W pixels lie
// `pitch` elements apart (H*W, or more in a repacked copy).
template <int VEC>
__global__ void __launch_bounds__(kTcThreads, 3)
    filter_grad_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
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
      copy_chunk<VEC>(dys + r * kDyPitch + q, src, ok);
    }
    constexpr int x_row_chunks = window_len<VEC>() / VEC;
    for (int i = tid; i < kTcC * 3 * x_row_chunks; i += kTcThreads) {
      const int row = i / x_row_chunks;  // c * 3 + kh
      const int q = (i - row * x_row_chunks) * VEC;
      const int cl = row / 3;
      const int kh = row - cl * 3;
      const int c = c0 + cl;
      const int pix = ((p0 + (kh - 1) * W - 1) & ~(VEC - 1)) + q;
      const bool ok = c < C && pix >= 0 && pix < HW;
      const uint16_t* src = ok ? x + (static_cast<size_t>(n) * C + c) * pitch + pix : x;
      copy_chunk<VEC>(xs + row * kXPitch + q, src, ok);
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
int launch_bf16(const void* x, const void* dy, void* part, int N, int C, int H, int W,
                int F, int splits, int chunk, int pitch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(filter_grad_bf16_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kTcC - 1) / kTcC, (F + kTcF - 1) / kTcF, splits);
  filter_grad_bf16_kernel<VEC><<<grid, kTcThreads, kTcSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
      static_cast<float*>(part), N, C, H, W, F, chunk, pitch);
  return static_cast<int>(cudaGetLastError());
}

// out[plane, p] = in[plane, p] for p < HW, 0 up to pitch: planes padded to
// a multiple of 8 elements, for operands no cp.async width fits.
__global__ void __launch_bounds__(256)
    pad_planes_kernel(const uint16_t* __restrict__ in, uint16_t* __restrict__ out,
                      long long planes, int HW, int pitch) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= planes * pitch) return;
  const long long plane = i / pitch;
  const int p = static_cast<int>(i - plane * pitch);
  out[i] = p < HW ? in[plane * HW + p] : static_cast<uint16_t>(0);
}

int pad_planes(const void* in, void* out, long long planes, int HW, int pitch,
               cudaStream_t stream) {
  const long long total = planes * pitch;
  pad_planes_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out), planes, HW, pitch);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy (in bf16 elements, 8 or 4) that keeps every chunk inside
// one plane and aligned: H*W and both pointers must be multiples of it.  1
// means neither fits (H*W % 4 != 0, or a pointer less than 8-byte aligned):
// the operands are then repacked into planes padded to a multiple of 8.
int copy_width(const void* x, const void* dy, int HW) {
  const auto px = reinterpret_cast<uintptr_t>(x);
  const auto pd = reinterpret_cast<uintptr_t>(dy);
  for (int vec = 8; vec >= 4; vec /= 2)
    if (HW % vec == 0 && px % (2 * vec) == 0 && pd % (2 * vec) == 0) return vec;
  return 1;
}

int padded_pitch(int HW) { return (HW + 7) / 8 * 8; }

// Blocks of the bf16 kernel resident at once on the current device (SMs x
// blocks an SM), or 0 if the device cannot be queried; read once a device.
long long resident_bf16_blocks() {
  static long long cached[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] > 0) return cached[dev];
  const auto kernel = filter_grad_bf16_kernel<8>;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, kTcSmem) !=
          cudaSuccess)
    return 0;
  cached[dev] = static_cast<long long>(sms) * per_sm;
  return cached[dev];
}

}  // namespace

extern "C" {

// How conv3x3_filter_grad splits its contraction: returns the number of
// splits and writes the work of each to *chunk: rows of N*H*W for f32 (a
// multiple of 16), pipeline steps of 64 pixels of one image for bf16; the
// last split may be shorter.
//
// f32: enough splits that the grid has about 1,024 blocks, but none shorter
// than 512 rows, whose partial tile would cost more to write and add than
// to compute.
//
// bf16: the split count s that minimizes an estimate of the time in units
// of one block's pipeline step: the waves of blocks (as many resident at
// once as the current device's SMs times the blocks an SM holds, 3 x 132
// on an H100 SXM) times the steps of a split, plus writing and re-reading
// the s partial tiles.  A step costs about 3.4 us at 3 blocks an SM on an
// H100 (0.215 ms for 64 steps a block at the 56x56x64 stage, chip_smoke.py
// phase 4), the time to move 1.4 M partial floats (8 bytes each, 3.35
// TB/s): that ratio is the one constant fitted to the card.  This keeps the
// grid from spilling a few blocks into a second wave.  Returns -1 if the
// device cannot be queried.
int conv3x3_filter_grad_splits(int N, int C, int H, int W, int F, int is_bf16, int* chunk) {
  long long splits, each;
  if (is_bf16) {
    const long long slots = resident_bf16_blocks();
    if (slots <= 0) return -1;
    constexpr double kStepsPerPartial = 1.0 / 1.4e6;
    const long long work =
        static_cast<long long>(N) * ((static_cast<long long>(H) * W + kStep - 1) / kStep);
    const long long tiles = static_cast<long long>((C + kTcC - 1) / kTcC) * ((F + kTcF - 1) / kTcF);
    const double partial = static_cast<double>(F) * 9 * C * kStepsPerPartial;
    const long long most = 8 * ((slots + tiles - 1) / tiles);
    splits = 1;
    double best = -1.0;
    for (long long s = 1; s <= most && s <= work; ++s) {
      const long long waves = (tiles * s + slots - 1) / slots;
      const double cost = static_cast<double>(waves * ((work + s - 1) / s)) + s * partial;
      if (best < 0 || cost < best) {
        best = cost;
        splits = s;
      }
    }
    each = (work + splits - 1) / splits;
    *chunk = static_cast<int>(each);
    return static_cast<int>((work + each - 1) / each);
  }
  constexpr long long kTargetBlocks = 1024;  // about 8 for each of 132 SMs
  constexpr long long kMinRowsPerSplit = 512;
  const long long work = static_cast<long long>(N) * H * W;
  const long long tiles =
      static_cast<long long>((C * 9 + kTileK - 1) / kTileK) * ((F + kTileF - 1) / kTileF);
  splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (work + kMinRowsPerSplit - 1) / kMinRowsPerSplit;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  each = (work + splits - 1) / splits;
  each = (each + kTileR - 1) / kTileR * kTileR;
  *chunk = static_cast<int>(each);
  return static_cast<int>((work + each - 1) / each);
}

// Elements of bf16 scratch that conv3x3_filter_grad needs for these bf16
// operands: N * (C + F) padded planes when no copy width fits, else 0.
long long conv3x3_filter_grad_scratch(const void* x, const void* dy, int N, int C, int H,
                                      int W, int F) {
  if (copy_width(x, dy, H * W) > 1) return 0;
  return static_cast<long long>(N) * (C + F) * padded_pitch(H * W);
}

// dw[F, C, 3, 3] (f32) from x[N, C, H, W] and dy[N, F, H, W], both bf16
// (tensor-core instance) when is_bf16, else f32 (SIMT instance).  The work
// is split as conv3x3_filter_grad_splits gives it for the same dtype; part
// is f32 scratch of splits x F x 9C; scratch holds the bf16 elements that
// conv3x3_filter_grad_scratch asks for (or is null when it asks for none).
int conv3x3_filter_grad(const void* x, const void* dy, void* part, void* dw,
                        int N, int C, int H, int W, int F, int splits,
                        int chunk, int is_bf16, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (is_bf16) {
    const int HW = H * W;
    switch (copy_width(x, dy, HW)) {
      case 8: err = launch_bf16<8>(x, dy, part, N, C, H, W, F, splits, chunk, HW, st); break;
      case 4: err = launch_bf16<4>(x, dy, part, N, C, H, W, F, splits, chunk, HW, st); break;
      default: {
        if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const int pitch = padded_pitch(HW);
        uint16_t* xp = static_cast<uint16_t*>(scratch);
        uint16_t* dyp = xp + static_cast<size_t>(N) * C * pitch;
        err = pad_planes(x, xp, static_cast<long long>(N) * C, HW, pitch, st);
        if (err == 0) err = pad_planes(dy, dyp, static_cast<long long>(N) * F, HW, pitch, st);
        if (err == 0)
          err = launch_bf16<8>(xp, dyp, part, N, C, H, W, F, splits, chunk, pitch, st);
      }
    }
  } else {
    const dim3 grid((C * 9 + kTileK - 1) / kTileK, (F + kTileF - 1) / kTileF, splits);
    filter_grad_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(part), N, C, H, W, F, chunk);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  return reduce_splits(part, dw, splits, F * C * 9, st);
}

// The copy width, in bf16 elements, that the bf16 instance takes for these
// operands (8, 4, or 1 for the repack), so that a caller can see which path
// ran.
int conv3x3_filter_grad_copy_width(const void* x, const void* dy, int H, int W) {
  return copy_width(x, dy, H * W);
}

}  // extern "C"
