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
// bf16 instance: Hopper's warpgroup MMA, wgmma.mma_async m64nNk16 (bf16 in,
// f32 accumulate; bf16 products are exact in f32), A from registers, B from
// shared memory, both operands staged by the TMA copy engine.
//   - Operands: pixels are M, output channels N, K a chunk's 16 input
//     channels at one tap: D (64 pixels x N f) += X (64 x 16) W^T, 9 wgmma
//     a chunk.  x is A, in registers, because a tap that wraps across the
//     image's left or right edge must contribute nothing and a descriptor
//     can mask nothing: each lane's ldmatrix row is one pixel's 16 channels
//     at the tap, or a row of zeros where the tap wraps.  The weight has no
//     pixel dimension, so it is B, behind a K-major descriptor.
//   - Block: two warpgroups (kWgs), each over one pipeline step of
//     conv3x3_common.cuh (64 pixels of one image; consecutive steps, the
//     last block's second warpgroup idle where their count is odd), sharing
//     each weight slice of N output channels: N = 64 where F <= 64, else 128.
//     A block runs the whole K = 9C itself (no split-K), so y and each
//     step's partial statistics come out of its registers.  Grid ceil(F / N)
//     x ceil(steps / 2): 3,136 blocks at the 56x56x64 stage, 256 at 7x7x512;
//     2 blocks an SM.
//   - The weight: permuted once a call by a small kernel into slices, one a
//     (f tile, chunk), each N x 144 contiguous elements in core-matrix order
//     ([tap][c / 8][f / 8][8 f][8 c]: 8 f x 16 bytes, 128 contiguous bytes),
//     so a tap's B is the slice with the descriptor started tap * N * 32
//     bytes in.  One thread stages a slice with one cp.async.bulk (the TMA
//     engine without a tensor map) into a ring of 2, on an mbarrier.
//   - x: a tensor map over x as (H*W pixels, C, B), boxes of 80 pixels x 16
//     channels.  For each kh, lane 0 of warp kh + 1 copies the chunk's window
//     from plane pixel p0 + (kh - 1) W - 1 rounded down to a multiple of 8 (a
//     tensor copy's innermost coordinate must be a multiple of 16 bytes: any
//     other stopped the kernel with an illegal instruction), on the
//     warpgroup's mbarrier.  Pixels outside the plane land as zeros, so no
//     thread computes the zero fill.  The tensor's strides must be multiples
//     of 16 bytes: where H*W % 8 != 0 or x is not 16-byte aligned, a first
//     kernel repacks x into planes padded to 8 elements (stage 3's 196 and
//     stage 4's 49 pixels at 224 px).  The warps then transpose the windows
//     to [kh][pixel][c] (48-byte rows, conflict-free for ldmatrix) in 8 x 8
//     blocks: ldmatrix.trans reads a block into the fragments of its
//     transpose, stmatrix writes those as rows.
//   - A chunk: wait for x(i), barrier, issue weight(i + 1), transpose,
//     barrier, issue x(i + 1), wait for weight(i); then for each kh the 3
//     taps' A fragments (ldmatrix), wgmma.fence, 3 wgmma, a commit group;
//     the third group reuses the first's registers after wgmma.wait_group 1,
//     and wgmma.wait_group 0 closes the chunk.
//   - Epilogue: round D to bf16, stage it through shared memory as [f][pixel]
//     and write each f's 64 pixels as a row (16-, 8-, 4- or 2-byte stores as
//     the plane and the pointer allow, neighbouring lanes on neighbouring
//     pixels); sum the rounded values and their squares per column: a
//     thread's 2 rows, the 8 lanes of a column (three shuffle levels, each
//     halving the values a lane holds), the warpgroup's 4 warps in order,
//     into the step's row of the partials.
//   - The wgmma on its own: conv_wgmma_selftest_kernel (C entry
//     conv3x3_bn_stats_wgmma_selftest), one m64nNk16 with register A and the
//     weight slice's descriptor started at a tap, at N = 64 and 128.
//   - Where the cycles go (conv_clocks.py: clock64() counters in thread 0 of
//     three blocks, the 56x56x64 and 14x14x256 stages at batch 128; H100
//     80GB HBM3 at 700 W; PERF.md).  The mma.sync instance it replaces
//     (M = 64 f, N = 64 pixels, 4 warps, every thread issuing cp.async
//     copies of both operands, the weight again for every chunk; read in
//     the same way with marks in its own source, which went with it): issuing
//     the copies 42-44% of a block's cycles at 56x56x64 and 59-61% at
//     14x14x256, the mma about 20%, the transpose 8-11%, ldmatrix 5-7%.
//     This kernel: at 14x14x256 the transpose 30-33% and the products 28-29%
//     (and 8% waiting for them), the copies' issue 9-12%, the wait for x
//     7%; at 56x56x64 (4 chunks a block) the products 22-23%, the transpose
//     17-24%, the wait for the first windows 16-18%, the epilogue 13-17%.
//     The transpose is 4 ldmatrix.trans and 4 stmatrix a warp a chunk, so
//     its share is most likely waiting on shared memory, which the wgmmas'
//     B reads, the copies and the transposes share (not measured: no
//     profiler counters on that machine).
//   - Tried on an H100 in temporary variants, each timed beside the others
//     in one call (ResNet-50 step sums at 224 / 448 px; the mma.sync
//     instance 4.33-4.40 / 2.95-2.97 ms in the same calls):
//       - x staged with cp.async as in the mma.sync instance (16- or 8-byte
//         copies by every thread), weight by cp.async.bulk, one block an SM
//         (148 registers): 3.16 / 2.34; with 2 blocks an SM (128 registers):
//         2.66-2.73 / 2.14-2.17; the copies' issue then took 34-46% of a
//         block's cycles at 14x14x256;
//       - one warpgroup a block: 2.80-2.85 / 2.08-2.11 with cp.async x,
//         2.24 / 1.60 with the tensor copies (the weight staged once for
//         every 64 pixels, not 128);
//       - N = 64 for every F: 3.28 / 2.25;
//       - all 9 taps' A fragments loaded before the first wgmma (36
//         registers, not 24): 2.66 / 2.14 against 2.59 / 2.00;
//       - the tensor copies for x: 2.07 / 1.48 against 2.61 / 1.97 (cp.async);
//         1 block an SM (156 registers): 2.40 / 1.71;
//       - the transpose with 32-bit loads and byte permutes (8 loads, 2
//         16-byte stores for 8 channels at 2 pixels), and y stored 16 bytes
//         or 2 at a time: 2.04 / 1.49 against 1.86 / 1.44 for ldmatrix.trans
//         + stmatrix and stores by alignment;
//       - the weight copy split into 8 pieces issued by lane 0 of each warp:
//         1.94 / 1.52 against 1.85 / 1.45;
//       - two x window slots a warpgroup where N = 64 (the windows of chunk
//         i + 2 in flight during chunk i): 1.85 / 1.44 against 1.87 / 1.44,
//         no gain beside the noise;
//       - 3 blocks an SM at N = 64: ptxas serialized the wgmmas for want of
//         registers (C7512), not timed.
//     Stages 3-4 still compute about a quarter of padding: 196 = 3 x 64 + 4
//     pixels, and 49 of 64.
//
// f32 instance: a warp-level tensor-core GEMM, 3xTF32 on mma.sync m16n8k8
// (TF32 in, f32 accumulate; the split and the mma in conv3x3_common.cuh):
// three TF32 products for each f32-exact one.  M = output channels f, N =
// pixels, K = 9C, fed by a 2-stage cp.async ring.
//   - A block owns 64 f (4 warps, 3 blocks an SM) or, where F >= 128, 128 f
//     (8 warps, 2 blocks an SM) x one pipeline step of conv3x3_common.cuh
//     (64 pixels of one image), each warp 32 f x 32 pixels, and runs the
//     whole K = 9C itself in chunks of 8 input channels x 9 taps (one tap is
//     one k8 slice).  The 128 f block stages and transposes each x window
//     for twice the outputs: 7-8% faster than the 64 f block at the
//     ResNet-50 stages 2-4 (below).  Each output is the same sum in the same
//     order in either.  The grid is ceil(F / FT) x B * ceil(H*W / 64).
//   - The weight is permuted once a call to wp[f][c / 8][kh, kw][c % 8] and
//     staged for each chunk with 16-byte cp.async.  x: the chunk's windows
//     (8 c x 3 kh, from plane pixel p0 + (kh - 1) W - 1 on, zero outside
//     the plane) staged with cp.async in NCHW order and transposed once a
//     chunk in shared memory to [kh][pixel][c]: an n8 x k8 B fragment is 8
//     pixels x 8 channels at a fixed tap, ldmatrix takes one row address per
//     pixel, so the shift by kw costs nothing, and a tap that wraps across
//     the image's left or right edge points its row at a row of zeros.
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
//   - Epilogue: y as f32 (64-bit stores of pixel pairs), and the sums of y
//     and y^2 per channel: 8 a thread in order, then across the 4 lanes of
//     a row (__shfl_xor_sync 1, 2), then the block's two pixel halves
//     through shared memory, into per-step partials.
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
// SAME padding's zeros.  Only the windows that reach outside x's plane read
// them, element by element: in f32 the window chunks staged with cp.async
// (stage_x_chunk in conv3x3_common.cuh), in bf16 the kh = 0 and kh = 2
// windows, whose elements outside the plane the tensor copy landed as zeros
// (patch_halo).  x's planes keep the copy width chosen for them, and a null
// pointer leaves every path as it was.  y and the partial sums cover x's own
// H rows; each pixel's products are summed in the same order as in a launch
// on the whole image, so y is the same, bit for bit (chip_smoke.py phase
// 17a).
//
// ptxas (sm_90a, CUDA 12.9): the bf16 kernel at N = 128 128 registers (its
// bound for 2 blocks of 256 threads an SM), 28 bytes of spills, 112,208
// bytes of dynamic shared memory (the ring of 2 weight slices, 73,728; each
// warpgroup's windows, 7,680 as copied and 11,520 transposed; a zero row;
// 4 mbarriers); at N = 64 119 registers, no spills, 75,344 bytes; 2 blocks
// an SM either way; its self-test 94 and 62 registers; the f32 kernel with 64 f 155
// registers, no spills, 71,120 bytes (2 stages of 26,368, the split
// windows of 17,280), 3 blocks an SM; with 128 f 128 registers (its bound
// for 2 blocks of 256 threads an SM), 56-64 bytes of spills, 111,056
// bytes; the weight permutation, the repack 16; the second pass 32
// registers and 8,448 bytes.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;

constexpr int kTcStages = 2;         // depth of the f32 instance's cp.async ring
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
// bf16 instance: warpgroup MMA (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcC = 16;             // input channels per K chunk: one wgmma's K at each tap
constexpr int kTcK = kTcC * 9;       // K values per chunk
constexpr int kXBox = 80;            // pixels of an x window: 66 read past a start rounded down to 8
constexpr int kRawElems = 3 * kTcC * kXBox;  // x as the copy lands it, [kh][c][pixel]
constexpr int kTPitch = kTcC + 8;    // transposed rows [kh][pixel][c], 48 bytes: ldmatrix conflict-free
constexpr int kTElems = 3 * kXBox * kTPitch;
constexpr int kYPitch = kStep + 8;   // the staged output tile's rows [f][pixel], 144 bytes

// The weight slice of one (f tile, chunk) as B of the wgmmas: NT f x 16
// channels at each of the 9 taps, K-major without swizzle, as core matrices
// of 8 f x 8 channels (128 contiguous bytes), [tap][c / 8][f / 8][f % 8][c % 8].
// A tap's B starts tap * NT * 32 bytes in; the leading byte offset (the
// second 8 channels) is NT * 16 bytes, the stride byte offset (the next 8 f)
// 128.
__host__ __device__ constexpr int b_offset(int tap, int f, int c, int nt) {
  return ((tap * 2 + c / 8) * (nt / 8) + f / 8) * 64 + (f % 8) * 8 + c % 8;
}

// The type of a store of V bf16 elements.
template <int V>
struct VecOf;
template <>
struct VecOf<8> {
  using type = uint4;
};
template <>
struct VecOf<4> {
  using type = uint2;
};
template <>
struct VecOf<2> {
  using type = unsigned;
};
template <>
struct VecOf<1> {
  using type = uint16_t;
};

// m64nNk16, bf16 in, f32 sums: d += a (64 x 16, registers) * b (16 x N,
// K-major, descriptor).
template <int N>
struct ConvWgmma;

template <>
struct ConvWgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct ConvWgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// kWgs warpgroups a block, each over one pipeline step (64 pixels of one
// image), sharing the weight slices of NT output channels: two halve the
// weight's copies per output against one (the head comment has the
// timings).  Shared memory: a ring of 2 weight slices, each warpgroup's x
// windows as copied and transposed, a zero row, the mbarriers (the ring's 2,
// one a warpgroup for x).  After the last chunk the ring holds the staged
// output tiles and the transposed windows the warps' column sums.
constexpr int kWgs = 2;
template <int NT>
struct WgConv {
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kWBytes = NT * kTcK * 2;
  static constexpr int kRawOff = 2 * kWBytes;
  static constexpr int kXtOff = kRawOff + kWgs * kRawElems * 2;
  static constexpr int kZeroOff = kXtOff + kWgs * kTElems * 2;
  static constexpr int kBarOff = kZeroOff + kTPitch * 2;
  static constexpr int kSmem = kBarOff + (2 + kWgs) * 8;
  static_assert(kWBytes % 128 == 0 && kRawOff % 128 == 0 && (kTcC * kXBox * 2) % 128 == 0 &&
                    kXtOff % 16 == 0 && kZeroOff % 16 == 0 && kBarOff % 8 == 0,
                "shared memory alignment");
  static_assert(kWgs * NT * kYPitch * 2 <= kRawOff, "the output tiles must fit the ring");
  static_assert(kWgs * 4 * 2 * NT * 4 <= kWgs * kTElems * 2, "the column sums must fit");
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void stmatrix_x4(void* p, const unsigned (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// One level of reduce_over_g: each lane keeps the half of its values that
// its MASK bit selects and adds its partner's copy of that half.
template <int HALF, int MASK, int M>
__device__ __forceinline__ void reduce_level(float (&v)[M], int lane) {
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float lo = v[i], hi = v[i + HALF];
    const float send = upper ? lo : hi;
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

// Sums each of the M values of this lane with those of the 8 lanes that
// share its tig (lane & 3) in a fixed tree, halving the values held at each
// of the three levels (xor 16, 8, 4): lane g = lane >> 2 ends with values
// base .. base + M / 8 - 1 in v[0 ..], base = (g >> 2) M / 2 + ((g >> 1) &
// 1) M / 4 + (g & 1) M / 8, each the sum over the 8 lanes.
template <int M>
__device__ __forceinline__ void reduce_over_g(float (&v)[M], int lane) {
  reduce_level<M / 2, 16>(v, lane);
  reduce_level<M / 4, 8>(v, lane);
  reduce_level<M / 8, 4>(v, lane);
}

// Block (f tile, step group) of a 1-D grid: f tile = blockIdx.x % ceil(F /
// NT), warpgroup wg owns step t = (blockIdx.x / ceil(F / NT)) * kWgs + wg of
// the B * ceil(H*W / 64) steps, so the blocks of one step are neighbours and
// share its x windows in L2.  xmap is x (or its repacked copy) as a tensor
// of (H*W pixels, C, B); wp holds the weight slices, [f tile][chunk].
template <int NT>
__global__ void __launch_bounds__(128 * kWgs, 2)
    conv3x3_stats_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                               const uint16_t* __restrict__ top,
                               const uint16_t* __restrict__ bottom,
                               const uint16_t* __restrict__ wp, uint16_t* __restrict__ y,
                               float* __restrict__ part_s, float* __restrict__ part_ss, int C,
                               int H, int W, int F, int steps) {
  using L = WgConv<NT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;    // this warp's warpgroup
  const int wq = warp & 3;     // pixel rows 16 wq .. of its step
  const int wtid = tid & 127;  // thread within the warpgroup
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int f_tiles = (F + NT - 1) / NT;
  const int tile = blockIdx.x % f_tiles;
  const int f0 = tile * NT;
  const int t = (blockIdx.x / f_tiles) * kWgs + wg;
  const bool active = t < steps;  // the last block's second warpgroup may have none
  const int n = active ? t / per_image : 0;
  const int p0 = active ? (t - n * per_image) * kStep : 0;
  const int chunks = (C + kTcC - 1) / kTcC;

  CLOCKS_BEGIN
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem + L::kRawOff) + wg * kRawElems;
  uint16_t* xt = reinterpret_cast<uint16_t*>(smem + L::kXtOff) + wg * kTElems;
  uint16_t* zero_row = reinterpret_cast<uint16_t*>(smem + L::kZeroOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);  // 2 weight slots, then x
  uint64_t* xbar = bars + 2 + wg;
  const uint16_t* wslices = wp + static_cast<size_t>(tile) * chunks * (NT * kTcK);

  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 2 + kWgs; ++b) mbar_init(&bars[b], 1);
    mbar_init_fence();
  }
  if (tid < kTPitch / 8) reinterpret_cast<uint4*>(zero_row)[tid] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // The weight slice of chunk ch into ring slot ch % 2, by one thread.
  auto load_weight = [&](int ch) {
    if (tid == 0) {
      mbar_arrive_expect(&bars[ch & 1], L::kWBytes);
      bulk_load(smem + (ch & 1) * L::kWBytes, wslices + static_cast<size_t>(ch) * (NT * kTcK),
                L::kWBytes, &bars[ch & 1]);
    }
  };
  // The x windows of chunk ch: for each kh, channels ch * 16 .. + 15 at 80
  // plane pixels from first[kh] = p0 + (kh - 1) W - 1 rounded down to a
  // multiple of 8 (a tensor copy starts on 16 bytes).  Lane 0 of warp kh + 1
  // of the warpgroup copies window kh (the first also sets the bytes the
  // barrier waits for), so the three issue side by side.
  int first[3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) first[kh] = (p0 + (kh - 1) * W - 1) & ~7;
  auto load_x = [&](int ch) {
    if (lane == 0 && wq >= 1 && active) {
      const int kh = wq - 1;
      if (kh == 0) mbar_arrive_expect(xbar, kRawElems * 2);
      tma_load_3d(raw + kh * kTcC * kXBox, &xmap, first[kh], ch * kTcC, n, xbar);
    }
  };
  // Halo rows: window elements of rows -1 and H come from top and bottom
  // (the copy landed zeros there), element by element, where given.
  auto patch_halo = [&](int ch) {
    const uint16_t* rows[2] = {top, bottom};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int kh = side * 2;
      const int lo = side == 0 ? -W : HW;  // the halo row's pixels lo .. lo + W - 1
      if (rows[side] == nullptr || first[kh] + kXBox <= lo || first[kh] >= lo + W) continue;
      for (int i = wtid; i < kTcC * kXBox; i += 128) {
        const int cl = i / kXBox;
        const int k = first[kh] + i - cl * kXBox - lo;  // column in the halo row
        const int c = ch * kTcC + cl;
        if (k >= 0 && k < W && c < C)
          raw[kh * kTcC * kXBox + i] = rows[side][(static_cast<size_t>(n) * C + c) * W + k];
      }
    }
  };
  // raw[kh][cl][q] -> xt[kh][q][cl] in 8 x 8 blocks (8 channels x 8
  // pixels): ldmatrix.trans reads 4 blocks into the fragments of their
  // transposes, stmatrix writes those as rows of 8 channels.  A warp's unit
  // is the 2 channel halves x 2 pixel blocks of one kh: 15 units, 80 pixels.
  auto transpose = [&]() {
    const int j = lane & 7;  // the row this lane addresses in its block
    const int m = lane >> 3;  // its block: channel half m >> 1, pixel block m & 1
    for (int u = wq; u < 3 * kXBox / 16; u += 4) {
      const int kh = u / (kXBox / 16);
      const int pb = (u - kh * (kXBox / 16)) * 2 + (m & 1);
      const int ch = (m >> 1) * 8;
      unsigned f[4];
      ldmatrix_x4_trans(f, raw + (kh * kTcC + ch + j) * kXBox + pb * 8);
      stmatrix_x4(xt + (kh * kXBox + pb * 8 + j) * kTPitch + ch, f);
    }
  };

  // This lane's ldmatrix row of A: pixel r of the step (row lane & 15 of
  // the warp's 16), channels c_off .. + 7; at tap (kh, kw) the transposed
  // window's row r + kw + the window start's rounding, or the zero row where
  // the tap wraps across the image's left or right edge.
  const int r = wq * 16 + (lane & 15);
  const int c_off = (lane >> 4) * 8;
  const int col = (p0 + r) % W;
  const bool has_left = col >= 1, has_right = col <= W - 2;
  const uint16_t* row_at[3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
    row_at[kh] = xt + (kh * kXBox + r + p0 + (kh - 1) * W - 1 - first[kh]) * kTPitch + c_off;
  const uint16_t* zero_at = zero_row + c_off;

  float acc[NT / 2];
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;

  CLOCK_MARK(1)
  load_weight(0);
  load_x(0);
  CLOCK_MARK(3)
  for (int i = 0; i < chunks; ++i) {
    if (active) mbar_wait(xbar, i & 1);
    CLOCK_MARK(4)
    if (top != nullptr || bottom != nullptr) patch_halo(i);
    __syncthreads();  // x(i) is whole; xt is free; slot (i + 1) % 2's wgmmas are done
    CLOCK_MARK(2)
    if (i + 1 < chunks) load_weight(i + 1);
    CLOCK_MARK(3)
    transpose();
    CLOCK_MARK(5)
    __syncthreads();  // xt is whole; raw is free
    CLOCK_MARK(2)
    if (i + 1 < chunks) load_x(i + 1);
    CLOCK_MARK(3)

    // 9 wgmma, one a tap, in three groups of one kh: each group's A
    // fragments are loaded while the previous group's products run; the
    // third reuses the first's registers once its products are done.
    mbar_wait(&bars[i & 1], (i >> 1) & 1);
    CLOCK_MARK(6)
    const uint64_t desc = smem_desc(smem + (i & 1) * L::kWBytes, NT * 16, 128);
    unsigned a[2][3][4];
    fence_operands(acc);
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      if (kh == 2) wgmma_wait<1>();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const bool ok = kw == 1 || (kw == 0 ? has_left : has_right);
        ldmatrix_x4(a[kh & 1][kw], ok ? row_at[kh] + kw * kTPitch : zero_at);
      }
      wgmma_fence();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        ConvWgmma<NT>::mma(acc, a[kh & 1][kw],
                           desc + static_cast<uint64_t>((kh * 3 + kw) * NT * 2));
      wgmma_commit();
    }
    CLOCK_MARK(7)
    wgmma_wait<0>();
    fence_operands(acc);
    CLOCK_MARK(8)
  }
  __syncthreads();  // every warp is done with the ring and the transposed windows
  CLOCK_MARK(2)

  // Epilogue: y rounded to bf16 into the staged tile [f][pixel]; per-column
  // sums of the rounded values and their squares: the thread's two rows,
  // then the 8 lanes of a column (reduce_over_g), then the 4 warps in order.
  uint16_t* tile_y = reinterpret_cast<uint16_t*>(smem) + wg * NT * kYPitch;
  float* sums = reinterpret_cast<float*>(smem + L::kXtOff) + wg * 4 * 2 * NT;  // [wq][s, ss][NT]
  const int r0 = wq * 16 + g;
  const bool ok0 = active && p0 + r0 < HW, ok1 = active && p0 + r0 + 8 < HW;
  float s[NT / 4], ss[NT / 4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int fl = 8 * j + 2 * tig + e;
      const __nv_bfloat16 b0 = __float2bfloat16(acc[4 * j + e]);
      const __nv_bfloat16 b1 = __float2bfloat16(acc[4 * j + 2 + e]);
      tile_y[fl * kYPitch + r0] = __bfloat16_as_ushort(b0);
      tile_y[fl * kYPitch + r0 + 8] = __bfloat16_as_ushort(b1);
      const float v0 = ok0 ? __bfloat162float(b0) : 0.f;
      const float v1 = ok1 ? __bfloat162float(b1) : 0.f;
      s[2 * j + e] = v0 + v1;
      ss[2 * j + e] = fmaf(v1, v1, v0 * v0);
    }
  reduce_over_g(s, lane);
  reduce_over_g(ss, lane);
  {
    constexpr int M = NT / 4;
    const int base = (g >> 2) * (M / 2) + ((g >> 1) & 1) * (M / 4) + (g & 1) * (M / 8);
#pragma unroll
    for (int k = 0; k < M / 8; ++k) {
      const int m = base + k;
      const int fl = 8 * (m >> 1) + 2 * tig + (m & 1);
      sums[(wq * 2 + 0) * NT + fl] = s[k];
      sums[(wq * 2 + 1) * NT + fl] = ss[k];
    }
  }
  __syncthreads();
  CLOCK_MARK(9)
  if (!active) return;
  for (int fl = wtid; fl < NT; fl += 128) {
    if (f0 + fl >= F) break;
    const size_t at = static_cast<size_t>(t) * F + f0 + fl;
    part_s[at] = ((sums[0 * NT + fl] + sums[2 * NT + fl]) + sums[4 * NT + fl]) + sums[6 * NT + fl];
    part_ss[at] =
        ((sums[1 * NT + fl] + sums[3 * NT + fl]) + sums[5 * NT + fl]) + sums[7 * NT + fl];
  }
  // y: each f's 64 pixels are contiguous, written V elements a store, the
  // widest that the plane (H*W % V == 0) and the pointer allow, neighbouring
  // lanes on neighbouring pixels
  auto store_y = [&](auto width) {
    constexpr int V = decltype(width)::value;
    using Vec = typename VecOf<V>::type;
    constexpr int per_row = kStep / V;
    for (int i = wtid; i < NT * per_row; i += 128) {
      const int fl = i / per_row;
      const int q = (i - fl * per_row) * V;
      if (f0 + fl >= F || p0 + q >= HW) continue;
      *reinterpret_cast<Vec*>(y + (static_cast<size_t>(n) * F + f0 + fl) * HW + p0 + q) =
          *reinterpret_cast<const Vec*>(tile_y + fl * kYPitch + q);
    }
  };
  const auto y_at = reinterpret_cast<uintptr_t>(y);
  if (HW % 8 == 0 && y_at % 16 == 0)
    store_y(std::integral_constant<int, 8>{});
  else if (HW % 4 == 0 && y_at % 8 == 0)
    store_y(std::integral_constant<int, 4>{});
  else if (HW % 2 == 0 && y_at % 4 == 0)
    store_y(std::integral_constant<int, 2>{});
  else
    store_y(std::integral_constant<int, 1>{});
  CLOCK_MARK(10)
  CLOCKS_END
}

// Output channels a block of the bf16 instance: 64 where F <= 64 (one tile
// is all of F), else 128.
inline int bf16_tile(int F) { return F <= 64 ? 64 : 128; }

// x (planes `pitch` elements apart, a multiple of 8, 16-byte aligned) as a
// tensor of (H*W pixels, C, B) with boxes of 80 pixels x 16 channels: the
// pixels from H*W up to the pitch, like those before 0, lie outside it.
int x_tensor_map(CUtensorMap* map, const void* x, int B, int C, int HW, int pitch) {
  return tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, HW, C, B,
                       static_cast<long long>(pitch) * 2, static_cast<long long>(pitch) * C * 2,
                       kXBox, kTcC, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int NT>
int launch_bf16_tile(const CUtensorMap& xmap, const void* top, const void* bottom, const void* wp,
                     void* y, void* part_s, void* part_ss, int B, int C, int H, int W, int F,
                     cudaStream_t stream) {
  using L = WgConv<NT>;
  const auto kernel = conv3x3_stats_wgmma_kernel<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long steps = static_cast<long long>(B) * ((H * W + kStep - 1) / kStep);
  const long long blocks = (steps + kWgs - 1) / kWgs * ((F + NT - 1) / NT);
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kSmem, stream>>>(
      xmap, static_cast<const uint16_t*>(top), static_cast<const uint16_t*>(bottom),
      static_cast<const uint16_t*>(wp), static_cast<uint16_t*>(y), static_cast<float*>(part_s),
      static_cast<float*>(part_ss), C, H, W, F, static_cast<int>(steps));
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* top, const void* bottom, const void* wp, void* y,
                void* part_s, void* part_ss, int B, int C, int H, int W, int F, int pitch,
                cudaStream_t stream) {
  CUtensorMap xmap;
  const int err = x_tensor_map(&xmap, x, B, C, H * W, pitch);
  if (err != 0) return err;
  if (bf16_tile(F) == 64)
    return launch_bf16_tile<64>(xmap, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, stream);
  return launch_bf16_tile<128>(xmap, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, stream);
}

// wp[f tile][chunk][b_offset(tap, f % NT, c % 16, NT)] = wt[f][c][tap], 0
// past F and C: the weight slices, each NT * 144 contiguous elements.  A
// thread per element of wt padded to whole tiles and chunks, in wt's order.
__global__ void __launch_bounds__(256)
    permute_weights_bf16_kernel(const uint16_t* __restrict__ wt, uint16_t* __restrict__ wp,
                                int C, int F, int chunks, int nt) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_f = chunks * kTcK;  // (c, tap) of one f, C padded to whole chunks
  if (i >= static_cast<long long>((F + nt - 1) / nt) * nt * per_f) return;
  const int f = static_cast<int>(i / per_f);
  const int rem = static_cast<int>(i - static_cast<long long>(f) * per_f);
  const int c = rem / 9;
  const int tap = rem - c * 9;
  const size_t slice = static_cast<size_t>(f / nt) * chunks + c / kTcC;
  wp[slice * nt * kTcK + b_offset(tap, f % nt, c % kTcC, nt)] =
      f < F && c < C ? wt[(static_cast<size_t>(f) * C + c) * 9 + tap] : uint16_t(0);
}

long long bf16_weight_elems(int C, int F) {
  const int nt = bf16_tile(F);
  return static_cast<long long>((F + nt - 1) / nt) * nt * ((C + kTcC - 1) / kTcC) * kTcK;
}

int permute_weights_bf16(const void* wt, uint16_t* wp, int C, int F, cudaStream_t stream) {
  const long long elems = bf16_weight_elems(C, F);
  permute_weights_bf16_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint16_t*>(wt), wp, C, F, (C + kTcC - 1) / kTcC, bf16_tile(F));
  return static_cast<int>(cudaGetLastError());
}

// One wgmma as the kernel issues it: d (64 x N, f32) = a (64 x 16) times
// b[tap]^T, b (9, N, 16): a through shared memory rows of kTPitch and
// ldmatrix into registers, as the kernel loads x; b into the weight slice's
// layout, read through the descriptor started at the tap's offset.
template <int N>
__global__ void __launch_bounds__(128)
    conv_wgmma_selftest_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                               float* __restrict__ d, int tap) {
  __shared__ __align__(128) uint16_t bs[9 * N * kTcC];
  __shared__ __align__(16) uint16_t as[64 * kTPitch];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < 64 * kTcC; i += 128) as[(i / kTcC) * kTPitch + i % kTcC] = a[i];
  for (int i = tid; i < 9 * N * kTcC; i += 128) {
    const int c = i % kTcC, f = (i / kTcC) % N, k = i / (kTcC * N);
    bs[b_offset(k, f, c, N)] = b[i];
  }
  fence_proxy_async();
  __syncthreads();
  unsigned frag[4];
  ldmatrix_x4(frag, as + (warp * 16 + (lane & 15)) * kTPitch + (lane >> 4) * 8);
  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  fence_operands(acc);
  wgmma_fence();
  ConvWgmma<N>::mma(acc, frag, smem_desc(bs, N * 16, 128) + static_cast<uint64_t>(tap * N * 2));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    d[(warp * 16 + g + ((e >> 1) & 1) * 8) * N + (e >> 2) * 8 + tig * 2 + (e & 1)] = acc[e];
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

// Block (f tile, step t) of a 1-D grid: f tile = blockIdx.x % ceil(F / FT),
// t = blockIdx.x / ceil(F / FT), so the blocks of one step are neighbours
// and share its x windows in L2.  x planes lie `pitch` elements apart (H*W,
// or more in a repacked copy).  Chunks of 8 input channels (one m16n8k8
// slice a tap), FT output channels a block.
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

// Elements of the permuted weight: bf16 the weight slices (F rounded up to
// whole tiles of NT x ceil(C / 16) chunks x 144); f32 F x ceil(C / 8) chunks
// x 72.
long long permuted_weight_elems(int C, int F, bool bf16) {
  if (bf16) return bf16_weight_elems(C, F);
  return static_cast<long long>(F) * ((C + kF32C - 1) / kF32C) * kF32K;
}

// The copy width, in elements, that the instance takes for x: bf16 8 (the
// tensor copies need 16-byte planes), f32 4 or 2 (16- or 8-byte cp.async);
// 1 where none fits and x is repacked into padded planes.
int copy_width_of(const void* x, int HW, bool bf16) {
  if (bf16) return copy_width<2>(HW, x) == 8 ? 8 : 1;
  return copy_width<4>(HW, x);
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
// (bf16 8, f32 4 or 2, or 1 for the repack), so that a caller can see which
// path ran.
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
    err = permute_weights_bf16(wt, wp, C, F, st);
    if (err != 0) return err;
    if (copy_width_of(x, HW, true) == 8) {
      err = launch_bf16(x, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, HW, st);
    } else {
      uint16_t* xp = wp + w_elems;
      err = pad_planes<uint16_t>(x, xp, static_cast<long long>(B) * C, HW, pitch, st);
      if (err == 0) err = launch_bf16(xp, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, pitch, st);
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
  return is_bf16 ? "tensor cores: wgmma m64nNk16 bf16, 64 pixels x N f a warpgroup, N = 64 "
                   "where F <= 64, else 128, 2 warpgroups a block"
                 : "tensor cores: mma.sync m16n8k8 3xTF32";
}

// The bf16 instance's wgmma on its own (conv_wgmma_selftest_kernel): d (64
// x n, f32) = a (64 x 16) times b[tap]^T for b (9, n, 16), a and b bf16,
// row-major, contiguous; n is 64 or 128 (the instance's tiles) and 0 <=
// tap < 9, else cudaErrorInvalidValue.
int conv3x3_bn_stats_wgmma_selftest(const void* a, const void* b, void* d, int n, int tap,
                                    void* stream) {
  if (tap < 0 || tap >= 9) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint16_t*>(a);
  const auto* pb = static_cast<const uint16_t*>(b);
  if (n == 64)
    conv_wgmma_selftest_kernel<64><<<1, 128, 0, st>>>(pa, pb, static_cast<float*>(d), tap);
  else if (n == 128)
    conv_wgmma_selftest_kernel<128><<<1, 128, 0, st>>>(pa, pb, static_cast<float*>(d), tap);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
