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
// f32 instance: Hopper's warpgroup MMA with TF32 operands, wgmma.mma_async
// m64nNk8 (f32 accumulate), as 3xTF32 (the split in conv3x3_common.cuh):
// each f32 operand v is split into big = tf32(v) and small = v - big
// truncated to TF32, and each product is small * big + big * small + big *
// big, f32-exact to about 2^-20 relative.  The block is the bf16
// instance's: pixels as M, 64 a warpgroup, two warpgroups a block sharing
// each weight slice of N = 64 output channels where F <= 64, else 128; the
// whole K = 9C in the block, in chunks of 8 channels (one k8 slice a tap).
//   - x is A, in registers.  TF32 wgmma takes shared-memory operands
//     K-major only and a descriptor's start moves in 16-byte units, so a kw
//     shift of one pixel can live only in the register operand, which also
//     masks the taps that wrap across the image's left or right column.
//     Each thread loads its fragment in mma.sync m16n8k8's TF32 A layout
//     (a0 (row g, column t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t +
//     4); rows are pixels, columns channels) with plain 32-bit shared loads
//     straight from the windows as the tensor copies land them, [c][pixel]
//     in rows of 72 floats (72 t + g mod 32 puts the 32 lanes on 32 banks),
//     and splits it in registers: no transpose, which takes 17-33% of a
//     bf16 block.  A tap's fragment is loaded while the previous tap's three
//     wgmma run (wgmma.wait_group 1 frees the registers of the tap before).
//   - The weight is B, K-major without swizzle, in the bf16 instance's
//     slice layout at 32 bytes of K a row (slice_offset); a tap's B is the
//     descriptor started tap * N * 32 bytes in.  The permutation splits it
//     once a call, each slice's big parts then its small ones: every block
//     stages twice the weight's bytes but splits nothing.  Those bytes are
//     the most a call moves from L2: 9C x N x 8 a block (295 KB at the
//     56x56x64 stage), 0.92 GB over its 3,136 blocks beside x's windows'
//     0.35 GB, about 4 TB/s at 0.32 ms; four warpgroups sharing each slice
//     halve them and were slower (below), so L2 does not set the time.
//   - Accumulation: a y sums 9C <= 4,608 terms, and the tensor cores' own
//     sums truncate: all 4,608 summed there land 2.8-3.5e-5 of max |y| from
//     f64, past Y_OF_MAX = 1e-5 (conv_tf32_selftest_kernel, C entry
//     conv3x3_bn_stats_tf32_selftest, at N = 64 and 128).  So a chunk's 72
//     products (8 channels x 9 taps, 27 wgmma) go into a temporary from zero
//     (scale-d 0 at its first) and the running sums take them with one
//     rounded f32 add, C / 8 adds a y: 5.3-6.7e-7 (144 or 288 terms a flush:
//     0.9-1.2e-6 or 1.8-2.2e-6).  32 + 32 accumulator registers a thread at
//     N = 64, 64 + 64 at N = 128.
//   - Copies: thread 0 issues all of a chunk's copies onto its slot's
//     mbarrier, in a ring of 2 slots, one chunk ahead: the weight slice's
//     two parts by one cp.async.bulk, and each warpgroup's three x windows
//     by TMA tensor copies over x as (H*W pixels, C, B), boxes of 72 pixels
//     x 8 channels from plane pixel p0 + (kh - 1) W - 1 rounded down to 4
//     (a tensor copy's innermost coordinate must be a multiple of 16
//     bytes); pixels outside the plane land as zeros.  The tensor's strides
//     must be multiples of 16 bytes: where H*W % 4 != 0 or x is not 16-byte
//     aligned, x is first repacked into planes padded to 8 floats (stage
//     4's 49 pixels at 224 px).
//   - A chunk: wait for its slot, patch the halo rows, barrier, issue the
//     next chunk's copies, 9 taps of three wgmma, a commit group each,
//     wgmma.wait_group 0, the f32 add.
//   - Epilogue: the bf16 instance's (stage_tile, write_partials,
//     store_rows), without the rounding: y through shared memory in rows of
//     272 bytes, the same tree of sums.
//   - Where the cycles go (conv_clocks.py, thread 0 of three blocks,
//     56x56x64 and 14x14x256 at batch 128; H100 80GB HBM3, 700 W).  The
//     mma.sync instance this replaces (M = 64 or 128 f, N = 64 pixels,
//     every thread issuing cp.async copies of both operands, x transposed
//     and split once a chunk, the weight split in registers after ldmatrix;
//     read with marks in its own source, which went with it): the products
//     (ldmatrix, the weight's split and the mma in line) 52-66% of a
//     block's cycles, issuing the copies 27-35%, the transpose 5-7%.  This
//     kernel at 56x56x64 / 14x14x256: the products (A fragments, the wgmma
//     issue and the waits between taps) 44-50% / 57%, issuing the copies
//     27-28% / 26% (thread 0, whose warpgroup waits for it), waiting for the
//     last group 6% / 7%, for the copies 5% / 4%, the epilogue 5-6% / 3-4%.
//   - Tried on an H100 in temporary variants, each timed in one call beside
//     the others and the mma.sync instance (ResNet-50 step sums at 224 /
//     448 px; the mma.sync instance 12.0-13.1 / 8.7-10.0 ms in those calls,
//     this kernel 6.0-6.7 / 5.3-5.7):
//       - the weight split in place in every block once its copy lands (as
//         the f32 filter gradient splits dy), half the bytes: 6.9-7.0 /
//         5.9 against 6.4-6.5 / 5.3-5.5 in the same call (the split took
//         11-16% of a block's cycles);
//       - the next chunk's wait, halo rows and split moved under the
//         current chunk's wgmma: 8.1-8.4 / 6.8-6.9 against 6.8-6.9 /
//         5.6-5.8 (104 bytes of spills at N = 64);
//       - four warpgroups a block sharing each slice at N = 64, one block
//         an SM (half the weight's bytes a pixel): 7.0 / 6.0 against 6.1-
//         6.3 / 5.3; at F <= 64 only, 6.2-6.3 / 5.4; thread 0 then spends
//         42-52% of its cycles issuing 13 copies a chunk;
//       - three warpgroups a block at N = 128 (168 registers, 104-224 bytes
//         of spills): 7.5-7.6 / 5.4-5.5 against 6.4-6.5 / 5.3-5.5, faster
//         only at the 448-px stage 4 (0.39 against 0.45 ms: one wave of
//         blocks where two warpgroups leave 1.45);
//       - the x windows issued by lane 0 of warps 1-3 of each warpgroup:
//         6.7-7.0 / 5.7-6.0 against 6.4-6.7 / 5.5-5.7; by the first thread
//         of each warpgroup: 7.0-7.1 / 6.0-6.1; the weight's copy in halves
//         by the first threads of both warpgroups: 6.6-6.7 / 5.9-6.0
//         against 6.0 / 5.3 (a warp that issues copies holds up its whole
//         warpgroup's wgmma, so spreading the issue spreads the stall);
//         the copies issued after the first tap's group: 6.6-6.8 / 5.8
//         against 6.4-6.7 / 5.5-5.7; the weight by a TMA tensor copy in
//         place of the bulk copy: 5.9-6.1 / 5.2 against 6.0 / 5.3, the
//         same;
//       - a producer warp (a ninth warp issuing every copy up to 2 chunks
//         ahead onto full and empty mbarriers, no block barrier in the
//         loop) at N = 128, and at both N (one block an SM): 7.3-7.4 /
//         5.4-5.7 against 6.7 / 5.1-5.2; without the issue stall its
//         consumers wait on their own wgmma groups (18% of their cycles at
//         14x14x256, against 7%).
//     Stages 3-4 still compute about a quarter of padding: 196 = 3 x 64 + 4
//     pixels, and 49 of 64.
//
// Both: a second kernel adds each channel's partials in a fixed order.  No
// atomics: y, s and ss are the same on every run.  Pixels, channels and
// taps past their ends are masked, so any B, C, H, W, F >= 1 work.
//
// Halo rows (spatial partitioning, where x is a block of an image's rows):
// x's rows -1 and H may be given as (B, C, 1, W) tensors in place of the
// SAME padding's zeros.  Only the windows that reach outside x's plane read
// them, element by element: in both instances the kh = 0 and kh = 2
// windows, whose elements outside the plane the tensor copy landed as zeros
// (patch_halo).  x's planes keep the copy width chosen for them, and a null
// pointer leaves every path as it was.  y and the partial sums cover x's own
// H rows; each pixel's products are summed in the same order as in a launch
// on the whole image, so y is the same, bit for bit (chip_smoke.py phase
// 17a).
//
// ptxas (sm_90a, CUDA 12.9): the bf16 kernel at N = 128 128 registers (its
// bound for 2 blocks of 256 threads an SM), 24 bytes of spills, 112,208
// bytes of dynamic shared memory (the ring of 2 weight slices, 73,728; each
// warpgroup's windows, 7,680 as copied and 11,520 transposed; a zero row;
// 4 mbarriers); at N = 64 120 registers, no spills, 75,344 bytes; 2 blocks
// an SM either way; its self-test 94 and 62 registers; the f32 kernel at N
// = 64 127 registers, no spills, 101,392 bytes (2 slots of 50,688: the
// weight slice's two parts, 36,864, and both warpgroups' windows), 2 blocks
// an SM; at N = 128 209 registers, no spills, 175,120 bytes, 1 block an SM;
// its self-test 98 and 162 registers; the weight permutation 18, the repack
// 16; the second pass 32 registers and 8,448 bytes.
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

constexpr int kReduceChannels = 32;  // channels per block of the second pass
constexpr int kReduceRows = 32;      // row phases per block of the second pass

// ---------------------------------------------------------------------------
// Pieces of both instances
// ---------------------------------------------------------------------------

// The weight slice of one (f tile, chunk) as B of the wgmmas: NT f x the
// chunk's channels at each of the 9 taps, K-major without swizzle, as core
// matrices of 8 f x 16 bytes (E = 16 / sizeof(T) channels: 8 bf16, 4 f32;
// 128 contiguous bytes), [tap][c / E][f / 8][f % 8][c % E].  A chunk is 2E
// channels, one wgmma's K (32 bytes), so a tap's B starts tap * NT * 32
// bytes in; the leading byte offset (the second E channels) is NT * 16
// bytes, the stride byte offset (the next 8 f) 128.
template <typename T>
__host__ __device__ constexpr int slice_offset(int tap, int f, int c, int nt) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  return ((tap * 2 + c / E) * (nt / 8) + f / 8) * (8 * E) + (f % 8) * E + c % E;
}

// Channels of a K chunk: one wgmma's 32 bytes of K at each tap.
template <typename T>
__host__ __device__ constexpr int chunk_channels() {
  return 32 / static_cast<int>(sizeof(T));
}

// Output channels a block of each instance: 64 where F <= 64 (one tile is
// all of F), else 128.
inline int f_tile(int F) { return F <= 64 ? 64 : 128; }

// The type of a store of BYTES bytes.
template <int BYTES>
struct VecOf;
template <>
struct VecOf<16> {
  using type = uint4;
};
template <>
struct VecOf<8> {
  using type = uint2;
};
template <>
struct VecOf<4> {
  using type = unsigned;
};
template <>
struct VecOf<2> {
  using type = uint16_t;
};

// ---------------------------------------------------------------------------
// bf16 instance: warpgroup MMA (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcC = chunk_channels<uint16_t>();  // input channels per K chunk: 16
constexpr int kTcK = kTcC * 9;       // K values per chunk
constexpr int kXBox = 80;            // pixels of an x window: 66 read past a start rounded down to 8
constexpr int kRawElems = 3 * kTcC * kXBox;  // x as the copy lands it, [kh][c][pixel]
constexpr int kTPitch = kTcC + 8;    // transposed rows [kh][pixel][c], 48 bytes: ldmatrix conflict-free
constexpr int kTElems = 3 * kXBox * kTPitch;
constexpr int kYPitch = kStep + 8;   // the staged output tile's rows [f][pixel], 144 bytes

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

// The value that y stores, rounded to T, into `out`; returns it as f32
// (the statistics are those of the stored y).
__device__ __forceinline__ float store_value(float v, float& out) {
  out = v;
  return v;
}

__device__ __forceinline__ float store_value(float v, uint16_t& out) {
  const __nv_bfloat16 b = __float2bfloat16(v);
  out = __bfloat16_as_ushort(b);
  return __bfloat162float(b);
}

// The epilogue's first half, for a warpgroup's m64nNk accumulators (pixel
// rows, f columns): y rounded to T into the staged tile [f][pixel] of rows
// PITCH elements apart, and the per-column sums of the rounded values and
// their squares: a thread's two rows (16 wq + g and + 8; ok0 and ok1 say
// whether they are pixels of the plane), the 8 lanes of a column
// (reduce_over_g), into sums[wq][s, ss][NT] for write_partials to add the 4
// warps in order.
template <typename T, int NT, int PITCH>
__device__ __forceinline__ void stage_tile(const float (&acc)[NT / 2], T* tile_y, float* sums,
                                           int wq, int lane, bool ok0, bool ok1) {
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = wq * 16 + g;
  float s[NT / 4], ss[NT / 4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int fl = 8 * j + 2 * tig + e;
      const float y0 = store_value(acc[4 * j + e], tile_y[fl * PITCH + r0]);
      const float y1 = store_value(acc[4 * j + 2 + e], tile_y[fl * PITCH + r0 + 8]);
      const float v0 = ok0 ? y0 : 0.f;
      const float v1 = ok1 ? y1 : 0.f;
      s[2 * j + e] = v0 + v1;
      ss[2 * j + e] = fmaf(v1, v1, v0 * v0);
    }
  reduce_over_g(s, lane);
  reduce_over_g(ss, lane);
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

// Step t's row of the partial sums: each column's 4 warp sums in order.
template <int NT>
__device__ __forceinline__ void write_partials(const float* sums, float* part_s, float* part_ss,
                                               int t, int F, int f0, int wtid) {
  for (int fl = wtid; fl < NT; fl += 128) {
    if (f0 + fl >= F) break;
    const size_t at = static_cast<size_t>(t) * F + f0 + fl;
    part_s[at] = ((sums[0 * NT + fl] + sums[2 * NT + fl]) + sums[4 * NT + fl]) + sums[6 * NT + fl];
    part_ss[at] =
        ((sums[1 * NT + fl] + sums[3 * NT + fl]) + sums[5 * NT + fl]) + sums[7 * NT + fl];
  }
}

// y from the staged tile: each f's 64 pixels are contiguous, written V
// elements a store, the widest of 16, 8, 4 (or 2) bytes that the plane
// (H*W % V == 0) and the pointer allow, neighbouring lanes on neighbouring
// pixels.
template <typename T, int NT, int PITCH>
__device__ __forceinline__ void store_rows(const T* tile_y, T* y, int n, int F, int f0, int HW,
                                           int p0, int wtid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  auto rows = [&](auto width) {
    constexpr int V = decltype(width)::value;
    using Vec = typename VecOf<V * static_cast<int>(sizeof(T))>::type;
    constexpr int per_row = kStep / V;
    for (int i = wtid; i < NT * per_row; i += 128) {
      const int fl = i / per_row;
      const int q = (i - fl * per_row) * V;
      if (f0 + fl >= F || p0 + q >= HW) continue;
      *reinterpret_cast<Vec*>(y + (static_cast<size_t>(n) * F + f0 + fl) * HW + p0 + q) =
          *reinterpret_cast<const Vec*>(tile_y + fl * PITCH + q);
    }
  };
  const auto y_at = reinterpret_cast<uintptr_t>(y);
  if (HW % E == 0 && y_at % 16 == 0)
    rows(std::integral_constant<int, E>{});
  else if (HW % (E / 2) == 0 && y_at % 8 == 0)
    rows(std::integral_constant<int, E / 2>{});
  else if (HW % (E / 4) == 0 && y_at % 4 == 0)
    rows(std::integral_constant<int, E / 4>{});
  else
    rows(std::integral_constant<int, 1>{});
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

  // Epilogue: y rounded to bf16 into the staged tile; the per-column sums
  // into the transposed windows' space; step t's partials, then y
  uint16_t* tile_y = reinterpret_cast<uint16_t*>(smem) + wg * NT * kYPitch;
  float* sums = reinterpret_cast<float*>(smem + L::kXtOff) + wg * 4 * 2 * NT;  // [wq][s, ss][NT]
  stage_tile<uint16_t, NT, kYPitch>(acc, tile_y, sums, wq, lane,
                                    active && p0 + wq * 16 + g < HW,
                                    active && p0 + wq * 16 + g + 8 < HW);
  __syncthreads();
  CLOCK_MARK(9)
  if (!active) return;
  write_partials<NT>(sums, part_s, part_ss, t, F, f0, wtid);
  store_rows<uint16_t, NT, kYPitch>(tile_y, y, n, F, f0, HW, p0, wtid);
  CLOCK_MARK(10)
  CLOCKS_END
}

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
  if (f_tile(F) == 64)
    return launch_bf16_tile<64>(xmap, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, stream);
  return launch_bf16_tile<128>(xmap, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, stream);
}

// The weight slices: wp[f tile][chunk][slice_offset<T>(tap, f % nt, c % CC,
// nt)] = wt[f][c][tap], 0 past F and C, CC = chunk_channels<T>(), each
// slice nt * 9 * CC contiguous elements.  f32 slices come in two parts, the
// TF32 big parts, then the small ones (split_tf32), split here once a call
// rather than in every block that stages them.  A thread per element of wt
// padded to whole tiles and chunks, in wt's order.
template <typename T>
__host__ __device__ constexpr int weight_parts() {
  return std::is_same<T, float>::value ? 2 : 1;
}

template <typename T>
__global__ void __launch_bounds__(256)
    permute_weights_kernel(const T* __restrict__ wt, T* __restrict__ wp, int C, int F,
                           int chunks, int nt) {
  constexpr int CC = chunk_channels<T>();
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_f = chunks * CC * 9;  // (c, tap) of one f, C padded to whole chunks
  if (i >= static_cast<long long>((F + nt - 1) / nt) * nt * per_f) return;
  const int f = static_cast<int>(i / per_f);
  const int rem = static_cast<int>(i - static_cast<long long>(f) * per_f);
  const int c = rem / 9;
  const int tap = rem - c * 9;
  const size_t slice = static_cast<size_t>(f / nt) * chunks + c / CC;
  const T v = f < F && c < C ? wt[(static_cast<size_t>(f) * C + c) * 9 + tap] : T(0);
  T* dst =
      wp + slice * weight_parts<T>() * nt * CC * 9 + slice_offset<T>(tap, f % nt, c % CC, nt);
  if constexpr (weight_parts<T>() == 2) {
    unsigned big, small;
    split_tf32(v, big, small);
    dst[0] = __uint_as_float(big);
    dst[nt * CC * 9] = __uint_as_float(small);
  } else {
    dst[0] = v;
  }
}

template <typename T>
long long weight_elems(int C, int F) {
  constexpr int CC = chunk_channels<T>();
  const int nt = f_tile(F);
  return static_cast<long long>((F + nt - 1) / nt) * nt * ((C + CC - 1) / CC) * CC * 9 *
         weight_parts<T>();
}

template <typename T>
int permute_weights(const void* wt, T* wp, int C, int F, cudaStream_t stream) {
  constexpr int CC = chunk_channels<T>();
  const long long elems =
      static_cast<long long>((F + f_tile(F) - 1) / f_tile(F)) * f_tile(F) * ((C + CC - 1) / CC) *
      CC * 9;  // a thread per element of wt padded to whole tiles and chunks
  permute_weights_kernel<T><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(wt), wp, C, F, (C + CC - 1) / CC, f_tile(F));
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
    bs[slice_offset<uint16_t>(k, f, c, N)] = b[i];
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
// f32 instance: TF32 warpgroup MMA (wgmma), 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTfC = chunk_channels<float>();  // input channels per K chunk: 8
constexpr int kTfK = kTfC * 9;                 // K values per chunk
constexpr int kTfXBox = 72;        // pixels of an x window: 69 read past a start rounded down to 4
constexpr int kTfWin = kTfC * kTfXBox;  // one kh window as the copy lands it, [c][pixel]
constexpr int kTfYPitch = kStep + 4;    // the staged output tile's rows [f][pixel], 272 bytes

// kWgs warpgroups a block, each over one pipeline step (64 pixels of one
// image), sharing the weight slices of NT output channels.  Shared memory:
// a ring of 2 slots, each a weight slice's big and small TF32 parts (as the
// permutation split them) and each warpgroup's three x windows; the 2
// mbarriers of the slots.  After the last chunk the slots hold the staged
// output tiles and the warps' column sums.
template <int NT>
struct TfConv {
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kWBytes = NT * kTfK * 4;  // one part of a weight slice
  static constexpr int kXBytes = 3 * kTfWin * 4;
  static constexpr int kSlotBytes = 2 * kWBytes + kWgs * kXBytes;
  static constexpr int kBarOff = 2 * kSlotBytes;
  static constexpr int kSmem = kBarOff + 2 * 8;
  static constexpr int kSumsOff = kWgs * NT * kTfYPitch * 4;
  static_assert(kWBytes % 128 == 0 && kXBytes % 128 == 0 && (kTfWin * 4) % 128 == 0,
                "tensor copies land on 128 bytes");
  static_assert(kSumsOff + kWgs * 4 * 2 * NT * 4 <= kBarOff, "the output tiles and sums must fit");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// Block (f tile, step group) of a 1-D grid as in the bf16 instance: f tile
// = blockIdx.x % ceil(F / NT), warpgroup wg owns step t = (blockIdx.x /
// ceil(F / NT)) * kWgs + wg.  xmap is x (or its repacked copy) as a tensor
// of (H*W pixels, C, B) in boxes of 72 pixels x 8 channels; wp holds the
// weight slices, [f tile][chunk][big, small].
template <int NT>
__global__ void __launch_bounds__(128 * kWgs, NT == 64 ? 2 : 1)
    conv3x3_stats_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                              const float* __restrict__ top, const float* __restrict__ bottom,
                              const float* __restrict__ wp, float* __restrict__ y,
                              float* __restrict__ part_s, float* __restrict__ part_ss, int C,
                              int H, int W, int F, int steps) {
  using L = TfConv<NT>;
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
  const int group = blockIdx.x / f_tiles;
  const int t = group * kWgs + wg;
  const bool active = t < steps;  // the last block's second warpgroup may have none
  const int n = active ? t / per_image : 0;
  const int p0 = active ? (t - n * per_image) * kStep : 0;
  const int chunks = (C + kTfC - 1) / kTfC;

  CLOCKS_BEGIN
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  const float* wslices = wp + static_cast<size_t>(tile) * chunks * (2 * NT * kTfK);
  auto slot_w = [&](int s) { return reinterpret_cast<float*>(smem + s * L::kSlotBytes); };
  auto slot_x = [&](int s, int w) {
    return reinterpret_cast<float*>(smem + s * L::kSlotBytes + 2 * L::kWBytes + w * L::kXBytes);
  };

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // The copies of chunk ch into slot ch % 2, all by thread 0, on the slot's
  // barrier: the weight slice's two parts (one cp.async.bulk) and, for each
  // warpgroup with a step, its three windows, channels ch * 8 .. + 7 at 72
  // plane pixels from p0 + (kh - 1) W - 1 rounded down to a multiple of 4
  // (a tensor copy's innermost coordinate must be a multiple of 16 bytes);
  // pixels outside the plane and channels past C land as zeros.  (Copies
  // issued by other warps stall those warps' warpgroups instead: slower,
  // head comment.)
  auto load = [&](int ch) {
    const int s = ch & 1;
    const int wgs = min(kWgs, steps - group * kWgs);  // warpgroups with a step
    mbar_arrive_expect(&bars[s], 2 * L::kWBytes + wgs * L::kXBytes);
    bulk_load(slot_w(s), wslices + static_cast<size_t>(ch) * (2 * NT * kTfK), 2 * L::kWBytes,
              &bars[s]);
    for (int w = 0; w < wgs; ++w) {
      const int tw = group * kWgs + w;
      const int nw = tw / per_image;
      const int pw = (tw - nw * per_image) * kStep;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
        tma_load_3d(slot_x(s, w) + kh * kTfWin, &xmap, (pw + (kh - 1) * W - 1) & ~3, ch * kTfC,
                    nw, &bars[s]);
    }
  };
  int first[3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) first[kh] = (p0 + (kh - 1) * W - 1) & ~3;
  // Halo rows: window elements of rows -1 and H come from top and bottom
  // (the copy landed zeros there), element by element, where given.
  auto patch_halo = [&](float* xs, int ch) {
    const float* rows[2] = {top, bottom};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int kh = side * 2;
      const int lo = side == 0 ? -W : HW;  // the halo row's pixels lo .. lo + W - 1
      if (rows[side] == nullptr || first[kh] + kTfXBox <= lo || first[kh] >= lo + W) continue;
      for (int i = wtid; i < kTfWin; i += 128) {
        const int cl = i / kTfXBox;
        const int k = first[kh] + i - cl * kTfXBox - lo;  // column in the halo row
        const int c = ch * kTfC + cl;
        if (k >= 0 && k < W && c < C)
          xs[kh * kTfWin + i] = rows[side][(static_cast<size_t>(n) * C + c) * W + k];
      }
    }
  };

  // This thread's A elements at tap (kh, kw): pixel rows r0 = 16 wq + g and
  // r0 + 8 of the step, channels tig and tig + 4 (a0 (r0, tig), a1 (r0 + 8,
  // tig), a2 (r0, tig + 4), a3 (r0 + 8, tig + 4)), window element r + kw +
  // the window start's rounding, split into big and small TF32 parts; zero
  // where the tap wraps across the image's left or right edge.  Rows of 72
  // floats put the 32 lanes' loads on 32 banks (72 tig + g mod 32).
  const int r0 = wq * 16 + g;
  const int col0 = (p0 + r0) % W, col1 = (p0 + r0 + 8) % W;
  const bool left0 = col0 >= 1, left1 = col1 >= 1;
  const bool right0 = col0 <= W - 2, right1 = col1 <= W - 2;
  int at_kh[3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
    at_kh[kh] = kh * kTfWin + tig * kTfXBox + r0 + (p0 + (kh - 1) * W - 1 - first[kh]);
  auto load_a = [&](const float* xs, int tap, unsigned (&big)[4], unsigned (&small)[4]) {
    const int kh = tap / 3, kw = tap - kh * 3;
    const float* q = xs + at_kh[kh] + kw;
    const bool ok0 = kw == 1 || (kw == 0 ? left0 : right0);
    const bool ok1 = kw == 1 || (kw == 0 ? left1 : right1);
    split_tf32(ok0 ? q[0] : 0.f, big[0], small[0]);
    split_tf32(ok1 ? q[8] : 0.f, big[1], small[1]);
    split_tf32(ok0 ? q[4 * kTfXBox] : 0.f, big[2], small[2]);
    split_tf32(ok1 ? q[4 * kTfXBox + 8] : 0.f, big[3], small[3]);
  };

  float acc[NT / 2];  // the running sums, pixels x f
  float tmp[NT / 2];  // one chunk's products, summed in the tensor cores
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) acc[e] = tmp[e] = 0.f;

  CLOCK_MARK(1)
  if (tid == 0) load(0);
  CLOCK_MARK(3)
  for (int i = 0; i < chunks; ++i) {
    const int s = i & 1;
    mbar_wait(&bars[s], (i >> 1) & 1);
    CLOCK_MARK(4)
    if (active && (top != nullptr || bottom != nullptr)) patch_halo(slot_x(s, wg), i);
    CLOCK_MARK(5)
    // slot s has landed and its halo rows are patched; every warpgroup is
    // done with chunk i - 1, so slot (i + 1) % 2 is free for the next copies
    __syncthreads();
    CLOCK_MARK(2)
    if (tid == 0 && i + 1 < chunks) load(i + 1);
    CLOCK_MARK(3)
    if (!active) continue;
    const float* xs = slot_x(s, wg);
    // 9 taps, each three wgmma (small * big, big * small, big * big) in a
    // commit group into tmp, from zero at the chunk's first; each tap's A
    // fragments are loaded while the previous tap's products run, into the
    // registers of the tap before it once its group is done
    const uint64_t db = smem_desc(slot_w(s), NT * 16, 128);
    const uint64_t ds = smem_desc(slot_w(s) + NT * kTfK, NT * 16, 128);
    unsigned a[2][2][4];  // [tap % 2][big, small]
    load_a(xs, 0, a[0][0], a[0][1]);
    fence_operands(tmp);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int b = tap & 1;
      const uint64_t at = static_cast<uint64_t>(tap * NT * 2);  // tap * NT * 32 bytes
      wgmma_fence();
      Tf32Wgmma<NT>::mma(tmp, a[b][1], db + at, tap != 0);
      Tf32Wgmma<NT>::mma(tmp, a[b][0], ds + at, 1);
      Tf32Wgmma<NT>::mma(tmp, a[b][0], db + at, 1);
      wgmma_commit();
      if (tap < 8) {
        wgmma_wait<1>();
        load_a(xs, tap + 1, a[b ^ 1][0], a[b ^ 1][1]);
      }
    }
    CLOCK_MARK(7)
    // the chunk's 72 products of each y, summed in the tensor cores, join
    // the running sums with one rounded f32 add (head comment)
    wgmma_wait<0>();
    fence_operands(tmp);
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[e] += tmp[e];
    CLOCK_MARK(8)
  }
  __syncthreads();  // every warp is done with the ring
  CLOCK_MARK(2)

  // Epilogue: y into the staged tile; the per-column sums beside the tiles;
  // step t's partials, then y
  float* tile_y = reinterpret_cast<float*>(smem) + wg * NT * kTfYPitch;
  float* sums = reinterpret_cast<float*>(smem + L::kSumsOff) + wg * 4 * 2 * NT;  // [wq][s, ss][NT]
  stage_tile<float, NT, kTfYPitch>(acc, tile_y, sums, wq, lane, active && p0 + r0 < HW,
                                   active && p0 + r0 + 8 < HW);
  __syncthreads();
  CLOCK_MARK(9)
  if (!active) return;
  write_partials<NT>(sums, part_s, part_ss, t, F, f0, wtid);
  store_rows<float, NT, kTfYPitch>(tile_y, y, n, F, f0, HW, p0, wtid);
  CLOCK_MARK(10)
  CLOCKS_END
}

// x (planes `pitch` floats apart, a multiple of 4, 16-byte aligned) as a
// tensor of (H*W pixels, C, B) with boxes of 72 pixels x 8 channels: the
// pixels from H*W up to the pitch, like those before 0, lie outside it.
int x_tensor_map_f32(CUtensorMap* map, const void* x, int B, int C, int HW, int pitch) {
  return tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, HW, C, B,
                       static_cast<long long>(pitch) * 4, static_cast<long long>(pitch) * C * 4,
                       kTfXBox, kTfC, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int NT>
int launch_f32_tile(const CUtensorMap& xmap, const void* top, const void* bottom, const void* wp,
                    void* y, void* part_s, void* part_ss, int B, int C, int H, int W, int F,
                    cudaStream_t stream) {
  using L = TfConv<NT>;
  const auto kernel = conv3x3_stats_tf32_kernel<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long steps = static_cast<long long>(B) * ((H * W + kStep - 1) / kStep);
  const long long blocks = (steps + kWgs - 1) / kWgs * ((F + NT - 1) / NT);
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kSmem, stream>>>(
      xmap, static_cast<const float*>(top), static_cast<const float*>(bottom),
      static_cast<const float*>(wp), static_cast<float*>(y), static_cast<float*>(part_s),
      static_cast<float*>(part_ss), C, H, W, F, static_cast<int>(steps));
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* top, const void* bottom, const void* wp, void* y,
               void* part_s, void* part_ss, int B, int C, int H, int W, int F, int pitch,
               cudaStream_t stream) {
  CUtensorMap xmap;
  const int err = x_tensor_map_f32(&xmap, x, B, C, H * W, pitch);
  if (err != 0) return err;
  if (f_tile(F) == 64)
    return launch_f32_tile<64>(xmap, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, stream);
  return launch_f32_tile<128>(xmap, top, bottom, wp, y, part_s, part_ss, B, C, H, W, F, stream);
}

// The TF32 wgmma chain as the f32 kernel issues it: d (64 x N, f32) = a (64
// x K) times b (N x K)^T, K = 72 chunks in the kernel's order (chunk, tap,
// 8 channels), both f32 row-major.  A chunk's b goes into the weight
// slice's layout (slice_offset), split into its big and small parts as the
// permutation splits the weight; a's fragments are loaded and split in
// registers, as the kernel loads x's windows; each tap is three wgmma
// against the descriptors started at the tap's offset.  The products of
// `flush` consecutive chunks are summed in the tensor cores from zero and
// added to the running sums with an f32 add, or with flush 0 every product
// is summed in the tensor cores.
template <int N>
__global__ void __launch_bounds__(128)
    conv_tf32_selftest_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ d, int chunks, int flush) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* big = reinterpret_cast<float*>(smem);
  float* small = big + N * kTfK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int K = chunks * kTfK;
  float acc[N / 2], tmp[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = tmp[e] = 0.f;
  int in_window = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    for (int i = tid; i < N * kTfK; i += 128) {
      const int c = i % kTfC, f = (i / kTfC) % N, tap = i / (kTfC * N);
      unsigned vb, vs;
      split_tf32(b[static_cast<size_t>(f) * K + ch * kTfK + tap * kTfC + c], vb, vs);
      big[slice_offset<float>(tap, f, c, N)] = __uint_as_float(vb);
      small[slice_offset<float>(tap, f, c, N)] = __uint_as_float(vs);
    }
    fence_proxy_async();
    __syncthreads();
    const uint64_t db = smem_desc(big, N * 16, 128), ds = smem_desc(small, N * 16, 128);
    for (int tap = 0; tap < 9; ++tap) {
      unsigned ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        const int row = 16 * warp + g + 8 * (e & 1), col = tig + 4 * (e >> 1);
        split_tf32(a[static_cast<size_t>(row) * K + ch * kTfK + tap * kTfC + col], ab[e], as[e]);
      }
      const uint64_t at = static_cast<uint64_t>(tap * N * 2);  // tap * N * 32 bytes
      auto products = [&](float(&dst)[N / 2], int scale_d) {
        fence_operands(dst);
        wgmma_fence();
        Tf32Wgmma<N>::mma(dst, as, db + at, scale_d);
        Tf32Wgmma<N>::mma(dst, ab, ds + at, 1);
        Tf32Wgmma<N>::mma(dst, ab, db + at, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dst);
      };
      if (flush == 0)
        products(acc, 1);
      else
        products(tmp, tap != 0 || in_window != 0);
    }
    if (flush != 0 && ++in_window == flush) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[e] += tmp[e];
      in_window = 0;
    }
    __syncthreads();  // every warp is done with the slice before the next is written
  }
  if (flush != 0 && in_window != 0) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] += tmp[e];
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    d[(16 * warp + g + ((e >> 1) & 1) * 8) * N + (e >> 2) * 8 + 2 * tig + (e & 1)] = acc[e];
}

template <int N>
int conv_tf32_selftest(const float* a, const float* b, float* d, int chunks, int flush,
                       cudaStream_t stream) {
  const int smem = 2 * N * kTfK * 4;
  const auto kernel = conv_tf32_selftest_kernel<N>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 128, smem, stream>>>(a, b, d, chunks, flush);
  return static_cast<int>(cudaGetLastError());
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

// The copy width, in elements, that the instance takes for x: 16 bytes, 8
// bf16 or 4 f32 elements (the tensor copies need planes of whole 16 bytes),
// or 1 where that does not fit and x is repacked into padded planes.
int copy_width_of(const void* x, int HW, bool bf16) {
  if (bf16) return copy_width<2>(HW, x) == 8 ? 8 : 1;
  return copy_width<4>(HW, x) == 4 ? 4 : 1;
}

long long permuted_weight_elems(int C, int F, bool bf16) {
  return bf16 ? weight_elems<uint16_t>(C, F) : weight_elems<float>(C, F);
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
// (bf16 8, f32 4, or 1 for the repack), so that a caller can see which path
// ran.
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
  const bool bf16 = is_bf16 != 0;
  int err = bf16 ? permute_weights<uint16_t>(wt, static_cast<uint16_t*>(scratch), C, F, st)
                 : permute_weights<float>(wt, static_cast<float*>(scratch), C, F, st);
  if (err != 0) return err;
  // x itself where its planes suit the tensor copies, else repacked after
  // the weight
  const void* xs = x;
  int xpitch = HW;
  if (copy_width_of(x, HW, bf16) == 1) {
    void* xp = static_cast<unsigned char*>(scratch) + w_elems * (bf16 ? 2 : 4);
    const long long planes = static_cast<long long>(B) * C;
    err = bf16 ? pad_planes<uint16_t>(x, xp, planes, HW, pitch, st)
               : pad_planes<float>(x, xp, planes, HW, pitch, st);
    if (err != 0) return err;
    xs = xp;
    xpitch = pitch;
  }
  err = bf16 ? launch_bf16(xs, top, bottom, scratch, y, part_s, part_ss, B, C, H, W, F, xpitch, st)
             : launch_f32(xs, top, bottom, scratch, y, part_s, part_ss, B, C, H, W, F, xpitch, st);
  if (err != 0) return err;
  return reduce_partials(part_s, part_ss, s, ss, conv3x3_bn_stats_partial_rows(B, H, W), F, st);
}

// Which instance conv3x3_bn_stats runs for a dtype, for a caller to report.
const char* conv3x3_bn_stats_instance(int is_bf16) {
  return is_bf16 ? "tensor cores: wgmma m64nNk16 bf16, 64 pixels x N f a warpgroup, N = 64 "
                   "where F <= 64, else 128, 2 warpgroups a block"
                 : "tensor cores: wgmma m64nNk8 3xTF32, 64 pixels x N f a warpgroup, N = 64 "
                   "where F <= 64, else 128, 2 warpgroups a block";
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

// The f32 instance's TF32 wgmma chain on its own
// (conv_tf32_selftest_kernel): d (64 x n, f32) = a (64 x K) times b (n x
// K)^T, K = 72 chunks, a and b f32, row-major, contiguous; the products of
// `flush` consecutive chunks summed in the tensor cores from zero, then
// added in f32 (0: all of them in the tensor cores).  n is 64 or 128 (the
// instance's tiles), chunks >= 1 and flush >= 0, else cudaErrorInvalidValue.
int conv3x3_bn_stats_tf32_selftest(const void* a, const void* b, void* d, int n, int chunks,
                                   int flush, void* stream) {
  if (chunks < 1 || flush < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  if (n == 64) return conv_tf32_selftest<64>(pa, pb, static_cast<float*>(d), chunks, flush, st);
  if (n == 128) return conv_tf32_selftest<128>(pa, pb, static_cast<float*>(d), chunks, flush, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
