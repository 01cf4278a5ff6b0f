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
// Both instances: one pipeline step is 64 pixels of one image (a step never
// straddles two images; the plane's tail is zero-filled and its empty
// slices are skipped), staging dy (the block's f x 64 pixels) and, for each
// input channel, the pixel rows of x the step's taps read (the rows above
// and below come from the plane itself, zero or the halo rows outside it).
// A block owns all 9 taps of its input channels, so each staged x value
// serves all of them.  The split count comes from the device's resident
// blocks (below).
//
// bf16 instance: Hopper's warpgroup MMA, wgmma.mma_async m64n32k16 (bf16
// in, f32 accumulate; bf16 products are exact in f32), A from registers, B
// from shared memory, fed by a 3-stage cp.async ring.
//   - Operands: A = dy (64 f x 16 pixels), B = x (16 pixels x 32 c), one
//     wgmma a tap.  wgmma takes B only through a matrix descriptor whose
//     start moves in 16-byte units, so x is transposed once a step into
//     rows of 8 channels per pixel, xt[c / 8][pixel row][8] (MN-major, no
//     swizzle: a core matrix of 8 pixels x 8 channels is 128 contiguous
//     bytes).  Tap (kh, kw) of output pixel p is row row0[kh] + p + kw, so
//     every tap's B is the same array with the descriptor started that many
//     rows in: the shift by kw that breaks ldmatrix's alignment is one row.
//   - The image's left and right columns: tap kw = 0 of a pixel in column 0
//     (kw = 2 in column W - 1) reads the neighbouring image row's pixel,
//     which must not count, and a descriptor can mask nothing.  So dy is
//     masked instead (pixel p's product at tap kw is dy[f, p] x[c, p + kw
//     + ...]): its A fragment (ldmatrix; a warp holds 16 rows in mma.sync's
//     m16n8k16 A layout) and two copies ANDed with the pixels' edge bits
//     (a table staged with the step) serve kw = 0, 1, 2.
//   - x rows: for each kh, the window of conv3x3_common.cuh, 80 rows from
//     plane pixel p0 + (kh - 1) W - 1 rounded down to 8, so row0[kh] is kh *
//     80 + that remainder.
//   - Tile: a warpgroup owns 64 f x 32 c x 9 taps, 144 f32 accumulators a
//     thread.  A block is one warpgroup where F <= 64 and two (128 f, each x
//     row staged and transposed once for both) where F > 64: two were faster
//     a call at the ResNet-50 stages 2-4 in side-by-side runs on an H100,
//     and at stage 1 (F = 64) half of them would compute padding.
//   - Step: wait for the ring, barrier, issue step i + 2's copies, transpose
//     x (8 32-bit loads, 2 16-byte stores for 8 channels at 2 pixels),
//     fence.proxy.async (the threads' stores before wgmma's async-proxy
//     reads), barrier; then the A fragments of all slices, wgmma.fence, 9
//     wgmma a slice, one commit group, and wgmma.wait_group 0 before the
//     next step may refill what they read.  Keeping a step's wgmmas in
//     flight across the next step's transpose needed the A fragments and
//     accumulators alive there: ptxas ran out of registers and serialized
//     every wgmma (C7511), and it was slower.
//   - The output tile (f rows of 288 contiguous floats of part) is staged
//     through shared memory and written row by row: storing the fragments
//     straight from registers scattered each warp's stores over 8 rows and
//     4 columns, the largest single cost of the first build.
//   - Copies: 16-byte cp.async where H*W % 8 == 0 and both pointers are
//     16-byte aligned (a chunk then lies wholly inside or outside a plane,
//     and out-of-plane chunks are zero-filled whole, cp.async's src-size 0);
//     else a first kernel repacks x and dy into planes padded to a multiple
//     of 8 elements (two launches).  8-byte copies of the 196-pixel planes
//     were slower a call than the repack and 16-byte copies.
//   - What bounds it on the card: the copies.  clock64() counters in one
//     block (H100, stage 1 at 224 px) put most of its cycles in issuing a
//     step's cp.async, then in issuing its 36 wgmma (near the rate of a lone
//     stream of m64n32k16), little in the transpose and the barriers.  TMA
//     would take the copies off the threads (ROADMAP).
//   - The wgmma protocol is checked on its own by wgmma_selftest_kernel (C
//     entry conv3x3_filter_grad_wgmma_selftest): one m64n32k16 with register
//     A and the descriptor started at whole-row offsets, against a matrix
//     product.
//   - Tried on an H100 in temporary variants, each timed beside this design,
//     and dropped, each slower or no faster at the ResNet-50 stage shapes: a
//     step's wgmmas kept in flight across the next step's transpose
//     (serialized, above); the next copies issued between the slices'
//     wgmmas; two warpgroups over 64 c sharing dy in place of two over 128 f
//     sharing x; one span of pixels p0 - W - 1 .. p0 + 64 + W in place of
//     the three windows (the same: their repeated rows are L1 hits), and
//     that span kept in a ring across an image's steps, staging 64 new rows
//     a step (slower: more registers, and less L1 beside the larger shared
//     memory); cp.async.cg for the 16-byte copies; the copy loops'
//     invariants hoisted; a 4-stage ring.
//
// f32 instance: Hopper's warpgroup MMA with TF32 operands, wgmma.mma_async
// m64n64k8 (f32 accumulate), as 3xTF32 (the split in conv3x3_common.cuh):
// each f32 operand a is split into a_big = tf32(a), rounded to nearest with
// ties away (as cvt.rna.tf32.f32 rounds, but by an integer add and mask),
// and a_small = a - a_big (exact in f32) truncated to TF32, so a_big +
// a_small is a to 2^-21; the product is a_small*b_big + a_big*b_small +
// a_big*b_big (a_small*b_small, 2^-22 of it, is dropped), f32-exact to about
// 2^-20 relative at worst.  This is not "TF32 on": one TF32 product is 2^-11
// off.  (Integer operations, because conversions run at a fraction of the
// rate: with cvt.rna for both parts every call of the mma.sync instance
// took 9% longer, and rounding a_small too 7%.)
//   - Operands: dw^T, M = 64 input channels, N = 64 output channels, K =
//     pixels.  TF32 wgmma takes both operands K-major only (the transpose
//     bits exist for 16-bit types), and NCHW gives both so; but a tap's kw
//     shift is one pixel, 4 bytes along K, and a
//     descriptor's start moves in 16-byte units, so the shifted operand
//     cannot be B.  So x is A, in registers: each thread loads its fragment
//     (mma.sync m16n8k8's TF32 A layout: a0 (g, t), a1 (g + 8, t), a2 (g, t
//     + 4), a3 (g + 8, t + 4), warp w of the warpgroup rows 16 w on; the
//     other order measured 0.6-4 of the sum of |terms| away) with plain
//     32-bit shared loads at any shift, zero where the tap wraps across the
//     image's left or right column (the step's edge table), and splits it.
//     dy is B, unshifted, behind a K-major descriptor with the 128-byte
//     swizzle that its tensor copies land in (rows of 32 pixels, a k8
//     slice 32 bytes into a row); all threads split it in place after the
//     copy lands, big parts over the copy, small parts into a second buffer.
//     Each slice is three wgmma, small * big, big * small, big * big.
//   - Accumulation: TF32 wgmma's f32 sums, like mma.sync's, lose too much
//     over a block's share of a split.  Measured on an H100 with the
//     self-test (conv3x3_filter_grad_tf32_selftest), 3xTF32 over 2,048 /
//     4,096 pixels from f64 in units of max |d|: all of them summed in the
//     tensor cores 1.35-1.54e-5 / 2.9-3.2e-5, past the 1e-5 bound; products
//     of 8 / 16 / 32 / 64 pixels summed there from zero, then f32 adds,
//     3.1-8.5e-7; 128 / 256 pixels 0.8-1.0e-6 / 1.7-2.0e-6.  So each tap's
//     products of a step (64 pixels) go into a temporary from zero (scale-d
//     0 at the step's first slice) and the running sums take them with one
//     f32 add: 96 + 32 accumulator registers a thread.
//   - Block: three warpgroups, warpgroup kh owning taps (kh, 0 .. 2) of 64
//     c x 64 f, all sharing the step's dy; one block an SM.  A step is 3 taps
//     x up to 8 slices x 3 wgmma a warpgroup; each slice's group is waited
//     for before the next slice's A fragment is loaded into its registers.
//   - Copies: TMA tensor copies by one thread onto mbarriers; x's three
//     windows (76 plane pixels from p0 + (kh - 1) W - 1 rounded down to 4:
//     a tensor copy's innermost coordinate must be a multiple of 16 bytes;
//     76-float rows keep the fragment loads conflict-free) in a ring of 3
//     slots, copied 2 steps ahead, dy (2 boxes of 32 pixels x 64 f) in a
//     ring of 2, 1 step ahead; pixels outside the plane, channels past C
//     and f past F land as zeros.  The tensors' strides must be multiples of
//     16 bytes: where H*W % 4 != 0 or a pointer is not 16-byte aligned, x
//     and dy are first repacked into planes padded to 8 floats (stage 4's
//     49 pixels, odd ragged planes).  Halo rows are patched into the kh = 0
//     and kh = 2 windows element by element where the copy landed zeros.
//   - Where the cycles go (conv_clocks.py, thread 0 of three blocks,
//     56x56x64 and 14x14x256, batch 128; H100 80GB HBM3, 700 W): the
//     mma.sync instance this replaces (M = 64 f, 4 warps, every thread
//     issuing cp.async copies) spent 28-37% of a block's cycles issuing
//     copies, 30-40% in the mma, 16-18% loading and splitting x, 8-9% on
//     dy's fragments.  This kernel: issuing its wgmma groups 24-25% and
//     waiting for them 31-34%, x's A fragments 24%, the split of dy 5-6%,
//     the copies' issue 5-6%, waiting for copies and barriers 4%.  Its
//     tensor pipe is busy a little over half the time: each warpgroup has
//     one group of 3 wgmma in flight, between its fragment loads and
//     waits (a microbenchmark of the same wgmma, 3 a group and a wait,
//     reached 1,023 FMA a cycle an SM, the full rate, from 2 warpgroups).
//   - Tried on an H100 in temporary variants, each timed beside the others
//     in one call (ResNet-50 step sums at 224 / 448 px): the slices
//     unrolled for each slice count (168 registers, 600 bytes of spills,
//     which the 29 KB of L1 left beside the shared memory does not hold:
//     27% of a block's cycles went to the loop head) 6.16-6.19 / 4.40-4.43
//     against 5.50-5.57 / 3.96-4.03 for the slice loop; N = 32 for every F
//     +10% (so one tile of 64 f: only the ImageNet ResNets, F >= 64, call
//     the op); A double-buffered with two groups in flight (spills) +14%;
//     2 or 4 slices a group, unrolled, +2% / +15%; 2 slices a group in the
//     slice loop 1-3% faster at stages 1-3 and 2% slower at stage 4, with
//     warpgroup.arrive fences that ptxas injected (C7519), not kept; x's
//     ring of 2 slots copied 1 step ahead with the split dy
//     double-buffered (faster than a ring of 3 while both spilled); L2
//     promotion of the tensor maps none or 256 B (no change); no x or no dy
//     copies after the ring's first fill (results wrong, time unchanged:
//     the copies do not bound it).
//
// ptxas (sm_90a, CUDA 12.9): the bf16 kernel 218 registers, no spills, one
// warpgroup 89,280 bytes of dynamic shared memory (the transposed rows,
// 15,360, and 3 stages of 24,640), 2 blocks an SM, two warpgroups 116,928
// bytes, 1 block an SM (registers bound both); the f32 kernel 157
// registers, no spills, 225,384 bytes (x's ring 175,104, dy's 32,768, dy's
// small parts 16,384), 1 block of 384 threads an SM; the bf16 self-test 46
// registers, the TF32 self-test 98; the repack and the ordered reduction 16
// and 32 registers.
//
// Halo rows (spatial partitioning): x's rows -1 and H may be given as
// (N, C, 1, W) tensors in place of the zero padding; dy covers x's own
// rows.  The bf16 instance's x windows read them with stage_x_chunk
// (conv3x3_common.cuh), the f32 instance patches its tensor copies' windows
// (above); a null pointer changes nothing.
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

// ---------------------------------------------------------------------------
// bf16 instance: warpgroup MMA (wgmma)
// ---------------------------------------------------------------------------

// The wgmma pieces (fences, waits, the descriptor) are in conv3x3_common.cuh.

constexpr int kWgC = 32;                // input channels per block: the wgmma's N
constexpr int kWgGroups = kWgC / 8;     // 8-channel groups: core matrices along N
constexpr int kWgWin = window_len<8>();  // pixel rows of one kh window: 80
constexpr int kWgRows = 3 * kWgWin;     // pixel rows of x a channel a step: 240, [kh][80]
constexpr int kWgStages = 3;            // depth of the cp.async ring
constexpr int kWgDyPitch = kStep + 8;   // 144-byte rows of dy: ldmatrix conflict-free
constexpr int kWgRawElems = kWgC * kWgRows;           // x as staged, [c][pixel row]
constexpr int kWgTElems = kWgGroups * kWgRows * 8;    // xt[c / 8][pixel row][c % 8]

constexpr int kWgOutPitch = kWgC * 9 + 1;  // floats a row of the staged output tile: odd, 2-way banks

// B in shared memory: MN-major ("transposed", channels contiguous) without
// swizzle, as rows of 8 channels (16 bytes) per pixel, [c / 8][pixel][8],
// so a core matrix (8 pixels x 8 channels) is 128 contiguous bytes.  In its
// matrix descriptor (smem_desc) the leading byte offset is the step along K
// (the next 8 pixels: 128 bytes), the stride byte offset the step along N
// (the next 8 channels: a window of pixel rows).  A start one pixel on adds 1.
constexpr uint64_t kWgLbo = 8 * 16;
constexpr uint64_t kWgSbo = kWgRows * 16;

__device__ __forceinline__ uint64_t b_desc(const void* p) { return smem_desc(p, kWgLbo, kWgSbo); }

// d += a (64 x 16, registers) * b (16 x 32, descriptor), bf16 in, f32 sums;
// B MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const unsigned (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// This warp's A fragment of columns k0 .. k0 + 15 of the 16 rows from
// `rows` on (`pitch` elements apart).
__device__ __forceinline__ void load_a(unsigned (&a)[4], const uint16_t* rows, int pitch,
                                       int k0, int lane) {
  ldmatrix_x4(a, rows + (lane & 15) * pitch + k0 + (lane >> 4) * 8);
}

// x's staged rows [c][pixel row] -> xt[c / 8][pixel row][c % 8]: a unit
// is 8 channels at 2 pixel rows, 8 32-bit loads and 2 16-byte stores.
__device__ __forceinline__ void transpose_x(const uint16_t* raw, uint16_t* xt, int tid,
                                            int threads) {
  constexpr int pairs = kWgRows / 2;
  for (int u = tid; u < kWgGroups * pairs; u += threads) {
    const int qp = u % pairs;
    const int grp = u / pairs;
    unsigned w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = *reinterpret_cast<const unsigned*>(raw + (grp * 8 + j) * kWgRows + qp * 2);
    uint4 lo, hi;  // pixel 2 qp, pixel 2 qp + 1
    lo.x = __byte_perm(w[0], w[1], 0x5410);
    lo.y = __byte_perm(w[2], w[3], 0x5410);
    lo.z = __byte_perm(w[4], w[5], 0x5410);
    lo.w = __byte_perm(w[6], w[7], 0x5410);
    hi.x = __byte_perm(w[0], w[1], 0x7632);
    hi.y = __byte_perm(w[2], w[3], 0x7632);
    hi.z = __byte_perm(w[4], w[5], 0x7632);
    hi.w = __byte_perm(w[6], w[7], 0x7632);
    uint16_t* dst = xt + (grp * kWgRows + qp * 2) * 8;
    *reinterpret_cast<uint4*>(dst) = lo;
    *reinterpret_cast<uint4*>(dst + 8) = hi;
  }
}

// WG warpgroups a block, each over 64 output channels f; all share the x
// windows of the block's 32 input channels.
template <int WG>
struct WgTile {
  static constexpr int kF = 64 * WG;  // output channels per block
  static constexpr int kThreads = 128 * WG;
  static constexpr int kDyElems = kF * kWgDyPitch;
  static constexpr int kStageBytes = (kDyElems + kWgRawElems) * 2 + kStep;  // + the edge table
  // the transposed windows, then the ring
  static constexpr int kSmem = kWgTElems * 2 + kWgStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(64 * kWgOutPitch * 4 <= kSmem, "a warpgroup's output tile must fit");
};

// Warpgroups a block: one where F <= 64 (the second would compute padding),
// else two, which share each step's x rows (see the head comment).
inline int warpgroups_for(int F) { return F > 64 ? 2 : 1; }
// What one pipeline step of a block costs, in partial floats of the split
// rule (conv3x3_filter_grad_splits): about 3.6 us either way (2 blocks of one
// warpgroup an SM, or 1 of two: 0.185 ms for 48 steps a block at the
// 56x56x64 stage and 0.234 ms for 64 at 14x14x256, chip_smoke.py phase 4,
// H100), the time of 1.5 M floats of 8 bytes moved at 3.35 TB/s.
constexpr double kWgPartialsPerStep = 1.5e6;
constexpr int kWgVec = 8;  // elements a cp.async copies: 16 bytes, or the repack

// Block (cx, fy, split) owns channels f0 .. f0 + 64 WG - 1, c0 .. c0 + 31
// (all 9 taps) and the pipeline steps [split * chunk, (split + 1) * chunk)
// of the N * ceil(H*W / 64) steps, image by image.  Planes of H*W pixels
// lie `pitch` elements apart (H*W, or more in a repacked copy).
template <int WG>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? 2 : 1)
    filter_grad_wgmma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ top,
                             const uint16_t* __restrict__ bottom,
                             const uint16_t* __restrict__ dy, float* __restrict__ part, int N,
                             int C, int H, int W, int F, int chunk, int pitch) {
  using Tile = WgTile<WG>;
  constexpr int VEC = kWgVec;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint16_t* xt = reinterpret_cast<uint16_t*>(smem);  // the transposed windows
  unsigned char* ring = smem + kWgTElems * 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows 16 warp .. of the block's f
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int total = N * per_image;
  const int c0 = blockIdx.x * kWgC;
  const int f0 = blockIdx.y * Tile::kF;
  const int t_begin = blockIdx.z * chunk;
  const int t_end = t_begin + chunk < total ? t_begin + chunk : total;
  const int steps = t_end - t_begin;
  CLOCKS_BEGIN

  auto stage_dy = [&](int slot) {
    return reinterpret_cast<uint16_t*>(ring + slot * Tile::kStageBytes);
  };

  // Stages step t (image n, pixels p0 .. p0 + 63) into ring slot `slot`.
  auto load_step = [&](int t, int slot) {
    uint16_t* dys = stage_dy(slot);
    uint16_t* raw = dys + Tile::kDyElems;
    uint8_t* edge = reinterpret_cast<uint8_t*>(raw + kWgRawElems);
    const int n = t / per_image;
    const int p0 = (t - n * per_image) * kStep;
    constexpr int dy_row_chunks = kStep / VEC;
    for (int i = tid; i < Tile::kF * dy_row_chunks; i += Tile::kThreads) {
      const int r = i / dy_row_chunks;
      const int q = (i - r * dy_row_chunks) * VEC;
      const int f = f0 + r;
      const bool ok = f < F && p0 + q < HW;
      const uint16_t* src = ok ? dy + (static_cast<size_t>(n) * F + f) * pitch + p0 + q : dy;
      copy_chunk<VEC * 2>(dys + r * kWgDyPitch + q, src, ok);
    }
    constexpr int x_row_chunks = kWgRows / VEC;
    for (int i = tid; i < kWgC * x_row_chunks; i += Tile::kThreads) {
      const int cl = i / x_row_chunks;
      const int q = (i - cl * x_row_chunks) * VEC;  // the pixel row
      const int kh = q / kWgWin;
      const int pix = ((p0 + (kh - 1) * W - 1) & ~(VEC - 1)) + q - kh * kWgWin;
      const int c = c0 + cl;
      const bool ok = c < C;
      const size_t plane = static_cast<size_t>(n) * C + c;
      stage_x_chunk<VEC>(raw + cl * kWgRows + q, ok ? x + plane * pitch : x,
                         top ? top + plane * W : nullptr, bottom ? bottom + plane * W : nullptr,
                         pix, HW, W, ok);
    }
    if (tid < kStep) {  // bit 0: the pixel has a left neighbour, bit 1: a right one
      const int w = (p0 + tid) % W;
      edge[tid] = static_cast<uint8_t>((w >= 1 ? 1 : 0) | (w <= W - 2 ? 2 : 0));
    }
  };

  float acc[9][16];  // [kh * 3 + kw][the m64n32 fragment]
#pragma unroll
  for (int j = 0; j < 9; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;

  // The products of one step's S slices of 16 pixels: per slice, dy's A
  // fragment and its two masked copies (kw = 0 without the pixels of the
  // image's left column, kw = 2 without its right column), then 9 wgmma,
  // one a tap, whose B starts at row row0[kh] + kw + the slice's first pixel.
  auto mma_step = [&](const uint16_t* dys, const uint8_t* edge, uint64_t desc,
                      const int (&row0)[3], auto slices) {
    constexpr int S = decltype(slices)::value;
    unsigned a[S][3][4];
#pragma unroll
    for (int ks = 0; ks < S; ++ks) {
      load_a(a[ks][1], dys + warp * 16 * kWgDyPitch, kWgDyPitch, ks * 16, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a0, a1: pixels p, p + 1; a2, a3: p + 8, p + 9
        const int p = ks * 16 + h * 8 + tig * 2;
        const unsigned e0 = edge[p], e1 = edge[p + 1];
        const unsigned left = ((e0 & 1) ? 0x0000ffffu : 0u) | ((e1 & 1) ? 0xffff0000u : 0u);
        const unsigned right = ((e0 & 2) ? 0x0000ffffu : 0u) | ((e1 & 2) ? 0xffff0000u : 0u);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          a[ks][0][h * 2 + r] = a[ks][1][h * 2 + r] & left;
          a[ks][2][h * 2 + r] = a[ks][1][h * 2 + r] & right;
        }
      }
    }
    CLOCK_MARK(5)
#pragma unroll
    for (int j = 0; j < 9; ++j) fence_operands(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < S; ++ks)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          wgmma_m64n32k16(acc[kh * 3 + kw], a[ks][kw],
                          desc + static_cast<uint64_t>(row0[kh] + kw + ks * 16));
    wgmma_commit();
    CLOCK_MARK(6)
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 9; ++j) fence_operands(acc[j]);
    CLOCK_MARK(7)
  };

  CLOCK_MARK(1)
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load_step(t_begin + s, s);
    cp_async_commit();
  }
  CLOCK_MARK(3)

  // Each step waits for its own wgmmas (mma_step): kept in flight across
  // the next step's transpose, their A fragments and accumulators took more
  // registers than ptxas had, and it serialized every wgmma (C7511).
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // step i has landed; slot (i - 1) % kWgStages and xt are free
    CLOCK_MARK(2)
    {
      const int next = i + kWgStages - 1;
      if (next < steps) load_step(t_begin + next, next % kWgStages);
      cp_async_commit();
    }
    CLOCK_MARK(3)
    const int slot = i % kWgStages;
    const uint16_t* dys = stage_dy(slot);
    const uint16_t* raw = dys + Tile::kDyElems;
    const uint8_t* edge = reinterpret_cast<const uint8_t*>(raw + kWgRawElems);
    transpose_x(raw, xt, tid, Tile::kThreads);
    fence_proxy_async();
    CLOCK_MARK(4)
    __syncthreads();  // xt is whole, and visible to every warpgroup's wgmma
    CLOCK_MARK(2)

    const int t = t_begin + i;
    const int n = t / per_image;
    const int p0 = (t - n * per_image) * kStep;
    // the row of output pixel 0 at tap (kh, 0): window kh's, + its start's
    // remainder below the copy width
    int row0[3];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) row0[kh] = kh * kWgWin + ((p0 + (kh - 1) * W - 1) & (VEC - 1));
    const uint64_t desc = b_desc(xt);
    switch ((min(kStep, HW - p0) + 15) / 16) {  // slices holding pixels of the plane
      case 1: mma_step(dys, edge, desc, row0, std::integral_constant<int, 1>{}); break;
      case 2: mma_step(dys, edge, desc, row0, std::integral_constant<int, 2>{}); break;
      case 3: mma_step(dys, edge, desc, row0, std::integral_constant<int, 3>{}); break;
      default: mma_step(dys, edge, desc, row0, std::integral_constant<int, 4>{});
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 9; ++j) fence_operands(acc[j]);
  cp_async_wait<0>();
  CLOCK_MARK(2)

  // The block's partial tile, f rows of 32 c x 9 taps, is 288 contiguous
  // floats of each row of part[split]: staged through shared memory (every
  // warp is done with it) and written row by row, coalesced.
  float* tile = reinterpret_cast<float*>(smem);  // [64][kWgOutPitch], a warpgroup's rows
  const int K = C * 9;
  const int cols = min(kWgC, C - c0) * 9;
  for (int wg = 0; wg < WG; ++wg) {
    __syncthreads();
    if ((warp >> 2) == wg) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = (warp & 3) * 16 + g + ((e >> 1) & 1) * 8;
        const int cl = (e >> 2) * 8 + tig * 2 + (e & 1);
#pragma unroll
        for (int j = 0; j < 9; ++j) tile[r * kWgOutPitch + cl * 9 + j] = acc[j][e];
      }
    }
    __syncthreads();
    const int fw = f0 + wg * 64;
    const int rows = min(64, F - fw);
    float* out = part + (static_cast<size_t>(blockIdx.z) * F + fw) * K + c0 * 9;
    for (int i = tid; i < rows * kWgC * 9; i += Tile::kThreads) {
      const int r = i / (kWgC * 9);
      const int col = i - r * (kWgC * 9);
      if (col < cols) out[static_cast<size_t>(r) * K + col] = tile[r * kWgOutPitch + col];
    }
  }
  CLOCK_MARK(9)
  CLOCKS_END
}

template <int WG>
int launch_bf16(const void* x, const void* top, const void* bottom, const void* dy, void* part,
                int N, int C, int H, int W, int F, int splits, int chunk, int pitch,
                cudaStream_t stream) {
  using Tile = WgTile<WG>;
  auto kernel = filter_grad_wgmma_kernel<WG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kWgC - 1) / kWgC, (F + Tile::kF - 1) / Tile::kF, splits);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(top),
      static_cast<const uint16_t*>(bottom), static_cast<const uint16_t*>(dy),
      static_cast<float*>(part), N, C, H, W, F, chunk, pitch);
  return static_cast<int>(cudaGetLastError());
}

// One wgmma as the kernel issues it: d (64 x 32, f32) = a (64 x 16) times
// rows row .. row + 15 of b (rows x 32), both bf16 and row-major.  A goes
// through shared memory and ldmatrix into registers, b into the transposed
// layout [c / 8][pixel row][8] of kWgRows rows, read through the descriptor
// started `row` pixel rows (16-byte units) in.
__global__ void __launch_bounds__(128)
    wgmma_selftest_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                          float* __restrict__ d, int rows, int row) {
  __shared__ __align__(128) uint16_t bs[kWgTElems];
  __shared__ __align__(16) uint16_t as[64 * kWgDyPitch];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < 64 * 16; i += 128) as[(i / 16) * kWgDyPitch + i % 16] = a[i];
  for (int i = tid; i < kWgRows * kWgC; i += 128) {
    const int r = i / kWgC, c = i % kWgC;
    bs[((c / 8) * kWgRows + r) * 8 + c % 8] = r < rows ? b[i] : 0;
  }
  fence_proxy_async();
  __syncthreads();
  unsigned frag[4];
  load_a(frag, as + warp * 16 * kWgDyPitch, kWgDyPitch, 0, lane);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  fence_operands(acc);
  wgmma_fence();
  wgmma_m64n32k16(acc, frag, b_desc(bs) + static_cast<uint64_t>(row));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int e = 0; e < 16; ++e)
    d[(warp * 16 + g + ((e >> 1) & 1) * 8) * kWgC + (e >> 2) * 8 + tig * 2 + (e & 1)] = acc[e];
}

// ---------------------------------------------------------------------------
// f32 instance: TF32 warpgroup MMA (wgmma), 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTfC = 64;          // input channels per block: the wgmma's M
constexpr int kTfF = 64;          // output channels per block: the wgmma's N

// The big and small TF32 parts of n floats at v (a multiple of 4, 16-byte
// aligned), by `threads` threads: v keeps the big parts, small takes the
// rest (split_tf32), element for element, so any layout (a swizzled one
// too) is kept.
__device__ __forceinline__ void split_in_place(float* v, float* small, int n, int tid,
                                               int threads) {
  for (int i = tid * 4; i < n; i += threads * 4) {
    const float4 x = *reinterpret_cast<const float4*>(v + i);
    uint4 b, r;
    split_tf32(x.x, b.x, r.x);
    split_tf32(x.y, b.y, r.y);
    split_tf32(x.z, b.z, r.z);
    split_tf32(x.w, b.w, r.w);
    *reinterpret_cast<uint4*>(v + i) = b;
    *reinterpret_cast<uint4*>(small + i) = r;
  }
}

// The first 1,024-byte boundary at or after p (a swizzle atom's alignment).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// The TF32 wgmma on its own, as the f32 kernel issues it: d (64 x 64, f32)
// = a (64 x 8 slices) times b (64 x 8 slices)^T, both f32, row-major.  a
// goes into registers split in big and small TF32 parts, warp w holding
// rows 16 w .. 16 w + 15 in mma.sync m16n8k8's TF32 A layout: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) (the other order measured
// 0.6-4 of the sum of |terms| away on an H100).  b lands by tensor copies
// of 32 k x 64 with the 128-byte swizzle, 64 k a chunk, and is split in
// place; each k8
// slice is read through the descriptor started 32 bytes a slice into a
// row.  Each slice is three wgmma (small * big, big * small, big * big);
// the products of `depth` consecutive slices are summed in the tensor cores
// from zero and added to the running sums with an f32 add, or with depth 0
// every product is summed in the tensor cores.
__global__ void __launch_bounds__(128)
    tf32_selftest_kernel(const __grid_constant__ CUtensorMap bmap, const float* __restrict__ a,
                         float* __restrict__ d, int slices, int depth) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int N = kTfF;
  constexpr int kBox = N * 32;  // floats of one box: N rows of 32 k
  float* big = reinterpret_cast<float*>(align_1024(smem_raw));
  float* small = big + 2 * kBox;
  uint64_t* bar = reinterpret_cast<uint64_t*>(small + 2 * kBox);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int K = slices * 8;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int row[4], col[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    row[e] = 16 * warp + g + 8 * (e & 1);
    col[e] = t + 4 * (e >> 1);
  }
  float acc[N / 2], tmp[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = tmp[e] = 0.f;
  int in_window = 0;
  for (int ch = 0; ch * 8 < slices; ++ch) {
    if (tid == 0) {
      mbar_arrive_expect(bar, 2 * kBox * 4);
      tma_load_3d(big, &bmap, ch * 64, 0, 0, bar);
      tma_load_3d(big + kBox, &bmap, ch * 64 + 32, 0, 0, bar);
    }
    mbar_wait(bar, ch & 1);
    split_in_place(big, small, 2 * kBox, tid, 128);
    fence_proxy_async();
    __syncthreads();
    for (int s = 0; s < 8 && ch * 8 + s < slices; ++s) {
      unsigned ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(a[static_cast<size_t>(row[e]) * K + ch * 64 + s * 8 + col[e]], ab[e], as[e]);
      const int off = (s >> 2) * kBox + (s & 3) * 8;
      const uint64_t db = smem_desc_sw128(big + off), ds = smem_desc_sw128(small + off);
      auto products = [&](float(&dst)[N / 2], int scale_d) {
        fence_operands(dst);
        wgmma_fence();
        Tf32Wgmma<kTfF>::mma(dst, as, db, scale_d);
        Tf32Wgmma<kTfF>::mma(dst, ab, ds, 1);
        Tf32Wgmma<kTfF>::mma(dst, ab, db, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dst);
      };
      if (depth == 0) {
        products(acc, 1);
      } else {
        products(tmp, in_window != 0);
        if (++in_window == depth) {
#pragma unroll
          for (int e = 0; e < N / 2; ++e) acc[e] += tmp[e];
          in_window = 0;
        }
      }
    }
    __syncthreads();  // every warp is done with the chunk before the next lands
  }
  if (depth != 0 && in_window != 0) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] += tmp[e];
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    d[(16 * warp + g + ((e >> 1) & 1) * 8) * N + (e >> 2) * 8 + 2 * t + (e & 1)] = acc[e];
}

int tf32_selftest(const void* a, const void* b, void* d, int slices, int depth,
                  cudaStream_t stream) {
  constexpr int N = kTfF;
  CUtensorMap bmap;
  const long long K = static_cast<long long>(slices) * 8;
  int err = tensor_map_3d(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, b, K, N, 1, K * 4, K * N * 4,
                          32, N, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int smem = 1024 + 4 * N * 32 * 4 + 16;
  auto kernel = tf32_selftest_kernel;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  kernel<<<1, 128, smem, stream>>>(bmap, static_cast<const float*>(a), static_cast<float*>(d),
                                   slices, depth);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTfXBox = 76;       // pixels of an x window: 69 read past a start rounded down to 4
constexpr int kTfOutPitch = kTfC * 9 + 1;  // floats a row of the staged output tile: odd

// The f32 instance's block: three warpgroups, warpgroup kh owning the taps
// (kh, 0 .. 2) of 64 input channels x 64 output channels (the wgmma's N),
// sharing each step's dy.  Shared memory: a ring of 3 slots of x's three
// windows [kh][c][76] (kh's window from plane pixel p0 + (kh - 1) W - 1
// rounded down to 4), copied 2 steps ahead; a ring of 2 slots of dy as the
// tensor copy lands it (2 boxes of 64 f x 32 pixels, 128-byte swizzle;
// split in place into its big TF32 parts), copied 1 step ahead; dy's small
// parts for the step; the step's edge table; the mbarriers of the slots.
// The output tile, 64 rows (f) of 64 c x 9 taps, reuses the rings after the
// last step.
struct TfTile {
  static constexpr int kThreads = 384;
  static constexpr int kXStages = 3;
  static constexpr int kDyStages = 2;
  static constexpr int kDyBox = kTfF * 32 * 4;   // bytes of one dy box
  static constexpr int kDyBytes = 2 * kDyBox;  // a step's dy, or its small parts
  static constexpr int kXBytes = 3 * kTfC * kTfXBox * 4;
  static constexpr int kDyOff = kXStages * kXBytes;
  static constexpr int kSmallOff = kDyOff + kDyStages * kDyBytes;
  static constexpr int kEdgeOff = kSmallOff + kDyBytes;
  static constexpr int kBarOff = kEdgeOff + kStep;
  static constexpr int kSmem = 1024 + kBarOff + (kXStages + kDyStages) * 8;  // + aligning to 1,024
  static_assert(kDyBox % 1024 == 0 && kXBytes % 1024 == 0,
                "dy's swizzle atoms must stay 1,024-byte aligned");
  static_assert(kTfF * kTfOutPitch * 4 <= kEdgeOff, "the output tile must fit the rings");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};
// What one pipeline step of a block costs, in partial floats of the split
// rule (conv3x3_filter_grad_splits): about 6.6 us (0.316 ms for 48 steps a
// block at the 56x56x64 stage, one block an SM, H100), the time of 2.8 M
// floats of 8 bytes moved at 3.35 TB/s.
constexpr double kTfPartialsPerStep = 2.8e6;

// Block (cx, fy, split) owns input channels c0 .. c0 + 63, output channels
// f0 .. f0 + 63 (all 9 taps) and the pipeline steps [split * chunk,
// (split + 1) * chunk) of the N * ceil(H*W / 64) steps, image by image.
// xmap is x (or its repacked copy) as a tensor of (H*W pixels, C, N), dymap
// dy as one of (H*W, F, N).  top and bottom: x's halo rows, or null.
__global__ void __launch_bounds__(384, 1)
    filter_grad_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap dymap,
                            const float* __restrict__ top, const float* __restrict__ bottom,
                            float* __restrict__ part, int N, int C, int H, int W, int F,
                            int chunk) {
  using L = TfTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint8_t* edge = smem + L::kEdgeOff;  // the step's pixels: bit 0 a left, bit 1 a right neighbour
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L::kBarOff);  // x's slots, then dy's
  uint64_t* dybar = xbar + L::kXStages;
  float* small = reinterpret_cast<float*>(smem + L::kSmallOff);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = warp >> 2;  // this warpgroup's row of taps
  const int wq = warp & 3;   // channels 16 wq .. 16 wq + 15 of the block's 64
  const int g = lane >> 2;
  const int t = lane & 3;
  const int HW = H * W;
  const int per_image = (HW + kStep - 1) / kStep;
  const int total = N * per_image;
  const int c0 = blockIdx.x * kTfC;
  const int f0 = blockIdx.y * kTfF;
  const int t_begin = blockIdx.z * chunk;
  const int t_end = t_begin + chunk < total ? t_begin + chunk : total;
  const int steps = t_end - t_begin;
  CLOCKS_BEGIN

  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < L::kXStages + L::kDyStages; ++b) mbar_init(&xbar[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // The copies of step i of the block, by one thread: x's windows into slot
  // i % 3, dy (2 boxes of 32 pixels) into slot i % 2.  Boxes reaching
  // outside the tensor land zeros there (x before or past the plane or past
  // C, dy past the plane or past F).
  auto load_x = [&](int i) {
    if (tid != 0) return;
    const int tt = t_begin + i;
    const int n = tt / per_image;
    const int p0 = (tt - n * per_image) * kStep;
    uint64_t* bar = &xbar[i % L::kXStages];
    float* xs = reinterpret_cast<float*>(smem + (i % L::kXStages) * L::kXBytes);
    mbar_arrive_expect(bar, L::kXBytes);
#pragma unroll
    for (int h = 0; h < 3; ++h)
      tma_load_3d(xs + h * kTfC * kTfXBox, &xmap, (p0 + (h - 1) * W - 1) & ~3, c0, n, bar);
  };
  auto load_dy = [&](int i) {
    if (tid != 0) return;
    const int tt = t_begin + i;
    const int n = tt / per_image;
    const int p0 = (tt - n * per_image) * kStep;
    uint64_t* bar = &dybar[i & 1];
    unsigned char* dst = smem + L::kDyOff + (i & 1) * L::kDyBytes;
    mbar_arrive_expect(bar, L::kDyBytes);
    tma_load_3d(dst, &dymap, p0, f0, n, bar);
    tma_load_3d(dst + L::kDyBox, &dymap, p0 + 32, f0, n, bar);
  };
  // Halo rows: window elements of rows -1 and H come from top and bottom
  // (the copy landed zeros there), element by element, where given.
  auto patch_halo = [&](float* xs, int n, int p0) {
    const float* rows[2] = {top, bottom};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int h = side * 2;
      const int first = (p0 + (h - 1) * W - 1) & ~3;
      const int lo = side == 0 ? -W : HW;  // the halo row's pixels lo .. lo + W - 1
      if (rows[side] == nullptr || first + kTfXBox <= lo || first >= lo + W) continue;
      for (int i = tid; i < kTfC * kTfXBox; i += L::kThreads) {
        const int cl = i / kTfXBox;
        const int k = first + i - cl * kTfXBox - lo;  // column in the halo row
        const int c = c0 + cl;
        if (k >= 0 && k < W && c < C)
          xs[h * kTfC * kTfXBox + i] = rows[side][(static_cast<size_t>(n) * C + c) * W + k];
      }
    }
  };

  float acc[3][kTfF / 2];  // [kw][the m64n64 fragment]: dw^T, channels x f
  float tmp[kTfF / 2];     // one tap's products of the step, summed in the tensor cores
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int e = 0; e < kTfF / 2; ++e) acc[kw][e] = 0.f;
#pragma unroll
  for (int e = 0; e < kTfF / 2; ++e) tmp[e] = 0.f;

  // The products of one step's S slices of 8 pixels, tap by tap: for each
  // slice x's A fragment at the tap (row g or g + 8 of the warp's 16
  // channels; pixels 8 s + t and 8 s + t + 4, shifted by kw; zero where the
  // tap wraps across the image's left or right edge), split into big and
  // small TF32 parts; then three wgmma against dy's slice (small * big, big
  // * small, big * big), into tmp from zero at the tap's first slice, one
  // commit group, and a wait for it (its A registers are then free for the
  // next slice).  After the tap's last slice the running sums take the
  // step's products with one f32 add (accumulated in the tensor cores over a
  // whole split they would lose too much, head comment).  The slices are a
  // loop, not unrolled: one copy of the code, and fewer values live across
  // it (an unrolled copy for each slice count spilled more and took longer).
  auto mma_step = [&](const float* r0, unsigned lbits, unsigned rbits, uint64_t db,
                      uint64_t ds, int S) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
#pragma unroll 1
      for (int s = 0; s < S; ++s) {
        unsigned ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const int h = e >> 1;
          const float v = r0[(e & 1) * 8 * kTfXBox + 8 * s + 4 * h + kw];
          const bool ok = kw == 1 || (((kw == 0 ? lbits : rbits) >> (2 * s + h)) & 1u);
          split_tf32(ok ? v : 0.f, ab[e], as[e]);
        }
        CLOCK_MARK(5)
        const uint64_t at = static_cast<uint64_t>(((s >> 2) * L::kDyBox + (s & 3) * 32) >> 4);
        if (s == 0) fence_operands(tmp);
        wgmma_fence();
        Tf32Wgmma<kTfF>::mma(tmp, as, db + at, s != 0);
        Tf32Wgmma<kTfF>::mma(tmp, ab, ds + at, 1);
        Tf32Wgmma<kTfF>::mma(tmp, ab, db + at, 1);
        wgmma_commit();
        CLOCK_MARK(6)
        wgmma_wait<0>();
        CLOCK_MARK(7)
      }
      fence_operands(tmp);
#pragma unroll
      for (int e = 0; e < kTfF / 2; ++e) acc[kw][e] += tmp[e];
      CLOCK_MARK(8)
    }
  };

  CLOCK_MARK(1)
  if (steps > 0) {
    load_x(0);
    load_dy(0);
  }
  if (steps > 1) load_x(1);
  CLOCK_MARK(3)
  for (int i = 0; i < steps; ++i) {
    const int tt = t_begin + i;
    const int n = tt / per_image;
    const int p0 = (tt - n * per_image) * kStep;
    float* xs = reinterpret_cast<float*>(smem + (i % L::kXStages) * L::kXBytes);
    float* dyb = reinterpret_cast<float*>(smem + L::kDyOff + (i & 1) * L::kDyBytes);
    mbar_wait(&xbar[i % L::kXStages], (i / L::kXStages) & 1);
    mbar_wait(&dybar[i & 1], (i >> 1) & 1);
    CLOCK_MARK(2)
    // every warp is done with step i - 1: its slots and the small parts
    // are free for the next copies and this step's split
    __syncthreads();
    CLOCK_MARK(10)
    if (i + 1 < steps) load_dy(i + 1);
    if (i + 2 < steps) load_x(i + 2);
    CLOCK_MARK(3)
    if (tid < kStep) {
      const int w = (p0 + tid) % W;
      edge[tid] = static_cast<uint8_t>((w >= 1 ? 1 : 0) | (w <= W - 2 ? 2 : 0));
    }
    if (top != nullptr || bottom != nullptr) patch_halo(xs, n, p0);
    split_in_place(dyb, small, L::kDyBytes / 4, tid, L::kThreads);
    fence_proxy_async();
    CLOCK_MARK(4)
    __syncthreads();  // dy's two parts, the edge table and the halo rows are whole
    CLOCK_MARK(10)

    const int first = (p0 + (kh - 1) * W - 1) & ~3;
    const float* r0 =
        xs + (kh * kTfC + wq * 16 + g) * kTfXBox + (p0 + (kh - 1) * W - 1 - first) + t;
    unsigned lbits = 0, rbits = 0;  // bit 2 s + h: pixel 8 s + t + 4 h
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const unsigned e = edge[8 * (j >> 1) + t + 4 * (j & 1)];
      lbits |= (e & 1u) << j;
      rbits |= ((e >> 1) & 1u) << j;
    }
    const uint64_t db = smem_desc_sw128(dyb), ds = smem_desc_sw128(small);
    // the slices holding pixels of the plane
    mma_step(r0, lbits, rbits, db, ds, (min(kStep, HW - p0) + 7) / 8);
  }
  __syncthreads();  // every warp is done with the ring
  CLOCK_MARK(10)

  // The block's partial tile, 64 rows (f) of 64 c x 9 taps, is 576
  // contiguous floats of each row of part[split]: staged through shared
  // memory and written row by row, coalesced.
  float* tile = reinterpret_cast<float*>(smem);  // [64][kTfOutPitch]
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int e = 0; e < kTfF / 2; ++e) {
      const int cl = wq * 16 + g + ((e >> 1) & 1) * 8;
      const int fl = (e >> 2) * 8 + 2 * t + (e & 1);
      tile[fl * kTfOutPitch + cl * 9 + kh * 3 + kw] = acc[kw][e];
    }
  __syncthreads();
  const int K = C * 9;
  const int rows = min(kTfF, F - f0);
  const int cols = min(kTfC, C - c0) * 9;
  float* out = part + (static_cast<size_t>(blockIdx.z) * F + f0) * K + c0 * 9;
  for (int i = tid; i < rows * kTfC * 9; i += L::kThreads) {
    const int r = i / (kTfC * 9);
    const int col = i - r * (kTfC * 9);
    if (col < cols) out[static_cast<size_t>(r) * K + col] = tile[r * kTfOutPitch + col];
  }
  CLOCK_MARK(9)
  CLOCKS_END
}

// x and dy (planes `pitch` floats apart, a multiple of 4, 16-byte aligned)
// as the tensor maps of filter_grad_tf32_kernel: x's boxes 76 pixels x 64
// channels, dy's 32 pixels x 64 f with the 128-byte swizzle; the pixels
// from H*W up to the pitch, like those before 0, lie outside them.
int launch_f32(const void* x, const void* top, const void* bottom, const void* dy, void* part,
               int N, int C, int H, int W, int F, int splits, int chunk, int pitch,
               cudaStream_t stream) {
  CUtensorMap xmap, dymap;
  int err = tensor_map_3d(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, H * W, C, N,
                          static_cast<long long>(pitch) * 4,
                          static_cast<long long>(pitch) * C * 4, kTfXBox, kTfC,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = tensor_map_3d(&dymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dy, H * W, F, N,
                        static_cast<long long>(pitch) * 4, static_cast<long long>(pitch) * F * 4,
                        32, kTfF, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  using L = TfTile;
  auto kernel = filter_grad_tf32_kernel;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem));
  if (err != 0) return err;
  const dim3 grid((C + kTfC - 1) / kTfC, (F + kTfF - 1) / kTfF, splits);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      xmap, dymap, static_cast<const float*>(top), static_cast<const float*>(bottom),
      static_cast<float*>(part), N, C, H, W, F, chunk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Choosing the instance's path and its splits
// ---------------------------------------------------------------------------

// The copy width, in elements, the instance takes: bf16 8 (16-byte
// cp.async), f32 4 (tensor copies, whose strides must be multiples of 16
// bytes); 1 where it does not fit and the operands are repacked into padded
// planes (bf16 takes no 8-byte copies: see the head comment).
int copy_width_of(const void* x, const void* dy, int HW, bool bf16) {
  if (!bf16) return copy_width<4>(HW, x, dy) >= 4 ? 4 : 1;
  return copy_width<2>(HW, x, dy) == 8 ? 8 : 1;
}

long long resident_bf16[2][64] = {};
long long resident_f32[64] = {};

// Blocks of the instance for F output channels resident at once on the
// current device (0 if the device cannot be queried).
long long resident_blocks_of(bool bf16, int F) {
  if (!bf16)
    return resident_blocks(filter_grad_tf32_kernel, TfTile::kThreads, TfTile::kSmem,
                           resident_f32);
  if (warpgroups_for(F) == 2)
    return resident_blocks(filter_grad_wgmma_kernel<2>, WgTile<2>::kThreads, WgTile<2>::kSmem,
                           resident_bf16[1]);
  return resident_blocks(filter_grad_wgmma_kernel<1>, WgTile<1>::kThreads, WgTile<1>::kSmem,
                         resident_bf16[0]);
}

// Each instance's tile (output channels x input channels a block) and what
// one of its pipeline steps costs in partial floats (the split rule below).
struct SplitModel {
  int tile_f, tile_c;
  double partials_per_step;
};

SplitModel split_model(bool bf16, int F) {
  if (bf16) return {64 * warpgroups_for(F), kWgC, kWgPartialsPerStep};
  return {kTfF, kTfC, kTfPartialsPerStep};
}

}  // namespace

extern "C" {


// How conv3x3_filter_grad splits its contraction: returns the number of
// splits and writes to *chunk the pipeline steps (64 pixels of one image)
// of each; the last split may be shorter.
//
// The split count s minimizes an estimate of the time in units of one
// block's pipeline step: the waves of blocks (as many resident at once as
// the current device's SMs times the blocks an SM holds of the instance and
// its tile: on an H100 SXM 2 x 132 bf16 blocks of one warpgroup, 1 x 132 of
// two, 1 x 132 f32) times the steps of a split, plus writing and re-reading
// the s partial tiles.  The one constant fitted to the card, per instance,
// is what a step costs in partial floats (8 bytes each moved at 3.35 TB/s):
// bf16 1.5 M (kWgPartialsPerStep), f32 2.8 M (kTfPartialsPerStep).  This
// keeps the grid from spilling a few blocks into a second wave: at the
// ResNet-50 stage shapes the f32 instance takes 131 / 33 / 8 / 2 splits of
// its 1 / 4 / 16 / 64 tiles, at 224 px and at 448 px.  Returns -1 if the
// device cannot be queried.
int conv3x3_filter_grad_splits(int N, int C, int H, int W, int F, int is_bf16, int* chunk) {
  const long long slots = resident_blocks_of(is_bf16 != 0, F);
  if (slots <= 0) return -1;
  const SplitModel model = split_model(is_bf16 != 0, F);
  const long long work =
      static_cast<long long>(N) * ((static_cast<long long>(H) * W + kStep - 1) / kStep);
  const long long tiles = static_cast<long long>((C + model.tile_c - 1) / model.tile_c) *
                          ((F + model.tile_f - 1) / model.tile_f);
  const double partial = static_cast<double>(F) * 9 * C / model.partials_per_step;
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
    const void* xs = x;
    const void* dys = dy;
    int pitch = HW;
    err = 0;
    if (copy_width_of(x, dy, HW, true) == 1) {
      if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      pitch = padded_pitch(HW);
      uint16_t* xp = static_cast<uint16_t*>(scratch);
      uint16_t* dyp = xp + static_cast<size_t>(N) * C * pitch;
      err = pad_planes<uint16_t>(x, xp, static_cast<long long>(N) * C, HW, pitch, st);
      if (err == 0)
        err = pad_planes<uint16_t>(dy, dyp, static_cast<long long>(N) * F, HW, pitch, st);
      xs = xp;
      dys = dyp;
    }
    if (err == 0)
      err = warpgroups_for(F) == 2
                ? launch_bf16<2>(xs, top, bottom, dys, part, N, C, H, W, F, splits, chunk, pitch, st)
                : launch_bf16<1>(xs, top, bottom, dys, part, N, C, H, W, F, splits, chunk, pitch, st);
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
// these operands, so that a caller can see which path ran: bf16 8 (16-byte
// cp.async), f32 4 (tensor copies), or 1 (the repack into padded planes).
int conv3x3_filter_grad_copy_width(const void* x, const void* dy, int H, int W, int is_bf16) {
  return copy_width_of(x, dy, H * W, is_bf16 != 0);
}

// Which instance conv3x3_filter_grad runs for a dtype, for a caller to report.
const char* conv3x3_filter_grad_instance(int is_bf16) {
  return is_bf16 ? "tensor cores: wgmma m64n32k16 bf16, 64 f x 32 c x 9 taps a warpgroup, "
                   "1 warpgroup a block where F <= 64, else 2"
                 : "tensor cores: wgmma m64n64k8 3xTF32, 64 c x 64 f x 3 taps a warpgroup, "
                   "3 warpgroups a block";
}

// The bf16 instance's wgmma on its own (wgmma_selftest_kernel): d (64 x 32,
// f32) = a (64 x 16) times rows row .. row + 15 of b (rows x 32), a and b
// bf16, row-major, contiguous; rows <= 240 and row + 16 <= rows, else
// cudaErrorInvalidValue.
int conv3x3_filter_grad_wgmma_selftest(const void* a, const void* b, void* d, int rows,
                                       int row, void* stream) {
  if (rows > kWgRows || row < 0 || row + 16 > rows) return static_cast<int>(cudaErrorInvalidValue);
  wgmma_selftest_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), static_cast<float*>(d),
      rows, row);
  return static_cast<int>(cudaGetLastError());
}

// The f32 instance's TF32 wgmma on its own (tf32_selftest_kernel): d (64 x
// n, f32) = a (64 x 8 slices) times b (n x 8 slices)^T, all f32,
// row-major, contiguous; n the kernel's 64, else cudaErrorInvalidValue.
int conv3x3_filter_grad_tf32_selftest(const void* a, const void* b, void* d, int n, int slices,
                                      int depth, void* stream) {
  if (n != kTfF || slices < 1 || depth < 0) return static_cast<int>(cudaErrorInvalidValue);
  return tf32_selftest(a, b, d, slices, depth, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
