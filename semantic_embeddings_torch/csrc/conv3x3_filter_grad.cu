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
// 16-pixel slices are skipped), fed by a 3-stage cp.async ring that stages
// dy (the block's f x 64 pixels) and, for each input channel, the pixel
// rows of x the step's taps read (the rows above and below come from the
// plane itself, zero or the halo rows outside it).  A block owns all 9 taps
// of its input channels, so each staged x value serves all of them.  The
// split count comes from the device's resident blocks (below).
//
// bf16 instance: Hopper's warpgroup MMA, wgmma.mma_async m64n32k16 (bf16
// in, f32 accumulate; bf16 products are exact in f32), A from registers, B
// from shared memory.
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
// f32 instance: a warp-level GEMM, 3xTF32 on mma.sync m16n8k8 (the split
// and the mma in conv3x3_common.cuh, shared with the conv + statistics
// kernel).  Both operands are K-major in NCHW: dy's pixels (A, row-major,
// ldmatrix) and, for each (c, kh), x's window of conv3x3_common.cuh (B,
// column-major); no transpose.  A block owns 64 f x 16 c x 9 taps over 4
// warps (2 x 32 f, 2 x 8 c; 72 accumulators a thread).  Output pixel p and
// tap (kh, kw) read window element p + kw: the shift breaks ldmatrix's
// alignment, so x's fragments come from plain shared loads, each serving
// the three kw, masked at the image's left and right columns (the edge
// table staged with the step).  Each f32
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
// ptxas (sm_90a, CUDA 12.9): no spills anywhere; the bf16 kernel 218
// registers, one warpgroup 89,280 bytes of dynamic shared memory (the
// transposed rows, 15,360, and 3 stages of 24,640), 2 blocks an SM, two
// warpgroups 116,928 bytes, 1 block an SM (registers bound both); the f32
// kernel 207 registers and 96,192 bytes, 2 blocks an SM; the self-test 46
// registers; the repack and the ordered reduction 16 and 32 registers.
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
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 9; ++j) fence_operands(acc[j]);
  };

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load_step(t_begin + s, s);
    cp_async_commit();
  }

  // Each step waits for its own wgmmas (mma_step): kept in flight across
  // the next step's transpose, their A fragments and accumulators took more
  // registers than ptxas had, and it serialized every wgmma (C7511).
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // step i has landed; slot (i - 1) % kWgStages and xt are free
    {
      const int next = i + kWgStages - 1;
      if (next < steps) load_step(t_begin + next, next % kWgStages);
      cp_async_commit();
    }
    const int slot = i % kWgStages;
    const uint16_t* dys = stage_dy(slot);
    const uint16_t* raw = dys + Tile::kDyElems;
    const uint8_t* edge = reinterpret_cast<const uint8_t*>(raw + kWgRawElems);
    transpose_x(raw, xt, tid, Tile::kThreads);
    fence_proxy_async();
    __syncthreads();  // xt is whole, and visible to every warpgroup's wgmma

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
// f32 instance (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kF32F = 64;         // output channels per block
constexpr int kF32C = 16;         // input channels per block (x 9 taps = 144 columns)
constexpr int kF32Stages = 3;     // depth of the cp.async ring
constexpr int kF32Threads = 128;  // 4 warps: 2 (32 f each) x 2 (8 c each)

constexpr int kF32DyPitch = kStep + 4;  // 272-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kF32XPitch = 76;          // 3 rows (one channel) = 228 words = 4 mod 32 banks
constexpr int kF32DyElems = kF32F * kF32DyPitch;
constexpr int kF32XElems = kF32C * 3 * kF32XPitch;
constexpr int kF32StageBytes = (kF32DyElems + kF32XElems) * 4 + kStep;  // + the edge table
constexpr int kF32Smem = kF32Stages * kF32StageBytes;
static_assert(kF32StageBytes % 16 == 0, "stages must stay 16-byte aligned");
constexpr int kF32Vec = 4;             // floats a 16-byte cp.async copies
static_assert(window_len<kF32Vec>() <= kF32XPitch, "x window exceeds its row");

// Block (cx, fy, split) owns channels f0 .. f0+63, c0 .. c0+15 (all 9 taps)
// and the pipeline steps [split * chunk, (split + 1) * chunk) of the N *
// ceil(H*W / 64) steps, image by image, on f32 operands with 16-byte copies
// and planes `pitch` floats apart (H*W, or more in a repacked copy).
__global__ void __launch_bounds__(kF32Threads, 2)
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
  const int c0 = blockIdx.x * kF32C;
  const int f0 = blockIdx.y * kF32F;
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
    for (int i = tid; i < kF32F * dy_row_chunks; i += kF32Threads) {
      const int r = i / dy_row_chunks;
      const int q = (i - r * dy_row_chunks) * kF32Vec;
      const int f = f0 + r;
      const bool ok = f < F && p0 + q < HW;
      const float* src = ok ? dy + (static_cast<size_t>(n) * F + f) * pitch + p0 + q : dy;
      copy_chunk<kF32Vec * 4>(dys + r * kF32DyPitch + q, src, ok);
    }
    constexpr int x_row_chunks = window_len<kF32Vec>() / kF32Vec;
    for (int i = tid; i < kF32C * 3 * x_row_chunks; i += kF32Threads) {
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
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < steps) load_step(t_begin + s, s);
    cp_async_commit();
  }

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    {
      const int next = i + kF32Stages - 1;
      if (next < steps) load_step(t_begin + next, next % kF32Stages);
      cp_async_commit();
    }

    const int slot = i % kF32Stages;
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
  const dim3 grid((C + kF32C - 1) / kF32C, (F + kF32F - 1) / kF32F, splits);
  filter_grad_f32_kernel<<<grid, kF32Threads, kF32Smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(top),
      static_cast<const float*>(bottom), static_cast<const float*>(dy), static_cast<float*>(part),
      N, C, H, W, F, chunk, pitch);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Choosing the instance's path and its splits
// ---------------------------------------------------------------------------

// The copy width, in elements, the instance takes: bf16 8, f32 4 (16-byte
// cp.async); 1 where it does not fit and the operands are repacked into
// padded planes (bf16 takes no 8-byte copies: see the head comment).
int copy_width_of(const void* x, const void* dy, int HW, bool bf16) {
  if (!bf16) return copy_width<4>(HW, x, dy) >= 4 ? 4 : 1;
  return copy_width<2>(HW, x, dy) == 8 ? 8 : 1;
}

long long resident_bf16[2][64] = {};
long long resident_f32[64] = {};

// Blocks of the instance for F output channels resident at once on the
// current device (0 if the device cannot be queried).
long long resident_blocks_of(bool bf16, int F) {
  if (!bf16) return resident_blocks(filter_grad_f32_kernel, kF32Threads, kF32Smem, resident_f32);
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
  return {kF32F, kF32C, 2.7e6};
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
// two, 2 x 132 f32) times the steps of a split, plus writing and re-reading
// the s partial tiles.  The one constant fitted to the card, per instance,
// is what a step costs in partial floats (8 bytes each moved at 3.35 TB/s):
// bf16 1.5 M (kWgPartialsPerStep); an f32 step about 6.5 us at 2 blocks an
// SM (0.618 ms for 95 steps), 2.7 M.  This keeps the grid from spilling a
// few blocks into a second wave.  Returns -1 if the device cannot be
// queried.
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
// these operands, so that a caller can see which path ran: bf16 8, f32 4
// (16-byte cp.async), or 1 (the repack into padded planes).
int conv3x3_filter_grad_copy_width(const void* x, const void* dy, int H, int W, int is_bf16) {
  return copy_width_of(x, dy, H * W, is_bf16 != 0);
}

// Which instance conv3x3_filter_grad runs for a dtype, for a caller to report.
const char* conv3x3_filter_grad_instance(int is_bf16) {
  return is_bf16 ? "tensor cores: wgmma m64n32k16 bf16, 64 f x 32 c x 9 taps a warpgroup, "
                   "1 warpgroup a block where F <= 64, else 2"
                 : "tensor cores: mma.sync m16n8k8 3xTF32";
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

}  // extern "C"
