// Filter gradient of a 1x1 convolution (stride 1 or 2, no padding), in f32,
// for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves every 1x1 conv's weight
// gradient to XLA.  The port's ResNet blocks had it from cuDNN, whose f32
// weight gradient with TF32 off runs on the FMA units (wgrad_alg0_engine,
// its atomics-based algorithm): at 224 px and batch 128 the 36 1x1 convs of
// ResNet-50 (conv_a, conv_c and the projection shortcuts) took most of its
// 29 ms a step, against a bound of 3.4 ms.  This kernel computes them on the
// tensor cores as 3xTF32, which is f32-exact as the 3x3 kernels are:
//
//   dw[f, c] = sum_{n, i, j} dy[n, f, i, j] * x[n, c, s*i, s*j]
//
// x (N, C, H, W) and dy (N, F, Ho, Wo) f32, NCHW; dw (F, C) f32.  With K =
// N*Ho*Wo, a GEMM of F x C outputs over K products: A (64 rows a warpgroup)
// x B (N columns) summed over K, both operands K-major (a channel's pixels
// are contiguous in NCHW), the only form TF32 wgmma takes.
//
// What bounds it: 2*K*C*F operations on K*(C + F) inputs read and C*F
// outputs written.  At ResNet-50's 15 shapes the bound is the operations at
// stages 2-4 (3xTF32 at 495 / 3 TFLOP/s) and the bytes at stage 1 (C = 64:
// x and dy of 103-411 MB at 3.35 TB/s); 3.4 ms a step in all.  K runs to
// 401,408 while C*F is as small as 64 x 64, so the contraction is split
// across blocks (split-K) into f32 partials part[split, F, C], which a
// second kernel (reduce_splits_1x1_kernel) adds in a fixed order: dw is
// bitwise the same on every run.
//
// Design:
//   - 3xTF32 as in conv3x3_common.cuh: each operand v is split into big =
//     tf32(v) (rounded) and small = v - big (truncated to TF32); a k8 slice
//     is three wgmma, small * big, big * small, big * big, f32-exact to about
//     2^-20 relative.  Both operands come from shared memory (m64nNk8 with A
//     and B behind descriptors): with no kw shift to apply, as the 3x3 filter
//     gradient has, neither needs registers, and each value is split once a
//     block, not once for every warpgroup that reads it.
//   - Operands in shared memory: rows (channels) of 32 pixels, 128 bytes,
//     with the 128-byte swizzle (the layout TMA's SWIZZLE_128B lands and
//     smem_desc_sw128 reads); a k8 slice starts 32 bytes into the row.
//   - Two ways in, chosen by the operands (conv1x1_filter_grad_instance):
//     * Tensor copies (TMA), where both tensors' planes are whole 16 bytes
//       and aligned (stride 1, H*W % 4 == 0: 25 of ResNet-50's 36 calls).
//       One thread copies a step's boxes, 32 pixels x the tile's rows of
//       (H*W, channels, N) tensor maps, with the 128-byte swizzle, into a
//       ring of 3 buffers, two steps ahead; a step stays in one image
//       (pixels past the plane land as zeros, and slices past them are
//       skipped).  Once a step lands, all threads split it in place: big
//       parts over the copy, small parts beside it.
//     * The threads' loads, everywhere else: the stride-2 convs (a box
//       cannot subsample a flattened pixel run) and stage 4's 49-pixel
//       planes (196-byte strides, which TMA refuses; no repacked copy).
//       Each thread loads 16 bytes of a row (4 pixels of one channel) per
//       row it owns into registers, one 16-byte load where the planes allow
//       it, else four 4-byte loads; one step later it splits them and
//       stores both parts at their swizzled place.  K is the flattened
//       (image, pixel) index, so a step may span images.  Two buffers.
//   - Pipeline, either way: a step issues its wgmma group on one buffer,
//     then, while the tensor cores run it, readies the next step's buffer
//     (split in place, or split from registers and the step after next
//     loaded), then waits for the group and a barrier.
//   - What bounds it on the card (H100, ResNet-50's shapes, each variant
//     timed beside the others in one call): the loads.  The threads' loads
//     run at about 2 TB/s from L2 and device memory in all, however they
//     are issued: without the wgmma they alone took 7.4 of the 9.1 ms a
//     step that the threads' loads then took everywhere, and neither two
//     steps of loads in flight (more registers), cp.async into a staging
//     ring (12.3 ms: more shared-memory traffic, fewer blocks an SM), loads
//     issued before the stores, L2 prefetch-size hints nor prefetches four
//     steps ahead moved them.  Tensor copies took the 25 calls they can
//     serve from 5.5 to 4.6 ms (the stage-1 shapes to 0.66-0.70 of their
//     bound, bytes; stages 2-3 to 0.43-0.51); the other 11 calls stay at
//     0.26-0.32 of theirs.  The slices of a step unrolled: 5% faster than
//     a loop over them.
//   - Accumulation: TF32 wgmma's f32 sums lose too much over a split's
//     thousands of pixels (conv3x3_filter_grad.cu, measured with its
//     self-test), so a step's products go into a temporary from zero and the
//     running sums take them with one f32 add a step (32 pixels).
//   - Tiles, chosen by the shape (conv1x1_filter_grad_instance): 128 x 128
//     outputs a block (two warpgroups, m64n128k8) where both C and F exceed
//     64; 128 x 64 (two warpgroups, m64n64k8, the larger side as A) where
//     one of them is 64 or less; 64 x 64 (one warpgroup) where both are.
//     The split count fills the card's resident blocks (the rule of
//     conv3x3_filter_grad_splits with this kernel's step cost), with the
//     partials kept under 64 MB.
//
// ptxas (sm_90a, CUDA 12.9): no spills; 210 / 126 / 143 registers for the
// 128 x 128, 128 x 64 and 64 x 64 tiles with the threads' loads, 165 / 107 /
// 107 with tensor copies; the reduction 32.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error (cudaGetLastError).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;

constexpr int kK = 32;  // pixels (K values) a pipeline step: one 128-byte row an operand row
constexpr int kStages = 3;  // buffers of the tensor copies' ring: each copied two steps ahead
constexpr int kReduceOutputs = 32;  // outputs a block of the reduction
constexpr int kReduceGroups = 8;    // warps a block, each over every 8th split
constexpr long long kMaxPartialBytes = 64ll << 20;

// m64nNk8, TF32 operands, f32 sums, both operands in shared memory:
// d = (scale_d ? d : 0) + a (64 x 8) * b (8 x N), each K-major behind a
// descriptor.  D's fragment as in Tf32Wgmma (conv3x3_common.cuh).
template <int N>
struct Tf32WgmmaSS;

template <>
struct Tf32WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


// One side of the GEMM: a tensor (N, ch, plane pixels) whose channels are
// rows.  Output pixel p = i*Wo + j reads plane pixel p at stride 1, and
// (s*i)*w + s*j at stride s; vec: 16-byte loads of 4 pixels (stride 1, the
// plane a multiple of 4 pixels, the tensor 16-byte aligned).
struct Operand {
  const float* base;
  int ch, plane, w, stride, vec;
};

// Partial sums go to part[split, F, C]; a_is_x: A's rows are x's channels
// (else dy's), B's the other's.
struct Problem {
  Operand a, b;
  float* part;
  int F, C, HW, Wo, K, chunk, tiles_m, a_is_x;
};

// The block's tile: WG warpgroups, each 64 rows of A, and TN columns (B);
// TMA: tensor copies into a ring of kStages buffers, else the threads' loads
// through registers into two.
template <int WG, int TN, bool TMA>
struct Tile {
  static constexpr int kTM = 64 * WG;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kRowsPerPass = kThreads / 8;  // a thread owns one 16-byte chunk of a row
  static constexpr int kPassesA = kTM / kRowsPerPass;
  static constexpr int kPasses = (kTM + TN) / kRowsPerPass;
  // one buffer: A's big parts, B's big parts, A's small parts, B's small parts
  static constexpr int kBigB = kTM * 128;
  static constexpr int kSmallA = (kTM + TN) * 128;
  static constexpr int kSmallB = kSmallA + kTM * 128;
  static constexpr int kBuffer = 2 * (kTM + TN) * 128;
  static constexpr int kBuffers = TMA ? kStages : 2;
  // the buffers, the copies' barriers, + aligning to 1,024
  static constexpr int kSmem = 1024 + kBuffers * kBuffer + kStages * 8;
  // blocks an SM: as many as the shared memory holds, at most 3 (registers)
  static constexpr int kBlocksPerSm = 232448 / kSmem < 3 ? 232448 / kSmem : 3;
  static_assert((kTM + TN) % kRowsPerPass == 0 && kTM % kRowsPerPass == 0, "whole passes");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// Byte offset of 16-byte chunk `j` of row `r` in a 128-byte-swizzled
// K-major operand (rows of 128 bytes, 8-row atoms of 1,024 bytes).
__device__ __forceinline__ int swizzled(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// The plane pixel that output pixel p reads.
__device__ __forceinline__ int plane_pixel(const Operand& op, int p, int Wo) {
  if (op.stride == 1) return p;
  const int i = p / Wo;
  return op.stride * (i * op.w + (p - i * Wo));
}

// Splits 4 floats into TF32 big and small parts (split_tf32) and stores each
// 16 bytes.
__device__ __forceinline__ void split_store(float4 v, unsigned char* big, unsigned char* small) {
  uint4 b, s;
  split_tf32(v.x, b.x, s.x);
  split_tf32(v.y, b.y, s.y);
  split_tf32(v.z, b.z, s.z);
  split_tf32(v.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(small) = s;
}

// The first 1,024-byte boundary at or after p (a swizzle atom's alignment).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// One step's products of warpgroup's 64 rows of A with B, S slices of 8
// pixels, into tmp from zero: three wgmma a slice (small * big, big *
// small, big * big), one commit group.
template <int TN, int S>
__device__ __forceinline__ void step_products(float (&tmp)[TN / 2], uint64_t a_big,
                                              uint64_t a_small, uint64_t b_big, uint64_t b_small) {
  fence_operands(tmp);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint64_t at = static_cast<uint64_t>(2 * s);  // 32 bytes a slice, in 16-byte units
    Tf32WgmmaSS<TN>::mma(tmp, a_small + at, b_big + at, s != 0);
    Tf32WgmmaSS<TN>::mma(tmp, a_big + at, b_small + at, 1);
    Tf32WgmmaSS<TN>::mma(tmp, a_big + at, b_big + at, 1);
  }
  wgmma_commit();
}

// Block (tile, split): A rows m0 .. m0 + 64 WG - 1, B rows n0 .. n0 + TN - 1,
// over the steps [split * chunk, (split + 1) * chunk) of the block's path:
// with TMA ceil(Ho*Wo / 32) steps an image, image by image (a tensor copy
// stays in one image; pixels past the plane land as zeros), else ceil(K /
// 32) of the flattened K.  amap and bmap: A's and B's tensors as (Ho*Wo,
// channels, N) with boxes of 32 pixels x the tile's rows (TMA only).
template <int WG, int TN, bool TMA>
__global__ void __launch_bounds__(128 * WG, (Tile<WG, TN, TMA>::kBlocksPerSm))
    filter_grad_1x1_tf32_kernel(const __grid_constant__ CUtensorMap amap,
                                const __grid_constant__ CUtensorMap bmap, const Problem pr) {
  using T = Tile<WG, TN, TMA>;
  constexpr int P = T::kPasses;
  constexpr int PA = T::kPassesA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // this warpgroup's 64 rows of A
  const int lane = tid & 31;
  const int jc = tid & 7;     // the 16-byte chunk (pixels 4 jc .. 4 jc + 3) this thread loads
  const int r0 = tid >> 3;    // its first row; then every kRowsPerPass-th
  const int m0 = (blockIdx.x % pr.tiles_m) * T::kTM;
  const int n0 = (blockIdx.x / pr.tiles_m) * TN;
  const int per_image = (pr.HW + kK - 1) / kK;
  const int total = TMA ? (pr.K / pr.HW) * per_image : (pr.K + kK - 1) / kK;
  const int t_begin = blockIdx.y * pr.chunk;
  const int t_end = t_begin + pr.chunk < total ? t_begin + pr.chunk : total;
  const int steps = t_end - t_begin;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBuffers * T::kBuffer);

  // the descriptors of buffer b's four operands, this warpgroup's rows of A
  struct Descs {
    uint64_t a_big, a_small, b_big, b_small;
  };
  auto descs = [&](int b) {
    unsigned char* buf = smem + b * T::kBuffer;
    return Descs{smem_desc_sw128(buf + wg * 64 * 128),
                 smem_desc_sw128(buf + T::kSmallA + wg * 64 * 128),
                 smem_desc_sw128(buf + T::kBigB), smem_desc_sw128(buf + T::kSmallB)};
  };

  float acc[TN / 2], tmp[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) acc[e] = tmp[e] = 0.f;
  // After a step's wgmma group: wait for it, add its products to the running
  // sums, and let every thread's stores of this step reach the async proxy.
  auto finish_step = [&]() {
    wgmma_wait<0>();
    fence_operands(tmp);
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[e] += tmp[e];
    fence_proxy_async();
    __syncthreads();  // every warpgroup is done with this step's buffer; the next is whole
  };

  if constexpr (TMA) {
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < kStages; ++b) mbar_init(&full[b], 1);
      mbar_init_fence();
    }
    __syncthreads();
    // Step t's tensor copies into buffer b's big parts, by one thread.
    auto issue = [&](int t, int b) {
      if (tid != 0) return;
      const int n = t / per_image;
      const int p0 = (t - n * per_image) * kK;
      unsigned char* buf = smem + b * T::kBuffer;
      mbar_arrive_expect(&full[b], (T::kTM + TN) * 128);
      tma_load_3d(buf, &amap, p0, m0, n, &full[b]);
      tma_load_3d(buf + T::kBigB, &bmap, p0, n0, n, &full[b]);
    };
    // Waits for step i's copies in buffer b, then splits them in place:
    // big parts over the copy, small parts beside them.
    auto split = [&](int i, int b) {
      mbar_wait(&full[b], (i / kStages) & 1);
      float* big = reinterpret_cast<float*>(smem + b * T::kBuffer);
      float* small = reinterpret_cast<float*>(smem + b * T::kBuffer + T::kSmallA);
      for (int v = tid * 4; v < (T::kTM + TN) * kK; v += T::kThreads * 4) {
        const float4 x = *reinterpret_cast<const float4*>(big + v);
        split_store(x, reinterpret_cast<unsigned char*>(big + v),
                    reinterpret_cast<unsigned char*>(small + v));
      }
    };
    if (steps > 0) issue(t_begin, 0);
    if (steps > 1) issue(t_begin + 1, 1);
    if (steps > 0) split(0, 0);
    fence_proxy_async();
    __syncthreads();
    for (int i = 0; i < steps; ++i) {
      const int t = t_begin + i;
      // buffer (i + 2) % 3 held step i - 1, whose readers the last barrier waited for
      if (i + 2 < steps) issue(t + 2, (i + 2) % kStages);
      const Descs d = descs(i % kStages);
      const int p0 = (t % per_image) * kK;
      const int live = pr.HW - p0 < kK ? pr.HW - p0 : kK;
      switch ((live + 7) / 8) {  // the slices holding pixels of the plane
        case 1: step_products<TN, 1>(tmp, d.a_big, d.a_small, d.b_big, d.b_small); break;
        case 2: step_products<TN, 2>(tmp, d.a_big, d.a_small, d.b_big, d.b_small); break;
        case 3: step_products<TN, 3>(tmp, d.a_big, d.a_small, d.b_big, d.b_small); break;
        default: step_products<TN, 4>(tmp, d.a_big, d.a_small, d.b_big, d.b_small);
      }
      if (i + 1 < steps) split(i + 1, (i + 1) % kStages);  // while the tensor cores run
      finish_step();
    }
  } else {
    float4 regs[P];  // the values of the step after the one being stored

    // This thread's 4 values of channel c of an operand, from their offsets
    // in the tensor (without the channel's); zeros past the channels or K.
    auto load_row = [&](const Operand& op, const long long (&off)[4], int c, int k) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c >= op.ch) return v;
      const float* row = op.base + static_cast<long long>(c) * op.plane;
      if (op.vec) {
        if (k < pr.K) v = __ldg(reinterpret_cast<const float4*>(row + off[0]));
      } else {
        if (k < pr.K) v.x = __ldg(row + off[0]);
        if (k + 1 < pr.K) v.y = __ldg(row + off[1]);
        if (k + 2 < pr.K) v.z = __ldg(row + off[2]);
        if (k + 3 < pr.K) v.w = __ldg(row + off[3]);
      }
      return v;
    };
    // Loads step t (K values 32 t .. 32 t + 31, the flattened (image,
    // pixel)) into regs: row r0 + q * kRowsPerPass of A (q < PA) or of B,
    // this thread's 4 values; zeros past a side's channels or past K.
    auto load = [&](int t) {
      const int k = t * kK + 4 * jc;  // this thread's first K value
      int n[4], p[4];  // its 4 values' image and pixel
      n[0] = k / pr.HW;
      p[0] = k - n[0] * pr.HW;
#pragma unroll
      for (int e = 1; e < 4; ++e) {
        p[e] = p[e - 1] + 1;
        n[e] = n[e - 1];
        if (p[e] == pr.HW) {
          p[e] = 0;
          ++n[e];
        }
      }
      long long off_a[4], off_b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        off_a[e] = static_cast<long long>(n[e]) * pr.a.ch * pr.a.plane + plane_pixel(pr.a, p[e], pr.Wo);
        off_b[e] = static_cast<long long>(n[e]) * pr.b.ch * pr.b.plane + plane_pixel(pr.b, p[e], pr.Wo);
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {  // A's rows first, then B's
        const int r = r0 + q * T::kRowsPerPass;
        regs[q] = q < PA ? load_row(pr.a, off_a, m0 + r, k) : load_row(pr.b, off_b, n0 + r - T::kTM, k);
      }
    };
    // Splits regs into buffer b's big and small parts, at the swizzled places.
    auto store = [&](int b) {
      unsigned char* buf = smem + b * T::kBuffer;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int r = r0 + q * T::kRowsPerPass;  // A's rows first, then B's
        const bool is_a = q < PA;
        const int o = swizzled(is_a ? r : r - T::kTM, jc);
        split_store(regs[q], buf + (is_a ? 0 : T::kBigB) + o,
                    buf + (is_a ? T::kSmallA : T::kSmallB) + o);
      }
    };
    if (steps > 0) {
      load(t_begin);
      store(0);
      if (steps > 1) load(t_begin + 1);
      fence_proxy_async();
    }
    __syncthreads();
    for (int i = 0; i < steps; ++i) {
      // all 4 slices, the last step's too: its values past K are zeros
      const Descs d = descs(i & 1);
      step_products<TN, 4>(tmp, d.a_big, d.a_small, d.b_big, d.b_small);
      // while the tensor cores run this step: the next step's values into
      // the other buffer (whose readers the last barrier waited for), and
      // the step after it into registers
      if (i + 1 < steps) store((i + 1) & 1);
      if (i + 2 < steps) load(t_begin + i + 2);
      finish_step();
    }
  }

  // The block's partial tile: D[m][n] of warpgroup wg's 64 rows, written
  // to part[split, f, c] (rows of A are f or c as a_is_x says); each warp's
  // stores fill whole 32-byte sectors either way.
  const int g = lane >> 2;
  const int tq = lane & 3;
  float* out = pr.part + static_cast<long long>(blockIdx.y) * pr.F * pr.C;
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    const int m = m0 + wg * 64 + (warp & 3) * 16 + g + ((e >> 1) & 1) * 8;
    const int n = n0 + (e >> 2) * 8 + 2 * tq + (e & 1);
    const int f = pr.a_is_x ? n : m;
    const int c = pr.a_is_x ? m : n;
    if (f < pr.F && c < pr.C) out[static_cast<long long>(f) * pr.C + c] = acc[e];
  }
}

// dw[o] = sum over splits of part[split, o], in a fixed order: warp w of a
// block sums splits w, w + 8, ... of 32 outputs in order, then the 8 sums
// are added in order of w.
__global__ void __launch_bounds__(kReduceOutputs * kReduceGroups)
    reduce_splits_1x1_kernel(const float* __restrict__ part, float* __restrict__ dw, int splits,
                             int outputs) {
  __shared__ float sums[kReduceGroups][kReduceOutputs];
  const int lane = threadIdx.x % kReduceOutputs;
  const int grp = threadIdx.x / kReduceOutputs;
  const int o = blockIdx.x * kReduceOutputs + lane;
  float total = 0.f;
  if (o < outputs)
    for (int s = grp; s < splits; s += kReduceGroups)
      total += part[static_cast<long long>(s) * outputs + o];
  sums[grp][lane] = total;
  __syncthreads();
  if (grp == 0 && o < outputs) {
    float all = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceGroups; ++w) all += sums[w][lane];
    dw[o] = all;
  }
}

// What a call runs: warpgroups, the tile's columns, whether A is x, and
// whether the tensor copies load it.  Two warpgroups (128 rows of A) unless
// both sides are at most 64 channels; 128 columns where both sides exceed
// 64, else 64 (the larger side then A).  Tensor copies where the planes
// allow them (stride 1, H*W a multiple of 4 pixels, both tensors 16-byte
// aligned: their strides are then whole 16 bytes), else the threads' loads.
struct Instance {
  int wg, tn, a_is_x, tma;
};

Instance instance_for(int C, int F, bool tma) {
  const int lo = C < F ? C : F, hi = C < F ? F : C;
  if (hi <= 64) return {1, 64, 0, tma};
  return {2, lo <= 64 ? 64 : 128, C > F ? 1 : 0, tma};
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool takes_tma(const void* x, const void* dy, int HW, int stride) {
  return stride == 1 && HW % 4 == 0 && aligned(x) && aligned(dy);
}

template <int WG, int TN, bool TMA>
int launch(const Problem& pr, int tiles_n, int splits, cudaStream_t stream) {
  using T = Tile<WG, TN, TMA>;
  CUtensorMap amap{}, bmap{};
  if (TMA) {
    const long long N = pr.K / pr.HW;
    int err = tensor_map_3d(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pr.a.base, pr.HW, pr.a.ch, N,
                            4ll * pr.HW, 4ll * pr.HW * pr.a.ch, kK, T::kTM,
                            CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = tensor_map_3d(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pr.b.base, pr.HW, pr.b.ch, N,
                          4ll * pr.HW, 4ll * pr.HW * pr.b.ch, kK, TN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  auto kernel = filter_grad_1x1_tf32_kernel<WG, TN, TMA>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(pr.tiles_m * tiles_n, splits), T::kThreads, T::kSmem, stream>>>(amap, bmap, pr);
  return static_cast<int>(cudaGetLastError());
}

long long resident_cache[6][64] = {};

template <int WG, int TN, bool TMA>
long long resident() {
  using T = Tile<WG, TN, TMA>;
  return resident_blocks(filter_grad_1x1_tf32_kernel<WG, TN, TMA>, T::kThreads, T::kSmem,
                         resident_cache[(WG - 1) * 2 + (TN == 128 ? 2 : 0) + (TMA ? 1 : 0)]);
}

long long resident_blocks_of(const Instance& in) {
  if (in.wg == 1) return in.tma ? resident<1, 64, true>() : resident<1, 64, false>();
  if (in.tn == 64) return in.tma ? resident<2, 64, true>() : resident<2, 64, false>();
  return in.tma ? resident<2, 128, true>() : resident<2, 128, false>();
}

// What one pipeline step of a block costs, in partial floats of the split
// rule: the floats whose write and re-read (8 bytes each at 3.35 TB/s) take
// as long as a step, about 1.5 us.
constexpr double kPartialsPerStep = 6.0e5;

}  // namespace

extern "C" {

// How conv1x1_filter_grad splits its contraction for these operands:
// returns the number of splits and writes to *chunk the steps (32 pixels)
// of each; the last split may be shorter.  The count minimizes the waves of
// blocks (as many resident at once as the device holds of the instance)
// times the steps of a split, plus writing and re-reading the partials
// (conv3x3_filter_grad_splits's rule), with the partials under 64 MB.
// Returns -1 if the device cannot be queried.
int conv1x1_filter_grad_splits(const void* x, const void* dy, int N, int C, int F, int Ho,
                               int Wo, int stride, int* chunk) {
  const int HW = Ho * Wo;
  const Instance in = instance_for(C, F, takes_tma(x, dy, HW, stride));
  const long long slots = resident_blocks_of(in);
  if (slots <= 0) return -1;
  const int m_side = in.a_is_x ? C : F, n_side = in.a_is_x ? F : C;
  const long long tiles = static_cast<long long>((m_side + 64 * in.wg - 1) / (64 * in.wg)) *
                          ((n_side + in.tn - 1) / in.tn);
  const long long work = in.tma ? static_cast<long long>(N) * ((HW + kK - 1) / kK)
                                : (static_cast<long long>(N) * HW + kK - 1) / kK;
  const double partial = static_cast<double>(F) * C / kPartialsPerStep;
  long long most = 8 * ((slots + tiles - 1) / tiles);
  const long long by_bytes = kMaxPartialBytes / (4ll * F * C);
  if (most > by_bytes) most = by_bytes;
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

// dw[F, C] (f32) from x[N, C, H, W] and dy[N, F, Ho, Wo] (f32, contiguous)
// of a 1x1 conv of this stride (Ho = ceil(H / stride), Wo likewise).  The
// work is split as conv1x1_filter_grad_splits gives it; part is f32 scratch
// of splits x F x C, or null where there is one split (the kernel then
// writes dw itself).
int conv1x1_filter_grad(const void* x, const void* dy, void* part, void* dw, int N, int C, int H,
                        int W, int F, int Ho, int Wo, int stride, int splits, int chunk,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && part == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Instance in = instance_for(C, F, takes_tma(x, dy, Ho * Wo, stride));
  const Operand ox{static_cast<const float*>(x), C, H * W, W, stride,
                   stride == 1 && (H * W) % 4 == 0 && aligned(x) ? 1 : 0};
  const Operand ody{static_cast<const float*>(dy), F, Ho * Wo, Wo, 1,
                    (Ho * Wo) % 4 == 0 && aligned(dy) ? 1 : 0};
  Problem pr;
  pr.a = in.a_is_x ? ox : ody;
  pr.b = in.a_is_x ? ody : ox;
  pr.part = static_cast<float*>(splits > 1 ? part : dw);
  pr.F = F;
  pr.C = C;
  pr.HW = Ho * Wo;
  pr.Wo = Wo;
  pr.K = N * Ho * Wo;
  pr.chunk = chunk;
  pr.tiles_m = (pr.a.ch + 64 * in.wg - 1) / (64 * in.wg);
  pr.a_is_x = in.a_is_x;
  const int tiles_n = (pr.b.ch + in.tn - 1) / in.tn;
  int err;
  if (in.wg == 1)
    err = in.tma ? launch<1, 64, true>(pr, tiles_n, splits, st)
                 : launch<1, 64, false>(pr, tiles_n, splits, st);
  else if (in.tn == 64)
    err = in.tma ? launch<2, 64, true>(pr, tiles_n, splits, st)
                 : launch<2, 64, false>(pr, tiles_n, splits, st);
  else
    err = in.tma ? launch<2, 128, true>(pr, tiles_n, splits, st)
                 : launch<2, 128, false>(pr, tiles_n, splits, st);
  if (err != 0 || splits == 1) return err;
  const int outputs = F * C;
  reduce_splits_1x1_kernel<<<(outputs + kReduceOutputs - 1) / kReduceOutputs,
                              kReduceOutputs * kReduceGroups, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, outputs);
  return static_cast<int>(cudaGetLastError());
}

// What conv1x1_filter_grad runs for these operands, for a caller to report.
const char* conv1x1_filter_grad_instance(const void* x, const void* dy, int C, int F, int HW,
                                         int stride) {
  const Instance in = instance_for(C, F, takes_tma(x, dy, HW, stride));
  static const char* names[2][3] = {
      {"3xTF32 wgmma m64n64k8, 64 x 64 a block, the threads' loads",
       "3xTF32 wgmma m64n64k8, 128 x 64 a block, the threads' loads",
       "3xTF32 wgmma m64n128k8, 128 x 128 a block, the threads' loads"},
      {"3xTF32 wgmma m64n64k8, 64 x 64 a block, tensor copies",
       "3xTF32 wgmma m64n64k8, 128 x 64 a block, tensor copies",
       "3xTF32 wgmma m64n128k8, 128 x 128 a block, tensor copies"}};
  return names[in.tma][in.wg == 1 ? 0 : (in.tn == 64 ? 1 : 2)];
}

}  // extern "C"
