// Pieces shared by the 3x3 conv kernels (conv3x3_bn_stats.cu,
// conv3x3_filter_grad.cu): the pipeline step, the x window, cp.async and
// ldmatrix, the split of f32 operands for 3xTF32, the warpgroup MMA's
// fences, waits, TF32 products and matrix descriptors, the mbarriers and TMA
// copies (bulk and tensor) with the tensor map's
// encoding, the choice of copy width, the repack into padded planes for
// operands no copy width fits, the occupancy query the split rules read,
// and the clock probes that conv_clocks.py compiles in (CONV3X3_CLOCKS).
//
// The x window: one pipeline step covers kStep pixels p0 .. p0 + kStep - 1
// of one image plane.  For each input channel and each kh, the step stages
// a window of x from plane pixel p0 + (kh - 1) * W - 1 on, so that output
// pixel p and tap (kh, kw) read window element p + kw (before the window
// start is rounded down to the copy width, which the reads then add back).
// Elements outside the plane are zero; taps that wrap across the left or
// right edge of the image are masked by the reader.
//
// Halo rows: where an image is one block of rows of a larger one (a shard
// of spatial partitioning), its rows -1 and H are given as two rows of W
// elements for each plane (`top`, `bottom`: (N, C, 1, W) tensors), in place
// of the zeros; a null pointer keeps the zeros.  Only the window chunks
// that reach outside the plane read them (stage_x_chunk), one element at a
// time: x's planes keep the alignment the copy width was chosen for.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifdef CONV3X3_CLOCKS
// Clock probes, compiled in only where CONV3X3_CLOCKS is defined (by
// conv_clocks.py; the build of _build.py never defines it, and without it
// the macros below are empty).  Thread 0 of three blocks of a launch (those
// at 1/8, 1/2 and 7/8 of its grid, in linear order) reads clock64() at each
// CLOCK_MARK(i) and adds the interval since the previous mark to bucket i;
// CLOCKS_END stores the buckets, and the total since CLOCKS_BEGIN in bucket
// 0, to conv3x3_clocks[probe], which conv3x3_clocks_read copies out and
// clears.  The reads of clock64() order the instructions around them, so
// the buckets are those of the probed build.
__device__ unsigned long long conv3x3_clocks[3][16];

namespace conv3x3 {
struct ClockProbe {
  long long ck[16];
  long long t0, tp;
  int probe;
  __device__ __forceinline__ ClockProbe() {
    const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
    const unsigned id = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    probe = threadIdx.x != 0 ? -1
            : id == blocks / 8 ? 0
            : id == blocks / 2 ? 1
            : id == blocks / 8 * 7 ? 2
                                   : -1;
#pragma unroll
    for (int i = 0; i < 16; ++i) ck[i] = 0;
    t0 = tp = clock64();
  }
  __device__ __forceinline__ void mark(int i) {
    const long long tn = clock64();
    ck[i] += tn - tp;
    tp = tn;
  }
  __device__ __forceinline__ void done() {
    if (probe < 0) return;
#pragma unroll
    for (int i = 1; i < 16; ++i) conv3x3_clocks[probe][i] = ck[i];
    conv3x3_clocks[probe][0] = clock64() - t0;
  }
};
}  // namespace conv3x3

extern "C" int conv3x3_clocks_read(unsigned long long* out) {
  static unsigned long long zeros[3][16] = {};
  const int err = static_cast<int>(cudaMemcpyFromSymbol(out, conv3x3_clocks, sizeof(zeros)));
  cudaMemcpyToSymbol(conv3x3_clocks, zeros, sizeof(zeros));
  return err;
}

#define CLOCKS_BEGIN conv3x3::ClockProbe clocks_;
#define CLOCK_MARK(i) clocks_.mark(i);
#define CLOCKS_END clocks_.done();
#else
#define CLOCKS_BEGIN
#define CLOCK_MARK(i)
#define CLOCKS_END
#endif

namespace conv3x3 {

constexpr int kStep = 64;  // pixels of one image per pipeline step

// Window length for a copy width of VEC elements: element p + 2 for the
// last pixel p = kStep - 1 past a start rounded down by up to VEC - 1,
// rounded up to whole chunks.
template <int VEC>
__host__ __device__ constexpr int window_len() {
  return (kStep + VEC + 1 + VEC - 1) / VEC * VEC;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) from src to the shared dst, or zeros when !ok (src is
// then not read).
template <int BYTES>
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, bool ok) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
               : "memory");
}

// Stages the VEC elements of a window from plane pixel `pix` on (a
// multiple of VEC, possibly before or past the plane) into the shared dst:
// `plane` is this plane's first pixel (read only where `ok`, the channel's
// being in range), `top` and `bottom` its halo rows of W elements, or null.
// A chunk that lies inside the plane, or reaches outside it only where no
// halo row is given, is one cp.async as before (zeros outside the plane);
// any other chunk is staged element by element: row -1 from top, row H from
// bottom, zeros beyond them.  A chunk may straddle the plane's end only in
// a repacked copy, whose padding stands in for the zeros.
template <int VEC, typename T>
__device__ __forceinline__ void stage_x_chunk(T* dst, const T* plane, const T* top,
                                              const T* bottom, int pix, int HW, int W, bool ok) {
  const bool halo = ok && ((pix < 0 && top != nullptr) || (pix + VEC > HW && bottom != nullptr));
  if (!halo) {
    const bool inside = ok && pix >= 0 && pix < HW;
    copy_chunk<VEC * static_cast<int>(sizeof(T))>(dst, inside ? plane + pix : plane, inside);
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int k = pix + e;
    T v = T(0);
    if (k < 0) {
      if (top != nullptr && k >= -W) v = top[k + W];
    } else if (k < HW) {
      v = plane[k];
    } else if (bottom != nullptr && k - HW < W) {
      v = bottom[k - HW];
    }
    dst[e] = v;
  }
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

// 3xTF32: the tensor cores take f32 only as TF32 (10 mantissa bits), so an
// f32-exact product of a and b costs three TF32 products,
// a_small*b_big + a_big*b_small + a_big*b_big (a_small*b_small, 2^-22 of
// it, is dropped), f32-exact to about 2^-20 relative at worst.

// tf32(v): round to nearest, ties away from zero, to 10 mantissa bits (what
// cvt.rna.tf32.f32 gives), with integer operations, which run at the full
// rate where a conversion does not: add half of the 13 dropped bits to the
// magnitude, then clear them.
__device__ __forceinline__ unsigned to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small to 2^-21 relative, both TF32: big rounded, small (the
// exact remainder v - big) truncated, one integer operation.
__device__ __forceinline__ void split_tf32(float v, unsigned& big, unsigned& small) {
  big = to_tf32(v);
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// Hopper's warpgroup MMA (wgmma), shared by the four instances.  A
// warpgroup is 4 consecutive warps (the first a multiple of 4).  bf16
// m64nNk16 with A (64 x 16) in registers: warp w of the warpgroup holds rows
// 16w .. 16w + 15 in mma.sync m16n8k16's A layout (a0: row g, columns 2t,
// 2t + 1; a1: row g + 8; a2, a3: columns + 8), and B (16 x N) in shared
// memory behind a matrix descriptor (TF32 m64nNk8: Tf32Wgmma below).  D (64
// x N, f32) stays in registers: for each n8 block j, d[4j .. 4j + 3] are
// m16n8's C fragment of warp w's rows (row g: columns 8j + 2t, + 1; row g +
// 8: the same).

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory stores (the generic proxy) before
// wgmma's reads of them (the async proxy); a barrier then orders threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins accumulator registers across a wgmma pipeline: a compiler copy of
// one between the issue and the wait would serialize the wgmmas.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// m64nNk8 with TF32 operands, f32 sums, shared by the f32 instances of both
// kernels: d = (scale_d ? d : 0) + a (64 x 8, registers) * b (8 x N, K-major
// behind a descriptor).  A's TF32 layout is mma.sync m16n8k8's: a0 (row g,
// column t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), warp w of the
// warpgroup rows 16 w on (the other order measured 0.6-4 of the sum of
// |terms| away on an H100).  TF32 takes no transpose: both operands are
// K-major.
template <int N>
struct Tf32Wgmma;

template <>
struct Tf32Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const unsigned (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Tf32Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const unsigned (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// The matrix descriptor of a B operand in shared memory without swizzle
// (PTX ISA, "Matrix Descriptor Format"; CUTLASS's GmmaDescriptor): start
// address >> 4 in bits 0-13; the leading byte offset >> 4 in bits 16-29,
// the step from one core matrix (8 rows of 16 bytes, 128 contiguous bytes)
// to the next along K; the stride byte offset >> 4 in bits 32-45, the step
// to the next along M or N; base offset 0; layout type 0 (no swizzle) in
// bits 62-63.  Adding k to the descriptor moves its start 16 k bytes on.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint64_t lbo, uint64_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         ((sbo >> 4) << 32);
}

// The descriptor of an operand that a tensor copy landed with the 128-byte
// swizzle (CU_TENSOR_MAP_SWIZZLE_128B), K-major: rows of 128 bytes of K, 8
// rows (1,024 bytes, the swizzle's atom, which must start 1,024-byte
// aligned) a core-matrix group along M or N, so the stride byte offset is
// 1,024 and the leading byte offset unused (1); layout type 1 in bits
// 62-63.  A start `b` bytes into a row (a multiple of 16, below 128) reads
// the K values from there: the hardware applies the swizzle to the address.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return smem_desc(p, 16, 1024) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The barrier's phase now also waits for `bytes` more (and this thread's
// arrival).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from the global src to the shared dst by the
// bulk copy engine (TMA without a tensor map), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// to the shared dst by the TMA unit, completing on `bar`; elements outside
// the tensor (before or past any of its extents) land as zeros.  The
// innermost coordinate must be a multiple of 16 bytes: any other stopped a
// kernel with an illegal instruction on an H100.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor map over `base` as a 3-D tensor of extents (d0, d1, d2),
// innermost first, d1 and d2 steps `s1` and `s2` bytes apart (multiples of
// 16), in boxes of b0 x b1 x 1 elements, with the given swizzle; 0, or
// cudaErrorNotSupported / cudaErrorInvalidValue where the driver has no
// encoder or refuses the map.
inline int tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                         long long d0, long long d1, long long d2, long long s1, long long s2,
                         int b0, int b1, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1), static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// out[plane, p] = in[plane, p] for p < HW, 0 up to pitch: planes padded to
// a multiple of the widest copy, for operands no cp.async width fits.
template <typename T>
__global__ void __launch_bounds__(256)
    pad_planes_kernel(const T* __restrict__ in, T* __restrict__ out, long long planes, int HW,
                      int pitch) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= planes * pitch) return;
  const long long plane = i / pitch;
  const int p = static_cast<int>(i - plane * pitch);
  out[i] = p < HW ? in[plane * HW + p] : T(0);
}

template <typename T>
int pad_planes(const void* in, void* out, long long planes, int HW, int pitch,
               cudaStream_t stream) {
  const long long total = planes * pitch;
  pad_planes_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), planes, HW, pitch);
  return static_cast<int>(cudaGetLastError());
}

// The widest 16- or 8-byte copy, in elements of ELEM bytes, that keeps
// every chunk of a plane of HW elements inside the plane and aligned: HW
// and each pointer must be multiples of it.  1 where neither fits.
template <int ELEM>
int copy_width(int HW, const void* a, const void* b = nullptr) {
  const auto pa = reinterpret_cast<uintptr_t>(a);
  const auto pb = reinterpret_cast<uintptr_t>(b);
  for (int bytes = 16; bytes >= 8; bytes /= 2) {
    const int vec = bytes / ELEM;
    if (HW % vec == 0 && pa % bytes == 0 && pb % bytes == 0) return vec;
  }
  return 1;
}

// HW rounded up to a multiple of 8 elements: the pitch of repacked planes.
inline int padded_pitch(int HW) { return (HW + 7) / 8 * 8; }

// Blocks of `kernel` resident at once on the current device (SMs x blocks
// an SM at this block size and dynamic shared memory), or 0 if the device
// cannot be queried; read once a device into `cache`.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int threads, int smem, long long (&cache)[64]) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] > 0) return cache[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  cache[dev] = static_cast<long long>(sms) * per_sm;
  return cache[dev];
}

}  // namespace conv3x3
