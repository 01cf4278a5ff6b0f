// Fused L2-normalize + dot cosine loss, forward and backward, for Hopper.
//
// Replaces the Pallas kernels `_fwd_kernel` and `_bwd_kernel` of
// semantic_embeddings_tpu/ops/cosine_loss.py:
//
//   forward:  nsq_i = max(sum_j z_ij^2, 1e-12);  loss_i = 1 - (t_i . z_i) * rsqrt(nsq_i)
//   backward: dz_ij = -g_i * rsqrt(nsq_i) * (t_ij - ((t_i . z_i) / nsq_i) * z_ij)
//
// What bounds it: every element of z and t is read once (twice in the
// backward, which recomputes both row sums as the TPU kernel does) and used
// in two multiply-adds, so the pair is bound by memory bytes at any shape
// large enough to fill the card.  At the training path's shape (B = 100,
// D = 100: about 40 KB each of z and t) it is bound by launch latency.
//
// Design: one warp per row, 8 rows per 256-thread block, ceil(B / 8) blocks.
// Each lane strides over D with neighbouring lanes on neighbouring
// addresses, accumulates sum(z^2) and sum(t z) in f32 and the warp reduces
// them with __shfl_xor_sync.  The forward's lane 0 writes the row loss; in
// the backward every lane writes its dz elements in z's dtype.  Rows past B
// exit as a whole warp, and the lane loop masks the ragged end of D, so any
// B >= 1 and D >= 1 work.  z is f32 or bf16; t and g are f32.  The kernels
// launch on the caller's stream and allocate nothing; each C entry point
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * 32;
constexpr float kEps = 1e-12f;  // tf.nn.l2_normalize epsilon

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Row sums sum(z^2) and sum(t z), reduced across the warp: every lane
// returns the full sums.
template <typename T>
__device__ __forceinline__ void row_sums(const T* z, const float* t, int d,
                                         int lane, float* zz, float* tz) {
  float a = 0.f, b = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float zj = load_f32(z + j);
    a += zj * zj;
    b += t[j] * zj;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  *zz = a;
  *tz = b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cosine_loss_fwd_kernel(const T* __restrict__ z, const float* __restrict__ t,
                           float* __restrict__ loss, int b, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b) return;  // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * d;
  float zz, tz;
  row_sums(z + off, t + off, d, lane, &zz, &tz);
  if (lane == 0) loss[row] = 1.f - tz * rsqrtf(fmaxf(zz, kEps));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cosine_loss_bwd_kernel(const T* __restrict__ z, const float* __restrict__ t,
                           const float* __restrict__ g, T* __restrict__ dz,
                           int b, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b) return;
  const size_t off = static_cast<size_t>(row) * d;
  float zz, tz;
  row_sums(z + off, t + off, d, lane, &zz, &tz);
  const float nsq = fmaxf(zz, kEps);
  const float coeff = -g[row] * rsqrtf(nsq);
  const float proj = tz / nsq;
  for (int j = lane; j < d; j += 32) {
    const float zj = load_f32(z + off + j);
    store_from_f32(dz + off + j, coeff * (t[off + j] - proj * zj));
  }
}

inline dim3 grid_for(int b) { return dim3((b + kRowsPerBlock - 1) / kRowsPerBlock); }

}  // namespace

extern "C" {

// loss[b] = forward(z[b, d], t[b, d]); z is bf16 when z_is_bf16, else f32.
int cosine_loss_forward(const void* z, const void* t, void* loss, int b, int d,
                        int z_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_is_bf16) {
    cosine_loss_fwd_kernel<__nv_bfloat16><<<grid_for(b), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(t),
        static_cast<float*>(loss), b, d);
  } else {
    cosine_loss_fwd_kernel<float><<<grid_for(b), kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(t),
        static_cast<float*>(loss), b, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// dz[b, d] (z's dtype) = backward(z, t, g[b]).
int cosine_loss_backward(const void* z, const void* t, const void* g, void* dz,
                         int b, int d, int z_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_is_bf16) {
    cosine_loss_bwd_kernel<__nv_bfloat16><<<grid_for(b), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(t),
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dz), b, d);
  } else {
    cosine_loss_bwd_kernel<float><<<grid_for(b), kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(t),
        static_cast<const float*>(g), static_cast<float*>(dz), b, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
