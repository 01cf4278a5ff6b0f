// The f32 depthwise convolution (one k x k filter a channel, TF SAME
// padding) of NASNet-A's separable blocks, on Hopper (sm_90a): three
// kernels, one for each pass, each launched once a call.
//
//   forward      y[n,c,i,j]  = sum_{a,b} w[c,a,b] * x[n,c,s*i+a-pt, s*j+b-pl]
//   input grad   dx[n,c,u,v] = sum over the taps (a, b) and outputs (i, j)
//                              with s*i+a-pt = u, s*j+b-pl = v of w[c,a,b] * dy[n,c,i,j]
//   weight grad  dw[c,a,b]   = sum_{n,i,j} dy[n,c,i,j] * x[n,c,s*i+a-pt, s*j+b-pl]
//
// x (N, C, H, W) and dy (N, C, Ho, Wo) contiguous NCHW, w (C, 1, k, k),
// k in {3, 5, 7}, s in {1, 2}, Ho = ceil(H / s); x is zero outside the image.
// Every product and sum is an f32 FMA on the CUDA cores.
//
// It replaces no TPU kernel: the JAX package leaves depthwise convs to XLA.
// It was added because PyTorch sends f32 NCHW depthwise convs to ATen's
// DepthwiseConv2d.cu, whose forward and input gradient compute one output a
// thread, reading k^2 neighbours through the cache, and whose weight
// gradient re-reads x and dy for each tap: together some 10% of the bound
// at NASNet-A's 220 layers.
//
// The bound is bytes, not operations (2 k^2 operations an output, at most
// 98, against the card's 295 per byte): the forward reads x and w and
// writes y; the input gradient reads dy and w and writes dx; the weight
// gradient reads x and dy and writes the f32 dw.  So each kernel moves each
// of those bytes once:
//
// - A tile is a group of whole (n, c) planes, or a band of rows of one
//   plane where a plane does not fit (NASNet's 111-px planes), with the
//   k - 1 rows of halo the band reads.  The forward's and input gradient's
//   blocks loop over the tiles, as many blocks as the card holds at once.
//   A block stages a tile in shared memory by asynchronous copies
//   (cp.async), each thread starting all of its copies before it waits for
//   any, and writes the SAME zero border there: no padded copy of x is
//   made, and no crop of dx.  Whole planes keep one border, so a block
//   writes it once.  The copies are of 4 bytes: the padded rows (an odd
//   stride apart, for the banks) take no 16-byte copy, and 16-byte loads
//   through registers, written out float by float, measured slower.
// - Each thread takes one output row of the tile (rows side by side in a
//   warp, so that its reads of rows an odd stride apart hit distinct banks)
//   and, where the row is long, one of G groups of its columns; it keeps
//   the channel's k^2 taps in registers and computes J = 4 outputs along the
//   row at a time from a window of the row held in registers.
// - The forward and input gradient stage their outputs in shared memory and
//   store the tile with 16-byte stores where aligned: the tile is one
//   contiguous run of y or dx.
// - The input gradient is the correlation of dy with the flipped filter.  At
//   stride 2 the taps that reach a dx pixel are those of its row's and
//   column's parity: each thread keeps rows of one parity (classes of rows
//   side by side in the block, so a warp does not diverge) and walks its
//   row's even columns, then its odd ones, each with its own sub-filter.
// - The weight gradient runs a thread-block cluster for each channel: its
//   blocks take slices of the batch, stage x's and dy's planes, and each
//   thread sums its share of the k^2 taps in registers; the block reduces
//   them in a fixed order (warp shuffles, then its warps in order), and
//   block 0 of the cluster sums the blocks' partials over distributed
//   shared memory in rank order and writes dw once.  No atomics, no
//   workspace, no memset, no second kernel, and dw is bitwise the same from
//   run to run.  Clusters fill the card where the channels are few (42 and
//   84 in NASNet's stem); the launcher halves a cluster until all of the
//   launch's blocks fit on the card at once.
//
// The tiling (planes, rows and column groups a tile, the shared memory's
// strides, the cluster size) is chosen by the caller, ops/depthwise.py,
// from the shapes and the card's SM count, and handed over in a Layout.
//
// The kernels' names start as ATen's do (conv_depthwise2d_forward,
// _backward, _grad_weight): the benchmark's depthwise readers find each
// pass by that name and read it only when each pass launches once a layer,
// so they read the same work, counted in the same bytes, with these kernels
// in place of ATen's.  For that, a call launches its one kernel and nothing
// else: no copy, pad, memset or reduction pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int J = 4;              // outputs a thread computes along a row at once
constexpr int MAX_THREADS = 256;  // the caller's tiles take at most this many

// The tiling of one call; ints in the order ops/depthwise.py passes them.
struct Layout {
  int n, c, h, w;       // x (the forward's and weight gradient's input; dx's shape)
  int ho, wo;           // y and dy
  int pt, pl;           // SAME padding before the first row and column
  int planes;           // planes a tile (a block's group)
  int rows;             // output rows a tile (of y, of dx, of dy for dw)
  int groups;           // column groups a row
  int in_rows;          // shared-memory rows of a plane's input tile
  int in_stride;        // floats a row of the input tile (odd)
  int out_stride;       // floats a row of the output (dw: dy) tile (odd)
  int cluster;          // blocks a channel (weight gradient)
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// a / b for 0 <= a < 2^22 and b >= 1, from b's reciprocal rb
__device__ __forceinline__ int div_small(int a, int b, float rb) {
  int q = __float2int_rz(__int2float_rz(a) * rb);
  const int r = a - q * b;
  if (r < 0) --q;
  else if (r >= b) ++q;
  return q;
}

// Starts an asynchronous 4-byte copy from global to shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to), "l"(src) : "memory");
}

// Waits for the thread's asynchronous copies; a barrier then shows every
// thread's to the block.
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copies nseg segments of len floats (segment s at src + s * sstride) into
// shared memory: a segment is rows of w floats, hp rows a plane, and its
// element e of row i (of the segment) goes to
// dst[s * dseg + (i / hp) * dplane + (i % hp) * drow + e % w].  Each thread
// takes aligned 16-byte quads of global memory and starts asynchronous
// copies of their floats (cp.async): it issues all of its copies before it
// waits for any (copies_wait), so that their latency is paid once a tile.
__device__ __forceinline__ void stage_in(const float* __restrict__ src, long long sstride,
                                         int nseg, int len, int w, int hp, float* dst, int dseg,
                                         int dplane, int drow) {
  const int qps = (len + 6) >> 2;  // quads a segment of len floats can touch
  const float rq = 1.0f / qps, rw = 1.0f / w, rh = 1.0f / hp;
  for (int i = threadIdx.x; i < nseg * qps; i += blockDim.x) {
    const int s = nseg == 1 ? 0 : div_small(i, qps, rq);
    const float* seg = src + s * sstride;
    const int e0 = ((i - s * qps) << 2) - (int)((reinterpret_cast<uintptr_t>(seg) >> 2) & 3);
    if (e0 >= len) continue;
    const int first = max(e0, 0);
    int row = div_small(first, w, rw);
    int col = first - row * w;
    const int plane = div_small(row, hp, rh);
    row -= plane * hp;
    float* d = dst + s * dseg + plane * dplane + row * drow;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j < 0 || e0 + j >= len) continue;
      copy_async(d + col, seg + e0 + j);
      if (++col == w) {
        col = 0;
        d += drow;
        if (++row == hp) { row = 0; d += dplane - hp * drow; }
      }
    }
  }
}

// The converse of stage_in for one segment: dst[e] for e < len from the
// shared-memory tile, row i of plane i / hp at src + (i / hp) * splane +
// (i % hp) * srow; 16-byte stores where a quad lies inside the segment.
__device__ __forceinline__ void stage_out(float* __restrict__ dst, int len, int w, int hp,
                                          const float* src, int splane, int srow) {
  const int quads = (len + 6) >> 2;
  const int skew = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const float rw = 1.0f / w, rh = 1.0f / hp;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const int e0 = (i << 2) - skew;
    if (e0 >= len) continue;
    const int first = max(e0, 0);
    int row = div_small(first, w, rw);
    int col = first - row * w;
    const int plane = div_small(row, hp, rh);
    row -= plane * hp;
    const float* s = src + plane * splane + row * srow;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = 0.f;
      if (e0 + j < 0 || e0 + j >= len) continue;
      v[j] = s[col];
      if (++col == w) {
        col = 0;
        s += srow;
        if (++row == hp) { row = 0; s += splane - hp * srow; }
      }
    }
    if (e0 >= 0 && e0 + 4 <= len) {
      *reinterpret_cast<float4*>(dst + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j >= 0 && e0 + j < len) dst[e0 + j] = v[j];
    }
  }
}

// Zeroes the cells of np planes (plane p at t + p * tplane, rows trow
// apart) of nrows x ncols that lie outside rows [r0, r1) or columns [c0, c1).
__device__ __forceinline__ void zero_outside(float* t, int np, int tplane, int trow, int nrows,
                                             int ncols, int r0, int r1, int c0, int c1) {
  const int outer = r0 + (nrows - r1), side = ncols - (c1 - c0), inner = r1 - r0;
  const int n1 = np * outer * ncols, n2 = np * inner * side;
  const float ro = 1.0f / max(outer * ncols, 1), rc = 1.0f / ncols;
  const float ri = 1.0f / max(inner * side, 1), rs = 1.0f / max(side, 1);
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    const int p = div_small(i, outer * ncols, ro), rem = i - p * outer * ncols;
    int r = div_small(rem, ncols, rc);
    const int col = rem - r * ncols;
    if (r >= r0) r += r1 - r0;
    t[p * tplane + r * trow + col] = 0.f;
  }
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const int p = div_small(i, inner * side, ri), rem = i - p * inner * side;
    const int r = div_small(rem, side, rs);
    int col = rem - r * side;
    if (col >= c0) col += c1 - c0;
    t[p * tplane + (r0 + r) * trow + col] = 0.f;
  }
}

// The channel's k^2 taps, into registers.
template <int K>
__device__ __forceinline__ void load_taps(const float* __restrict__ wt, int c, float (&w)[K * K]) {
#pragma unroll
  for (int i = 0; i < K * K; ++i) w[i] = __ldg(wt + c * K * K + i);
}

// acc[t] += sum_{m < KA, l < KB} tap(m, l) * in[m * stride + IS * t + l] for
// the J outputs t, with tap(m, l) = w[(A0 + DA * m) * WS + B0 + DB * l] (taps
// WS a row): the filter as it is, flipped, or one parity's taps flipped.
// Each row of the window is read into registers once.
template <int WS, int WN, int KA, int KB, int IS, int A0, int DA, int B0, int DB>
__device__ __forceinline__ void correlate(const float* in, int stride, const float (&w)[WN],
                                          float (&acc)[J]) {
  constexpr int SPAN = IS * (J - 1) + KB;
#pragma unroll
  for (int m = 0; m < KA; ++m) {
    float v[SPAN];
#pragma unroll
    for (int u = 0; u < SPAN; ++u) v[u] = in[m * stride + u];
#pragma unroll
    for (int l = 0; l < KB; ++l) {
      const float tap = w[(A0 + DA * m) * WS + B0 + DB * l];
#pragma unroll
      for (int t = 0; t < J; ++t) acc[t] = fmaf(tap, v[IS * t + l], acc[t]);
    }
  }
}

// One dx row of a stride-2 input gradient, of row parity A0 (the taps
// a = A0, A0 + 2, ... reach it, from dy row (y + pt - a) / 2), in column
// group g of G: its even columns' runs, then its odd ones', each from the
// taps of its column parity B0.  w holds the filter's rows of parity A0
// only; the dy tile's window of a run ends at row top and column left (the
// dy pixel of tap (A0, B0) of the run's first output).
template <int K, int A0, int B0>
__device__ __forceinline__ void parity_taps(const float* tile, int stride, int top, int left,
                                            const float (&w)[(K - A0 + 1) / 2 * K],
                                            float (&acc)[J]) {
  constexpr int KA = (K - A0 + 1) / 2, KB = (K - B0 + 1) / 2;
  correlate<K, KA * K, KA, KB, 1, KA - 1, -1, B0 + 2 * (KB - 1), -2>(
      tile + (top - (KA - 1)) * stride + left - (KB - 1), stride, w, acc);
}

template <int K, int A0>
__device__ __forceinline__ void parity_row(const float* __restrict__ wt, int c, const float* tile,
                                           int stride, int top, int jlo, int pl, int width, int g,
                                           int G, float* out) {
  constexpr int KA = (K - A0 + 1) / 2;
  float w[KA * K];
#pragma unroll
  for (int m = 0; m < KA; ++m)
#pragma unroll
    for (int b = 0; b < K; ++b) w[m * K + b] = __ldg(wt + (c * K + A0 + 2 * m) * K + b);
  const int even = cdiv((width + 1) / 2, J), odd = cdiv(width / 2, J);  // runs a parity
  for (int m = g; m < even + odd; m += G) {
    const int qx = m < even ? 0 : 1;
    const int v0 = qx + 2 * J * (m < even ? m : m - even);
    const int left = ((v0 + pl - ((qx + pl) & 1)) >> 1) - jlo;
    float acc[J] = {};
    if (((qx + pl) & 1) == 0) parity_taps<K, A0, 0>(tile, stride, top, left, w, acc);
    else parity_taps<K, A0, 1>(tile, stride, top, left, w, acc);
#pragma unroll
    for (int t = 0; t < J; ++t)
      if (v0 + 2 * t < width) out[v0 + 2 * t] = acc[t];
  }
}

}  // namespace

template <int K, int S>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv_depthwise2d_forward_sm90_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                                     float* __restrict__ y, const Layout L) {
  extern __shared__ __align__(16) float smem[];
  const int P = L.planes, R = L.rows, G = L.groups;
  const int plane_in = L.in_rows * L.in_stride;
  float* tin = smem;                  // [P][in_rows][in_stride]: x, padded
  float* tout = smem + P * plane_in;  // [P][R][out_stride]: y
  const long long nplanes = (long long)L.n * L.c;
  const int bands = cdiv(L.ho, R);
  const long long tiles = (nplanes + P - 1) / P * bands;
  // the thread's output row of a tile: row r of plane p, column group g
  const int rho = threadIdx.x % (P * R), g = threadIdx.x / (P * R), p = rho / R, r = rho % R;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile / bands * P;
    const int np = (int)min((long long)P, nplanes - p0);
    const int r0 = (int)(tile % bands) * R, nr = min(R, L.ho - r0);
    // tile row 0 is x's row iy0; rows [ra, rb) of the tile lie in the image
    const int iy0 = S * r0 - L.pt, rin = S * (nr - 1) + K;
    const int ra = max(0, -iy0), rb = min(rin, L.h - iy0);
    const bool mine = g < G && p < np && r < nr;
    // whole planes keep one border: it is written for the block's first tile
    if (bands > 1 || tile == blockIdx.x)
      zero_outside(tin, np, plane_in, L.in_stride, rin, S * (L.wo - 1) + K, ra, rb, L.pl,
                   L.pl + L.w);
    // whole planes (np > 1) or one band: one contiguous run of x
    stage_in(x + (p0 * L.h + iy0 + ra) * L.w, 0, 1, np * (rb - ra) * L.w, L.w, rb - ra,
             tin + ra * L.in_stride + L.pl, 0, plane_in, L.in_stride);
    copies_wait();
    __syncthreads();
    if (mine) {
      float w[K * K];
      load_taps<K>(wt, (int)((p0 + p) % L.c), w);
      const float* in = tin + p * plane_in + S * r * L.in_stride;
      float* out = tout + (p * R + r) * L.out_stride;
      for (int j0 = g * J; j0 < L.wo; j0 += G * J) {
        float acc[J] = {};
        correlate<K, K * K, K, K, S, 0, 1, 0, 1>(in + S * j0, L.in_stride, w, acc);
#pragma unroll
        for (int t = 0; t < J; ++t)
          if (j0 + t < L.wo) out[j0 + t] = acc[t];
      }
    }
    __syncthreads();
    stage_out(y + (p0 * L.ho + r0) * L.wo, np * nr * L.wo, L.wo, nr, tout, R * L.out_stride,
              L.out_stride);
  }
}

template <int K, int S>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv_depthwise2d_backward_sm90_kernel(const float* __restrict__ dy, const float* __restrict__ wt,
                                      float* __restrict__ dx, const Layout L) {
  extern __shared__ __align__(16) float smem[];
  const int P = L.planes, R = L.rows, G = L.groups;
  const int plane_in = L.in_rows * L.in_stride;
  float* tin = smem;                  // [P][in_rows][in_stride]: dy, padded
  float* tout = smem + P * plane_in;  // [P][R][out_stride]: dx
  const long long nplanes = (long long)L.n * L.c;
  const int bands = cdiv(L.h, R);
  const long long tiles = (nplanes + P - 1) / P * bands;
  // the dy columns [jlo, jhi] that reach dx's columns; tile column 0 is jlo
  const int jlo = ceil_div(L.pl - (K - 1), S), jhi = floor_div(L.w - 1 + L.pl, S);
  // The thread's dx row of a tile: at stride 1 row r of plane p, column
  // group g; at stride 2 the rows of row parity a0 (the parity of their row
  // taps) are class a0, and the thread is row 2 rr + (a0 - y0 - pt) % 2.
  const int half = (R + 1) / 2;
  int p, g, r1 = 0, rr = 0, a0 = 0;
  if (S == 1) {
    r1 = threadIdx.x % (P * R);
    g = threadIdx.x / (P * R);
    p = r1 / R;
    r1 %= R;
  } else {
    rr = threadIdx.x % half;
    p = threadIdx.x / half % P;
    g = threadIdx.x / (half * P) % G;
    a0 = threadIdx.x / (half * P * G);
  }
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile / bands * P;
    const int np = (int)min((long long)P, nplanes - p0);
    const int y0 = (int)(tile % bands) * R, nr = min(R, L.h - y0);
    // the dy rows [ilo, ihi] that reach dx's rows [y0, y0 + nr); tile row 0 is ilo
    const int ilo = ceil_div(y0 + L.pt - (K - 1), S), ihi = floor_div(y0 + nr - 1 + L.pt, S);
    const int rin = ihi - ilo + 1;
    const int ra = max(0, -ilo), rb = min(rin, L.ho - ilo);
    const int r = S == 1 ? r1 : ((a0 - y0 - L.pt) & 1) + 2 * rr;
    const bool mine = g < G && a0 < 2 && p < np && r < nr;
    if (bands > 1 || tile == blockIdx.x)
      zero_outside(tin, np, plane_in, L.in_stride, rin, jhi - jlo + 1, ra, rb, -jlo,
                   L.wo - jlo);
    stage_in(dy + (p0 * L.ho + ilo + ra) * L.wo, 0, 1, np * (rb - ra) * L.wo, L.wo, rb - ra,
             tin + ra * L.in_stride - jlo, 0, plane_in, L.in_stride);
    copies_wait();
    __syncthreads();
    if (mine) {
      const int c = (int)((p0 + p) % L.c);
      float* out = tout + (p * R + r) * L.out_stride;
      if (S == 1) {
        // dx[u, v] = sum_{a,b} w[K-1-a, K-1-b] * dy_tile[u - y0 + a, v + b]
        float w[K * K];
        load_taps<K>(wt, c, w);
        const float* in = tin + p * plane_in + r * L.in_stride;
        for (int v0 = g * J; v0 < L.w; v0 += G * J) {
          float acc[J] = {};
          correlate<K, K * K, K, K, 1, K - 1, -1, K - 1, -1>(in + v0, L.in_stride, w, acc);
#pragma unroll
          for (int t = 0; t < J; ++t)
            if (v0 + t < L.w) out[v0 + t] = acc[t];
        }
      } else {
        const float* tile_in = tin + p * plane_in;
        const int top = ((y0 + r + L.pt - a0) >> 1) - ilo;
        if (a0 == 0) parity_row<K, 0>(wt, c, tile_in, L.in_stride, top, jlo, L.pl, L.w, g, G, out);
        else parity_row<K, 1>(wt, c, tile_in, L.in_stride, top, jlo, L.pl, L.w, g, G, out);
      }
    }
    __syncthreads();
    stage_out(dx + (p0 * L.h + y0) * L.w, np * nr * L.w, L.w, nr, tout, R * L.out_stride,
              L.out_stride);
  }
}

template <int K, int S>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv_depthwise2d_grad_weight_sm90_kernel(const float* __restrict__ x,
                                         const float* __restrict__ dy, float* __restrict__ dw,
                                         const Layout L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), c = blockIdx.y;
  const int P = L.planes, R = L.rows, G = L.groups;
  const int plane_in = L.in_rows * L.in_stride, plane_out = R * L.out_stride;
  float* tin = smem;                  // [P][in_rows][in_stride]: x, padded
  float* tout = smem + P * plane_in;  // [P][R][out_stride]: dy
  const int per = cdiv(L.n, L.cluster), n0 = rank * per, n1 = min(L.n, n0 + per);
  const int wc = cdiv(L.wo, J) * J;  // dy's columns the chunks read, zeros past wo
  const long long xplane = (long long)L.h * L.w, dplane = (long long)L.ho * L.wo;
  // the thread's row of a step: dy row r of plane p, column group g
  const int rho = threadIdx.x % (P * R), g = threadIdx.x / (P * R), p = rho / R, r = rho % R;
  float acc[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) acc[i] = 0.f;
  for (int n = n0; n < n1; n += P) {
    const int np = min(P, n1 - n);
    for (int r0 = 0; r0 < L.ho; r0 += R) {
      const int nr = min(R, L.ho - r0), iy0 = S * r0 - L.pt, rin = S * (nr - 1) + K;
      const int ra = max(0, -iy0), rb = min(rin, L.h - iy0);
      if (R < L.ho || n == n0) {  // whole planes keep one border
        zero_outside(tin, np, plane_in, L.in_stride, rin, L.in_stride, ra, rb, L.pl, L.pl + L.w);
        zero_outside(tout, np, plane_out, L.out_stride, nr, wc, 0, nr, 0, L.wo);
      }
      stage_in(x + ((long long)n * L.c + c) * xplane + (long long)(iy0 + ra) * L.w,
               L.c * xplane, np, (rb - ra) * L.w, L.w, rb - ra, tin + ra * L.in_stride + L.pl,
               plane_in, 0, L.in_stride);
      stage_in(dy + ((long long)n * L.c + c) * dplane + (long long)r0 * L.wo, L.c * dplane, np,
               nr * L.wo, L.wo, nr, tout, plane_out, 0, L.out_stride);
      copies_wait();
      __syncthreads();
      if (g < G && p < np && r < nr) {
        const float* xin = tin + p * plane_in + S * r * L.in_stride;
        const float* d = tout + p * plane_out + r * L.out_stride;
        for (int j0 = g * J; j0 < L.wo; j0 += G * J) {
          float e[J];
#pragma unroll
          for (int t = 0; t < J; ++t) e[t] = d[j0 + t];
#pragma unroll
          for (int a = 0; a < K; ++a) {
            float v[S * (J - 1) + K];
#pragma unroll
            for (int u = 0; u < S * (J - 1) + K; ++u) v[u] = xin[a * L.in_stride + S * j0 + u];
#pragma unroll
            for (int b = 0; b < K; ++b)
#pragma unroll
              for (int t = 0; t < J; ++t) acc[a * K + b] = fmaf(e[t], v[S * t + b], acc[a * K + b]);
          }
        }
      }
      __syncthreads();
    }
  }
  // the block's sums: each warp's by shuffles, then the warps' in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    float v = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    acc[i] = v;
  }
  float* red = smem;  // the tiles are no longer read
  float* part = smem + warps * K * K;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K * K; ++i) red[warp * K * K + i] = acc[i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < K * K; t += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < warps; ++q) s += red[q * K * K + t];
    part[t] = s;
  }
  // the cluster's sum: rank 0 reads each block's partial in rank order; the
  // second barrier keeps every block's shared memory until it has
  cluster.sync();
  for (int t = threadIdx.x; rank == 0 && t < K * K; t += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < L.cluster; ++q) s += cluster.map_shared_rank(part, q)[t];
    dw[c * K * K + t] = s;
  }
  cluster.sync();
}

namespace {

Layout layout_of(const int* v) {
  return Layout{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
                v[8], v[9], v[10], v[11], v[12], v[13], v[14]};
}

// Lets a kernel take more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Blocks of a tile loop: as many as the card holds at once, at most tiles.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int threads, int smem, long long tiles) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return min(tiles, (long long)max(per_sm, 1) * max(sms, 1));
}

template <int K, int S>
cudaError_t launch_forward(const float* x, const float* w, float* y, const Layout& L,
                           int threads, int smem, cudaStream_t stream) {
  auto kernel = conv_depthwise2d_forward_sm90_kernel<K, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)L.n * L.c + L.planes - 1) / L.planes * ((L.ho + L.rows - 1) / L.rows);
  const unsigned blocks = (unsigned)resident_blocks(kernel, threads, smem, tiles);
  kernel<<<blocks, threads, smem, stream>>>(x, w, y, L);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_input_grad(const float* dy, const float* w, float* dx, const Layout& L,
                              int threads, int smem, cudaStream_t stream) {
  auto kernel = conv_depthwise2d_backward_sm90_kernel<K, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)L.n * L.c + L.planes - 1) / L.planes * ((L.h + L.rows - 1) / L.rows);
  const unsigned blocks = (unsigned)resident_blocks(kernel, threads, smem, tiles);
  kernel<<<blocks, threads, smem, stream>>>(dy, w, dx, L);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_grad_weight(const float* x, const float* dy, float* dw, const Layout& L,
                               int threads, int smem, cudaStream_t stream) {
  auto kernel = conv_depthwise2d_grad_weight_sm90_kernel<K, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // every block at once: a cluster of blocks a channel as large as that allows
  Layout M = L;
  const long long resident = resident_blocks(kernel, threads, smem, (long long)L.c * L.cluster);
  while (M.cluster > 1 && (long long)L.c * M.cluster > resident) M.cluster /= 2;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)M.cluster, (unsigned)L.c);
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = (unsigned)M.cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, x, dy, dw, M);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

#define DEPTHWISE_DISPATCH(launch, ...)                                   \
  switch (k * 10 + s) {                                                   \
    case 31: return (int)launch<3, 1>(__VA_ARGS__);                       \
    case 32: return (int)launch<3, 2>(__VA_ARGS__);                       \
    case 51: return (int)launch<5, 1>(__VA_ARGS__);                       \
    case 52: return (int)launch<5, 2>(__VA_ARGS__);                       \
    case 71: return (int)launch<7, 1>(__VA_ARGS__);                       \
    case 72: return (int)launch<7, 2>(__VA_ARGS__);                       \
    default: return (int)cudaErrorInvalidValue;                           \
  }

// Each returns 0 or the CUDA error of the launch; layout holds the 15 ints
// of a Layout, threads and smem the block's threads and shared-memory bytes.
extern "C" int depthwise_conv_forward(const float* x, const float* w, float* y, const int* layout,
                                      int k, int s, int threads, int smem, void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(layout);
  DEPTHWISE_DISPATCH(launch_forward, x, w, y, L, threads, smem, (cudaStream_t)stream)
}

extern "C" int depthwise_conv_input_grad(const float* dy, const float* w, float* dx,
                                         const int* layout, int k, int s, int threads, int smem,
                                         void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(layout);
  DEPTHWISE_DISPATCH(launch_input_grad, dy, w, dx, L, threads, smem, (cudaStream_t)stream)
}

extern "C" int depthwise_conv_grad_weight(const float* x, const float* dy, float* dw,
                                          const int* layout, int k, int s, int threads, int smem,
                                          void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(layout);
  DEPTHWISE_DISPATCH(launch_grad_weight, x, dy, dw, L, threads, smem, (cudaStream_t)stream)
}
