// Grouped SwiGLU expert FFN for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm:
//   y[s] = (silu(x[s] @ w1[s]) * (x[s] @ w3[s])) @ w2[s]
// with x [S, C, D], w1/w3 [S, D, F], w2 [S, F, D], fp32 accumulation and the
// gated intermediate cast to x's type before the second product.
//
// What bounds it on the H100: serving routes a handful of rows to each
// expert slot (a 4-request decode step fills 1-4 rows of a slot whose
// capacity is 16384), so the work is reading each occupied slot's three
// weight matrices once: 3 * D * F * 2 bytes = 352 MB per slot in bf16 at
// Mixtral-8x7B width. The kernel is bound by device-memory bytes, not by
// arithmetic, as long as it neither touches the empty capacity nor re-reads
// the weights.
//
// What the design does about it:
// * A per-slot fill count fill[s] (rows actually routed there) bounds the
//   work. Rows at or past the fill are never read; the output there is
//   written as zeros, which is what the reference computes for the zero rows
//   the dispatcher leaves in them (silu(0) * 0 @ w2 == 0).
// * Two passes instead of the TPU's resident [bc, D] fp32 accumulator (16 KB
//   per row at D = 4096, too large for shared memory at useful row tiles):
//   pass 1 writes mid = cast(silu(x @ w1) * (x @ w3)) for the filled rows
//   only, into a [S, Cm, F] scratch the wrapper allocates; pass 2 computes
//   mid @ w2 tiled over D.
// * A block owns 64 output columns of one slot and loops over row tiles of
//   BM rows, so a decode-sized fill (<= BM rows) reads each weight column of
//   the slot exactly once. Its four warps split the reduction axis and meet
//   in shared memory at the end; lanes read 32 consecutive weights of a row
//   (coalesced), and each row tile of x sits in registers, broadcast across
//   the warp with shuffles.
// * Inner products run on the CUDA cores in fp32 (no TF32): the fp32 path
//   must agree with the plain version to fp32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // warps per block, split the reduction
constexpr int kCols = 2;                  // output columns per lane (stride 32)
constexpr int kBlockCols = 32 * kCols;    // output columns per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Accumulates, for BM rows of `a` (row stride K, first row r0, n valid rows)
// and the lane's kCols columns of `b` (row stride N), the partial products
// over this warp's share [k_lo, k_hi) of the reduction axis.
template <typename T, int BM, int NMAT>
__device__ __forceinline__ void partial_products(
    const T* __restrict__ a, const T* const* b, int K, int N, int r0, int n,
    int k_lo, int k_hi, int col0, int lane, float acc[NMAT][BM][kCols]) {
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[m][r][c] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
    float ar[BM];
    const int kl = k0 + lane;
#pragma unroll
    for (int r = 0; r < BM; ++r)
      ar[r] = (r0 + r < n && kl < k_hi) ? to_f(a[(size_t)(r0 + r) * K + kl])
                                        : 0.f;
    const int kn = min(32, k_hi - k0);
#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      const size_t row = (size_t)(k0 + j) * N;
      float w[NMAT][kCols];
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = col0 + 32 * c;
          w[m][c] = col < N ? to_f(b[m][row + col]) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float av = __shfl_sync(0xffffffffu, ar[r], j);
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[m][r][c] = fmaf(av, w[m][c], acc[m][r][c]);
      }
    }
  }
}

// Pass 1: mid[s, r, f] = cast(silu(x[s, r] @ w1[s, :, f]) * (x[s, r] @ w3[s, :, f]))
// for r < min(fill[s], C, Cm). Grid (ceil(F / 64), S), block kWarps * 32.
template <typename T, int BM>
__global__ void __launch_bounds__(kWarps * 32)
    gmm_up(const T* __restrict__ x, const T* __restrict__ w1,
           const T* __restrict__ w3, const int* __restrict__ fill,
           T* __restrict__ mid, int C, int D, int F, int Cm) {
  __shared__ float red[kWarps][2][BM][kBlockCols];
  const int s = blockIdx.y;
  const int n = min(min(fill[s], C), Cm);
  if (n <= 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kBlockCols + lane;
  const int per = (D + kWarps - 1) / kWarps;
  const int k_lo = min(D, warp * per), k_hi = min(D, k_lo + per);
  const T* xs = x + (size_t)s * C * D;
  const T* ws[2] = {w1 + (size_t)s * D * F, w3 + (size_t)s * D * F};
  for (int r0 = 0; r0 < n; r0 += BM) {
    float acc[2][BM][kCols];
    partial_products<T, BM, 2>(xs, ws, D, F, r0, n, k_lo, k_hi, col0, lane,
                               acc);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) red[warp][m][r][lane + 32 * c] = acc[m][r][c];
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBlockCols; i += kWarps * 32) {
      const int r = i / kBlockCols, cc = i % kBlockCols;
      const int f = blockIdx.x * kBlockCols + cc;
      if (r0 + r < n && f < F) {
        float ga = 0.f, gb = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          ga += red[w][0][r][cc];
          gb += red[w][1][r][cc];
        }
        const float g = ga / (1.f + expf(-ga)) * gb;  // silu(a) * b
        mid[((size_t)s * Cm + r0 + r) * F + f] = from_f<T>(g);
      }
    }
    __syncthreads();
  }
}

// Pass 2: y[s, r, d] = mid[s, r] @ w2[s, :, d] for r < min(fill[s], C, Cm),
// zero for the remaining rows of the slot. Grid (ceil(D / 64), S).
template <typename T, int BM>
__global__ void __launch_bounds__(kWarps * 32)
    gmm_down(const T* __restrict__ mid, const T* __restrict__ w2,
             const int* __restrict__ fill, T* __restrict__ y, int C, int D,
             int F, int Cm) {
  __shared__ float red[kWarps][BM][kBlockCols];
  const int s = blockIdx.y;
  const int n = max(0, min(min(fill[s], C), Cm));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kBlockCols + lane;
  const int per = (F + kWarps - 1) / kWarps;
  const int k_lo = min(F, warp * per), k_hi = min(F, k_lo + per);
  const T* ms = mid + (size_t)s * Cm * F;
  const T* ws[1] = {w2 + (size_t)s * F * D};
  T* ys = y + (size_t)s * C * D;
  for (int r0 = 0; r0 < n; r0 += BM) {
    float acc[1][BM][kCols];
    partial_products<T, BM, 1>(ms, ws, F, D, r0, n, k_lo, k_hi, col0, lane,
                               acc);
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][r][lane + 32 * c] = acc[0][r][c];
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBlockCols; i += kWarps * 32) {
      const int r = i / kBlockCols, cc = i % kBlockCols;
      const int d = blockIdx.x * kBlockCols + cc;
      if (r0 + r < n && d < D) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[w][r][cc];
        ys[(size_t)(r0 + r) * D + d] = from_f<T>(v);
      }
    }
    __syncthreads();
  }
  const T zero = from_f<T>(0.f);
  for (int r = n + warp; r < C; r += kWarps)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = col0 + 32 * c;
      if (d < D) ys[(size_t)r * D + d] = zero;
    }
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w1, const void* w3,
                   const void* w2, const int* fill, void* mid, void* y, int S,
                   int C, int D, int F, int Cm, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const dim3 grid_up((F + kBlockCols - 1) / kBlockCols, S);
  gmm_up<T, BM><<<grid_up, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), fill, static_cast<T*>(mid), C, D, F, Cm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down((D + kBlockCols - 1) / kBlockCols, S);
  gmm_down<T, BM><<<grid_down, block, 0, stream>>>(
      static_cast<const T*>(mid), static_cast<const T*>(w2), fill,
      static_cast<T*>(y), C, D, F, Cm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(int Cm, const void* x, const void* w1, const void* w3,
                        const void* w2, const int* fill, void* mid, void* y,
                        int S, int C, int D, int F, cudaStream_t stream) {
  // the row tile: a decode-sized fill (<= 4 rows) reads every weight once
  // and pays for 4 rows of arithmetic, larger fills take 16-row tiles
  if (Cm <= 4)
    return launch<T, 4>(x, w1, w3, w2, fill, mid, y, S, C, D, F, Cm, stream);
  return launch<T, 16>(x, w1, w3, w2, fill, mid, y, S, C, D, F, Cm, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [S, C, D], w1/w3 [S, D, F],
// w2 [S, F, D], fill [S] int32, mid [S, Cm, F] scratch, y [S, C, D], all
// contiguous on the device. Rows r >= min(fill[s], Cm) of y[s] are zero.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int moe_gmm_launch(int dtype, const void* x, const void* w1,
                              const void* w3, const void* w2, const void* fill,
                              void* mid, void* y, int S, int C, int D, int F,
                              int Cm, void* stream) {
  if (S <= 0 || C <= 0 || D <= 0 || F <= 0 || Cm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(fill);
  cudaError_t err;
  if (dtype == 0)
    err = launch_rows<float>(Cm, x, w1, w3, w2, fl, mid, y, S, C, D, F, st);
  else if (dtype == 1)
    err = launch_rows<__nv_bfloat16>(Cm, x, w1, w3, w2, fl, mid, y, S, C, D, F,
                                     st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
