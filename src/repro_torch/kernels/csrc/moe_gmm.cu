// Grouped SwiGLU expert FFN for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm:
//   y[s] = (silu(x[s] @ w1[s]) * (x[s] @ w3[s])) @ w2[s]
// with x [S, C, D], w1/w3 [S, D, F], w2 [S, F, D], fp32 accumulation and the
// gated intermediate cast to x's type before the second product.
//
// What bounds it on the H100 depends on the fill. A slot that holds n
// routed rows costs 6 D F n flops against its three weight matrices, 6 D F
// bytes (352 MB a slot in bf16 at Mixtral-8x7B width), so n flops a weight
// byte; the tensor cores become the limit at about 295. Serving's decode
// and chunk steps route a handful to 128 rows to a slot (a 4-request
// decode step fills 1-4 rows of a slot whose capacity is 16384): bound by
// device-memory bytes, as long as the kernel neither touches the empty
// capacity nor re-reads the weights. Prefill and training route hundreds
// to thousands (generate's 2 x 200-token prefill about 100 a slot, the EP
// train step 500-700, a 32k-token prefill about 8192): past about 300 rows
// a slot the operations bound it. So the bf16 forward has two designs, and
// the host picks one from max_fill (moe_gmm.py::select_design): the weight
// stream gmm_tc up to 128 rows a slot, the row tiles gmm_rows (section
// "bf16 at prefill and train fills") above.
//
// Common to every variant and design:
// * A per-slot fill count fill[s] (rows actually routed there) bounds the
//   work. Rows at or past the fill never reach the output (the dispatcher
//   leaves them unwritten; gmm_rows reads those of a straddling tile, but
//   each enters its own output row only, which is never stored); the
//   output there is written as zeros, which is what the reference computes
//   for the zero rows it holds there.
// * Two passes instead of the TPU's resident [bc, D] fp32 accumulator (16 KB
//   per row at D = 4096): pass 1 writes mid = cast(silu(x @ w1) * (x @ w3))
//   for the filled rows only, into a [S, Cm, F] scratch the wrapper
//   allocates; pass 2 computes mid @ w2.
//
// gmm_tc (bf16 with D % 8 == F % 8 == 0, max_fill <= 128): a weight stream
// through the tensor cores.
// * A and B swapped: the weights are the M side of wgmma.m64nNk16 (64
//   weight columns per warpgroup, an MN-major A read by the tensor cores
//   straight from the row-major [K, N] tile) and the slot's rows the N side
//   (N = 8..128), so a decode fill of 1-4 rows pads to 8, not to 64.
// * A block of two warpgroups owns 128 weight columns of one slot (pass 1:
//   64 of w1 and the same 64 of w3; pass 2: 128 of w2) and every row of the
//   slot up to a row tile of 8..128 rows (the wrapper sizes it from
//   max_fill), so each weight is read once for fills up to 128 rows; larger
//   fills (a forced design only) loop over row tiles and re-read the
//   block's weight columns each time.
// * Weights stream through 16-byte cp.async copies into a 3-4 stage ring of
//   64-deep tiles (16 KB of weights a stage) in the 128-byte swizzle of
//   wgmma's descriptors; copies run 1-2 stages ahead while one stage's
//   products stay in flight, and 2-3 blocks per SM keep 64-150 KB of copies
//   outstanding. wgmma, not mma.sync: mma.sync would have every warp read
//   the whole row tile through ldmatrix, which holds a full tile of 128 rows
//   to half its bound.
// * Split-K where the grid is thin (the wrapper's plan: fewer than 2 blocks
//   per SM, e.g. pass 2 at D = 4096): each split writes fp32 partial sums
//   into a scratch the wrapper allocates, and a reduce kernel adds them in
//   split order (no float atomics: two runs give the same bits), applying the
//   gate and the cast of mid after the sum in pass 1.
// * The zero rows [fill, C) of y are written by pass 1's blocks with 16-byte
//   stores, a few per pipeline step, so they share the weight stream's time
//   and every SM.
//
// gmm_simt (fp32, and bf16 with other widths): on the CUDA cores, fp32 with
// no TF32, because the fp32 path must agree with the plain version to 1e-4.
// * A block owns 64 output columns of one slot and loops over row tiles of
//   BM rows; its four warps split the reduction axis and meet in shared
//   memory at the end; lanes read 32 consecutive weights of a row
//   (coalesced), and each row tile of x sits in registers, broadcast across
//   the warp with shuffles.
//
// The backward (the Pallas kernel has none) is in the two Backward sections
// below: the CUDA cores' seven products, and four wgmma kernels for bf16.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA cores (fp32, and bf16 with other widths)
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;  // 2 warpgroups of 64 weight columns each
constexpr int kCols = 128;     // weight columns per block tile
constexpr int kBK = 64;        // reduction depth of one pipeline stage
constexpr int kWTile = kBK * 128;  // bytes of one warpgroup's weight tile

// A stage of the ring, in the 128-byte swizzle of mma.cuh: two weight tiles
// of 64 k-rows x 64 columns (MN-major A of each warpgroup), then the row
// tile, 8 * NT rows x 64 k (K-major B).
template <int NT>  // NT n-tiles of 8 rows: a row tile of 8 * NT rows
struct Tile {
  static constexpr int kRows = 8 * NT;
  static constexpr int kStages = NT >= 16 ? 3 : 4;
  static constexpr int kStageBytes = 2 * kWTile + kRows * 128;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  // blocks per SM the shared memory allows (227 KB a block at most); the
  // register cap follows from it (3 blocks: 85 registers a thread, 2: 128)
  static constexpr int kMinBlocks = 3 * kSmem <= 232448 ? 3 : 2;
};

// One pass over one slot and one column tile, for every row tile of the
// slot's filled rows. act [S, act_rows, K] (rows < n read), wa/wb [S, K, N]
// (wb only when GATED). Grid (column tiles, S, splits), block kThreads.
// splits == 1: writes out [S, out_rows, N] (GATED: cast(silu(a) * b), else
// the product), rows < n. splits > 1: writes fp32 partial sums to
// part [splits, S, Cm, NC] (NC = 2N, w1's columns then w3's, when GATED),
// rows < n, for the reduce kernels. zero_y (pass 1 only, else null): the
// block's share of y [S, C, D] rows [n, C) is written with zeros.
template <int NT, bool GATED>
__global__ void __launch_bounds__(kThreads, Tile<NT>::kMinBlocks)
    gmm_tc(const __nv_bfloat16* __restrict__ act, int act_rows,
           const __nv_bfloat16* __restrict__ wa,
           const __nv_bfloat16* __restrict__ wb, const int* __restrict__ fill,
           int C, int Cm, int K, int N, float* __restrict__ part,
           __nv_bfloat16* __restrict__ out, int out_rows,
           __nv_bfloat16* __restrict__ zero_y, int D) {
  using T = Tile<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // shared address of the ring
  unsigned char* ring = smem_raw + (base - raw);
  const int S = gridDim.y, splits = gridDim.z;
  const int s = blockIdx.y, z = blockIdx.z;
  const int n = max(0, min(min(fill[s], C), Cm));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;

  // this split's share of the reduction axis, in whole stages
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  const int kt0 = min(k_tiles, z * per), kt1 = min(k_tiles, kt0 + per);
  const int nk = kt1 - kt0;
  const int k_hi = min(K, kt1 * kBK);

  // the zero rows of y: this block's share, in 16-byte units
  uint4* zb = nullptr;
  size_t z_cur = 0, z_end = 0;
  int z_step = 0;  // units per thread per pipeline step
  if (zero_y != nullptr) {
    const size_t total = static_cast<size_t>(C - n) * D / 8;
    const size_t nblk = static_cast<size_t>(gridDim.x) * splits;
    const size_t share = (total + nblk - 1) / nblk;
    const size_t lo =
        min(total, (static_cast<size_t>(z) * gridDim.x + blockIdx.x) * share);
    z_end = min(total, lo + share);
    z_cur = lo + tid;
    zb = reinterpret_cast<uint4*>(zero_y +
                                  (static_cast<size_t>(s) * C + n) * D);
    const int steps = max(1, nk * ((n + T::kRows - 1) / T::kRows));
    const size_t units = (z_end - lo + kThreads - 1) / kThreads;
    z_step = static_cast<int>((units + steps - 1) / steps);
  }
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // the weight chunks this thread copies: chunk wch % 8 of warpgroup
  // wch / 8's tile, rows tid / 16 + 16 q of each stage
  const int wch = tid & 15, wrow = tid >> 4;
  const int wcol = GATED ? blockIdx.x * (kCols / 2) + (wch & 7) * 8
                         : blockIdx.x * kCols + wch * 8;
  const bool wcol_ok = wcol < N;
  const __nv_bfloat16* wsrc =
      (GATED && wch >= 8 ? wb : wa) + static_cast<size_t>(s) * K * N +
      (wcol_ok ? wcol : 0);
  const uint32_t wdst = (wch >> 3) * kWTile + mma::sw128(wrow, wch & 7);
  const __nv_bfloat16* asrc = act + static_cast<size_t>(s) * act_rows * K;

  auto load_stage = [&](int stage, int kt, int r0) {
    unsigned char* st = ring + stage * T::kStageBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int q = 0; q < kBK / 16; ++q) {
      const int row = wrow + 16 * q;
      const bool ok = wcol_ok && k0 + row < k_hi;
      mma::cp_async_16(st + wdst + 16 * q * 128,
                       wsrc + static_cast<size_t>(ok ? k0 + row : 0) * N, ok);
    }
#pragma unroll
    for (int i = tid; i < T::kRows * (kBK / 8); i += kThreads) {
      const int row = i >> 3, ch = i & 7;
      const bool ok = r0 + row < n && k0 + ch * 8 < k_hi;
      mma::cp_async_16(
          st + 2 * kWTile + mma::sw128(row, ch),
          asrc + (ok ? static_cast<size_t>(r0 + row) * K + k0 + ch * 8 : 0),
          ok);
    }
  };

  // the warpgroup's product over one stage: A = its weight tile (MN-major,
  // +2048 bytes per 16 k), B = the row tile (K-major, +32 bytes per 16 k)
  const int wg = warp >> 2;
  auto multiply = [&](int stage, float* acc) {
    const uint32_t st = base + stage * T::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma::wgmma_m64k16_ss<T::kRows, 1, 0>(
          acc, mma::desc_sw128(st + wg * kWTile + kk * 2048, kWTile, 1024),
          mma::desc_sw128(st + 2 * kWTile + kk * 32, 16, 1024));
  };

  for (int r0 = 0; r0 < n; r0 += T::kRows) {
    float acc[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
    // copies run kStages - 2 stages ahead, so that one stage's products
    // stay in flight while the next is issued
#pragma unroll
    for (int st = 0; st < T::kStages - 2; ++st) {
      if (st < nk) load_stage(st, kt0 + st, r0);
      mma::cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      mma::cp_async_wait<T::kStages - 3>();
      mma::fence_proxy_async();
      __syncthreads();  // stage `it` landed; the products of it - 2 are done
      const int nxt = it + T::kStages - 2;
      if (nxt < nk) load_stage(nxt % T::kStages, kt0 + nxt, r0);
      mma::cp_async_commit();
      mma::wgmma_fence();
      multiply(it % T::kStages, acc);
      mma::wgmma_commit();
      mma::wgmma_wait<1>();  // the products of it - 1 are done
      for (int q = 0; q < z_step && z_cur < z_end; ++q, z_cur += kThreads)
        zb[z_cur] = zero4;
    }
    mma::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) mma::fence_operand(acc[i]);
    mma::cp_async_wait<0>();
    __syncthreads();  // the ring is free for the epilogue's exchange

    // acc[4 * j + e] holds column g + 8 (e / 2) of the warp's 16 and row
    // r0 + 8 j + 2 c + e % 2
    const int mat = GATED ? warp >> 2 : 0;
    const int col0 = GATED ? blockIdx.x * (kCols / 2) + (warp & 3) * 16
                           : blockIdx.x * kCols + warp * 16;
    if (splits > 1) {
      const int NC = GATED ? 2 * N : N;
      float* pb = part + (static_cast<size_t>(z) * S + s) * Cm * NC + mat * N;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + j * 8 + 2 * c + (e & 1);
          const int col = col0 + g + 8 * (e >> 1);
          if (row < n && col < N)
            pb[static_cast<size_t>(row) * NC + col] = acc[4 * j + e];
        }
    } else if (GATED) {
      float* red = reinterpret_cast<float*>(ring);  // [4][NT][4][32]
      if (warp >= 4) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(((warp - 4) * NT + j) * 4 + e) * 32 + lane] = acc[4 * j + e];
      }
      __syncthreads();
      if (warp < 4) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + j * 8 + 2 * c + (e & 1);
            const int col = col0 + g + 8 * (e >> 1);
            const float ga = acc[4 * j + e];
            const float gb = red[((warp * NT + j) * 4 + e) * 32 + lane];
            if (row < n && col < N)
              out[(static_cast<size_t>(s) * out_rows + row) * N + col] =
                  __float2bfloat16(ga / (1.f + expf(-ga)) * gb);
          }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + j * 8 + 2 * c + (e & 1);
          const int col = col0 + g + 8 * (e >> 1);
          if (row < n && col < N)
            out[(static_cast<size_t>(s) * out_rows + row) * N + col] =
                __float2bfloat16(acc[4 * j + e]);
        }
    }
    __syncthreads();  // the exchange is read before the next tile's copies
  }
  for (; z_cur < z_end; z_cur += kThreads) zb[z_cur] = zero4;
}

// Pass 1's split sums, in split order, then the gate and the cast:
// mid[s, r, f] = cast(silu(a) * b). Grid (ceil(F / 256), Cm, S), block 256.
__global__ void __launch_bounds__(256)
    gate_reduce(const float* __restrict__ part, const int* __restrict__ fill,
                __nv_bfloat16* __restrict__ mid, int C, int Cm, int F,
                int splits) {
  const int S = gridDim.z, s = blockIdx.z, r = blockIdx.y;
  const int f = blockIdx.x * 256 + threadIdx.x;
  const int n = max(0, min(min(fill[s], C), Cm));
  if (r >= n || f >= F) return;
  float a = 0.f, b = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float* p =
        part + ((static_cast<size_t>(z) * S + s) * Cm + r) * (2 * F);
    a += p[f];
    b += p[F + f];
  }
  mid[(static_cast<size_t>(s) * Cm + r) * F + f] =
      __float2bfloat16(a / (1.f + expf(-a)) * b);
}

// Pass 2's split sums, in split order: y[s, r, d] for r < n.
// Grid (ceil(D / 256), Cm, S), block 256.
__global__ void __launch_bounds__(256)
    down_reduce(const float* __restrict__ part, const int* __restrict__ fill,
                __nv_bfloat16* __restrict__ y, int C, int Cm, int D,
                int splits) {
  const int S = gridDim.z, s = blockIdx.z, r = blockIdx.y;
  const int d = blockIdx.x * 256 + threadIdx.x;
  const int n = max(0, min(min(fill[s], C), Cm));
  if (r >= n || d >= D) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z)
    v += part[((static_cast<size_t>(z) * S + s) * Cm + r) * D + d];
  y[(static_cast<size_t>(s) * C + r) * D + d] = __float2bfloat16(v);
}

template <int NT>
cudaError_t launch(const void* x, const void* w1, const void* w3,
                   const void* w2, const int* fill, void* mid, float* part,
                   void* y, int S, int C, int D, int F, int Cm, int ks_up,
                   int ks_down, cudaStream_t st) {
  using B = __nv_bfloat16;
  constexpr int smem = Tile<NT>::kSmem;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gmm_tc<NT, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gmm_tc<NT, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const B* xb = static_cast<const B*>(x);
  B* midb = static_cast<B*>(mid);
  B* yb = static_cast<B*>(y);
  const dim3 grid_up((F + kCols / 2 - 1) / (kCols / 2), S, ks_up);
  gmm_tc<NT, true><<<grid_up, kThreads, smem, st>>>(
      xb, C, static_cast<const B*>(w1), static_cast<const B*>(w3), fill, C,
      Cm, D, F, part, midb, Cm, yb, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (ks_up > 1) {
    gate_reduce<<<dim3((F + 255) / 256, Cm, S), 256, 0, st>>>(
        part, fill, midb, C, Cm, F, ks_up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 grid_down((D + kCols - 1) / kCols, S, ks_down);
  gmm_tc<NT, false><<<grid_down, kThreads, smem, st>>>(
      midb, Cm, static_cast<const B*>(w2), nullptr, fill, C, Cm, F, D, part,
      yb, C, nullptr, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ks_down > 1) {
    down_reduce<<<dim3((D + 255) / 256, Cm, S), 256, 0, st>>>(
        part, fill, yb, C, Cm, D, ks_down);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace tc


// ---------------------------------------------------------------------------
// Backward (CUDA cores, fp32 and bf16)
// ---------------------------------------------------------------------------
//
// The Pallas kernel has no backward. Given dy [S, C, D], over the n_s =
// min(fill[s], C, Cm) filled rows of each slot only (rows past the fill
// carry zero gradient and add nothing to the weight gradients), it
// recomputes the forward's products and takes the gradients, with the
// forward's type conventions (fp32 sums; the gated intermediate rounded to
// x's type):
//   a = x w1, b = x w3 (fp32, recomputed: keeping them from the forward
//     would hold 2 x [S, Cm, F] fp32 across the whole backward of the model)
//   dmid = dy w2^T; da = cast(dmid b silu'(a)); db = cast(dmid silu(a));
//     mid = cast(silu(a) b)   (one fused epilogue)
//   dx = da w1^T + db w3^T (rows past the fill written as zeros)
//   dw1 = x^T da, dw3 = x^T db, dw2 = mid^T dy
// gemm: seven launches of one tiled product, each block a 64 x 64 output tile of
// one slot summed in a fixed order along the reduction axis (the rows of a
// slot, for the weight gradients): no float atomics, and two runs give the
// same bits. gemm (CUDA cores: fp32, and bf16 at other widths): 4 x 4
// outputs a thread over 16-deep stages of both operands staged in shared
// memory as fp32 (bf16 with D % 8 == F % 8 == 0 runs the wgmma kernels of
// the next section instead). What bounds it: 16 D F flops per routed row
// (the recompute and five products) against the weights' and weight
// gradients' 6 D F bytes a slot, so the operations, at a few hundred routed
// rows.

namespace bwd {

constexpr int kBM = 64, kBN = 64, kBK = 16;  // output tile, stage depth
constexpr int kThreads = 256;                // 16 x 16 threads, 4 x 4 each

// Element (i, j) of slot s of an operand: p[s * bs + i * si + j * sj]
// (A: i = output row, j = reduction index; B: i = reduction, j = column).
template <typename T>
struct Operand {
  const T* p;
  long long bs;
  long long si, sj;
};

__device__ __forceinline__ int slot_rows(const int* fill, int s, int C,
                                         int Cm) {
  return max(0, min(min(fill[s], C), Cm));
}

// out[s](m, n) = sum over the NPAIR pairs of sum_{k < K_s} A(m, k) B(k, n)
// for m < M_s, and 0 for M_s <= m < m_zero; K_s = the slot's filled rows if
// k_fill else K, M_s likewise with m_fill and M. EPI 0 stores out
// (row stride ldo, slot stride bso) in OutT. EPI 1 is the gate's backward,
// for the output dmid [S, Cm, F]: from ab = {a, b} fp32 [2][S][Cm][F] it
// writes g = {da, db, mid} in T [3][S][Cm][F].
// Grid (ceil(N / 64), ceil(rows / 64), S), block 256.
template <typename T, typename OutT, int NPAIR, int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm(Operand<T> a0, Operand<T> b0, Operand<T> a1, Operand<T> b1,
         const int* __restrict__ fill, int C, int Cm, int M, int N, int K,
         int m_fill, int k_fill, int m_zero, OutT* __restrict__ out,
         long long bso, int ldo, const float* __restrict__ ab,
         T* __restrict__ g) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int s = blockIdx.z;
  const int n_s = slot_rows(fill, s, C, Cm);
  const int Ms = m_fill ? n_s : M, Ks = k_fill ? n_s : K;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (m0 >= max(Ms, m_zero)) return;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (m0 < Ms) {
#pragma unroll
    for (int pr = 0; pr < NPAIR; ++pr) {
      const Operand<T> A = pr == 0 ? a0 : a1;
      const Operand<T> B = pr == 0 ? b0 : b1;
      const T* ap = A.p + s * A.bs;
      const T* bp = B.p + s * B.bs;
      for (int k0 = 0; k0 < Ks; k0 += kBK) {
        // the stage of A (64 rows x 16) and of B (16 x 64 columns), each
        // read along its contiguous axis
#pragma unroll
        for (int e = 0; e < kBM * kBK / kThreads; ++e) {
          const int idx = tid + kThreads * e;
          const int m = A.si == 1 ? idx % kBM : idx / kBK;
          const int k = A.si == 1 ? idx / kBM : idx % kBK;
          const int gm = m0 + m, gk = k0 + k;
          As[k][m] = gm < Ms && gk < Ks ? to_f(ap[gm * A.si + gk * A.sj]) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < kBN * kBK / kThreads; ++e) {
          const int idx = tid + kThreads * e;
          const int n = B.sj == 1 ? idx % kBN : idx / kBK;
          const int k = B.sj == 1 ? idx / kBN : idx % kBK;
          const int gn = n0 + n, gk = k0 + k;
          Bs[k][n] = gn < N && gk < Ks ? to_f(bp[gk * B.si + gn * B.sj]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  const size_t plane = static_cast<size_t>(gridDim.z) * Cm * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      if (EPI == 0) {
        if (m < Ms)
          out[s * bso + static_cast<long long>(m) * ldo + n] = from_f<OutT>(acc[i][j]);
        else if (m < m_zero)
          out[s * bso + static_cast<long long>(m) * ldo + n] = from_f<OutT>(0.f);
      } else if (m < Ms) {
        const size_t idx = (static_cast<size_t>(s) * Cm + m) * N + n;
        const float a = ab[idx], b = ab[plane + idx];
        const float sg = 1.f / (1.f + expf(-a));
        const float dmid = acc[i][j];
        g[idx] = from_f<T>(dmid * b * (sg * (1.f + a * (1.f - sg))));
        g[plane + idx] = from_f<T>(dmid * a * sg);
        g[2 * plane + idx] = from_f<T>(a / (1.f + expf(-a)) * b);
      }
    }
  }
}

// One product of the backward on the CUDA cores.
template <typename T, typename OutT, int NPAIR, int EPI>
cudaError_t product(int rows, int cols, int S, Operand<T> a0, Operand<T> b0,
                    Operand<T> a1, Operand<T> b1, const int* fill, int C,
                    int Cm, int M, int N, int K, int m_fill, int k_fill,
                    int m_zero, OutT* out, long long bso, int ldo,
                    const float* ab, T* g, cudaStream_t st) {
  const dim3 grid((cols + kBN - 1) / kBN, (rows + kBM - 1) / kBM, S);
  gemm<T, OutT, NPAIR, EPI><<<grid, kThreads, 0, st>>>(
      a0, b0, a1, b1, fill, C, Cm, M, N, K, m_fill, k_fill, m_zero, out, bso,
      ldo, ab, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const void* w1v, const void* w3v,
                   const void* w2v, const int* fill, const void* dyv,
                   float* ab, void* gv, void* dxv, void* dw1v, void* dw3v,
                   void* dw2v, int S, int C, int D, int F, int Cm,
                   cudaStream_t st) {
  using O = Operand<T>;
  const T* x = static_cast<const T*>(xv);
  const T* w1 = static_cast<const T*>(w1v);
  const T* w3 = static_cast<const T*>(w3v);
  const T* w2 = static_cast<const T*>(w2v);
  const T* dy = static_cast<const T*>(dyv);
  T* g = static_cast<T*>(gv);
  const long long CD = static_cast<long long>(C) * D;
  const long long DF = static_cast<long long>(D) * F;
  const long long mF = static_cast<long long>(Cm) * F;
  const long long plane = static_cast<long long>(S) * mF;
  const T* da = g;
  const T* db = g + plane;
  const T* mid = g + 2 * plane;
  const O none{x, 0, 0, 0};
  cudaError_t err;
  // a = x w1, b = x w3 (rows < n_s)
  for (int z = 0; z < 2; ++z) {
    err = product<T, float, 1, 0>(
        Cm, F, S, O{x, CD, D, 1}, O{z ? w3 : w1, DF, F, 1}, none, none, fill,
        C, Cm, Cm, F, D, 1, 0, 0, ab + z * plane, mF, F, nullptr, nullptr, st);
    if (err != cudaSuccess) return err;
  }
  // dmid = dy w2^T, then da, db, mid
  err = product<T, T, 1, 1>(
      Cm, F, S, O{dy, CD, D, 1}, O{w2, DF, 1, D}, none, none, fill, C, Cm, Cm,
      F, D, 1, 0, 0, nullptr, 0, 0, ab, g, st);
  if (err != cudaSuccess) return err;
  // dx = da w1^T + db w3^T, zero rows past the fill
  err = product<T, T, 2, 0>(
      C, D, S, O{da, mF, F, 1}, O{w1, DF, 1, F}, O{db, mF, F, 1},
      O{w3, DF, 1, F}, fill, C, Cm, C, D, F, 1, 0, C, static_cast<T*>(dxv), CD,
      D, nullptr, nullptr, st);
  if (err != cudaSuccess) return err;
  // dw1 = x^T da, dw3 = x^T db (reduction over the filled rows)
  for (int z = 0; z < 2; ++z) {
    err = product<T, T, 1, 0>(
        D, F, S, O{x, CD, 1, D}, O{z ? db : da, mF, F, 1}, none, none, fill, C,
        Cm, D, F, Cm, 0, 1, D, static_cast<T*>(z ? dw3v : dw1v), DF, F,
        nullptr, nullptr, st);
    if (err != cudaSuccess) return err;
  }
  // dw2 = mid^T dy
  return product<T, T, 1, 0>(
      F, D, S, O{mid, mF, 1, F}, O{dy, CD, D, 1}, none, none, fill, C, Cm, F,
      D, Cm, 0, 1, F, static_cast<T*>(dw2v), DF, D, nullptr, nullptr, st);
}

}  // namespace bwd


// ---------------------------------------------------------------------------
// Backward, bf16 on wgmma (D % 8 == F % 8 == 0)
// ---------------------------------------------------------------------------
//
// The same products, conventions and fill bounds as bwd::launch, as four
// kernels on one persistent tile loop (wg::run):
// * gmm_bwd_gate: a = x w1, b = x w3 and dmid = dy w2^T for a tile of 128
//   filled rows x 64 columns of F, three accumulators over the same
//   reduction axis D; the epilogue writes da, db and mid (bf16) straight
//   from registers, so a and b never reach device memory;
// * gmm_bwd_dx: dx = da w1^T + db w3^T, tiles of 128 rows x 128 columns of
//   D over both pairs (2F deep); the rows past the fill are written as
//   zeros by 16-byte stores, a few each pipeline step, so they share the
//   products' time;
// * gmm_bwd_dw13: dw1 = x^T da and dw3 = x^T db, tiles of 128 x 128 of
//   [D, F], two accumulators fed by each staged tile of x, summed over the
//   slot's filled rows only (an empty slot writes zero gradients);
// * gmm_bwd_dw2: dw2 = mid^T dy, tiles of 128 x 128 of [F, D].
// What bounds it on the H100: the operations, 16 D F flops per routed row
// against 989 TFLOP/s bf16 (at the EP train step's 4096 rows, D 4096,
// F 14336: 3.9 ms), while the weights read, the weight gradients written
// (6 D F bytes a slot) and dx's zero rows take about half that. So:
// * every product is an SS wgmma of 64-row warpgroup tiles read by the
//   tensor cores from 128-byte-swizzled tiles, each operand in its global
//   orientation (w1 / w3 as MN-major B of the gate and K-major B of dx, x,
//   da, db, mid and dy as MN-major operands of the weight gradients): the
//   transposes are wgmma's immediates, never a copy;
// * a block of two consumer warpgroups (64 output rows each) per SM walks
//   the kernel's output tiles with a stride of the grid; the 4-stage ring of
//   64-deep stages (cp.async, two stages ahead) runs on across tile
//   boundaries, so a tile's epilogue (stores from registers) overlaps the
//   next tile's copies, and one stage's products run while the next stage
//   is issued (wgmma_wait<1>);
// * the row-side kernels (gate, dx) enumerate only filled row tiles, row
//   tile fastest, so the blocks at work at one time share weight columns,
//   which L2 then serves; the weight-gradient kernels walk the [D, F] tiles
//   of one slot with the D tile fastest, sharing the slot's x (or mid) and
//   a few column tiles of da, db (or dy).
// Each output element is summed by one warpgroup in a fixed order along its
// reduction axis: no float atomics, and two runs give the same bits.

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kRows = 128;     // output rows of a tile: 64 a warpgroup
constexpr int kBK = 64;        // reduction depth of a stage
constexpr int kStages = 4;     // stages in the ring
constexpr int kAhead = kStages - 2;  // stages copied ahead of the products
constexpr int kAtom = 64 * 128;      // a 64-row tile of one 128-byte atom

__device__ __forceinline__ int slot_rows(const int* fill, int s, int C,
                                         int Cm) {
  return max(0, min(min(fill[s], C), Cm));
}

// ROWS x COLS elements from (r0, c0) of src (row stride ld) by 16-byte
// cp.async copies into a swizzled tile at dst (COLS / 64 atoms of ROWS x
// 128 bytes); zeros at rows >= rlim or columns >= clim
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const bf16* src,
                                          long long ld, int r0, int rlim,
                                          int c0, int clim) {
  constexpr int CH = COLS / 8;
  static_assert(ROWS * CH % kThreads == 0, "whole passes");
#pragma unroll
  for (int u = 0; u < ROWS * CH / kThreads; ++u) {
    const int i = threadIdx.x + kThreads * u;
    const int r = i / CH, ch = i % CH;
    const bool ok = r0 + r < rlim && c0 + ch * 8 < clim;
    mma::cp_async_16(dst + (ch >> 3) * (ROWS * 128) + mma::sw128(r, ch & 7),
                     src + (ok ? (r0 + r) * ld + c0 + ch * 8 : 0), ok);
  }
}

__device__ __forceinline__ uint64_t kmaj(uint32_t addr) {
  return mma::desc_sw128(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmaj(uint32_t addr) {
  return mma::desc_sw128(addr, kAtom, 1024);
}

// One output tile: slot s, rows m0.. and columns n0.. of the slot's output,
// and the slot's filled rows n.
struct Tile {
  int s, m0, n0, n;
};

// Row tiles of the filled rows x cols-wide column tiles, over every slot,
// row tile fastest. count() and at() read the fills.
struct RowTiles {
  const int* fill;
  int S, C, Cm, ct;  // ct column tiles of `cols` columns
  int cols;
  __device__ int count() const {
    int t = 0;
    for (int s = 0; s < S; ++s)
      t += (slot_rows(fill, s, C, Cm) + kRows - 1) / kRows * ct;
    return t;
  }
  __device__ Tile at(int t) const {
    for (int s = 0;; ++s) {
      const int n = slot_rows(fill, s, C, Cm);
      const int rt = (n + kRows - 1) / kRows;
      if (t < rt * ct) return Tile{s, (t % rt) * kRows, (t / rt) * cols, n};
      t -= rt * ct;
    }
  }
};

// The gate: g = {da, db, mid} [3, S, Cm, F] for the filled rows.
struct Gate {
  static constexpr int kCols = 64;  // columns of F a tile
  // x, dy (128 rows x 64 of D), w1, w3 (64 of D x 64 columns), w2 (64
  // columns x 64 of D)
  static constexpr int kStageBytes = 7 * kAtom;
  static constexpr int kAcc = 3 * 32;
  const bf16 *x, *dy, *w1, *w3, *w2;
  bf16* g;
  RowTiles tiles;
  int S, C, Cm, D, F;

  __device__ int count() const { return tiles.count(); }
  __device__ Tile at(int t) const { return tiles.at(t); }
  __device__ int depth(const Tile&) const { return (D + kBK - 1) / kBK; }
  __device__ void load(unsigned char* st, const Tile& t, int kt) const {
    const int k0 = kt * kBK;
    const long long xs = static_cast<long long>(t.s) * C * D;
    const long long ws = static_cast<long long>(t.s) * D * F;
    copy_tile<kRows, kBK>(st, x + xs, D, t.m0, t.n, k0, D);
    copy_tile<kRows, kBK>(st + 2 * kAtom, dy + xs, D, t.m0, t.n, k0, D);
    copy_tile<kBK, kCols>(st + 4 * kAtom, w1 + ws, F, k0, D, t.n0, F);
    copy_tile<kBK, kCols>(st + 5 * kAtom, w3 + ws, F, k0, D, t.n0, F);
    copy_tile<kCols, kBK>(st + 6 * kAtom, w2 + ws, D, t.n0, F, k0, D);
  }
  __device__ void multiply(uint32_t st, int kt, float* acc) const {
    const uint32_t wg = threadIdx.x >> 7;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int on = kt > 0 || kk > 0;
      const uint64_t ax = kmaj(st + wg * kAtom + kk * 32);
      mma::wgmma_m64k16_ss<64, 0, 1>(acc, ax,
                                     mnmaj(st + 4 * kAtom + kk * 2048), on);
      mma::wgmma_m64k16_ss<64, 0, 1>(acc + 32, ax,
                                     mnmaj(st + 5 * kAtom + kk * 2048), on);
      mma::wgmma_m64k16_ss<64, 0, 0>(
          acc + 64, kmaj(st + 2 * kAtom + wg * kAtom + kk * 32),
          kmaj(st + 6 * kAtom + kk * 32), on);
    }
  }
  // da = dmid b silu'(a), db = dmid silu(a), mid = silu(a) b, each rounded
  __device__ void epilogue(const Tile& t, const float* acc, int) const {
    const long long plane = static_cast<long long>(S) * Cm * F;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int row0 = t.m0 + (threadIdx.x >> 7) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = t.n0 + j * 8 + 2 * (lane & 3);
        if (row >= t.n || col >= F) continue;
        float o[3][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[4 * j + 2 * h + e];
          const float b = acc[32 + 4 * j + 2 * h + e];
          const float dm = acc[64 + 4 * j + 2 * h + e];
          const float sg = 1.f / (1.f + expf(-a));
          o[0][e] = dm * b * (sg * (1.f + a * (1.f - sg)));
          o[1][e] = dm * a * sg;
          o[2][e] = a / (1.f + expf(-a)) * b;
        }
        bf16* p = g + (static_cast<long long>(t.s) * Cm + row) * F + col;
#pragma unroll
        for (int z = 0; z < 3; ++z)
          *reinterpret_cast<uint32_t*>(p + z * plane) =
              mma::pack_bf16(o[z][0], o[z][1]);
      }
  }
};

// dx = da w1^T + db w3^T for the filled rows.
struct Dx {
  static constexpr int kCols = 128;  // columns of D a tile
  // da or db (128 rows x 64 of F), w1 or w3 (128 columns x 64 of F)
  static constexpr int kStageBytes = 4 * kAtom;
  static constexpr int kAcc = 64;
  const bf16 *g, *w1, *w3;
  bf16* dx;
  RowTiles tiles;
  int S, C, Cm, D, F;

  __device__ int count() const { return tiles.count(); }
  __device__ Tile at(int t) const { return tiles.at(t); }
  __device__ int depth(const Tile&) const {
    return 2 * ((F + kBK - 1) / kBK);
  }
  __device__ void load(unsigned char* st, const Tile& t, int kt) const {
    const int nkf = (F + kBK - 1) / kBK;
    const bool second = kt >= nkf;
    const int k0 = (second ? kt - nkf : kt) * kBK;
    const long long plane = static_cast<long long>(S) * Cm * F;
    copy_tile<kRows, kBK>(
        st, g + (second ? plane : 0) + static_cast<long long>(t.s) * Cm * F,
        F, t.m0, t.n, k0, F);
    copy_tile<kCols, kBK>(st + 2 * kAtom,
                          (second ? w3 : w1) +
                              static_cast<long long>(t.s) * D * F,
                          F, t.n0, D, k0, F);
  }
  __device__ void multiply(uint32_t st, int kt, float* acc) const {
    const uint32_t wg = threadIdx.x >> 7;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma::wgmma_m64k16_ss<kCols, 0, 0>(acc,
                                        kmaj(st + wg * kAtom + kk * 32),
                                        kmaj(st + 2 * kAtom + kk * 32),
                                        kt > 0 || kk > 0);
  }
  __device__ void epilogue(const Tile& t, const float* acc, int) const {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int row0 = t.m0 + (threadIdx.x >> 7) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = t.n0 + j * 8 + 2 * (lane & 3);
        if (row < t.n && col < D)
          *reinterpret_cast<uint32_t*>(
              dx + (static_cast<long long>(t.s) * C + row) * D + col) =
              mma::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
};

// out[i] = a^T b[i] over the filled rows, for NB operands b: a [S, rows, M]
// (slot stride a_slot, row stride M), b[i] [S, rows, N] (slot stride
// b_slot, row stride N), out[i] [S, M, N]; zero for an empty slot.
template <int NB>
struct WeightGrad {
  static constexpr int kCols = 128;  // columns of N a tile
  // a (64 rows x 128 of M), each b[i] (64 rows x 128 of N)
  static constexpr int kStageBytes = (1 + NB) * 2 * kAtom;
  static constexpr int kAcc = NB * 64;
  const bf16* a;
  const bf16* b[NB];
  bf16* out[NB];
  const int* fill;
  long long a_slot, b_slot;
  int S, C, Cm, M, N;

  __device__ int mt() const { return (M + kRows - 1) / kRows; }
  __device__ int nt() const { return (N + kCols - 1) / kCols; }
  __device__ int count() const { return S * mt() * nt(); }
  __device__ Tile at(int t) const {
    const int per = mt() * nt(), s = t / per, r = t % per;
    return Tile{s, (r % mt()) * kRows, (r / mt()) * kCols,
                slot_rows(fill, s, C, Cm)};
  }
  __device__ int depth(const Tile& t) const { return (t.n + kBK - 1) / kBK; }
  __device__ void load(unsigned char* st, const Tile& t, int kt) const {
    const int r0 = kt * kBK;
    copy_tile<kBK, kRows>(st, a + t.s * a_slot, M, r0, t.n, t.m0, M);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      copy_tile<kBK, kCols>(st + (1 + i) * 2 * kAtom, b[i] + t.s * b_slot, N,
                            r0, t.n, t.n0, N);
  }
  __device__ void multiply(uint32_t st, int kt, float* acc) const {
    const uint32_t wg = threadIdx.x >> 7;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = mnmaj(st + wg * kAtom + kk * 2048);
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int hb = 0; hb < kCols / 64; ++hb)
          mma::wgmma_m64k16_ss<64, 1, 1>(
              acc + 64 * i + 32 * hb, da,
              mnmaj(st + (1 + i) * 2 * kAtom + hb * kAtom + kk * 2048),
              kt > 0 || kk > 0);
    }
  }
  __device__ void epilogue(const Tile& t, const float* acc, int nk) const {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int row0 = t.m0 + (threadIdx.x >> 7) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          const int col = t.n0 + j * 8 + 2 * (lane & 3);
          const float* v = acc + 64 * i + 4 * j + 2 * h;
          if (row < M && col < N)
            *reinterpret_cast<uint32_t*>(
                out[i] + (static_cast<long long>(t.s) * M + row) * N + col) =
                nk > 0 ? mma::pack_bf16(v[0], v[1]) : 0u;
        }
  }
};

// No work beside the products.
struct Idle {
  __device__ void step() {}
  __device__ void finish() {}
};

// This block's share of the rows [n_s, C) of every slot of dx, in 16-byte
// units counted over the slots in order, written `per_step` at a time by
// each thread after a pipeline step and the rest at the end.
struct ZeroRows {
  uint4* dx;
  const int* fill;
  int C, Cm, D;
  long long u, end;     // this thread's next unit, the block's end
  int s;                // the slot of unit u ...
  long long s_lo, s_hi;  // ... whose units are [s_lo, s_hi)
  int per_step;

  __device__ long long units(int slot) const {
    return static_cast<long long>(C - slot_rows(fill, slot, C, Cm)) * (D / 8);
  }
  __device__ ZeroRows(bf16* y, const int* f, int S, int C_, int Cm_, int D_,
                      long long steps)
      : dx(reinterpret_cast<uint4*>(y)), fill(f), C(C_), Cm(Cm_), D(D_) {
    long long total = 0;
    for (int i = 0; i < S; ++i) total += units(i);
    const long long share = (total + gridDim.x - 1) / gridDim.x;
    const long long lo = min(total, blockIdx.x * share);
    end = min(total, lo + share);
    u = lo + threadIdx.x;
    s = 0;
    s_lo = 0;
    s_hi = units(0);
    const long long mine = (end - lo + kThreads - 1) / kThreads;
    per_step = steps > 0 ? static_cast<int>((mine + steps - 1) / steps) : 0;
  }
  __device__ void write(int k) {
    for (int q = 0; q < k && u < end; ++q, u += kThreads) {
      while (u >= s_hi) {
        ++s;
        s_lo = s_hi;
        s_hi += units(s);
      }
      const long long row0 = static_cast<long long>(s) * C +
                             slot_rows(fill, s, C, Cm);
      dx[row0 * (D / 8) + (u - s_lo)] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void step() { write(per_step); }
  __device__ void finish() { write(1 << 30); }
};

// The persistent tile loop: this block's tiles blockIdx.x, + gridDim.x, ...
// of p, each p.depth() stages deep; stages stream through the ring without
// a break at tile boundaries (tiles without stages are skipped by the
// copies); bg's step() runs after each stage, finish() at the end.
template <class P, class Bg>
__device__ __forceinline__ void run(const P& p, Bg& bg, unsigned char* ring,
                                    uint32_t base) {
  const int T = p.count();
  // the copy cursor: tile lt, stage lk of it
  int lt = blockIdx.x, lk = 0;
  Tile lti{};
  if (lt < T) lti = p.at(lt);
  auto settle = [&]() {
    while (lt < T && lk >= p.depth(lti)) {
      lt += gridDim.x;
      lk = 0;
      if (lt < T) lti = p.at(lt);
    }
  };
  settle();
  auto copy_next = [&](int stage) {
    if (lt < T) {
      p.load(ring + stage * P::kStageBytes, lti, lk);
      ++lk;
      settle();
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kAhead; ++st) copy_next(st);

  float acc[P::kAcc];
  int step = 0;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const Tile ti = p.at(t);
    const int nk = p.depth(ti);
    for (int kt = 0; kt < nk; ++kt, ++step) {
      mma::cp_async_wait<kAhead - 1>();
      mma::fence_proxy_async();
      __syncthreads();  // stage `step` landed; the products of step - 2 done
      copy_next((step + kAhead) % kStages);
      mma::wgmma_fence();
      p.multiply(base + (step % kStages) * P::kStageBytes, kt, acc);
      mma::wgmma_commit();
      mma::wgmma_wait<1>();  // the products of step - 1 are done
      bg.step();
    }
    mma::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < P::kAcc; ++i) mma::fence_operand(acc[i]);
    p.epilogue(ti, acc, nk);
  }
  mma::cp_async_wait<0>();
  bg.finish();
}

template <class P>
constexpr int smem_bytes() {
  return kStages * P::kStageBytes + 1024;  // + alignment to the swizzle atom
}

#define WG_RING                                                     \
  extern __shared__ __align__(16) unsigned char smem_raw[];        \
  const uint32_t raw = mma::smem_addr(smem_raw);                   \
  const uint32_t base = (raw + 1023u) & ~1023u;                    \
  unsigned char* ring = smem_raw + (base - raw);

__global__ void __launch_bounds__(kThreads, 1) gmm_bwd_gate(__grid_constant__ const Gate p) {
  WG_RING
  Idle bg;
  run(p, bg, ring, base);
}

__global__ void __launch_bounds__(kThreads, 1) gmm_bwd_dx(__grid_constant__ const Dx p) {
  WG_RING
  const int T = p.count();
  const long long tiles =
      static_cast<int>(blockIdx.x) < T
          ? (T - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
          : 0;
  ZeroRows bg(p.dx, p.tiles.fill, p.S, p.C, p.Cm, p.D,
              tiles * p.depth(Tile{}));
  run(p, bg, ring, base);
}

__global__ void __launch_bounds__(kThreads, 1)
    gmm_bwd_dw13(__grid_constant__ const WeightGrad<2> p) {
  WG_RING
  Idle bg;
  run(p, bg, ring, base);
}

__global__ void __launch_bounds__(kThreads, 1)
    gmm_bwd_dw2(__grid_constant__ const WeightGrad<1> p) {
  WG_RING
  Idle bg;
  run(p, bg, ring, base);
}
#undef WG_RING

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// raises the kernel's dynamic shared memory limit on its first launch
template <class K>
cudaError_t configure(K kernel, int smem, bool& configured) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

// The four launches. Grids: one block per SM (gate: at most one a row tile
// of max_fill rows x column tile; the weight gradients: at most one a
// tile), dx always one per SM (its zero rows need no tile).
cudaError_t launch(const bf16* x, const bf16* w1, const bf16* w3,
                   const bf16* w2, const int* fill, const bf16* dy, bf16* g,
                   bf16* dx, bf16* dw1, bf16* dw3, bf16* dw2, int S, int C,
                   int D, int F, int Cm, cudaStream_t st) {
  static bool configured[4] = {false, false, false, false};
  const int sms = sm_count();
  // one block per SM, fewer where the kernel has fewer tiles
  auto grid = [&](long long tiles) {
    return static_cast<int>(std::min<long long>(sms, tiles));
  };
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const long long plane = static_cast<long long>(S) * Cm * F;
  const long long CD = static_cast<long long>(C) * D;
  const long long mF = static_cast<long long>(Cm) * F;
  cudaError_t err;

  const Gate gate{x, dy, w1, w3, w2, g,
                  RowTiles{fill, S, C, Cm, cdiv(F, Gate::kCols), Gate::kCols},
                  S, C, Cm, D, F};
  const int smem_gate = smem_bytes<Gate>();
  if ((err = configure(gmm_bwd_gate, smem_gate, configured[0])) != cudaSuccess)
    return err;
  gmm_bwd_gate<<<grid(1LL * S * cdiv(Cm, kRows) * gate.tiles.ct), kThreads,
                 smem_gate, st>>>(gate);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const Dx dxp{g, w1, w3, dx,
               RowTiles{fill, S, C, Cm, cdiv(D, Dx::kCols), Dx::kCols},
               S, C, Cm, D, F};
  const int smem_dx = smem_bytes<Dx>();
  if ((err = configure(gmm_bwd_dx, smem_dx, configured[1])) != cudaSuccess)
    return err;
  gmm_bwd_dx<<<sms, kThreads, smem_dx, st>>>(dxp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using W13 = WeightGrad<2>;
  const W13 w13{x, {g, g + plane}, {dw1, dw3}, fill, CD, mF, S, C, Cm, D, F};
  const int smem13 = smem_bytes<W13>();
  if ((err = configure(gmm_bwd_dw13, smem13, configured[2])) != cudaSuccess)
    return err;
  gmm_bwd_dw13<<<grid(1LL * S * cdiv(D, kRows) * cdiv(F, W13::kCols)),
                 kThreads, smem13, st>>>(w13);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using W2 = WeightGrad<1>;
  const W2 w2p{g + 2 * plane, {dy}, {dw2}, fill, mF, CD, S, C, Cm, F, D};
  const int smem2 = smem_bytes<W2>();
  if ((err = configure(gmm_bwd_dw2, smem2, configured[3])) != cudaSuccess)
    return err;
  gmm_bwd_dw2<<<grid(1LL * S * cdiv(F, kRows) * cdiv(D, W2::kCols)), kThreads,
                smem2, st>>>(w2p);
  return cudaGetLastError();
}

}  // namespace wg


// ---------------------------------------------------------------------------
// bf16 at prefill and train fills: row-side wgmma tiles fed by TMA
// ---------------------------------------------------------------------------
//
// The forward's second tensor-core design (the host picks it from max_fill,
// see moe_gmm.py::select_design). Past about 300 rows a slot the forward is
// bound by the operations (6 D F flops a routed row against the weights'
// 6 D F bytes a slot), where gmm_tc's weight stream re-reads each weight
// column once per 128-row tile. Here:
// * rows on the M side: a tile is 128 filled rows of one slot (64 a
//   consumer warpgroup) x 256 accumulator columns, one m64n256k16 a 16-deep
//   step: pass 1 takes 128 columns of w1 and the same 128 of w3 side by side
//   (acc[0..63] = x w1, acc[64..127] = x w3 of the same columns), applies
//   silu(a) * b and the cast in registers and writes mid; pass 2 takes 256
//   columns of w2 and writes y. Each output element is summed by one
//   warpgroup in a fixed order over its whole reduction axis: no split-K,
//   no float atomics, two runs give the same bits;
// * TMA: one producer thread copies each 64-deep stage (128 rows x 64 of
//   x or mid, K-major A; four 64 x 64 boxes of the row-major [K, N] weights,
//   MN-major B, never transposed) in the 128-byte swizzle into a 4-stage
//   ring of 48 KB stages, with full / empty mbarriers; the consumers
//   (setmaxnreg 232) wait on "full", start wgmma and release a stage after
//   wgmma_wait<1>; the producer warpgroup keeps 40 registers a thread;
// * two blocks on neighbouring SMs form a cluster that takes two row tiles
//   of one column tile: each block copies its own rows and multicasts half
//   of the weight boxes into both blocks, so a tile draws 32 KB a stage
//   from L2, not 48 (at the tensor cores' peak a 128 x 256 tile alone
//   asks ~11.6 TB/s of L2; one block a tile drew 6.8-8.4 TB/s on the
//   H100 and held pass 1 to 58 % of the peak); a stage is free again once
//   both blocks' consumers release it (local and remote arrivals on the
//   "empty" barrier), and the producer waits for the last releases before
//   its block may exit;
// * persistent clusters, one block per SM, walk the pairs of filled row
//   tiles x column tiles of every slot, read on the device from the fills
//   (no host sync: the launch can be captured into a CUDA graph), in bands
//   of kBand column tiles: slot, band, row-tile pair, column tile fastest,
//   so the ~132 tiles at work at one time are ~16 row tiles x 8 column
//   tiles, whose rows and weight columns (16 MB each in pass 1) L2 serves
//   to all of them; the ring runs on across tiles, so a tile's epilogue
//   overlaps the next tile's loads;
// * the epilogue stages each warpgroup's 64 x 128 bf16 outputs in shared
//   memory (16-byte chunks swizzled by row) behind the warpgroup's own
//   named barrier and writes them as 16-byte rows, only rows below the
//   fill: rows past it (a tile that straddles the fill reads rows the
//   dispatcher never wrote) enter the products of their own output rows
//   only and are never stored;
// * the other three warps of the producer warpgroup write pass 1's share
//   of y's zero rows [n, C), 16 bytes a store, while the products run.

namespace rows {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kRows = 128;                  // rows of a tile, 64 a warpgroup
constexpr int kBK = 64;                     // reduction depth of a stage
constexpr int kStages = 4;                  // stages in the ring
constexpr int kBand = 8;                    // column tiles of a band
constexpr int kCluster = 2;  // blocks of a cluster: two row tiles, one
                             // column tile, the weight boxes multicast
static_assert(kCluster == 2, "the peer is rank ^ 1, the multicast mask 0b11");
constexpr int kATile = kRows * 128;         // the rows of a stage: 16 KB
constexpr int kAtom = kBK * 128;            // 64 k x 64 weight columns: 8 KB
constexpr int kStageBytes = kATile + 4 * kAtom;  // 48 KB
constexpr int kOut = 64 * 256;  // a warpgroup's 64 x 128 bf16 staging: 16 KB
// the ring, the two stagings, full and empty mbarriers, alignment
constexpr int kSmem = kStages * kStageBytes + 2 * kOut + 2 * kStages * 8 + 1024;
static_assert(kSmem <= 232448, "one block's shared memory");

struct Tile {
  int s, m0, n0, n;  // slot, first row, first column, the slot's filled rows
};

// Pairs of row tiles of the filled rows x column tiles of `cols` columns,
// over every slot in order; within a slot, bands of kBand column tiles,
// within a band row-tile pair then column tile (fastest). The block of
// cluster rank r takes row tile 2 p + r of pair p (past the fill when the
// slot's row tiles are odd: its products are then never stored).
struct Tiles {
  const int* fill;
  int S, C, Cm, ct, cols;
  __device__ int rows_of(int s) const {
    return max(0, min(min(fill[s], C), Cm));
  }
  __device__ static int pairs(int n) {
    return (n + kCluster * kRows - 1) / (kCluster * kRows);
  }
  __device__ int count() const {
    int t = 0;
    for (int s = 0; s < S; ++s) t += pairs(rows_of(s)) * ct;
    return t;
  }
  __device__ Tile at(int t, int rank) const {
    for (int s = 0;; ++s) {
      const int n = rows_of(s);
      const int rp = pairs(n);
      if (t < rp * ct) {
        const int b = t / (rp * kBand), rem = t - b * rp * kBand;
        const int bw = min(kBand, ct - b * kBand);
        return Tile{s, (rem / bw * kCluster + rank) * kRows,
                    (b * kBand + rem % bw) * cols, n};
      }
      t -= rp * ct;
    }
  }
};

struct Params {
  CUtensorMap act;  // x [S, C, D] (pass 1) or mid [S, Cm, F]: boxes 64 x 128
  CUtensorMap wa;   // w1 [S, D, F] or w2 [S, F, D]: boxes 64 x 64
  CUtensorMap wb;   // w3 (pass 1; pass 2 repeats wa)
  Tiles tiles;
  int K, N;         // reduction depth, output columns
  bf16* out;        // mid [S, Cm, F] or y [S, C, D]
  int out_rows;     // Cm or C
  bf16* zero_y;     // pass 1: y, whose rows [n, C) get zeros; else null
  int D;
};

template <bool GATED>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    gmm_rows(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the ring, 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kStages * kStageBytes + 2 * kOut;
  const int tid = threadIdx.x;
  const uint32_t rank = mma::cluster_ctarank(), peer = rank ^ 1;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mma::mbar_init(bars + 8 * i, 1);  // full: the producer, and 48 KB
      // empty: every consumer warp of both blocks (the peer's multicast
      // writes this block's stage too)
      mma::mbar_init(bars + 8 * (kStages + i), kCluster * kConsumers / 32);
    }
    mma::fence_barrier_init();
  }
  mma::cluster_sync();  // both blocks' barriers exist before either is used
  const int T = p.tiles.count();
  const int nk = (p.K + kBK - 1) / kBK;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (tid >= kConsumers) {
    // the producer warpgroup: warp 0 copies, warps 1-3 write zero rows
    mma::setmaxnreg_dec<40>();
    const int pt = tid - kConsumers;
    if (pt == 0) {
      mma::prefetch_tensormap(&p.act);
      mma::prefetch_tensormap(&p.wa);
      mma::prefetch_tensormap(&p.wb);
      int stage = 0;
      uint32_t phase = 0;
      auto advance = [&]() {
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int t = cluster; t < T; t += clusters) {
        const Tile ti = p.tiles.at(t, rank);
        for (int kt = 0; kt < nk; ++kt) {
          mma::mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
          const uint32_t full = bars + 8 * stage;
          mma::mbar_arrive_expect_tx(full, kStageBytes);
          const uint32_t st = base + stage * kStageBytes;
          const int k0 = kt * kBK;
          mma::tma_load_3d(st, &p.act, full, k0, ti.m0, ti.s);
          // this block's half of the weight boxes, into both blocks
#pragma unroll
          for (int q = 2 * rank; q < 2 * rank + 2; ++q)
            mma::tma_load_3d_multicast(
                st + kATile + q * kAtom, GATED && q >= 2 ? &p.wb : &p.wa,
                full, ti.n0 + 64 * (GATED ? q & 1 : q), k0, ti.s, 0b11);
          advance();
        }
      }
      // stay until both blocks' consumers have released every stage: the
      // peer's consumers arrive on this block's barriers
      for (int i = 0; i < kStages; ++i) {
        mma::mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
        advance();
      }
    } else if (GATED && pt >= 32) {
      // this block's share of the rows [n_s, C) of every slot of y, in
      // 16-byte units counted over the slots in order
      const int zt = pt - 32, zn = 96;
      const long long row_units = p.D / 8;
      auto units = [&](int s) {
        return (p.tiles.C - p.tiles.rows_of(s)) * row_units;
      };
      long long total = 0;
      for (int s = 0; s < p.tiles.S; ++s) total += units(s);
      const long long share = (total + gridDim.x - 1) / gridDim.x;
      const long long lo = min(total, blockIdx.x * share);
      const long long hi = min(total, lo + share);
      uint4* y = reinterpret_cast<uint4*>(p.zero_y);
      int s = 0;
      long long s_lo = 0, s_hi = units(0);
      for (long long u = lo + zt; u < hi; u += zn) {
        while (u >= s_hi) {
          ++s;
          s_lo = s_hi;
          s_hi += units(s);
        }
        const long long row0 =
            static_cast<long long>(s) * p.tiles.C + p.tiles.rows_of(s);
        y[row0 * row_units + (u - s_lo)] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    // the consumers: warpgroup wg owns rows 64 wg.. of each tile
    mma::setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    unsigned char* stg = smem + kStages * kStageBytes + wg * kOut;
    float acc[128];
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    auto release = [&](int s) {
      if (lane == 0) {
        mma::mbar_arrive(bars + 8 * (kStages + s));
        mma::mbar_arrive_cluster(bars + 8 * (kStages + s), peer);
      }
    };
    for (int t = cluster; t < T; t += clusters) {
      const Tile ti = p.tiles.at(t, rank);
      for (int kt = 0; kt < nk; ++kt) {
        mma::mbar_wait(bars + 8 * stage, phase);
        const uint32_t st = base + stage * kStageBytes;
        mma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          mma::wgmma_m64k16_ss<256, 0, 1>(
              acc, mma::desc_sw128(st + wg * (kATile / 2) + kk * 32, 16, 1024),
              mma::desc_sw128(st + kATile + kk * 2048, kAtom, 1024),
              kt > 0 || kk > 0);
        mma::wgmma_commit();
        mma::wgmma_wait<1>();  // the products of the previous stage are done
        if (kt > 0) release(prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mma::wgmma_wait<0>();
      release(prev);
#pragma unroll
      for (int i = 0; i < 128; ++i) mma::fence_operand(acc[i]);

      // acc[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h of the
      // warpgroup's 64, column 8 j + 2 (lane % 4) + e
#pragma unroll
      for (int q = 0; q < (GATED ? 1 : 2); ++q) {
        mma::named_barrier_sync(1 + wg, 128);  // the staging's reads are done
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + (lane >> 2) + 8 * h;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if constexpr (GATED) {
                const float a = acc[4 * j + 2 * h + e];
                const float b = acc[64 + 4 * j + 2 * h + e];
                // silu(a) * b; the approximate exp and division (a few
                // ulp of fp32, under the bf16 cast) keep the consumers'
                // time between tiles short
                v[e] = __fdividef(a, 1.f + __expf(-a)) * b;
              } else {
                v[e] = acc[4 * (16 * q + j) + 2 * h + e];
              }
            }
            *reinterpret_cast<uint32_t*>(stg + row * 256 +
                                         ((j ^ (row & 7)) << 4) +
                                         4 * (lane & 3)) =
                mma::pack_bf16(v[0], v[1]);
          }
        mma::named_barrier_sync(1 + wg, 128);  // the staging is written
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = (tid & 127) + 128 * u, r = i >> 4, ch = i & 15;
          const int row = ti.m0 + 64 * wg + r;
          const int col = ti.n0 + 128 * q + 8 * ch;
          if (row < ti.n && col < p.N)
            *reinterpret_cast<uint4*>(
                p.out + (static_cast<long long>(ti.s) * p.out_rows + row) *
                            p.N +
                col) =
                *reinterpret_cast<const uint4*>(stg + r * 256 +
                                                ((ch ^ (r & 7)) << 4));
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the CUDA driver API through the runtime
// (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The map of a bf16 [outer, rows, inner] tensor (contiguous) read in boxes
// of 64 inner elements (128 bytes, swizzled) x box_rows rows of one outer
// index; out-of-range elements read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int outer, int rows,
            int inner, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(rows) * inner * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both passes. Grids: one block per SM, fewer where a pass has fewer tiles
// at max_fill rows a slot (at least one: pass 1 writes the zero rows). A
// tensor map that cannot be made returns cudaErrorNotSupported.
cudaError_t launch(const bf16* x, const bf16* w1, const bf16* w3,
                   const bf16* w2, const int* fill, bf16* mid, bf16* y, int S,
                   int C, int D, int F, int Cm, cudaStream_t st) {
  static bool configured[2] = {false, false};
  cudaError_t err;
  if ((err = wg::configure(gmm_rows<true>, kSmem, configured[0])) !=
          cudaSuccess ||
      (err = wg::configure(gmm_rows<false>, kSmem, configured[1])) !=
          cudaSuccess)
    return err;
  const int sms = wg::sm_count();
  const long long pairs =
      1LL * S * ((Cm + kCluster * kRows - 1) / (kCluster * kRows));
  auto grid = [&](int ct) {
    return kCluster * static_cast<int>(std::max<long long>(
                          1, std::min<long long>(sms / kCluster, pairs * ct)));
  };

  Params up{};
  if (!encode(&up.act, x, S, C, D, kRows) ||
      !encode(&up.wa, w1, S, D, F, kBK) || !encode(&up.wb, w3, S, D, F, kBK))
    return cudaErrorNotSupported;
  const int ct_up = (F + 127) / 128;
  up.tiles = Tiles{fill, S, C, Cm, ct_up, 128};
  up.K = D;
  up.N = F;
  up.out = mid;
  up.out_rows = Cm;
  up.zero_y = y;
  up.D = D;
  gmm_rows<true><<<grid(ct_up), kThreads, kSmem, st>>>(up);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  Params down{};
  if (!encode(&down.act, mid, S, Cm, F, kRows) ||
      !encode(&down.wa, w2, S, F, D, kBK))
    return cudaErrorNotSupported;
  down.wb = down.wa;
  const int ct_down = (D + 255) / 256;
  down.tiles = Tiles{fill, S, C, Cm, ct_down, 256};
  down.K = F;
  down.N = D;
  down.out = y;
  down.out_rows = C;
  down.zero_y = nullptr;
  down.D = D;
  gmm_rows<false><<<grid(ct_down), kThreads, kSmem, st>>>(down);
  return cudaGetLastError();
}

}  // namespace rows

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = CUDA cores (gmm_up /
// gmm_down), 1 = tensor cores, the weight stream (gmm_tc: bf16, D % 8 ==
// F % 8 == 0, 16-byte aligned pointers; nt = 1, 2, 4, 8 or 16 n-tiles of 8
// rows, ks_up / ks_down the split-K factors of the two passes, part the
// fp32 scratch of [max(ks_up * 2F, ks_down * D) * S * Cm] floats when
// either is above 1, else unused), 2 = tensor cores, the row tiles
// (gmm_rows: the same types, widths and alignment; nt, ks_up, ks_down and
// part unused). x [S, C, D], w1/w3 [S, D, F], w2 [S, F, D], fill [S]
// int32, mid [S, Cm, F] scratch, y [S, C, D], all contiguous on the device.
// Rows r >= min(fill[s], Cm) of y[s] are zero. Returns the CUDA error code
// of the launches (0 = success).
extern "C" int moe_gmm_launch(int dtype, int variant, const void* x,
                              const void* w1, const void* w3, const void* w2,
                              const void* fill, void* mid, void* part, void* y,
                              int S, int C, int D, int F, int Cm, int nt,
                              int ks_up, int ks_down, void* stream) {
  if (S <= 0 || C <= 0 || D <= 0 || F <= 0 || Cm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(fill);
  if (variant == 2) {
    using B = __nv_bfloat16;
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || Cm > C)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(rows::launch(
        static_cast<const B*>(x), static_cast<const B*>(w1),
        static_cast<const B*>(w3), static_cast<const B*>(w2), fl,
        static_cast<B*>(mid), static_cast<B*>(y), S, C, D, F, Cm, st));
  }
  if (variant == 1) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || ks_up < 1 || ks_down < 1 ||
        ks_up > 65535 || ks_down > 65535 || Cm > 65535 ||
        ((ks_up > 1 || ks_down > 1) && part == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    float* pf = static_cast<float*>(part);
    switch (nt) {
      case 1: return static_cast<int>(tc::launch<1>(x, w1, w3, w2, fl, mid, pf, y, S, C, D, F, Cm, ks_up, ks_down, st));
      case 2: return static_cast<int>(tc::launch<2>(x, w1, w3, w2, fl, mid, pf, y, S, C, D, F, Cm, ks_up, ks_down, st));
      case 4: return static_cast<int>(tc::launch<4>(x, w1, w3, w2, fl, mid, pf, y, S, C, D, F, Cm, ks_up, ks_down, st));
      case 8: return static_cast<int>(tc::launch<8>(x, w1, w3, w2, fl, mid, pf, y, S, C, D, F, Cm, ks_up, ks_down, st));
      case 16: return static_cast<int>(tc::launch<16>(x, w1, w3, w2, fl, mid, pf, y, S, C, D, F, Cm, ks_up, ks_down, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
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

// The backward: dtype as above; variant 0 = CUDA cores (bwd::gemm), 1 =
// tensor cores (the wg:: kernels: bf16, D % 8 == F % 8 == 0, 16-byte
// aligned pointers); x [S, C, D], w1/w3 [S, D, F], w2 [S, F, D],
// fill [S] int32, dy [S, C, D], the scratch g [3, S, Cm, F] in x's type and,
// for variant 0 only (1 ignores it: null is fine), ab fp32 [2, S, Cm, F];
// writes dx [S, C, D] (zero rows past min(fill[s], Cm)), dw1/dw3 [S, D, F]
// and dw2 [S, F, D], all contiguous on the device. Returns the CUDA error
// code of the launches (0 = success).
extern "C" int moe_gmm_bwd_launch(int dtype, int variant, const void* x,
                                  const void* w1,
                                  const void* w3, const void* w2,
                                  const void* fill, const void* dy, void* ab,
                                  void* g, void* dx, void* dw1, void* dw3,
                                  void* dw2, int S, int C, int D, int F,
                                  int Cm, void* stream) {
  if (S <= 0 || C <= 0 || D <= 0 || F <= 0 || Cm <= 0 || Cm > C ||
      S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(fill);
  float* abf = static_cast<float*>(ab);
  using B = __nv_bfloat16;
  cudaError_t err;
  if (variant == 1) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = wg::launch(static_cast<const B*>(x), static_cast<const B*>(w1),
                     static_cast<const B*>(w3), static_cast<const B*>(w2), fl,
                     static_cast<const B*>(dy), static_cast<B*>(g),
                     static_cast<B*>(dx), static_cast<B*>(dw1),
                     static_cast<B*>(dw3), static_cast<B*>(dw2), S, C, D, F,
                     Cm, st);
  } else if (variant != 0 || abf == nullptr) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 0) {
    err = bwd::launch<float>(x, w1, w3, w2, fl, dy, abf, g, dx, dw1, dw3, dw2,
                             S, C, D, F, Cm, st);
  } else if (dtype == 1) {
    err = bwd::launch<B>(x, w1, w3, w2, fl, dy, abf, g, dx, dw1, dw3, dw2, S,
                         C, D, F, Cm, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
