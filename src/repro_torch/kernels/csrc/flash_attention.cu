// Causal / sliding-window flash attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (one-pass online
// softmax, key window (q - window, q], scale hd^-0.5, masked score -1e30,
// denominator clamped at 1e-30, fp32 running max / denominator /
// accumulator, fully masked KV blocks skipped) together with the GQA repeat
// of its wrapper (src/repro/kernels/ops.py::flash_attention).
//
// What bounds it on the H100: 4 * hd flops per unmasked (query, key) pair
// per head against one read of q, k, v. At serving prefill shapes (hd = 128,
// a few hundred tokens) that is a few microseconds of either, so the kernel
// is bound by latency; at a few thousand tokens by the tensor cores.
//
// Two variants, chosen by the wrapper (flash_attention.py::select_variant):
//
// bf16 with hd a multiple of 16 up to 128, on the tensor cores (FA2-style):
// * A block of 4 warps covers 64 query rows of one (batch, q head); each warp
//   owns 16 rows and keeps their Q fragments in registers for the whole key
//   loop. Blocks of the q heads of one KV head read the same K/V tiles, which
//   L2 serves after the first read (K and V of one KV head at 2048 tokens are
//   1 MB), so a block per q head costs no extra device-memory bytes and keeps
//   the grid at B * H * ceil(T / 64) blocks.
// * K/V tiles of 64 keys stay bf16 in shared memory, arriving by 16-byte
//   cp.async copies into a 2-stage ring (the next tile loads while this one
//   is used).
// * hd = 64 or 128 (flash_fwd_wg): S = Q K^T and O += P V on wgmma, B read
//   by the tensor cores straight from 128-byte-swizzled tiles, A (Q, then P)
//   from registers. Other hd (flash_fwd_tc): mma.sync.m16n8k16, K through
//   ldmatrix and V through ldmatrix.trans from rows padded by 16 bytes (no
//   bank conflicts). wgmma where it can: with 16 rows a warp, mma.sync
//   needs one ldmatrix per two products, and that traffic, not the tensor
//   cores, sets its pace at a few thousand keys.
// * The online softmax stays in registers: row max and sum across the 4
//   lanes of a row by shuffles, exp2 with the scale folded into one FMA, the
//   rescale of O skipped when no row's max moved. P is rounded to bf16 and
//   reused from the score accumulator layout as the A operand of P V.
// * Tiles outside the causal frontier or the window are never loaded (per
//   block) nor multiplied (per warp with mma.sync); only tiles on an edge
//   are masked. Keys past Tk are zero-filled by the copy and get
//   probability 0; query rows past Tq are never stored, so any T works.
//
// flash_fwd (fp32, and bf16 with other head sizes): on the CUDA cores. fp32
// must agree with the plain version to 1e-4, which TF32 would not.
// * One block per (batch * head, 16-query tile); its 4 warps own 4 query
//   rows each. Keys go through shared memory (as fp32) in tiles of 32, one
//   key per lane: a lane scores its key against the query row, the warp
//   reduces max and sum with shuffles, and the p @ v update broadcasts each
//   lane's probability to the lanes that own the head dims.
//
// Both read KV head h / (H / KVH) in place (the repeated KV the TPU wrapper
// builds never exists) and round p to the value type before p @ v, as the
// TPU kernel does. On request every forward variant also writes each row's
// log-sum-exp, which the backward kernels (the Pallas kernel has none; see
// the three Backward sections below: CUDA cores, mma.sync, wgmma) read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA cores (fp32, and bf16 with other head sizes)
// ---------------------------------------------------------------------------

constexpr int kBQ = 16;      // query rows per block
constexpr int kBK = 32;      // keys per tile: one per lane
constexpr int kWarps = 4;    // each warp owns kBQ / kWarps query rows
constexpr int kRows = kBQ / kWarps;
constexpr int kMaxHd = 128;
constexpr int kDims = kMaxHd / 32;   // head dims per lane
constexpr float kNegInf = -1e30f;

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

// the log-sum-exp of a row's scaled scores from its running max m and
// denominator l (natural units); +inf for a row that saw no key, so that the
// backward's exp(s - lse) gives it probability 0, as its output is 0
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q [B, Tq, H, hd], k/v [B, Tk, KVH, hd], o [B, Tq, H, hd].
// Grid (ceil(Tq / kBQ), B * H), block kWarps * 32.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int Tq, int Tk, int H, int KVH, int hd,
              int causal, int window, float scale) {
  __shared__ float qs[kBQ][kMaxHd];
  __shared__ float ks[kBK][kMaxHd + 1];
  __shared__ float vs[kBK][kMaxHd];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kBQ * hd; i += kWarps * 32) {
    const int r = i / hd, d = i % hd;
    const int qp = q0 + r;
    qs[r][d] = qp < Tq ? to_f(q[(((size_t)b * Tq + qp) * H + h) * hd + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }

  // keys any row of this tile may see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  for (int t0 = (k_lo / kBK) * kBK; t0 < k_hi; t0 += kBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBK * hd; i += kWarps * 32) {
      const int j = i / hd, d = i % hd;
      const int kp = t0 + j;
      const size_t off = (((size_t)b * Tk + kp) * KVH + kvh) * hd + d;
      ks[j][d] = kp < Tk ? to_f(k[off]) : 0.f;
      vs[j][d] = kp < Tk ? to_f(v[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      const int qp = q0 + r;
      if (qp >= Tq) continue;  // warp-uniform
      const int kp = t0 + lane;
      float sc = 0.f;
      for (int d = 0; d < hd; ++d) sc = fmaf(qs[r][d], ks[lane][d], sc);
      sc *= scale;
      bool ok = true;
      if (causal) ok = ok && kp <= qp;
      if (window) ok = ok && kp > qp - window;
      if (!ok) sc = kNegInf;
      const float m_new = fmaxf(m[i], warp_max(kp < Tk ? sc : kNegInf));
      const float p = kp < Tk ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      const float pr = to_f(from_f<T>(p));
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[i][c] = fmaf(pj, vs[j][d], acc[i][c]);
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + warp * kRows + i;
    if (qp >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Tq + qp] = row_lse(m[i], l[i]);
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int d = lane + 32 * c;
      if (d < hd)
        o[(((size_t)b * Tq + qp) * H + h) * hd + d] = from_f<T>(acc[i][c] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcWarps;  // query rows per block
constexpr int kTcBK = 64;             // keys per tile
constexpr int kTcStages = 2;          // K/V tiles in the shared-memory ring
constexpr int kTcNS = kTcBK / 8;      // n-tiles of 8 keys in a score tile
constexpr int kSmemPerSm = 232448;    // an SM's shared memory for blocks

// 2^x on the special function unit (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// What a warp of a tensor-core kernel knows about its 16 query rows and the
// softmax state of this lane's two of them (rows g and g + 8): the running
// max in the log2 domain and the lane's share of the denominators.
struct Rows {
  int wq0, wq1;  // the warp's first and last row
  int qr0, qr1;  // this lane's rows
  float m0, m1, l0, l1;
  __device__ Rows(int q0, int Tq) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    wq0 = q0 + warp * 16;
    wq1 = min(wq0 + 15, Tq - 1);
    qr0 = wq0 + g;
    qr1 = qr0 + 8;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
  }
};

// The Q fragments (mma A operand) of this lane's rows, read once from device
// memory and kept in registers for the whole key loop; rows past Tq are 0.
template <int HD>
__device__ __forceinline__ void load_q(const __nv_bfloat16* qb, size_t q_row,
                                       const Rows& r, int Tq,
                                       uint32_t qf[HD / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = kk * 16;
    qf[kk][0] = r.qr0 < Tq ? ld_u32(qb + r.qr0 * q_row + d) : 0u;
    qf[kk][1] = r.qr1 < Tq ? ld_u32(qb + r.qr1 * q_row + d) : 0u;
    qf[kk][2] = r.qr0 < Tq ? ld_u32(qb + r.qr0 * q_row + d + 8) : 0u;
    qf[kk][3] = r.qr1 < Tq ? ld_u32(qb + r.qr1 * q_row + d + 8) : 0u;
  }
}

// One key tile of the online softmax, in place. s holds this lane's raw
// scores q.k of kTcNS n-tiles of 8 keys from t0 (the mma accumulator
// layout: s[4j..4j+1] row qr0, s[4j+2..4j+3] row qr1). Masks only a tile on
// an edge (causal frontier, window, Tk): a masked score is -1e30 after
// scaling, a key past Tk gets probability 0. Updates the running max and
// denominators and leaves the probabilities in s. Returns whether some
// row's max moved in this warp, with the accumulator's rescale factors.
__device__ __forceinline__ bool softmax_tile(float* s, Rows& r, int t0,
                                             int Tk, int causal, int window,
                                             float scale_log2, float& corr0,
                                             float& corr1) {
  const int c = threadIdx.x & 3;
  float sl = scale_log2;  // raw scores are scaled inside the exp's FMA
  const bool edge = (causal && t0 + kTcBK - 1 > r.wq0) ||
                    (window && t0 <= r.wq1 - window) || t0 + kTcBK > Tk;
  if (edge) {
#pragma unroll
    for (int j = 0; j < kTcNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + j * 8 + 2 * c + (e & 1);
        const int qp = e < 2 ? r.qr0 : r.qr1;
        float x = s[4 * j + e] * scale_log2;
        if (kp >= Tk)
          x = -INFINITY;
        else if ((causal && kp > qp) || (window && kp <= qp - window))
          x = kNegInf;
        s[4 * j + e] = x;
      }
    sl = 1.f;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTcNS; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  mx0 = fmaxf(r.m0, mx0 * sl);  // sl > 0: the max of the scaled scores
  mx1 = fmaxf(r.m1, mx1 * sl);
  corr0 = ex2(r.m0 - mx0);
  corr1 = ex2(r.m1 - mx1);
  r.m0 = mx0;
  r.m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kTcNS; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], sl, -mx0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl, -mx0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl, -mx1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl, -mx1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  r.l0 = r.l0 * corr0 + rs0;
  r.l1 = r.l1 * corr1 + rs1;
  return __any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f);
}

// the accumulator (NO n-tiles of head dims) times the rows' factors
template <int NO>
__device__ __forceinline__ void rescale(float* o, float corr0, float corr1) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[4 * n] *= corr0;
    o[4 * n + 1] *= corr0;
    o[4 * n + 2] *= corr1;
    o[4 * n + 3] *= corr1;
  }
}

// the probabilities, rounded to bf16, as the mma A fragments of P (one per
// 16 keys): n-tiles 2kk and 2kk + 1 of the score accumulator
__device__ __forceinline__ void pack_p(const float* s,
                                       uint32_t pa[kTcBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = mma::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// o / max(l, 1e-30) of this lane's rows, bf16, to ob (row stride q_row);
// with lse_rows (the [Tq] statistics of this batch and head) also each
// row's log-sum-exp
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, size_t q_row,
                                           const float* o, Rows& r, int Tq,
                                           float* lse_rows) {
#pragma unroll
  for (int i = 1; i <= 2; i <<= 1) {
    r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, i);
    r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, i);
  }
  if (lse_rows != nullptr && (threadIdx.x & 3) == 0) {
    // the running max is in log2 units: lse = ln 2 * (m + log2 l)
    constexpr float kLn2 = 0.6931471805599453f;
    if (r.qr0 < Tq)
      lse_rows[r.qr0] = r.l0 > 0.f ? kLn2 * (r.m0 + log2f(r.l0)) : INFINITY;
    if (r.qr1 < Tq)
      lse_rows[r.qr1] = r.l1 > 0.f ? kLn2 * (r.m1 + log2f(r.l1)) : INFINITY;
  }
  const float inv0 = 1.f / fmaxf(r.l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(r.l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (r.qr0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r.qr0 * q_row + n * 8) =
          mma::pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (r.qr1 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r.qr1 * q_row + n * 8) =
          mma::pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

// The key tiles a block of 64 query rows from q0 may see, from the causal
// frontier and the window: tiles t_first .. t_first + n_tiles - 1.
__device__ __forceinline__ void key_tiles(int q0, int Tq, int Tk, int causal,
                                          int window, int& t_first,
                                          int& n_tiles) {
  const int q_last = min(q0 + kTcBQ, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  t_first = k_lo / kTcBK;
  n_tiles =
      k_hi > t_first * kTcBK ? (k_hi - t_first * kTcBK + kTcBK - 1) / kTcBK : 0;
}

// blocks per SM that a block's shared memory allows, at most 3 (which caps
// the registers at 168 a thread)
constexpr int min_blocks(int smem) {
  return kSmemPerSm / smem < 3 ? kSmemPerSm / smem : 3;
}

// mma.sync kernel, any hd a multiple of 16 (used for those not a multiple
// of 64): K/V rows padded by 16 bytes for conflict-free ldmatrix.
template <int HD>
constexpr int tc_smem_bytes() {
  return 2 /*K, V*/ * kTcStages * kTcBK * (HD + 8) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// q [B, Tq, H, HD], k/v [B, Tk, KVH, HD], o [B, Tq, H, HD], bf16.
// Grid (ceil(Tq / 64), B * H), block 128, dynamic shared memory
// tc_smem_bytes<HD>(). scale_log2 = hd^-0.5 * log2(e).
template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32,
                                  min_blocks(tc_smem_bytes<HD>()))
    flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int H, int KVH, int causal, int window,
                 float scale_log2) {
  constexpr int kStride = HD + 8;  // padded shared-memory row, elements
  constexpr int KS = HD / 16;      // k-steps of Q K^T
  constexpr int NO = HD / 8;       // n-tiles of O
  constexpr int CH = HD / 8;       // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTcStages * kTcBK * kStride;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  // the longest causal rows first: the last q tiles have the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int lane = threadIdx.x & 31;
  Rows r(q0, Tq);
  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t q_off = static_cast<size_t>(b) * Tq * q_row +
                       static_cast<size_t>(h) * HD + 2 * (lane & 3);
  uint32_t qf[KS][4];
  load_q<HD>(q + q_off, q_row, r, Tq, qf);
  int t_first, n_tiles;
  key_tiles(q0, Tq, Tk, causal, window, t_first, n_tiles);

  auto load_tile = [&](int stage, int t0) {
    __nv_bfloat16* kd = ks + stage * kTcBK * kStride;
    __nv_bfloat16* vd = vs + stage * kTcBK * kStride;
    for (int i = threadIdx.x; i < kTcBK * CH; i += kTcWarps * 32) {
      const int j = i / CH, ch = i % CH;
      const int kp = t0 + j;
      const bool ok = kp < Tk;
      const size_t off =
          ((static_cast<size_t>(b) * Tk + (ok ? kp : 0)) * KVH + kvh) * HD +
          ch * 8;
      mma::cp_async_16(kd + j * kStride + ch * 8, k + off, ok);
      mma::cp_async_16(vd + j * kStride + ch * 8, v + off, ok);
    }
  };

  float oacc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, (t_first + st) * kTcBK);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_first + it) * kTcBK;
    mma::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    const int nxt = it + kTcStages - 1;
    if (nxt < n_tiles) load_tile(nxt % kTcStages, (t_first + nxt) * kTcBK);
    mma::cp_async_commit();

    bool live = r.wq0 < Tq;
    if (causal) live = live && t0 <= r.wq1;
    if (window) live = live && t0 + kTcBK - 1 > r.wq0 - window;
    if (!live) continue;  // warp-uniform: every key of the tile is masked
    const __nv_bfloat16* kt = ks + (it % kTcStages) * kTcBK * kStride;
    const __nv_bfloat16* vt = vs + (it % kTcStages) * kTcBK * kStride;
    float s[kTcNS * 4];
#pragma unroll
    for (int i = 0; i < kTcNS * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < kTcNS / 2; ++np) {
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      kStride +
                                  kk * 16 + (((lane >> 3) & 1) << 3));
        mma::mma_bf16(s + 8 * np, qf[kk], bk[0], bk[1]);
        mma::mma_bf16(s + 8 * np + 4, qf[kk], bk[2], bk[3]);
      }
    float corr0, corr1;
    if (softmax_tile(s, r, t0, Tk, causal, window, scale_log2, corr0, corr1))
      rescale<NO>(oacc, corr0, corr1);
    uint32_t pa[kTcBK / 16][4];
    pack_p(s, pa);
    // O += P V, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(
            bv, vt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                         kStride +
                    np * 16 + ((lane >> 4) << 3));
        mma::mma_bf16(oacc + 8 * np, pa[kk], bv[0], bv[1]);
        mma::mma_bf16(oacc + 8 * np + 4, pa[kk], bv[2], bv[3]);
      }
  }
  store_rows<NO>(o + q_off, q_row, oacc, r, Tq,
                 lse != nullptr ? lse + static_cast<size_t>(bh) * Tq : nullptr);
}

// wgmma kernel, hd = 64 or 128: one warpgroup per block, B read by the
// tensor cores straight from shared memory (no ldmatrix), A (Q, then P)
// from registers. K and V tiles sit in the 128-byte swizzle (mma.cuh):
// 64-dim column blocks of one 128-byte row per key. Every warp takes part
// in every tile (wgmma is collective), so the causal and window skip is per
// block.
template <int HD>
constexpr int wg_smem_bytes() {
  return 2 * kTcStages * kTcBK * HD * static_cast<int>(sizeof(__nv_bfloat16)) +
         1024;  // + slack to align the ring to the 1024-byte swizzle atom
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32,
                                  min_blocks(wg_smem_bytes<HD>()))
    flash_fwd_wg(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int H, int KVH, int causal, int window,
                 float scale_log2) {
  static_assert(HD % 64 == 0 && kTcBK == 64, "128-byte swizzle atoms");
  constexpr int KS = HD / 16;                // k-steps of Q K^T
  constexpr int NO = HD / 8;                 // n-tiles of O
  constexpr int CH = HD / 8;                 // 16-byte chunks per K/V row
  constexpr int kBlk = kTcBK * 128;          // bytes of one 64-dim block
  constexpr int kTile = (HD / 64) * kBlk;    // bytes of one K or V tile
  constexpr int kRowStep = kTcWarps * 32 / CH;  // rows one pass copies
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // shared address of the ring
  unsigned char* ring = smem_raw + (base - raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  Rows r(q0, Tq);
  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t q_off = static_cast<size_t>(b) * Tq * q_row +
                       static_cast<size_t>(h) * HD + 2 * (threadIdx.x & 3);
  uint32_t qf[KS][4];
  load_q<HD>(q + q_off, q_row, r, Tq, qf);
  int t_first, n_tiles;
  key_tiles(q0, Tq, Tk, causal, window, t_first, n_tiles);

  // this thread copies chunk ch of rows row0 + kRowStep * u of each tile
  const int ch = threadIdx.x % CH, row0 = threadIdx.x / CH;
  const size_t kv_row = static_cast<size_t>(KVH) * HD;
  const size_t kv0 = (static_cast<size_t>(b) * Tk * KVH + kvh) * HD + ch * 8;
  const uint32_t dst0 = (ch >> 3) * kBlk + mma::sw128(row0, ch & 7);
  auto load_tile = [&](int stage, int t0) {
    unsigned char* kd = ring + stage * 2 * kTile + dst0;
#pragma unroll
    for (int u = 0; u < kTcBK / kRowStep; ++u) {
      const int kp = t0 + row0 + kRowStep * u;
      const bool ok = kp < Tk;
      const size_t off = kv0 + (ok ? kp : 0) * kv_row;
      mma::cp_async_16(kd + kRowStep * u * 128, k + off, ok);
      mma::cp_async_16(kd + kTile + kRowStep * u * 128, v + off, ok);
    }
  };

  float oacc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, (t_first + st) * kTcBK);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_first + it) * kTcBK;
    mma::cp_async_wait<kTcStages - 2>();
    mma::fence_proxy_async();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    const int nxt = it + kTcStages - 1;
    if (nxt < n_tiles) load_tile(nxt % kTcStages, (t_first + nxt) * kTcBK);
    mma::cp_async_commit();

    const uint32_t kt = base + (it % kTcStages) * 2 * kTile;
    const uint32_t vt = kt + kTile;
    float s[kTcNS * 4];
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma::wgmma_m64n64k16<0>(
          s, qf[kk],
          mma::desc_sw128(kt + (kk >> 2) * kBlk + (kk & 3) * 32, 16, 1024),
          kk > 0);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kTcNS * 4; ++i) mma::fence_operand(s[i]);

    float corr0, corr1;
    if (softmax_tile(s, r, t0, Tk, causal, window, scale_log2, corr0, corr1))
      rescale<NO>(oacc, corr0, corr1);
    uint32_t pa[kTcBK / 16][4];
    pack_p(s, pa);
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int hb = 0; hb < HD / 64; ++hb)
        mma::wgmma_m64n64k16<1>(
            oacc + 32 * hb, pa[kk],
            mma::desc_sw128(vt + hb * kBlk + kk * 2048, kBlk, 1024));
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) mma::fence_operand(oacc[i]);
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) mma::fence_operand_u32(pa[kk][i]);
  }
  store_rows<NO>(o + q_off, q_row, oacc, r, Tq,
                 lse != nullptr ? lse + static_cast<size_t>(bh) * Tq : nullptr);
}

template <int HD, bool WG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Tq, int Tk, int H, int KVH,
                      int causal, int window, float scale, cudaStream_t st) {
  constexpr int smem = WG ? wg_smem_bytes<HD>() : tc_smem_bytes<HD>();
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*,
                 const __nv_bfloat16*, __nv_bfloat16*, float*, int, int, int,
                 int, int, int, float);
  if constexpr (WG)
    kernel = flash_fwd_wg<HD>;
  else
    kernel = flash_fwd_tc<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Tq + kTcBQ - 1) / kTcBQ, B * H), block(kTcWarps * 32);
  kernel<<<grid, block, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Tq, Tk, H, KVH, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward (CUDA cores, fp32 and bf16, any hd <= 128)
// ---------------------------------------------------------------------------
//
// The Pallas kernel has no backward; this is FA2's, in three passes, every
// sum over keys, queries or q heads in a fixed order (no float atomics: two
// runs give the same bits). With s = scale q.k, P = exp(s - lse) (lse from
// the forward), dP = dO V^T and dS = P (dP - delta):
// * flash_bwd_delta: delta = rowsum(dO * O) per (batch, head, query), fp32;
// * flash_bwd_dq: one block per (batch * head, 32-query tile) walks the key
//   tiles its rows may see and accumulates dq = scale dS K in registers;
// * flash_bwd_dkdv: one block per (batch * KV head, 32-key tile) walks the
//   q heads of its group and, for each, the query tiles that may see its
//   keys, accumulating dv = P^T dO and dk = scale dS^T Q in registers: the
//   GQA sum over the group happens inside the block, and no expanded
//   [B, Tk, H, hd] gradient exists.
// Masks are the forward's expression; tiles wholly outside the causal
// frontier or the window are skipped. What bounds it: 5 products of 2 hd
// flops per visible (query, key) pair (7 here: dq and dk/dv each recompute
// S and dP), on the CUDA cores in fp32 from fp32 tiles in shared memory.
// q, k, v and dO tiles are staged as fp32 rows of hd rounded up to 4 (zero
// padded), at a row stride of 4 times an odd number of words, so that the
// float4 reads of the score products by 8 lanes of a quarter warp land on
// 32 distinct banks.

constexpr int kBwdTile = 32;  // queries and keys per tile
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRows = kBwdTile / kBwdWarps;  // tile rows per warp: 4

__host__ __device__ constexpr int bwd_hd4(int hd) { return (hd + 3) & ~3; }
__host__ __device__ constexpr int bwd_ld(int hd) {
  return bwd_hd4(hd) % 8 == 0 ? bwd_hd4(hd) + 4 : bwd_hd4(hd);
}
// dynamic shared memory of either kernel: 4 row tiles [32][ld], the
// probabilities and dS [32][33], and lse and delta of 32 rows
__host__ __device__ constexpr int bwd_smem_bytes(int hd) {
  return (4 * kBwdTile * bwd_ld(hd) + 2 * kBwdTile * (kBwdTile + 1) +
          2 * kBwdTile) * static_cast<int>(sizeof(float));
}

// rows r0 .. r0 + 31 of head `head` of src [B, n, heads, hd] into dst
// [32][ld] as fp32, zeros past n and past hd
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int r0, int n, int heads, int head,
                                          int hd) {
  const int hd4 = bwd_hd4(hd);
  for (int i = threadIdx.x; i < kBwdTile * hd4; i += kBwdThreads) {
    const int r = i / hd4, d = i % hd4;
    const int t = r0 + r;
    dst[r * ld + d] =
        t < n && d < hd
            ? to_f(src[((static_cast<size_t>(b) * n + t) * heads + head) * hd + d])
            : 0.f;
  }
}

// s[i] = q_r . k_j and dp[i] = do_r . v_j for the tile's query rows
// r = warp + 8 i and key j = lane
__device__ __forceinline__ void score_tile(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int ld, int hd4,
                                           float s[kBwdRows],
                                           float dp[kBwdRows]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i) s[i] = dp[i] = 0.f;
  const float* kr = ks + lane * ld;
  const float* vr = vs + lane * ld;
  for (int d = 0; d < hd4; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
      const int r = warp + kBwdWarps * i;
      const float4 qv = *reinterpret_cast<const float4*>(qs + r * ld + d);
      const float4 ov = *reinterpret_cast<const float4*>(dos + r * ld + d);
      s[i] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[i]))));
      dp[i] = fmaf(ov.x, vv.x, fmaf(ov.y, vv.y, fmaf(ov.z, vv.z, fmaf(ov.w, vv.w, dp[i]))));
    }
  }
}

// P and dS of the tile's pairs (query q0 + warp + 8 i, key k0 + lane) from
// the raw products, into ps / dss [32][33] (ps may be null)
__device__ __forceinline__ void prob_tile(const float s[kBwdRows],
                                          const float dp[kBwdRows],
                                          const float* lse_s,
                                          const float* delta_s, int q0,
                                          int k0, int Tq, int Tk, int causal,
                                          int window, float scale, float* ps,
                                          float* dss) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = k0 + lane;
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i) {
    const int r = warp + kBwdWarps * i;
    const int qp = q0 + r;
    const bool ok = qp < Tq && kp < Tk &&
                    !((causal && kp > qp) || (window && kp <= qp - window));
    const float p = ok ? expf(s[i] * scale - lse_s[r]) : 0.f;
    if (ps != nullptr) ps[r * (kBwdTile + 1) + lane] = p;
    dss[r * (kBwdTile + 1) + lane] = p * (dp[i] - delta_s[r]);
  }
}

// delta[b, h, t] = sum_d dout[b, t, h, d] * o[b, t, h, d]: one warp per row.
// Grid ceil(B * Tq * H / 8), block 256.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int B, int Tq, int H, int hd) {
  const int row = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * Tq * H) return;
  const size_t off = static_cast<size_t>(row) * hd;  // row = (b * Tq + t) * H + h
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(dout[off + d]), to_f(o[off + d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, t = (row / H) % Tq, b = row / (H * Tq);
    delta[(static_cast<size_t>(b) * H + h) * Tq + t] = acc;
  }
}

// dq of one (batch, head) and 32 query rows. Grid (ceil(Tq / 32), B * H),
// block 256, dynamic shared memory bwd_smem_bytes(hd).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int Tq,
                 int Tk, int H, int KVH, int hd, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ld = bwd_ld(hd), hd4 = bwd_hd4(hd);
  float* qs = sm;
  float* dos = qs + kBwdTile * ld;
  float* ks = dos + kBwdTile * ld;
  float* vs = ks + kBwdTile * ld;
  float* dss = vs + kBwdTile * ld;  // (the probabilities' tile stays unused)
  float* lse_s = dss + 2 * kBwdTile * (kBwdTile + 1);
  float* delta_s = lse_s + kBwdTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  // the longest causal rows first: the last query tiles see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_rows(qs, ld, q, b, q0, Tq, H, h, hd);
  load_rows(dos, ld, dout, b, q0, Tq, H, h, hd);
  if (threadIdx.x < kBwdTile) {
    const int qp = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qp < Tq ? lse[static_cast<size_t>(bh) * Tq + qp] : 0.f;
    delta_s[threadIdx.x] = qp < Tq ? delta[static_cast<size_t>(bh) * Tq + qp] : 0.f;
  }
  float acc[kBwdRows][kDims];
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + kBwdTile, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / kBwdTile) * kBwdTile; k0 < k_hi; k0 += kBwdTile) {
    __syncthreads();  // the previous tile's dS K is done with ks
    load_rows(ks, ld, k, b, k0, Tk, KVH, kvh, hd);
    load_rows(vs, ld, v, b, k0, Tk, KVH, kvh, hd);
    __syncthreads();
    float s[kBwdRows], dp[kBwdRows];
    score_tile(qs, dos, ks, vs, ld, hd4, s, dp);
    prob_tile(s, dp, lse_s, delta_s, q0, k0, Tq, Tk, causal, window, scale,
              nullptr, dss);
    __syncthreads();
    for (int j = 0; j < kBwdTile; ++j) {
      float kj[kDims];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int d = lane + 32 * c;
        kj[c] = d < hd ? ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i) {
        const float g = dss[(warp + kBwdWarps * i) * (kBwdTile + 1) + j];
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[i][c] = fmaf(g, kj[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i) {
    const int qp = q0 + warp + kBwdWarps * i;
    if (qp >= Tq) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int d = lane + 32 * c;
      if (d < hd)
        dq[((static_cast<size_t>(b) * Tq + qp) * H + h) * hd + d] =
            from_f<T>(acc[i][c] * scale);
    }
  }
}

// dk, dv of one (batch, KV head) and 32 keys, summed over the q heads of
// the group. Grid (ceil(Tk / 32), B * KVH), block 256, dynamic shared
// memory bwd_smem_bytes(hd).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Tq, int Tk, int H, int KVH, int hd,
                   int causal, int window, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ld = bwd_ld(hd), hd4 = bwd_hd4(hd);
  float* qs = sm;
  float* dos = qs + kBwdTile * ld;
  float* ks = dos + kBwdTile * ld;
  float* vs = ks + kBwdTile * ld;
  float* ps = vs + kBwdTile * ld;
  float* dss = ps + kBwdTile * (kBwdTile + 1);
  float* lse_s = dss + kBwdTile * (kBwdTile + 1);
  float* delta_s = lse_s + kBwdTile;
  const int b = blockIdx.y / KVH, kvh = blockIdx.y % KVH;
  const int grp = H / KVH;
  const int k0 = blockIdx.x * kBwdTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_rows(ks, ld, k, b, k0, Tk, KVH, kvh, hd);
  load_rows(vs, ld, v, b, k0, Tk, KVH, kvh, hd);
  float adk[kBwdRows][kDims], adv[kBwdRows][kDims];
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) adk[i][c] = adv[i][c] = 0.f;

  // queries that may see a key of the tile: [q_lo, q_hi)
  const int k_last = min(k0 + kBwdTile, Tk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Tq, k_last + window) : Tq;
  for (int h = kvh * grp; h < (kvh + 1) * grp; ++h) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int q0 = (q_lo / kBwdTile) * kBwdTile; q0 < q_hi; q0 += kBwdTile) {
      __syncthreads();  // the previous tile's products are done with qs, dos
      load_rows(qs, ld, q, b, q0, Tq, H, h, hd);
      load_rows(dos, ld, dout, b, q0, Tq, H, h, hd);
      if (threadIdx.x < kBwdTile) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < Tq ? lse[bh * Tq + qp] : 0.f;
        delta_s[threadIdx.x] = qp < Tq ? delta[bh * Tq + qp] : 0.f;
      }
      __syncthreads();
      float s[kBwdRows], dp[kBwdRows];
      score_tile(qs, dos, ks, vs, ld, hd4, s, dp);
      prob_tile(s, dp, lse_s, delta_s, q0, k0, Tq, Tk, causal, window, scale,
                ps, dss);
      __syncthreads();
      // key j = warp + 8 i, head dim d = lane + 32 c
      for (int r = 0; r < kBwdTile; ++r) {
        float qr[kDims], orow[kDims];
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          const int d = lane + 32 * c;
          qr[c] = d < hd ? qs[r * ld + d] : 0.f;
          orow[c] = d < hd ? dos[r * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kBwdRows; ++i) {
          const int j = warp + kBwdWarps * i;
          const float p = ps[r * (kBwdTile + 1) + j];
          const float g = dss[r * (kBwdTile + 1) + j];
#pragma unroll
          for (int c = 0; c < kDims; ++c) {
            adv[i][c] = fmaf(p, orow[c], adv[i][c]);
            adk[i][c] = fmaf(g, qr[c], adk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i) {
    const int kp = k0 + warp + kBwdWarps * i;
    if (kp >= Tk) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        const size_t off = ((static_cast<size_t>(b) * Tk + kp) * KVH + kvh) * hd + d;
        dk[off] = from_f<T>(adk[i][c] * scale);
        dv[off] = from_f<T>(adv[i][c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int Tq, int Tk, int H, int KVH, int hd, int causal,
                       int window, float scale, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem_bytes(kMaxHd));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bwd_smem_bytes(kMaxHd));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Tq * H;
  flash_bwd_delta<T><<<(rows + kBwdWarps - 1) / kBwdWarps, kBwdThreads, 0, st>>>(
      static_cast<const T*>(o), dot, delta, B, Tq, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = bwd_smem_bytes(hd);
  flash_bwd_dq<T><<<dim3((Tq + kBwdTile - 1) / kBwdTile, B * H), kBwdThreads,
                    smem, st>>>(qt, kt, vt, dot, lse, delta,
                                static_cast<T*>(dq), Tq, Tk, H, KVH, hd,
                                causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv<T><<<dim3((Tk + kBwdTile - 1) / kBwdTile, B * KVH),
                      kBwdThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Tq, Tk, H, KVH, hd, causal, window, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward, bf16 on mma.sync (hd a multiple of 16 other than 64 and 128)
// ---------------------------------------------------------------------------
//
// The same three passes as above (flash_bwd_delta is shared), FA2's
// backward on mma.sync.m16n8k16 with fp32 accumulation (hd 64 and 128 run
// the wgmma kernels further below). Tiles live in
// shared memory as bf16 rows of hd + 8 (16 bytes of padding: conflict-free
// ldmatrix), arriving by 16-byte cp.async copies into 2-stage rings.
// * flash_bwd_dq_tc: a block of 4 warps owns 64 query rows (16 a warp) of
//   one (batch, head), with their Q and dO tiles; it walks the 64-key tiles
//   its rows may see: S = Q K^T and dP = dO V^T (K and V read as the B
//   operand by ldmatrix), P = 2^(s scale log2 e - lse log2 e), dS =
//   P (dP - delta), rounded to bf16 and reused from the accumulator layout
//   as the A operand of dQ += dS K (K through ldmatrix.trans).
// * flash_bwd_dkdv_tc: a block of 4 warps owns 64 keys (16 a warp) of one
//   (batch, KV head), with their K and V tiles; it walks the q heads of the
//   group and, in each, the 32-query tiles that may see its keys: S^T =
//   K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q (dO and Q
//   through ldmatrix.trans) in registers, the GQA sum inside the block.
// Each output is summed by one warp in a fixed order: two runs give the
// same bits.

constexpr int kTbQ = 64;   // dq: query rows per block
constexpr int kTbK = 64;   // dk/dv: keys per block; dq: keys per tile
constexpr int kTbQt = 32;  // dk/dv: queries per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int tc_bwd_stride() { return HD + 8; }
// shared memory: dq holds Q, dO (64 rows each) and a 2-stage ring of K and
// V tiles; dk/dv holds K, V (64 rows each) and a 2-stage ring of Q and dO
// tiles of 32 rows
template <int HD>
__host__ __device__ constexpr int tc_dq_smem() {
  return (2 * kTbQ + 2 * 2 * kTbK) * tc_bwd_stride<HD>() * 2;
}
template <int HD>
__host__ __device__ constexpr int tc_dkdv_smem() {
  return (2 * kTbK + 2 * 2 * kTbQt) * tc_bwd_stride<HD>() * 2;
}

// rows r0 .. r0 + ROWS - 1 of head `head` of src [B, n, heads, HD] into a
// [ROWS][HD + 8] tile by 16-byte cp.async copies, zeros past n
template <int HD, int ROWS>
__device__ __forceinline__ void tc_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int b,
                                        int r0, int n, int heads, int head) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kTcWarps * 32) {
    const int r = i / CH, ch = i % CH;
    const int t = r0 + r;
    const bool ok = t < n;
    const size_t off =
        ((static_cast<size_t>(b) * n + (ok ? t : 0)) * heads + head) * HD +
        ch * 8;
    mma::cp_async_16(dst + r * tc_bwd_stride<HD>() + ch * 8, src + off, ok);
  }
}

// the A fragment (16 rows x 16 dims from column kk * 16) of a warp's rows
// row0 .. row0 + 15 of a [rows][HD + 8] tile
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t a[4], const __nv_bfloat16* t,
                                       int row0, int kk) {
  const int lane = threadIdx.x & 31;
  mma::ldmatrix_x4(a, t + (row0 + (lane & 15)) * tc_bwd_stride<HD>() +
                          kk * 16 + (lane >> 4) * 8);
}

// acc[0..NT*4) += A @ T^T: A the rows row0 .. row0 + 15 of a tile
// [rows][HD + 8] (fragments loaded per 16 dims), T a tile [NT * 8][HD + 8]
// read as the B operand (rows = n)
template <int HD, int NT>
__device__ __forceinline__ void mma_nt(float* acc, const __nv_bfloat16* a,
                                       int row0, const __nv_bfloat16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    a_frag<HD>(af, a, row0, kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bq[4];
      mma::ldmatrix_x4(bq, t + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   tc_bwd_stride<HD>() +
                               kk * 16 + (((lane >> 3) & 1) << 3));
      mma::mma_bf16(acc + 8 * np, af, bq[0], bq[1]);
      mma::mma_bf16(acc + 8 * np + 4, af, bq[2], bq[3]);
    }
  }
}

// acc[0..HD/2) += P (16 x KT*16, fragments pa) @ T, T a tile
// [KT * 16][HD + 8] read as the B operand through ldmatrix.trans (rows = k)
template <int HD, int KT>
__device__ __forceinline__ void mma_nn(float* acc, const uint32_t pa[][4],
                                       const __nv_bfloat16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bq[4];
      mma::ldmatrix_x4_trans(
          bq, t + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                      tc_bwd_stride<HD>() +
                  np * 16 + ((lane >> 4) << 3));
      mma::mma_bf16(acc + 8 * np, pa[kk], bq[0], bq[1]);
      mma::mma_bf16(acc + 8 * np + 4, pa[kk], bq[2], bq[3]);
    }
}

// values of N n-tiles of an accumulator, rounded to bf16, as A fragments
// (one per 16 columns)
template <int N>
__device__ __forceinline__ void pack_frags(const float* s,
                                           uint32_t pa[N / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = mma::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// dq. Grid (ceil(Tq / 64), B * H), block 128, dynamic shared memory
// tc_dq_smem<HD>().
template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H,
                    int KVH, int causal, int window, float scale) {
  constexpr int STR = tc_bwd_stride<HD>();
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTbQ * STR;
  __nv_bfloat16* ring = dos + kTbQ * STR;  // [stage][K, V][64][STR]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTbQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 3;
  Rows r(q0, Tq);
  const float sl = scale * kLog2e;
  const float l0 = r.qr0 < Tq ? lse[static_cast<size_t>(bh) * Tq + r.qr0] * kLog2e : 0.f;
  const float l1 = r.qr1 < Tq ? lse[static_cast<size_t>(bh) * Tq + r.qr1] * kLog2e : 0.f;
  const float d0 = r.qr0 < Tq ? delta[static_cast<size_t>(bh) * Tq + r.qr0] : 0.f;
  const float d1 = r.qr1 < Tq ? delta[static_cast<size_t>(bh) * Tq + r.qr1] : 0.f;
  int t_first, n_tiles;
  key_tiles(q0, Tq, Tk, causal, window, t_first, n_tiles);

  tc_rows<HD, kTbQ>(qs, q, b, q0, Tq, H, h);
  tc_rows<HD, kTbQ>(dos, dout, b, q0, Tq, H, h);
  auto load_tile = [&](int stage, int t0) {
    __nv_bfloat16* kd = ring + stage * 2 * kTbK * STR;
    tc_rows<HD, kTbK>(kd, k, b, t0, Tk, KVH, kvh);
    tc_rows<HD, kTbK>(kd + kTbK * STR, v, b, t0, Tk, KVH, kvh);
  };
  if (n_tiles > 0) load_tile(0, t_first * kTbK);
  mma::cp_async_commit();

  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_first + it) * kTbK;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile `it` (and Q, dO) landed; it - 1 is done with
    if (it + 1 < n_tiles) load_tile((it + 1) & 1, t0 + kTbK);
    mma::cp_async_commit();
    bool live = r.wq0 < Tq;
    if (causal) live = live && t0 <= r.wq1;
    if (window) live = live && t0 + kTbK - 1 > r.wq0 - window;
    if (!live) continue;  // warp-uniform: every pair of the tile is masked
    const __nv_bfloat16* kt = ring + (it & 1) * 2 * kTbK * STR;
    const __nv_bfloat16* vt = kt + kTbK * STR;
    float s[kTbK / 2], dp[kTbK / 2];
#pragma unroll
    for (int i = 0; i < kTbK / 2; ++i) s[i] = dp[i] = 0.f;
    mma_nt<HD, kTbK / 8>(s, qs, warp * 16, kt);
    mma_nt<HD, kTbK / 8>(dp, dos, warp * 16, vt);
#pragma unroll
    for (int j = 0; j < kTbK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + j * 8 + 2 * c + (e & 1);
        const int qp = e < 2 ? r.qr0 : r.qr1;
        const bool ok = qp < Tq && kp < Tk &&
                        !((causal && kp > qp) || (window && kp <= qp - window));
        const float p =
            ok ? ex2(fmaf(s[4 * j + e], sl, -(e < 2 ? l0 : l1))) : 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? d0 : d1));
      }
    uint32_t pa[kTbK / 16][4];
    pack_frags<kTbK / 8>(s, pa);
    mma_nn<HD, kTbK / 16>(acc, pa, kt);
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const size_t col = static_cast<size_t>(h) * HD + n * 8 + 2 * c;
    const size_t row = static_cast<size_t>(H) * HD;
    const size_t base = static_cast<size_t>(b) * Tq * row + col;
    if (r.qr0 < Tq)
      *reinterpret_cast<uint32_t*>(dq + base + r.qr0 * row) =
          mma::pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (r.qr1 < Tq)
      *reinterpret_cast<uint32_t*>(dq + base + r.qr1 * row) =
          mma::pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// dk, dv. Grid (ceil(Tk / 64), B * KVH), block 128, dynamic shared memory
// tc_dkdv_smem<HD>().
template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Tq, int Tk, int H,
                      int KVH, int causal, int window, float scale) {
  constexpr int STR = tc_bwd_stride<HD>();
  constexpr int NO = HD / 8;
  constexpr int NQ = kTbQt / 8;  // n-tiles of queries in a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTbK * STR;
  __nv_bfloat16* ring = vs + kTbK * STR;  // [stage][Q, dO][32][STR]
  const int b = blockIdx.y / KVH, kvh = blockIdx.y % KVH;
  const int grp = H / KVH;
  const int k0 = blockIdx.x * kTbK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wk0 = k0 + warp * 16, wk1 = min(wk0 + 15, Tk - 1);
  const int kr0 = wk0 + g, kr1 = kr0 + 8;
  const float sl = scale * kLog2e;

  // the query tiles that may see a key of the block: [q_lo, q_hi)
  const int k_last = min(k0 + kTbK, Tk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Tq, k_last + window) : Tq;
  const int qt0 = q_lo / kTbQt;
  const int nq = q_hi > qt0 * kTbQt ? (q_hi - qt0 * kTbQt + kTbQt - 1) / kTbQt : 0;
  const int n_it = grp * nq;

  tc_rows<HD, kTbK>(ks, k, b, k0, Tk, KVH, kvh);
  tc_rows<HD, kTbK>(vs, v, b, k0, Tk, KVH, kvh);
  auto load_tile = [&](int stage, int it) {
    const int h = kvh * grp + it / nq, q0 = (qt0 + it % nq) * kTbQt;
    __nv_bfloat16* qd = ring + stage * 2 * kTbQt * STR;
    tc_rows<HD, kTbQt>(qd, q, b, q0, Tq, H, h);
    tc_rows<HD, kTbQt>(qd + kTbQt * STR, dout, b, q0, Tq, H, h);
  };
  if (n_it > 0) load_tile(0, 0);
  mma::cp_async_commit();

  float adk[NO * 4], adv[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) adk[i] = adv[i] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int h = kvh * grp + it / nq, q0 = (qt0 + it % nq) * kTbQt;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile `it` (and K, V) landed; it - 1 is done with
    if (it + 1 < n_it) load_tile((it + 1) & 1, it + 1);
    mma::cp_async_commit();
    bool live = wk0 < Tk;
    if (causal) live = live && wk0 <= q0 + kTbQt - 1;
    if (window) live = live && wk1 > q0 - window;
    if (!live) continue;  // warp-uniform: every pair of the tile is masked
    const __nv_bfloat16* qt = ring + (it & 1) * 2 * kTbQt * STR;
    const __nv_bfloat16* dot = qt + kTbQt * STR;
    float st[NQ * 4], dpt[NQ * 4];
#pragma unroll
    for (int i = 0; i < NQ * 4; ++i) st[i] = dpt[i] = 0.f;
    mma_nt<HD, NQ>(st, ks, warp * 16, qt);
    mma_nt<HD, NQ>(dpt, vs, warp * 16, dot);
    const size_t bh = static_cast<size_t>(b) * H + h;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        const int qp = q0 + j * 8 + 2 * c + e0;
        const bool qok = qp < Tq;
        const float lq = qok ? lse[bh * Tq + qp] * kLog2e : 0.f;
        const float dq_ = qok ? delta[bh * Tq + qp] : 0.f;
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * e1 + e0;
          const int kp = e1 ? kr1 : kr0;
          const bool ok = qok && kp < Tk &&
                          !((causal && kp > qp) || (window && kp <= qp - window));
          const float p = ok ? ex2(fmaf(st[4 * j + e], sl, -lq)) : 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dq_);
        }
      }
    uint32_t pa[NQ / 2][4];
    pack_frags<NQ>(st, pa);
    mma_nn<HD, NQ / 2>(adv, pa, dot);
    pack_frags<NQ>(dpt, pa);
    mma_nn<HD, NQ / 2>(adk, pa, qt);
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const size_t row = static_cast<size_t>(KVH) * HD;
    const size_t base = static_cast<size_t>(b) * Tk * row +
                        static_cast<size_t>(kvh) * HD + n * 8 + 2 * c;
    if (kr0 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + base + kr0 * row) =
          mma::pack_bf16(adk[4 * n] * scale, adk[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + kr0 * row) =
          mma::pack_bf16(adv[4 * n], adv[4 * n + 1]);
    }
    if (kr1 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + base + kr1 * row) =
          mma::pack_bf16(adk[4 * n + 2] * scale, adk[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + kr1 * row) =
          mma::pack_bf16(adv[4 * n + 2], adv[4 * n + 3]);
    }
  }
}

template <int HD>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* o, const float* lse, const void* dout,
                          void* dq, void* dk, void* dv, float* delta, int B,
                          int Tq, int Tk, int H, int KVH, int causal,
                          int window, float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_dq_smem<HD>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 tc_dkdv_smem<HD>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Tq * H;
  flash_bwd_delta<T><<<(rows + kBwdWarps - 1) / kBwdWarps, kBwdThreads, 0, st>>>(
      static_cast<const T*>(o), dot, delta, B, Tq, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc<HD><<<dim3((Tq + kTbQ - 1) / kTbQ, B * H), kTcWarps * 32,
                        tc_dq_smem<HD>(), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Tq, Tk, H, KVH, causal,
      window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_tc<HD><<<dim3((Tk + kTbK - 1) / kTbK, B * KVH),
                          kTcWarps * 32, tc_dkdv_smem<HD>(), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Tq, Tk, H, KVH, causal, window, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward, bf16 with hd = 64 or 128, on wgmma
// ---------------------------------------------------------------------------
//
// The same three passes and the same arithmetic as flash_bwd_*_tc (S and dP
// recomputed by both kernels: 7 products where the algorithm needs 5, the
// price of summing every gradient in one block, without float atomics).
// What bounds it on the H100: the operations, 14 hd flops per visible
// (query, key) pair against 989 TFLOP/s bf16 (at B = 2, T = 2048, 32 heads,
// hd 128, causal: 0.24 ms), while the bytes (q, k, v, o, dO and the
// gradients, read or written about once) take 0.03 ms. So the design feeds
// the tensor cores:
// * every product is a wgmma of a 64-row warpgroup tile, B (and A where it
//   is a staged tile) read by the tensor cores straight from 128-byte-
//   swizzled shared memory, the probabilities and dS from registers; no
//   ldmatrix traffic;
// * two consumer warpgroups per block share each staged tile: a dq block
//   owns 128 query rows (Q, dO resident) and walks the 64-key tiles of K
//   and V; a dk/dv block owns 128 keys (K, V resident) and walks, for each
//   q head of its GQA group, the 64-query tiles of Q and dO that can see its
//   keys, with their lse and delta rows;
// * tiles arrive by cp.async into a 4-stage ring, copies two stages ahead
//   of the products, and each stage has two mbarriers instead of a block
//   barrier: `full` completes when every thread's copies into it have
//   landed (cp.async.mbarrier.arrive), `empty` when both warpgroups are
//   done with it. So the warpgroups run out of step, up to two tiles apart:
//   one's softmax runs under the other's products, where a block barrier
//   a tile would line their softmax phases up and idle the tensor cores;
// * a warpgroup issues S and dP together, then its dQ (resp. dV and dK)
//   products, and drains its wgmma pipeline before any other instruction
//   writes an accumulator (else ptxas serializes every wgmma of the
//   kernel);
// * a warpgroup skips a tile that is wholly masked for its 64 rows, and
//   masks only a tile on an edge; dk/dv reads each query's lse and delta
//   once a tile, as float2 pairs, into registers.
// S^T = K Q^T and dP^T = V dO^T (dk/dv), S = Q K^T and dP = dO V^T (dq) run
// K-major on both sides; dV += P^T dO, dK += dS^T Q and dQ += dS K take the
// staged tile MN-major (TRANS_B = 1). Each output row is summed by one
// warpgroup in a fixed order: two runs give the same bits.

constexpr int kWgRows = 64;                  // rows of a consumer warpgroup
constexpr int kWgGroups = 2;                 // consumer warpgroups a block
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgBlock = kWgRows * kWgGroups;  // rows a block owns
constexpr int kWgTile = 64;                  // rows of a walked tile
constexpr int kWgStages = 4;                 // walked tiles in the ring
constexpr int kWgAhead = kWgStages - 2;      // stages copied ahead

// shared memory: the resident pair (Q and dO, resp. K and V) of kWgBlock
// rows, the ring of walked pairs, the full and empty mbarrier of each
// stage, dk/dv's ring of lse and delta rows, and slack to align to the
// 1024-byte swizzle atom
template <int HD>
__host__ __device__ constexpr int wg_dq_smem() {
  return 2 * kWgBlock * HD * 2 + kWgStages * 2 * kWgTile * HD * 2 +
         2 * kWgStages * 8 + 1024;
}
template <int HD>
__host__ __device__ constexpr int wg_dkdv_smem() {
  return wg_dq_smem<HD>() + kWgStages * 2 * kWgTile * 4;
}

// rows r0 .. r0 + ROWS - 1 of head `head` of src [B, n, heads, HD] by
// 16-byte cp.async copies into a swizzled tile at dst: 64-dim blocks of
// ROWS x 128 bytes, zeros past n
template <int HD, int ROWS>
__device__ __forceinline__ void wg_rows(unsigned char* dst,
                                        const __nv_bfloat16* src, int b,
                                        int r0, int n, int heads, int head) {
  constexpr int CH = HD / 8;
  static_assert(ROWS * CH % kWgThreads == 0, "whole passes");
#pragma unroll
  for (int u = 0; u < ROWS * CH / kWgThreads; ++u) {
    const int i = threadIdx.x + kWgThreads * u;
    const int r = i / CH, ch = i % CH;
    const int t = r0 + r;
    const bool ok = t < n;
    const size_t off =
        ((static_cast<size_t>(b) * n + (ok ? t : 0)) * heads + head) * HD +
        ch * 8;
    mma::cp_async_16(dst + (ch >> 3) * (ROWS * 128) + mma::sw128(r, ch & 7),
                     src + off, ok);
  }
}

// acc = A B^T over HD, both K-major: A the warpgroup's 64 rows of a tile
// whose 64-dim blocks are a_blk bytes apart (at shared address a), B a
// 64-row tile (64-dim blocks 8 KB apart)
template <int HD>
__device__ __forceinline__ void wg_nt(float* acc, uint32_t a, int a_blk,
                                      uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma::wgmma_m64k16_ss<64, 0, 0>(
        acc, mma::desc_sw128(a + (kk >> 2) * a_blk + (kk & 3) * 32, 16, 1024),
        mma::desc_sw128(b + (kk >> 2) * kWgTile * 128 + (kk & 3) * 32, 16,
                        1024),
        kk > 0);
}

// acc[0..HD/2) += A (64 x 64, fragments pa) @ T, T a 64-row tile read
// MN-major (rows = k)
template <int HD>
__device__ __forceinline__ void wg_nn(float* acc, const uint32_t pa[4][4],
                                      uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < kWgTile / 16; ++kk)
#pragma unroll
    for (int hb = 0; hb < HD / 64; ++hb)
      mma::wgmma_m64n64k16<1>(
          acc + 32 * hb, pa[kk],
          mma::desc_sw128(t + hb * kWgTile * 128 + kk * 2048, kWgTile * 128,
                          1024));
}

template <int N>
__device__ __forceinline__ void fence_acc(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma::fence_operand(a[i]);
}
__device__ __forceinline__ void fence_frags(uint32_t pa[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) mma::fence_operand_u32(pa[kk][i]);
}

// The ring's mbarriers: full[s] at bars + 8 s, empty[s] after them. Walked
// tile `it` sits in stage it % kWgStages, the (it / kWgStages)-th use of
// that stage.
struct WgRing {
  uint32_t bars;
  __device__ explicit WgRing(uint32_t b) : bars(b) {
    if (threadIdx.x == 0)
      for (int s = 0; s < 2 * kWgStages; ++s)
        mma::mbar_init(bars + 8 * s, kWgThreads);
    __syncthreads();
  }
  // after this thread issued its copies of tile `it`
  __device__ void copied(int it) const {
    mma::mbar_arrive_cp_async(bars + 8 * (it % kWgStages));
  }
  // before this thread copies tile `it`: the tile that used its stage
  // before is done with by both warpgroups
  __device__ void wait_empty(int it) const {
    if (it >= kWgStages)
      mma::mbar_wait(bars + 8 * (kWgStages + it % kWgStages),
                     (it / kWgStages - 1) & 1);
  }
  // every copy of tile `it` landed, visible to wgmma
  __device__ void wait_full(int it) const {
    mma::mbar_wait(bars + 8 * (it % kWgStages), (it / kWgStages) & 1);
    mma::fence_proxy_async();
  }
  // this thread (its warpgroup's products drained) is done with tile `it`
  __device__ void release(int it) const {
    mma::mbar_arrive(bars + 8 * (kWgStages + it % kWgStages));
  }
};

// dq. Grid (ceil(Tq / 128), B * H), block 256, dynamic shared memory
// wg_dq_smem<HD>().
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wg(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H,
                    int KVH, int causal, int window, float scale) {
  static_assert(HD % 64 == 0, "128-byte swizzle atoms");
  constexpr int NO = HD / 8;
  constexpr int kQBlk = kWgBlock * 128;     // a 64-dim block of Q or dO
  constexpr int kQ = (HD / 64) * kQBlk;     // the Q or dO tile
  constexpr int kK = (HD / 64) * kWgTile * 128;  // a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);  // [Q][dO][stage][K, V]
  const WgRing ring(base + 2 * kQ + kWgStages * 2 * kK);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  // the longest causal rows first: the last query blocks see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBlock;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wq0 = q0 + wg * kWgRows, wq1 = min(wq0 + kWgRows - 1, Tq - 1);
  const int qr0 = wq0 + warp * 16 + g, qr1 = qr0 + 8;
  const float sl = scale * kLog2e;
  const size_t st0 = static_cast<size_t>(bh) * Tq;
  const float l0 = qr0 < Tq ? lse[st0 + qr0] * kLog2e : 0.f;
  const float l1 = qr1 < Tq ? lse[st0 + qr1] * kLog2e : 0.f;
  const float d0 = qr0 < Tq ? delta[st0 + qr0] : 0.f;
  const float d1 = qr1 < Tq ? delta[st0 + qr1] : 0.f;

  // the key tiles any row of the block may see
  const int q_last = min(q0 + kWgBlock, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_first = k_lo / kWgTile;
  const int n_tiles = k_hi > t_first * kWgTile
                          ? (k_hi - t_first * kWgTile + kWgTile - 1) / kWgTile
                          : 0;

  wg_rows<HD, kWgBlock>(sm, q, b, q0, Tq, H, h);
  wg_rows<HD, kWgBlock>(sm + kQ, dout, b, q0, Tq, H, h);
  auto load_tile = [&](int it) {  // (the first also lands Q and dO)
    ring.wait_empty(it);
    unsigned char* kd = sm + 2 * kQ + (it % kWgStages) * 2 * kK;
    const int t0 = (t_first + it) * kWgTile;
    wg_rows<HD, kWgTile>(kd, k, b, t0, Tk, KVH, kvh);
    wg_rows<HD, kWgTile>(kd + kK, v, b, t0, Tk, KVH, kvh);
    ring.copied(it);
  };
  for (int it = 0; it < kWgAhead && it < n_tiles; ++it) load_tile(it);

  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  const uint32_t qa = base + wg * kWgRows * 128, doa = qa + kQ;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kWgAhead < n_tiles) load_tile(it + kWgAhead);
    const int t0 = (t_first + it) * kWgTile;
    bool live = wq0 < Tq;
    if (causal) live = live && t0 <= wq1;
    if (window) live = live && t0 + kWgTile - 1 > wq0 - window;
    ring.wait_full(it);
    if (live) {  // warpgroup-uniform: else every pair is masked
      const uint32_t kt = base + 2 * kQ + (it % kWgStages) * 2 * kK;
      float s[32], dp[32];
      mma::wgmma_fence();
      wg_nt<HD>(s, qa, kQBlk, kt);
      wg_nt<HD>(dp, doa, kQBlk, kt + kK);
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      fence_acc<32>(s);
      fence_acc<32>(dp);
      if ((causal && t0 + kWgTile - 1 > wq0) ||
          (window && t0 <= wq1 - window) || t0 + kWgTile > Tk ||
          wq0 + kWgRows > Tq) {  // a tile on an edge
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = e < 2 ? qr0 : qr1;
            const int kp = t0 + j * 8 + 2 * c + (e & 1);
            if (qp >= Tq || kp >= Tk || (causal && kp > qp) ||
                (window && kp <= qp - window))
              s[4 * j + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl, -(e < 2 ? l0 : l1))) *
                         (dp[4 * j + e] - (e < 2 ? d0 : d1));
      uint32_t pa[4][4];
      pack_frags<8>(s, pa);
      mma::wgmma_fence();
      wg_nn<HD>(acc, pa, kt);  // dQ += dS K
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      fence_acc<NO * 4>(acc);
      fence_frags(pa);
    }
    ring.release(it);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t ob = static_cast<size_t>(b) * Tq * row +
                    static_cast<size_t>(h) * HD + 2 * c;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (qr0 < Tq)
      *reinterpret_cast<uint32_t*>(dq + ob + qr0 * row + n * 8) =
          mma::pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (qr1 < Tq)
      *reinterpret_cast<uint32_t*>(dq + ob + qr1 * row + n * 8) =
          mma::pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// dk, dv. Grid (ceil(Tk / 128), B * KVH), block 256, dynamic shared memory
// wg_dkdv_smem<HD>().
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wg(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Tq, int Tk, int H,
                      int KVH, int causal, int window, float scale) {
  static_assert(HD % 64 == 0, "128-byte swizzle atoms");
  constexpr int NO = HD / 8;
  constexpr int kKBlk = kWgBlock * 128;     // a 64-dim block of K or V
  constexpr int kK = (HD / 64) * kKBlk;     // the K or V tile
  constexpr int kQ = (HD / 64) * kWgTile * 128;  // a Q or dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);  // [K][V][stage][Q, dO]
  const WgRing ring(base + 2 * kK + kWgStages * 2 * kQ);
  // [stage][lse, delta][64] after the barriers
  float* stats = reinterpret_cast<float*>(sm + 2 * kK + kWgStages * 2 * kQ +
                                          2 * kWgStages * 8);

  const int b = blockIdx.y / KVH, kvh = blockIdx.y % KVH;
  const int grp = H / KVH;
  // the smallest keys first: under causal masking they see the most queries
  const int k0 = blockIdx.x * kWgBlock;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wk0 = k0 + wg * kWgRows, wk1 = min(wk0 + kWgRows - 1, Tk - 1);
  const int kr0 = wk0 + warp * 16 + g, kr1 = kr0 + 8;
  const float sl = scale * kLog2e;

  // the query tiles that may see a key of the block: [q_lo, q_hi)
  const int k_last = min(k0 + kWgBlock, Tk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Tq, k_last + window) : Tq;
  const int qt0 = q_lo / kWgTile;
  const int nq = q_hi > qt0 * kWgTile
                     ? (q_hi - qt0 * kWgTile + kWgTile - 1) / kWgTile
                     : 0;
  const int n_it = grp * nq;

  wg_rows<HD, kWgBlock>(sm, k, b, k0, Tk, KVH, kvh);
  wg_rows<HD, kWgBlock>(sm + kK, v, b, k0, Tk, KVH, kvh);
  auto load_tile = [&](int it) {  // (the first also lands K and V)
    ring.wait_empty(it);
    const int stage = it % kWgStages;
    const int h = kvh * grp + it / nq, q0 = (qt0 + it % nq) * kWgTile;
    unsigned char* qd = sm + 2 * kK + stage * 2 * kQ;
    wg_rows<HD, kWgTile>(qd, q, b, q0, Tq, H, h);
    wg_rows<HD, kWgTile>(qd + kQ, dout, b, q0, Tq, H, h);
    if (threadIdx.x < 2 * kWgTile) {
      const int r = threadIdx.x % kWgTile, qp = q0 + r;
      const float* src = threadIdx.x < kWgTile ? lse : delta;
      const size_t off = (static_cast<size_t>(b) * H + h) * Tq;
      mma::cp_async_4(stats + stage * 2 * kWgTile + threadIdx.x,
                      src + off + (qp < Tq ? qp : 0), qp < Tq);
    }
    ring.copied(it);
  };
  for (int it = 0; it < kWgAhead && it < n_it; ++it) load_tile(it);

  float adk[NO * 4], adv[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) adk[i] = adv[i] = 0.f;
  const uint32_t ka = base + wg * kWgRows * 128, va = ka + kK;
  for (int it = 0; it < n_it; ++it) {
    if (it + kWgAhead < n_it) load_tile(it + kWgAhead);
    const int q0 = (qt0 + it % nq) * kWgTile;
    bool live = wk0 < Tk;
    if (causal) live = live && wk0 <= q0 + kWgTile - 1;
    if (window) live = live && wk1 > q0 - window;
    ring.wait_full(it);
    if (live) {  // warpgroup-uniform: else every pair is masked
      const int stage = it % kWgStages;
      const uint32_t qt = base + 2 * kK + stage * 2 * kQ, dot = qt + kQ;
      float st[32], dpt[32];
      mma::wgmma_fence();
      wg_nt<HD>(st, ka, kKBlk, qt);
      wg_nt<HD>(dpt, va, kKBlk, dot);
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      fence_acc<32>(st);
      fence_acc<32>(dpt);
      // st[4j + e]: key kr0 (e < 2) or kr1, query q0 + 8j + 2c + (e & 1)
      if ((causal && q0 < wk1) ||
          (window && q0 + kWgTile - 1 - window >= wk0) ||
          q0 + kWgTile > Tq || wk0 + kWgRows > Tk) {  // a tile on an edge
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = q0 + j * 8 + 2 * c + (e & 1);
            const int kp = e < 2 ? kr0 : kr1;
            if (qp >= Tq || kp >= Tk || (causal && kp > qp) ||
                (window && kp <= qp - window))
              st[4 * j + e] = -INFINITY;
          }
      }
      uint32_t pp[4][4], pd[4][4];  // P^T and dS^T as A fragments
      // this lane's queries q0 + 8j + 2c (+1): lse and delta, as pairs
      const float* ls = stats + stage * 2 * kWgTile + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j);
        const float2 d2 =
            *reinterpret_cast<const float2*>(ls + kWgTile + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int kk = j >> 1, i = (j & 1) * 2 + (e >> 1);
          const float p0 = ex2(fmaf(st[4 * j + e], sl, -l2.x * kLog2e));
          const float p1 = ex2(fmaf(st[4 * j + e + 1], sl, -l2.y * kLog2e));
          pp[kk][i] = mma::pack_bf16(p0, p1);
          pd[kk][i] = mma::pack_bf16(p0 * (dpt[4 * j + e] - d2.x),
                                     p1 * (dpt[4 * j + e + 1] - d2.y));
        }
      }
      mma::wgmma_fence();
      wg_nn<HD>(adv, pp, dot);  // dV += P^T dO
      wg_nn<HD>(adk, pd, qt);   // dK += dS^T Q
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      fence_acc<NO * 4>(adk);
      fence_acc<NO * 4>(adv);
      fence_frags(pp);
      fence_frags(pd);
    }
    ring.release(it);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  const size_t row = static_cast<size_t>(KVH) * HD;
  const size_t ob = static_cast<size_t>(b) * Tk * row +
                    static_cast<size_t>(kvh) * HD + 2 * c;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (kr0 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + ob + kr0 * row + n * 8) =
          mma::pack_bf16(adk[4 * n] * scale, adk[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + ob + kr0 * row + n * 8) =
          mma::pack_bf16(adv[4 * n], adv[4 * n + 1]);
    }
    if (kr1 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + ob + kr1 * row + n * 8) =
          mma::pack_bf16(adk[4 * n + 2] * scale, adk[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + ob + kr1 * row + n * 8) =
          mma::pack_bf16(adv[4 * n + 2], adv[4 * n + 3]);
    }
  }
}

template <int HD>
cudaError_t launch_bwd_wg(const void* q, const void* k, const void* v,
                          const void* o, const float* lse, const void* dout,
                          void* dq, void* dk, void* dv, float* delta, int B,
                          int Tq, int Tk, int H, int KVH, int causal,
                          int window, float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wg<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg_dq_smem<HD>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_wg<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wg_dkdv_smem<HD>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Tq * H;
  flash_bwd_delta<T><<<(rows + kBwdWarps - 1) / kBwdWarps, kBwdThreads, 0, st>>>(
      static_cast<const T*>(o), dot, delta, B, Tq, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wg<HD><<<dim3((Tq + kWgBlock - 1) / kWgBlock, B * H),
                        kWgThreads, wg_dq_smem<HD>(), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Tq, Tk, H, KVH, causal,
      window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_wg<HD><<<dim3((Tk + kWgBlock - 1) / kWgBlock, B * KVH),
                          kWgThreads, wg_dkdv_smem<HD>(), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Tq, Tk, H, KVH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; variant: 0 = CUDA cores (flash_fwd),
// 1 = tensor cores (flash_fwd_tc: bf16, hd % 16 == 0, 16-byte aligned
// pointers). Contiguous q [B, Tq, H, hd], k/v [B, Tk, KVH, hd],
// o [B, Tq, H, hd] on the device; hd <= 128, H % KVH == 0. lse_out: null,
// or an fp32 [B, H, Tq] that receives each row's log-sum-exp of the scaled
// scores (the backward's statistics). Returns the CUDA error code of the
// launch (0 = success).
extern "C" int flash_attention_launch(int dtype, int variant, const void* q,
                                      const void* k, const void* v, void* o,
                                      void* lse_out, int B, int Tq, int Tk,
                                      int H, int KVH,
                                      int hd, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KVH <= 0 || hd <= 0 ||
      hd > kMaxHd || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (variant == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 16: return launch_tc<16, false>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 32: return launch_tc<32, false>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 48: return launch_tc<48, false>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 64: return launch_tc<64, true>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 80: return launch_tc<80, false>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 96: return launch_tc<96, false>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 112: return launch_tc<112, false>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 128: return launch_tc<128, true>(q, k, v, o, lse, B, Tq, Tk, H, KVH, causal, window, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H), block(kWarps * 32);
  if (dtype == 0)
    flash_fwd<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, Tk, H,
        KVH, hd, causal, window, scale);
  else if (dtype == 1)
    flash_fwd<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, Tq, Tk, H, KVH, hd, causal, window, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward: dtype and variant as above (1 = the tensor-core kernels,
// flash_bwd_dq_wg / flash_bwd_dkdv_wg for hd 64 and 128, flash_bwd_dq_tc /
// flash_bwd_dkdv_tc for the other multiples of 16: bf16, 16-byte aligned
// pointers; 0 = the CUDA-core ones); contiguous q, o, dout, dq [B, Tq, H, hd],
// k, v, dk, dv [B, Tk, KVH, hd] of that type, lse (the forward's) and the
// scratch delta fp32 [B, H, Tq]; hd <= 128, H % KVH == 0. Writes dq, dk,
// dv (three launches: delta, dq, dk/dv). Returns the CUDA error code of the
// launches (0 = success).
extern "C" int flash_attention_bwd_launch(
    int dtype, int variant, const void* q, const void* k, const void* v,
    const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Tq, int Tk, int H, int KVH, int hd, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KVH <= 0 || hd <= 0 ||
      hd > kMaxHd || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (variant == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 16: return launch_bwd_tc<16>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 32: return launch_bwd_tc<32>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 48: return launch_bwd_tc<48>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 64: return launch_bwd_wg<64>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 80: return launch_bwd_tc<80>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 96: return launch_bwd_tc<96>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 112: return launch_bwd_tc<112>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 128: return launch_bwd_wg<128>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, causal, window, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_bwd<float>(q, k, v, o, ls, dout, dq, dk, dv,
                                              dl, B, Tq, Tk, H, KVH, hd, causal,
                                              window, scale, st));
  if (dtype == 1)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(
        q, k, v, o, ls, dout, dq, dk, dv, dl, B, Tq, Tk, H, KVH, hd, causal,
        window, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
