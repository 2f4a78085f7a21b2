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
// TPU kernel does.
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
              const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
              int H, int KVH, int hd, int causal, int window, float scale) {
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

// o / max(l, 1e-30) of this lane's rows, bf16, to ob (row stride q_row)
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, size_t q_row,
                                           const float* o, Rows& r, int Tq) {
#pragma unroll
  for (int i = 1; i <= 2; i <<= 1) {
    r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, i);
    r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, i);
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
                 __nv_bfloat16* __restrict__ o, int Tq, int Tk, int H,
                 int KVH, int causal, int window, float scale_log2) {
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
  store_rows<NO>(o + q_off, q_row, oacc, r, Tq);
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
                 __nv_bfloat16* __restrict__ o, int Tq, int Tk, int H,
                 int KVH, int causal, int window, float scale_log2) {
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
  store_rows<NO>(o + q_off, q_row, oacc, r, Tq);
}

template <int HD, bool WG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Tq, int Tk, int H, int KVH, int causal,
                      int window, float scale, cudaStream_t st) {
  constexpr int smem = WG ? wg_smem_bytes<HD>() : tc_smem_bytes<HD>();
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*,
                 const __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,
                 int, float);
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
      Tq, Tk, H, KVH, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; variant: 0 = CUDA cores (flash_fwd),
// 1 = tensor cores (flash_fwd_tc: bf16, hd % 16 == 0, 16-byte aligned
// pointers). Contiguous q [B, Tq, H, hd], k/v [B, Tk, KVH, hd],
// o [B, Tq, H, hd] on the device; hd <= 128, H % KVH == 0. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int flash_attention_launch(int dtype, int variant, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Tq, int Tk, int H, int KVH,
                                      int hd, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KVH <= 0 || hd <= 0 ||
      hd > kMaxHd || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 16: return launch_tc<16, false>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 32: return launch_tc<32, false>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 48: return launch_tc<48, false>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 64: return launch_tc<64, true>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 80: return launch_tc<80, false>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 96: return launch_tc<96, false>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 112: return launch_tc<112, false>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      case 128: return launch_tc<128, true>(q, k, v, o, B, Tq, Tk, H, KVH, causal, window, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H), block(kWarps * 32);
  if (dtype == 0)
    flash_fwd<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Tq, Tk, H, KVH,
        hd, causal, window, scale);
  else if (dtype == 1)
    flash_fwd<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Tq, Tk, H, KVH, hd, causal, window, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
