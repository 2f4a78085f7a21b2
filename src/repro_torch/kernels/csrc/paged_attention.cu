// Paged attention of the serving steps for Hopper (sm_90a): the decode
// round (one query a row) and the chunked prefill (one block-sized chunk of
// queries a row), read in place from the paged KV pool. bf16 queries over a
// bf16 or an int8 pool on the tensor cores, fp32 queries over an fp32 or an
// int8 pool on the CUDA cores.
//
// Replaces no TPU kernel. The JAX package leaves the paged read to XLA:
// src/repro/models/attention.py gathers every page of the table
// (paged_gather), then decode_attention / chunked_attention repeat k and v to
// every q head. Ported as plain PyTorch, that gather copied the table's whole
// width (twice the longest request) for every row and layer, and the repeat
// made an fp32 copy of it for each q head: three quarters of a serving tick
// on the H100, two to three orders of magnitude above the bytes the work
// needs. This kernel reads each live k/v byte once.
//
// Semantics (those of the plain version, the gathered read of
// models/attention.py::gathered_attention):
// query t of row b (absolute position q_offset[b] + t) attends causally to
// the keys at positions 0 .. q_offset[b] + t of its row; position p lies in
// physical block table[b, p / bs] at offset p % bs. q is scaled by hd^-0.5
// and rounded to bf16, QK^T sums exact bf16 products in fp32, the softmax
// runs in fp32, P is rounded to bf16 before PV, which sums in fp32, and the
// output is bf16. q head h reads kv head h / (H / KVH). An int8 pool holds
// codes and a bf16 scale per (position, kv head); a key or value element is
// float(code) * float(scale), rounded to the queries' type, as the plain
// version dequantizes. fp32 rounds nothing.
//
// What bounds it on the H100: bytes. Each live position costs hd * 2 bytes
// of k and of v per kv head; the products are 4 * hd flops per (query row,
// key), with at most grp * Tq = 96 query rows a kv head in the served cells:
// under 100 flops a byte, below the card's ~295.
//
// Design:
// * Grid (splits, KVH * row groups, B), from static shapes only, so that a
//   captured CUDA graph stays valid for any lengths and tables. A block
//   takes one (row, kv head, split). It reads its row's length from
//   q_offset on the device, cuts the row's live 32-key tiles into `splits`
//   equal runs and walks only its own run: the work follows the lengths,
//   and every row's work is spread over all splits. A run is at least
//   min_run tiles (from the wrapper's plan), which bounds what a split's
//   partial output (fp32, written and read once more) costs against the
//   k/v bytes its run reads. A block whose run is empty writes its (empty)
//   statistics and nothing else.
// * The grp * Tq query rows that share a kv head are the M side of the
//   products (row r: query r / grp, q head kvh * grp + r % grp), one warp
//   per 16 rows (decode: 6 rows padded to 16, one warp; a chunk of 16: 96
//   rows, six warps), so every k/v tile is loaded once for the whole group.
//   mma.sync m16n8k16 (bf16, fp32 accumulate) for QK^T and PV: wgmma's
//   64-row minimum would waste most of a decode tile, and the tensor cores
//   are not what bounds this work. K through ldmatrix, V through
//   ldmatrix.trans, from rows padded by 16 bytes (no bank conflicts).
// * Tiles of 32 keys arrive by 16-byte cp.async copies into a 3-stage ring
//   (two tiles in flight while one is used). The row offsets of a tile's
//   keys are read from the page table (one key a thread) an iteration
//   before its copies are issued, into a small shared ring, so no copy
//   waits on a table read. Keys past the row's length arrive as zeros and
//   are masked.
// * Online softmax in registers, in the log2 domain. A split writes its
//   partial output and statistics (fp32), and paged_attn_combine merges
//   the splits in a fixed order (flash-decoding): no atomics, the same bits
//   on every run. With one split the block writes bf16 output directly.
// * An int8 pool's tiles arrive as codes (16-byte copies, the same ring)
//   with their scales, which a thread reads into registers a tile ahead;
//   once a tile has landed, the block dequantizes it into one bf16 tile,
//   which the products read as they read a bf16 pool's stage.
// * A page id outside the pool reads as zeros (never out of bounds).
//
// paged_attn_f32 (fp32 queries; an fp32 or int8 pool): on the CUDA cores,
// since fp32 must agree with the plain version to 1e-4, which TF32 would
// not. The same grid, lengths, splits and combine; a block takes 16 query
// rows of a kv head (4 warps of 4 rows); each 32-key tile goes through
// shared memory as fp32, one key a lane, the warp reducing max and sum by
// shuffles (the CUDA-core flash_fwd's scheme).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kTK = 32;         // keys per tile
constexpr int kStages = 3;      // tiles in the shared-memory ring
constexpr int kOffSlots = kStages + 1;  // tiles whose row offsets are held
constexpr int kMaxWarps = 8;    // 16-row m-tiles per block
constexpr int kMaxSplits = 32;  // splits of a row (the combine's lanes)
constexpr int kSimtWarps = 4;   // paged_attn_f32: warps a block
constexpr int kSimtRows = 16;   // paged_attn_f32: query rows a block
constexpr int kMaxHd = 128;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dynamic shared memory of paged_attn: bf16 pools, the K/V ring of bf16
// rows padded by 16 bytes; int8 pools, one bf16 K/V tile (the dequantized
// codes) and the ring of int8 rows padded by 16 bytes
template <int HD, bool kInt8>
constexpr int smem_bytes() {
  constexpr int tile = 2 /*K, V*/ * kTK * (HD + 8) *
                       static_cast<int>(sizeof(__nv_bfloat16));
  return kInt8 ? tile + 2 * kStages * kTK * (HD + 16) : kStages * tile;
}

// q [B, Tq, H, HD] bf16; pools [n_blocks, bs, KVH, HD] bf16, or int8 codes
// with bf16 scales [n_blocks, bs, KVH] (kInt8); table [B, P] int32;
// q_offset [B] int32; o [B, Tq, H, HD] (one split) or o_part
// [splits, B, Tq, H, HD] fp32 and ml [splits, B, Tq, H, 2] fp32 (the
// running max in log2 units and the denominator). Block 32 * warps.
template <int HD, bool kInt8>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attn(const __nv_bfloat16* __restrict__ q,
               const void* __restrict__ kpool_, const void* __restrict__ vpool_,
               const __nv_bfloat16* __restrict__ kscale,
               const __nv_bfloat16* __restrict__ vscale,
               const int* __restrict__ table,
               const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ o,
               float* __restrict__ o_part, float* __restrict__ ml, int Tq,
               int H, int KVH, int n_blocks, int bs, int P, int mgroups,
               int min_run, float scale) {
  using KV = std::conditional_t<kInt8, int8_t, __nv_bfloat16>;
  const KV* __restrict__ kpool = static_cast<const KV*>(kpool_);
  const KV* __restrict__ vpool = static_cast<const KV*>(vpool_);
  constexpr int kStride = HD + 8;  // padded bf16 tile row, elements
  constexpr int kRing = kInt8 ? HD + 16 : kStride;  // ring row, elements
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // per 16 bytes
  constexpr int CH = HD / EPC;     // 16-byte chunks per K/V row
  constexpr int KS = HD / 16;      // k-steps of Q K^T
  constexpr int NO = HD / 8;       // n-tiles of O
  constexpr int NS = kTK / 8;      // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the bf16 tiles the products read: the ring's stages (bf16 pools) or
  // the one dequantized tile (int8 pools), which the int8 ring follows
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vb = kb + (kInt8 ? 1 : kStages) * kTK * kStride;
  KV* kr;
  KV* vr;
  if constexpr (kInt8) {
    kr = reinterpret_cast<KV*>(vb + kTK * kStride);
    vr = kr + kStages * kTK * kRing;
  } else {
    kr = kb;
    vr = vb;
  }
  // element offset of each key's row in the pools (-1: no key), by tile
  __shared__ long long koff[kOffSlots][kTK];
  // int8 pools: the k and v scales of each key, for two tiles
  __shared__ float scl[kInt8 ? 2 : 1][2][kTK];

  const int nsplit = gridDim.x, split = blockIdx.x;
  const int kvh = blockIdx.y / mgroups, mg = blockIdx.y % mgroups;
  const int b = blockIdx.z, B = gridDim.z;
  const int grp = H / KVH, rows = grp * Tq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int mtiles = (rows + 15) / 16;
  const int per_group = (mtiles + mgroups - 1) / mgroups;
  const int tile_m = mg * per_group + warp;
  const bool computes = tile_m < mtiles;  // warp-uniform
  const int r0 = tile_m * 16 + g, r1 = r0 + 8;

  // this block's run of key tiles, from the row's length
  const int off = q_offset[b];
  const int len = max(0, min(off + Tq, P * bs));  // keys the last query sees
  const int ntiles = (len + kTK - 1) / kTK;
  const int per = max((ntiles + nsplit - 1) / nsplit, min_run);
  const int t_first = split * per;
  const int n_tiles = max(0, min(t_first + per, ntiles) - t_first);

  // output row (b, t, h) of M row r, flat over [B, Tq, H]
  auto out_row = [&](int r) -> size_t {
    return (static_cast<size_t>(b) * Tq + r / grp) * H + kvh * grp + r % grp;
  };

  // Q fragments (the mma A operand) of this lane's rows, scaled and rounded
  // to bf16 as the plain version's q * hd^-0.5; rows past grp * Tq are 0
  uint32_t qf[KS][4];
  auto q_word = [&](int r, int d) -> uint32_t {
    if (!computes || r >= rows) return 0u;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(q + out_row(r) * HD + d));
    return mma::pack_bf16(f.x * scale, f.y * scale);
  };
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = kk * 16 + 2 * c;
    qf[kk][0] = q_word(r0, d);
    qf[kk][1] = q_word(r1, d);
    qf[kk][2] = q_word(r0, d + 8);
    qf[kk][3] = q_word(r1, d + 8);
  }
  const int qp0 = off + r0 / grp, qp1 = off + r1 / grp;

  // the row offsets of tile x of the run: thread j < kTK reads key j's page
  // id (page_id), then stores the key's offset (store_offset)
  const int* trow = table + static_cast<size_t>(b) * P;
  auto page_id = [&](int x) -> int {
    const int kp = (t_first + x) * kTK + threadIdx.x;
    return x < n_tiles && kp < len ? __ldg(trow + kp / bs) : -1;
  };
  auto store_offset = [&](int x, int blk) {
    const int kp = (t_first + x) * kTK + threadIdx.x;
    koff[x % kOffSlots][threadIdx.x] =
        static_cast<unsigned>(blk) < static_cast<unsigned>(n_blocks)
            ? ((static_cast<long long>(blk) * bs + kp % bs) * KVH + kvh) * HD
            : -1;
  };
  auto load_tile = [&](int x) {
    KV* kd = kr + (x % kStages) * kTK * kRing;
    KV* vd = vr + (x % kStages) * kTK * kRing;
    const long long* at = koff[x % kOffSlots];
    for (int i = threadIdx.x; i < kTK * CH; i += blockDim.x) {
      const int j = i / CH, ch = i % CH;
      const long long row = at[j];
      const size_t src = row >= 0 ? static_cast<size_t>(row) + ch * EPC : 0;
      mma::cp_async_16(kd + j * kRing + ch * EPC, kpool + src, row >= 0);
      mma::cp_async_16(vd + j * kRing + ch * EPC, vpool + src, row >= 0);
    }
  };
  // int8 pools: thread j < kTK's key's k and v scales of tile x (whose
  // offsets are stored), 0 for no key
  auto scales = [&](int x, float& sk, float& sv) {
    const long long row = koff[x % kOffSlots][threadIdx.x];
    sk = row >= 0 ? __bfloat162float(kscale[row / HD]) : 0.f;
    sv = row >= 0 ? __bfloat162float(vscale[row / HD]) : 0.f;
  };
  // int8 pools: tile x's codes (landed) times their scales, rounded to
  // bf16, into the bf16 tile; eight elements a step
  auto dequant = [&](int x) {
    constexpr int per_kv = kTK * (HD / 8);
    for (int i = threadIdx.x; i < 2 * per_kv; i += blockDim.x) {
      const int kv = i / per_kv, j = (i % per_kv) / (HD / 8);
      const int ch = i % (HD / 8);
      const float s = scl[x & 1][kv][j];
      const int8_t* src = reinterpret_cast<const int8_t*>(kv ? vr : kr) +
                          ((x % kStages) * kTK + j) * kRing + ch * 8;
      const char4 lo = *reinterpret_cast<const char4*>(src);
      const char4 hi = *reinterpret_cast<const char4*>(src + 4);
      uint4 w;
      w.x = mma::pack_bf16(static_cast<float>(lo.x) * s,
                           static_cast<float>(lo.y) * s);
      w.y = mma::pack_bf16(static_cast<float>(lo.z) * s,
                           static_cast<float>(lo.w) * s);
      w.z = mma::pack_bf16(static_cast<float>(hi.x) * s,
                           static_cast<float>(hi.y) * s);
      w.w = mma::pack_bf16(static_cast<float>(hi.z) * s,
                           static_cast<float>(hi.w) * s);
      *reinterpret_cast<uint4*>((kv ? vb : kb) + j * kStride + ch * 8) = w;
    }
  };

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) oacc[i] = 0.f;

  // one tile of the online softmax: S = Q K^T, the mask, the running max
  // and denominators, O rescaled, then O += P V (P rounded to bf16)
  auto tile = [&](int t0, const __nv_bfloat16* kt, const __nv_bfloat16* vt) {
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      kStride +
                                  kk * 16 + (((lane >> 3) & 1) << 3));
        mma::mma_bf16(s + 8 * np, qf[kk], bk[0], bk[1]);
        mma::mma_bf16(s + 8 * np + 4, qf[kk], bk[2], bk[3]);
      }
    // log2 units; past a row's own position (or the row's length) -inf.
    // Only a tile that reaches past the first query's position, or past
    // the row's length, has a mask.
    const bool edge = t0 + kTK - 1 > off || t0 + kTK > len;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * kLog2e;
        if (edge) {
          const int kp = t0 + j * 8 + 2 * c + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp > qp || kp >= len) x = -INFINITY;
        }
        s[4 * j + e] = x;
      }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    mx0 = fmaxf(m0, mx0);
    mx1 = fmaxf(m1, mx1);
    // a row with no visible key yet keeps probabilities and factors at 0
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float corr0 = ex2(m0 - base0), corr1 = ex2(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[4 * j] = ex2(s[4 * j] - base0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - base0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - base1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - base1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[4 * n] *= corr0;
      oacc[4 * n + 1] *= corr0;
      oacc[4 * n + 2] *= corr1;
      oacc[4 * n + 3] *= corr1;
    }
    // the A fragments of P for n-tiles 2kk, 2kk + 1, then O += P V
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = mma::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(
            bv, vt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                         kStride +
                    np * 16 + ((lane >> 4) << 3));
        mma::mma_bf16(oacc + 8 * np, pa, bv[0], bv[1]);
        mma::mma_bf16(oacc + 8 * np + 4, pa, bv[2], bv[3]);
      }
    }
  };

  if (threadIdx.x < kTK)
#pragma unroll
    for (int x = 0; x < kStages; ++x) store_offset(x, page_id(x));
  __syncthreads();
  if constexpr (kInt8) {
    // tile 0's scales (tile x + 1's are read while tile x is in use)
    if (threadIdx.x < kTK)
      scales(0, scl[0][0][threadIdx.x], scl[0][1][threadIdx.x]);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    mma::cp_async_wait<kStages - 2>();
    // tile `it` landed; every warp is done with tile it - 1; the offsets
    // of tile it + kStages - 1 (and, int8, tile it's scales) are stored
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    mma::cp_async_commit();
    // the page ids of tile it + kStages, read now and stored after this
    // tile's products (their slot's last copies were issued at it - 3)
    const int ahead = threadIdx.x < kTK ? page_id(it + kStages) : -1;
    const int t0 = (t_first + it) * kTK;
    if constexpr (kInt8) {
      // tile it + 1's scales, read now and stored after this tile's
      // products (their slot was last read by tile it - 1's dequant)
      float nk = 0.f, nv = 0.f;
      if (threadIdx.x < kTK) scales(it + 1, nk, nv);
      dequant(it);
      __syncthreads();
      if (computes) tile(t0, kb, vb);
      if (threadIdx.x < kTK) {
        store_offset(it + kStages, ahead);
        scl[(it + 1) & 1][0][threadIdx.x] = nk;
        scl[(it + 1) & 1][1][threadIdx.x] = nv;
      }
    } else {
      if (computes)
        tile(t0, kb + (it % kStages) * kTK * kStride,
             vb + (it % kStages) * kTK * kStride);
      if (threadIdx.x < kTK) store_offset(it + kStages, ahead);
    }
  }
  if (!computes) return;
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  if (nsplit == 1) {
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * c;
      if (r0 < rows)
        *reinterpret_cast<uint32_t*>(o + out_row(r0) * HD + d) =
            mma::pack_bf16(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
      if (r1 < rows)
        *reinterpret_cast<uint32_t*>(o + out_row(r1) * HD + d) =
            mma::pack_bf16(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
    }
    return;
  }
  const size_t plane = static_cast<size_t>(split) * B * Tq * H;
  if (c == 0) {
    if (r0 < rows)
      reinterpret_cast<float2*>(ml)[plane + out_row(r0)] = make_float2(m0, l0);
    if (r1 < rows)
      reinterpret_cast<float2*>(ml)[plane + out_row(r1)] = make_float2(m1, l1);
  }
  if (n_tiles == 0) return;  // the combine reads no output of an empty run
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < rows)
      *reinterpret_cast<float2*>(o_part + (plane + out_row(r0)) * HD + d) =
          make_float2(oacc[4 * n], oacc[4 * n + 1]);
    if (r1 < rows)
      *reinterpret_cast<float2*>(o_part + (plane + out_row(r1)) * HD + d) =
          make_float2(oacc[4 * n + 2], oacc[4 * n + 3]);
  }
}

// fp32 queries over an fp32 pool, or an int8 pool with bf16 scales: the
// arguments of paged_attn with KV = float or int8_t and any hd <= 128.
// Grid (splits, KVH * mgroups, B), mgroups = ceil(grp * Tq / 16); block
// kSimtWarps * 32.
template <typename KV>
__global__ void __launch_bounds__(kSimtWarps * 32)
    paged_attn_f32(const float* __restrict__ q, const KV* __restrict__ kpool,
                   const KV* __restrict__ vpool,
                   const __nv_bfloat16* __restrict__ kscale,
                   const __nv_bfloat16* __restrict__ vscale,
                   const int* __restrict__ table,
                   const int* __restrict__ q_offset, float* __restrict__ o,
                   float* __restrict__ o_part, float* __restrict__ ml, int Tq,
                   int H, int KVH, int hd, int n_blocks, int bs, int P,
                   int mgroups, int min_run, float scale) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int kRows = kSimtRows / kSimtWarps;  // query rows a warp
  constexpr int kDims = kMaxHd / 32;             // head dims a lane
  __shared__ float qs[kSimtRows][kMaxHd];
  __shared__ float ks[kTK][kMaxHd + 1];
  __shared__ float vs[kTK][kMaxHd];
  __shared__ long long koff[kTK];
  __shared__ float ksc[kTK], vsc[kTK];

  const int nsplit = gridDim.x, split = blockIdx.x;
  const int kvh = blockIdx.y / mgroups, mg = blockIdx.y % mgroups;
  const int b = blockIdx.z, B = gridDim.z;
  const int grp = H / KVH, rows = grp * Tq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int off = q_offset[b];
  const int len = max(0, min(off + Tq, P * bs));
  const int ntiles = (len + kTK - 1) / kTK;
  const int per = max((ntiles + nsplit - 1) / nsplit, min_run);
  const int t_first = split * per;
  const int n_tiles = max(0, min(t_first + per, ntiles) - t_first);

  auto out_row = [&](int r) -> size_t {
    return (static_cast<size_t>(b) * Tq + r / grp) * H + kvh * grp + r % grp;
  };

  // q * hd^-0.5 in fp32, as the plain version scales it
  for (int i = threadIdx.x; i < kSimtRows * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, R = mg * kSimtRows + r;
    qs[r][d] = R < rows ? q[out_row(R) * hd + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  const int* trow = table + static_cast<size_t>(b) * P;
  for (int x = 0; x < n_tiles; ++x) {
    const int t0 = (t_first + x) * kTK;
    __syncthreads();  // every warp is done with the last tile
    if (threadIdx.x < kTK) {
      const int kp = t0 + threadIdx.x;
      const int blk = kp < len ? __ldg(trow + kp / bs) : -1;
      const long long row =
          static_cast<unsigned>(blk) < static_cast<unsigned>(n_blocks)
              ? ((static_cast<long long>(blk) * bs + kp % bs) * KVH + kvh) * hd
              : -1;
      koff[threadIdx.x] = row;
      if constexpr (kInt8) {
        ksc[threadIdx.x] = row >= 0 ? __bfloat162float(kscale[row / hd]) : 0.f;
        vsc[threadIdx.x] = row >= 0 ? __bfloat162float(vscale[row / hd]) : 0.f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd;
      const long long row = koff[j];
      float kx = row >= 0 ? to_f(kpool[row + d]) : 0.f;
      float vx = row >= 0 ? to_f(vpool[row + d]) : 0.f;
      if constexpr (kInt8) {
        kx *= ksc[j];
        vx *= vsc[j];
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i, R = mg * kSimtRows + r;
      if (R >= rows) continue;  // warp-uniform
      const int qp = off + R / grp, kp = t0 + lane;
      float sc = 0.f;
      for (int d = 0; d < hd; ++d) sc = fmaf(qs[r][d], ks[lane][d], sc);
      if (kp > qp || kp >= len) sc = -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sc));
      // a row with no visible key yet keeps probabilities and factors at 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(sc - base);
      const float corr = expf(m[i] - base);
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= corr;
#pragma unroll 8
      for (int j = 0; j < kTK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < kDims; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) acc[i][e] = fmaf(pj, vs[j][d], acc[i][e]);
        }
      }
      m[i] = m_new;
    }
  }

  const size_t plane = static_cast<size_t>(split) * B * Tq * H;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int R = mg * kSimtRows + warp * kRows + i;
    if (R >= rows) continue;
    const size_t orow = out_row(R);
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) o[orow * hd + d] = acc[i][e] * inv;
      }
      continue;
    }
    // the combine's statistics: the running max in log2 units
    if (lane == 0)
      reinterpret_cast<float2*>(ml)[plane + orow] =
          make_float2(m[i] * kLog2e, l[i]);
    if (n_tiles == 0) continue;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o_part[(plane + orow) * hd + d] = acc[i][e];
    }
  }
}

// Merges the splits of each output row (one warp a row, four a block):
// lane s holds split s's weight 2^(m_s - max m), a split with an empty
// denominator weighs 0 and its output is not read; the sums run over the
// splits in order. T is the output's type.
template <typename T>
__global__ void __launch_bounds__(128)
    paged_attn_combine(const float* __restrict__ o_part,
                       const float* __restrict__ ml, T* __restrict__ o,
                       int n_rows, int hd, int nsplit) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform
  float m = -INFINITY, l = 0.f;
  if (lane < nsplit) {
    const float2 st = reinterpret_cast<const float2*>(
        ml)[static_cast<size_t>(lane) * n_rows + row];
    if (st.y > 0.f) m = st.x, l = st.y;
  }
  float mx = m;
#pragma unroll
  for (int x = 16; x >= 1; x >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  const float w = l > 0.f ? ex2(m - mx) : 0.f;
  float den = w * l;
#pragma unroll
  for (int x = 16; x >= 1; x >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, x);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d0 = 0; d0 < hd; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ws = __shfl_sync(0xffffffffu, w, s);
      if (ws > 0.f && d < hd)
        acc += ws * o_part[(static_cast<size_t>(s) * n_rows + row) * hd + d];
    }
    if (d < hd) store_out(o + static_cast<size_t>(row) * hd + d, acc * inv);
  }
}

// the split-merging launch after either kernel (nothing with one split)
template <typename T>
cudaError_t combine(cudaError_t err, float* o_part, float* ml, void* o,
                    int n_rows, int hd, int nsplit, cudaStream_t st) {
  if (err != cudaSuccess || nsplit == 1) return err;
  paged_attn_combine<T><<<(n_rows + 3) / 4, 128, 0, st>>>(
      o_part, ml, static_cast<T*>(o), n_rows, hd, nsplit);
  return cudaGetLastError();
}

template <int HD, bool kInt8>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* ksc, const void* vsc, const int* table,
                      const int* q_offset, void* o, float* o_part, float* ml,
                      int B, int Tq, int H, int KVH, int n_blocks, int bs,
                      int P, int nsplit, int mgroups, int min_run, int warps,
                      float scale, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD, kInt8>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn<HD, kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(nsplit, KVH * mgroups, B);
  paged_attn<HD, kInt8><<<grid, warps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const __nv_bfloat16*>(ksc),
      static_cast<const __nv_bfloat16*>(vsc), table, q_offset,
      static_cast<__nv_bfloat16*>(o), o_part, ml, Tq, H, KVH, n_blocks, bs, P,
      mgroups, min_run, scale);
  return combine<__nv_bfloat16>(cudaGetLastError(), o_part, ml, o,
                                B * Tq * H, HD, nsplit, st);
}

template <typename KV>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* ksc, const void* vsc, const int* table,
                        const int* q_offset, void* o, float* o_part,
                        float* ml, int B, int Tq, int H, int KVH, int hd,
                        int n_blocks, int bs, int P, int nsplit, int mgroups,
                        int min_run, float scale, cudaStream_t st) {
  const dim3 grid(nsplit, KVH * mgroups, B);
  paged_attn_f32<KV><<<grid, kSimtWarps * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const __nv_bfloat16*>(ksc),
      static_cast<const __nv_bfloat16*>(vsc), table, q_offset,
      static_cast<float*>(o), o_part, ml, Tq, H, KVH, hd, n_blocks, bs, P,
      mgroups, min_run, scale);
  return combine<float>(cudaGetLastError(), o_part, ml, o, B * Tq * H, hd,
                        nsplit, st);
}

template <bool kInt8>
cudaError_t launch_tc_hd(int hd, const void* q, const void* k, const void* v,
                         const void* ksc, const void* vsc, const int* tb,
                         const int* qo, void* o, float* op, float* mlp, int B,
                         int Tq, int H, int KVH, int n_blocks, int bs, int P,
                         int nsplit, int mgroups, int min_run, int warps,
                         float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch_tc<64, kInt8>(q, k, v, ksc, vsc, tb, qo, o, op, mlp, B, Tq, H, KVH, n_blocks, bs, P, nsplit, mgroups, min_run, warps, scale, st);
    case 80: return launch_tc<80, kInt8>(q, k, v, ksc, vsc, tb, qo, o, op, mlp, B, Tq, H, KVH, n_blocks, bs, P, nsplit, mgroups, min_run, warps, scale, st);
    case 128: return launch_tc<128, kInt8>(q, k, v, ksc, vsc, tb, qo, o, op, mlp, B, Tq, H, KVH, n_blocks, bs, P, nsplit, mgroups, min_run, warps, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Tq, H, hd], o [B, Tq, H, hd]: bf16 (q_type 0) or fp32 (q_type 1);
// k/v pools [n_blocks, bs, KVH, hd] of q's type (kv_type 0) or int8 codes
// (kv_type 1) with bf16 scales k_scale / v_scale [n_blocks, bs, KVH] (else
// null); all contiguous and 16-byte aligned; table [B, P] and q_offset [B]:
// contiguous int32; hd 64, 80 or 128; H % KVH == 0. nsplit (1..32),
// mgroups (bf16: row groups of at most 8 m-tiles each; fp32: ceil(grp * Tq
// / 16)) and min_run (tiles a split's run takes at least, >= 1) as
// paged_attention.py::plan gives them; with nsplit > 1 the fp32 scratch
// o_part [nsplit, B, Tq, H, hd] and ml [nsplit, B, Tq, H, 2]. Launches on
// `stream` (two launches with nsplit > 1) and returns the CUDA error code
// (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* q_offset, void* o,
    void* o_part, void* ml, int B, int Tq, int H, int KVH, int hd,
    int n_blocks, int bs, int P, int nsplit, int mgroups, int min_run,
    int q_type, int kv_type, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      n_blocks <= 0 || bs <= 0 || P <= 0 || nsplit < 1 ||
      nsplit > kMaxSplits || mgroups < 1 || min_run < 1 ||
      (hd != 64 && hd != 80 && hd != 128) || (q_type != 0 && q_type != 1) ||
      (kv_type != 0 && kv_type != 1) ||
      (kv_type == 1 && (k_scale == nullptr || v_scale == nullptr)) ||
      (nsplit > 1 && (o_part == nullptr || ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (H / KVH) * Tq;
  const int mtiles = (rows + 15) / 16;
  const int warps = (mtiles + mgroups - 1) / mgroups;
  if (q_type == 0 ? warps > kMaxWarps
                  : mgroups != (rows + kSimtRows - 1) / kSimtRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* qo = static_cast<const int*>(q_offset);
  float* op = static_cast<float*>(o_part);
  float* mlp = static_cast<float*>(ml);
  cudaError_t err;
  if (q_type == 1)
    err = kv_type == 1
              ? launch_simt<int8_t>(q, k, v, k_scale, v_scale, tb, qo, o, op,
                                    mlp, B, Tq, H, KVH, hd, n_blocks, bs, P,
                                    nsplit, mgroups, min_run, scale, st)
              : launch_simt<float>(q, k, v, k_scale, v_scale, tb, qo, o, op,
                                   mlp, B, Tq, H, KVH, hd, n_blocks, bs, P,
                                   nsplit, mgroups, min_run, scale, st);
  else
    err = kv_type == 1
              ? launch_tc_hd<true>(hd, q, k, v, k_scale, v_scale, tb, qo, o,
                                   op, mlp, B, Tq, H, KVH, n_blocks, bs, P,
                                   nsplit, mgroups, min_run, warps, scale, st)
              : launch_tc_hd<false>(hd, q, k, v, k_scale, v_scale, tb, qo, o,
                                    op, mlp, B, Tq, H, KVH, n_blocks, bs, P,
                                    nsplit, mgroups, min_run, warps, scale,
                                    st);
  return static_cast<int>(err);
}
