// The paged read of multi-head latent attention (MLA, DeepSeek-V2) for
// Hopper (sm_90a): the decode round (one query a row) and the chunked
// prefill (one block-sized chunk of queries a row), read in place from the
// paged latent pool. bf16 on the tensor cores, fp32 on the CUDA cores.
//
// Replaces no TPU kernel (the JAX package has no MLA). Its plain version is
// models/mla.py::gathered_mla: the pool's pages gathered whole, then
// latent_attention.
//
// Semantics (those of the plain version): the pool holds one row of kD =
// 576 values a position, [c (512); roped k_pe (64)], shared by the kH = 16
// heads. q [B, Tq, 16, 576] is each head's absorbed query (q_nope W_kvb_k^T,
// then q_pe). Query t of row b (absolute position q_offset[b] + t) attends
// causally to positions 0 .. q_offset[b] + t of its row; position p lies in
// physical block table[b, p / bs] at offset p % bs. The score is q . row
// times `scale`; the values are the row's first kDV = 512 entries. q is
// scaled and rounded to bf16, QK^T sums exact bf16 products in fp32, the
// softmax runs in fp32, P is rounded to bf16 before PV, which sums in fp32,
// and the output is bf16. fp32 rounds nothing.
//
// What bounds it on the H100: a decode round reads 1152 bytes a key for
// 16 * 2 * (576 + 512) = 34,816 flops, 30 flops a byte: bytes. A chunk of
// 16 queries does 16 times the flops on the same bytes: the tensor cores.
//
// Design:
// * Grid (query-token groups, splits, B), from static shapes only, so that
//   a captured CUDA graph stays valid for any lengths and tables; the token
//   groups of one (row, split) are neighbours in launch order, so their
//   copies of the same latent tiles meet in L2. A block reads its row's
//   length from q_offset on the device, cuts the row's live 32-key tiles
//   into `splits` equal runs of at least min_run tiles and walks its own.
// * A query token's 16 heads are one 16-row m-tile of mma.sync m16n8k16
//   (bf16, fp32 accumulate). Four warps serve an m-tile: for QK^T each
//   takes a quarter of the row's 576 dims (9 k-steps, its q fragments held
//   in registers for the whole run) and writes its partial scores to
//   shared memory; after a block barrier each sums the four quarters in a
//   fixed order (so the four agree bit for bit), runs the online softmax
//   and, for PV, takes a quarter of the 512 value dims. So each tile's rows
//   are read from shared memory once for QK^T and once for PV, by all 16
//   heads at once. A block holds one token (decode: four warps) or two
//   (a chunk: eight warps).
// * Tiles of 32 latent rows arrive by 16-byte cp.async copies into a
//   3-stage ring of rows padded by 16 bytes (ldmatrix without bank
//   conflicts; V through ldmatrix.trans from the same rows). The row
//   offsets of a tile's keys are read from the page table an iteration
//   before its copies are issued. Keys past the row's length arrive as
//   zeros and are masked; a page id outside the pool reads as zeros.
// * A split writes its partial output and statistics (fp32), and
//   paged_mla_combine merges the splits in a fixed order (no atomics, the
//   same bits on every run); with one split the block writes its output.
//
// paged_mla_f32 (fp32): one block (four warps, four heads each) a (token,
// split, row); q and each 32-key tile in shared memory as fp32, one key a
// lane for the scores (a warp's four heads together, so each key element
// is read once for four products), the warp reducing max and sum by
// shuffles, and each value element read once for the four heads' sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kH = 16;          // heads: one m-tile a query token
constexpr int kD = 576;         // a latent row
constexpr int kDV = 512;        // its value entries
constexpr int kTK = 32;         // keys per tile
constexpr int kStages = 3;      // tiles in the shared-memory ring
constexpr int kOffSlots = kStages + 1;  // tiles whose row offsets are held
constexpr int kKQ = 4;          // warps an m-tile
constexpr int kMaxMT = 2;       // m-tiles (query tokens) a block
constexpr int kMaxSplits = 32;  // splits of a row (the combine's lanes)
constexpr int kStride = kD + 8; // padded ring row, bf16 elements
constexpr int kKS = kD / 16 / kKQ;  // k-steps of a warp's quarter of QK^T
constexpr int kNO = kDV / kKQ / 8;  // n-tiles of a warp's quarter of O
constexpr int kNS = kTK / 8;        // n-tiles of a score tile
constexpr int kSp = kTK + 8;        // floats a row of a partial score plane
constexpr int kSimtWarps = 4;       // paged_mla_f32: warps a block
constexpr int kSimtStride = kD + 1; // paged_mla_f32: floats a tile row
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kD % (16 * kKQ) == 0 && kDV % (16 * kKQ) == 0, "quarters");

// 2^x on the special function unit (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// dynamic shared memory of paged_mla: the ring, then mt * kKQ partial
// score planes of 16 rows
__host__ __device__ constexpr int smem_tc(int mt) {
  return kStages * kTK * kStride * 2 + mt * kKQ * 16 * kSp * 4;
}
constexpr int kSmemF32 = 4 * (kH * kD + kTK * kSimtStride);

// q [B, Tq, kH, kD] bf16; pool [n_blocks, bs, kD] bf16; table [B, P]
// int32; q_offset [B] int32; o [B, Tq, kH, kDV] (one split) or o_part
// [splits, B, Tq, kH, kDV] fp32 and ml [splits, B, Tq, kH, 2] fp32 (the
// running max in log2 units and the denominator). Block kKQ * mt * 32.
__global__ void __launch_bounds__(kKQ * kMaxMT * 32)
    paged_mla(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ pool,
              const int* __restrict__ table, const int* __restrict__ q_offset,
              __nv_bfloat16* __restrict__ o, float* __restrict__ o_part,
              float* __restrict__ ml, int Tq, int n_blocks, int bs, int P,
              int mt, int min_run, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sp = reinterpret_cast<float*>(ring + kStages * kTK * kStride);
  // element offset of each key's row in the pool (-1: no key), by tile
  __shared__ long long koff[kOffSlots][kTK];

  const int mg = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = blockIdx.z, B = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp / kKQ;  // the warp's token in the block
  const int wq = warp % kKQ;  // its quarter of the dims (QK^T), values (PV)
  const int t = mg * mt + wm;
  const bool computes = t < Tq;  // warp-uniform

  // this block's run of key tiles, from the row's length
  const int off = q_offset[b];
  const int len = max(0, min(off + Tq, P * bs));  // keys the last query sees
  const int ntiles = (len + kTK - 1) / kTK;
  const int per = max((ntiles + nsplit - 1) / nsplit, min_run);
  const int t_first = split * per;
  const int n_tiles = max(0, min(t_first + per, ntiles) - t_first);
  const int qp = off + t;  // the token's position: both rows' (two heads)
  const size_t orow = (static_cast<size_t>(b) * Tq + t) * kH;  // head 0

  // Q fragments (the mma A operand) of heads g and g + 8 over this warp's
  // quarter of the dims, scaled and rounded to bf16 as the plain version's
  // q * scale
  uint32_t qf[kKS][4];
  auto q_word = [&](int h, int d) -> uint32_t {
    if (!computes) return 0u;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(q + (orow + h) * kD + d));
    return mma::pack_bf16(f.x * scale, f.y * scale);
  };
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const int d = (wq * kKS + kk) * 16 + 2 * c;
    qf[kk][0] = q_word(g, d);
    qf[kk][1] = q_word(g + 8, d);
    qf[kk][2] = q_word(g, d + 8);
    qf[kk][3] = q_word(g + 8, d + 8);
  }

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
            ? (static_cast<long long>(blk) * bs + kp % bs) * kD
            : -1;
  };
  constexpr int CH = kD / 8;  // 16-byte chunks a row
  auto load_tile = [&](int x) {
    __nv_bfloat16* dst = ring + (x % kStages) * kTK * kStride;
    const long long* at = koff[x % kOffSlots];
    for (int i = threadIdx.x; i < kTK * CH; i += blockDim.x) {
      const int j = i / CH, ch = i % CH;
      const long long row = at[j];
      const size_t src = row >= 0 ? static_cast<size_t>(row) + ch * 8 : 0;
      mma::cp_async_16(dst + j * kStride + ch * 8, pool + src, row >= 0);
    }
  };

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[kNO * 4];
#pragma unroll
  for (int i = 0; i < kNO * 4; ++i) oacc[i] = 0.f;
  float* planes = sp + wm * kKQ * 16 * kSp;  // the token's kKQ planes

  // this warp's quarter of S = Q K^T over tile kt, into its plane
  auto partial_scores = [&](const __nv_bfloat16* kt) {
    float s[kNS * 4];
#pragma unroll
    for (int i = 0; i < kNS * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const int dk = (wq * kKS + kk) * 16;
#pragma unroll
      for (int np = 0; np < kNS / 2; ++np) {
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      kStride +
                                  dk + (((lane >> 3) & 1) << 3));
        mma::mma_bf16(s + 8 * np, qf[kk], bk[0], bk[1]);
        mma::mma_bf16(s + 8 * np + 4, qf[kk], bk[2], bk[3]);
      }
    }
    float* pl = planes + wq * 16 * kSp;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const int col = j * 8 + 2 * c;
      *reinterpret_cast<float2*>(pl + g * kSp + col) =
          make_float2(s[4 * j], s[4 * j + 1]);
      *reinterpret_cast<float2*>(pl + (g + 8) * kSp + col) =
          make_float2(s[4 * j + 2], s[4 * j + 3]);
    }
  };

  // the four quarters summed in order, the mask, the online softmax, then
  // O += P V over this warp's quarter of the values (P rounded to bf16)
  auto softmax_pv = [&](int t0, const __nv_bfloat16* kt) {
    float s[kNS * 4];
#pragma unroll
    for (int i = 0; i < kNS * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kKQ; ++k) {
      const float* pl = planes + k * 16 * kSp;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const int col = j * 8 + 2 * c;
        const float2 a = *reinterpret_cast<const float2*>(pl + g * kSp + col);
        const float2 e =
            *reinterpret_cast<const float2*>(pl + (g + 8) * kSp + col);
        s[4 * j] += a.x;
        s[4 * j + 1] += a.y;
        s[4 * j + 2] += e.x;
        s[4 * j + 3] += e.y;
      }
    }
    // log2 units; past the token's position (or the row's length) -inf.
    const bool edge = t0 + kTK - 1 > qp || t0 + kTK > len;
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * kLog2e;
        if (edge) {
          const int kp = t0 + j * 8 + 2 * c + (e & 1);
          if (kp > qp || kp >= len) x = -INFINITY;
        }
        s[4 * j + e] = x;
      }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
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
    for (int j = 0; j < kNS; ++j) {
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
    for (int n = 0; n < kNO; ++n) {
      oacc[4 * n] *= corr0;
      oacc[4 * n + 1] *= corr0;
      oacc[4 * n + 2] *= corr1;
      oacc[4 * n + 3] *= corr1;
    }
    const __nv_bfloat16* vt = kt + wq * (kDV / kKQ);
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = mma::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
#pragma unroll
      for (int np = 0; np < kNO / 2; ++np) {
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
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    mma::cp_async_wait<kStages - 2>();
    // tile `it` landed; every warp is done with tile it - 1 and with the
    // score planes; the offsets of tile it + kStages - 1 are stored
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    mma::cp_async_commit();
    // the page ids of tile it + kStages, read now and stored after this
    // tile's products (their slot's last copies were issued at it - 3)
    const int ahead = threadIdx.x < kTK ? page_id(it + kStages) : -1;
    const __nv_bfloat16* kt = ring + (it % kStages) * kTK * kStride;
    if (computes) partial_scores(kt);
    __syncthreads();  // every quarter's partial scores are in
    if (computes) softmax_pv((t_first + it) * kTK, kt);
    if (threadIdx.x < kTK) store_offset(it + kStages, ahead);
  }
  if (!computes) return;
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int d0 = wq * (kDV / kKQ);
  if (nsplit == 1) {
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      const int d = d0 + n * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(o + (orow + g) * kDV + d) =
          mma::pack_bf16(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(o + (orow + g + 8) * kDV + d) =
          mma::pack_bf16(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
    }
    return;
  }
  const size_t plane = static_cast<size_t>(split) * B * Tq * kH;
  if (c == 0 && wq == 0) {
    reinterpret_cast<float2*>(ml)[plane + orow + g] = make_float2(m0, l0);
    reinterpret_cast<float2*>(ml)[plane + orow + g + 8] = make_float2(m1, l1);
  }
  if (n_tiles == 0) return;  // the combine reads no output of an empty run
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    const int d = d0 + n * 8 + 2 * c;
    *reinterpret_cast<float2*>(o_part + (plane + orow + g) * kDV + d) =
        make_float2(oacc[4 * n], oacc[4 * n + 1]);
    *reinterpret_cast<float2*>(o_part + (plane + orow + g + 8) * kDV + d) =
        make_float2(oacc[4 * n + 2], oacc[4 * n + 3]);
  }
}

// fp32 queries over an fp32 pool: the arguments of paged_mla with fp32
// tensors; grid (Tq, splits, B), block kSimtWarps * 32, dynamic shared
// memory kSmemF32.
__global__ void __launch_bounds__(kSimtWarps * 32)
    paged_mla_f32(const float* __restrict__ q, const float* __restrict__ pool,
                  const int* __restrict__ table,
                  const int* __restrict__ q_offset, float* __restrict__ o,
                  float* __restrict__ o_part, float* __restrict__ ml, int Tq,
                  int n_blocks, int bs, int P, int min_run, float scale) {
  constexpr int kRows = kH / kSimtWarps;  // heads a warp
  constexpr int kDims = kDV / 32;         // value entries a lane
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;              // [kH][kD]: q * scale
  float* ks = fsm + kH * kD;    // [kTK][kSimtStride]
  __shared__ long long koff[kTK];

  const int t = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = blockIdx.z, B = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int off = q_offset[b];
  const int len = max(0, min(off + Tq, P * bs));
  const int ntiles = (len + kTK - 1) / kTK;
  const int per = max((ntiles + nsplit - 1) / nsplit, min_run);
  const int t_first = split * per;
  const int n_tiles = max(0, min(t_first + per, ntiles) - t_first);
  const int qp = off + t;
  const size_t orow = (static_cast<size_t>(b) * Tq + t) * kH;

  for (int i = threadIdx.x; i < kH * kD; i += blockDim.x)
    qs[i] = q[orow * kD + i] * scale;

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
      koff[threadIdx.x] =
          static_cast<unsigned>(blk) < static_cast<unsigned>(n_blocks)
              ? (static_cast<long long>(blk) * bs + kp % bs) * kD
              : -1;
    }
    __syncthreads();
    constexpr int C4 = kD / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kTK * C4; i += blockDim.x) {
      const int j = i / C4, d = (i % C4) * 4;
      const long long row = koff[j];
      const float4 v = row >= 0
                           ? *reinterpret_cast<const float4*>(pool + row + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      float* dst = ks + j * kSimtStride + d;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
    // the warp's four heads at once: each key element read once for four
    // products, each head's q four elements at a time
    const int kp = t0 + lane;
    const float* kl = ks + lane * kSimtStride;
    const float* qw = qs + warp * kRows * kD;
    float sc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      const float k0 = kl[d], k1 = kl[d + 1], k2 = kl[d + 2], k3 = kl[d + 3];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * kD + d);
        sc[i] = fmaf(qv.x, k0, sc[i]);
        sc[i] = fmaf(qv.y, k1, sc[i]);
        sc[i] = fmaf(qv.z, k2, sc[i]);
        sc[i] = fmaf(qv.w, k3, sc[i]);
      }
    }
    float pr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float x = kp > qp || kp >= len ? -INFINITY : sc[i];
      const float m_new = fmaxf(m[i], warp_max(x));
      // a row with no visible key yet keeps probabilities and factors at 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      pr[i] = expf(x - base);
      const float corr = expf(m[i] - base);
      l[i] = l[i] * corr + warp_sum(pr[i]);
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
#pragma unroll 2
    for (int j = 0; j < kTK; ++j) {
      float pj[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pj[i] = __shfl_sync(0xffffffffu, pr[i], j);
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const float v = ks[j * kSimtStride + lane + 32 * e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][e] = fmaf(pj[i], v, acc[i][e]);
      }
    }
  }

  const size_t plane = static_cast<size_t>(split) * B * Tq * kH;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t r = orow + warp * kRows + i;
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < kDims; ++e) o[r * kDV + lane + 32 * e] = acc[i][e] * inv;
      continue;
    }
    // the combine's statistics: the running max in log2 units
    if (lane == 0)
      reinterpret_cast<float2*>(ml)[plane + r] =
          make_float2(m[i] * kLog2e, l[i]);
    if (n_tiles == 0) continue;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      o_part[(plane + r) * kDV + lane + 32 * e] = acc[i][e];
  }
}

// Merges the splits of each output row (one warp a row, four a block):
// lane s holds split s's weight 2^(m_s - max m), a split with an empty
// denominator weighs 0 and its output is not read; the sums run over the
// splits in order. T is the output's type.
template <typename T>
__global__ void __launch_bounds__(128)
    paged_mla_combine(const float* __restrict__ o_part,
                      const float* __restrict__ ml, T* __restrict__ o,
                      int n_rows, int nsplit) {
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
  for (int d = lane; d < kDV; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ws = __shfl_sync(0xffffffffu, w, s);
      if (ws > 0.f)
        acc += ws * o_part[(static_cast<size_t>(s) * n_rows + row) * kDV + d];
    }
    store_out(o + static_cast<size_t>(row) * kDV + d, acc * inv);
  }
}

template <typename T>
cudaError_t combine(cudaError_t err, float* o_part, float* ml, void* o,
                    int n_rows, int nsplit, cudaStream_t st) {
  if (err != cudaSuccess || nsplit == 1) return err;
  paged_mla_combine<T><<<(n_rows + 3) / 4, 128, 0, st>>>(
      o_part, ml, static_cast<T*>(o), n_rows, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, 16, 576] and o [B, Tq, 16, 512]: bf16 (q_type 0) or fp32
// (q_type 1); pool [n_blocks, bs, 576] of q's type; all contiguous and
// 16-byte aligned; table [B, P] and q_offset [B]: contiguous int32. nsplit
// (1..32), mt (bf16: query tokens a block, 1 or 2; fp32: 1) and min_run
// (>= 1) as paged_mla.py::plan gives them; with nsplit > 1 the fp32
// scratch o_part [nsplit, B, Tq, 16, 512] and ml [nsplit, B, Tq, 16, 2].
// Launches on `stream` (two launches with nsplit > 1) and returns the CUDA
// error code (0 = success).
extern "C" int paged_mla_launch(const void* q, const void* pool,
                                const void* table, const void* q_offset,
                                void* o, void* o_part, void* ml, int B, int Tq,
                                int n_blocks, int bs, int P, int nsplit,
                                int mt, int min_run, int q_type, float scale,
                                void* stream) {
  if (B <= 0 || Tq <= 0 || n_blocks <= 0 || bs <= 0 || P <= 0 ||
      nsplit < 1 || nsplit > kMaxSplits || min_run < 1 ||
      (q_type != 0 && q_type != 1) || mt < 1 ||
      mt > (q_type == 0 ? kMaxMT : 1) ||
      (nsplit > 1 && (o_part == nullptr || ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* qo = static_cast<const int*>(q_offset);
  float* op = static_cast<float*>(o_part);
  float* mlp = static_cast<float*>(ml);
  const int n_rows = B * Tq * kH;
  if (q_type == 1) {
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_mla_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemF32);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    const dim3 grid(Tq, nsplit, B);
    paged_mla_f32<<<grid, kSimtWarps * 32, kSmemF32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool), tb, qo,
        static_cast<float*>(o), op, mlp, Tq, n_blocks, bs, P, min_run, scale);
    return static_cast<int>(
        combine<float>(cudaGetLastError(), op, mlp, o, n_rows, nsplit, st));
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(paged_mla, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_tc(kMaxMT));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Tq + mt - 1) / mt, nsplit, B);
  paged_mla<<<grid, kKQ * mt * 32, smem_tc(mt), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool), tb, qo,
      static_cast<__nv_bfloat16*>(o), op, mlp, Tq, n_blocks, bs, P, mt,
      min_run, scale);
  return static_cast<int>(
      combine<__nv_bfloat16>(cudaGetLastError(), op, mlp, o, n_rows, nsplit,
                             st));
}
