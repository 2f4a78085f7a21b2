// Causal / sliding-window flash attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (one-pass online
// softmax, key window (q - window, q], scale hd^-0.5, masked score -1e30,
// denominator clamped at 1e-30, fp32 running max / denominator /
// accumulator, fully masked KV blocks skipped) together with the GQA repeat
// of its wrapper (src/repro/kernels/ops.py::flash_attention).
//
// What bounds it on the H100: at serving prefill shapes (hd = 128, a few
// hundred tokens) the work is small: 4 * T^2 * hd flops per (batch, head)
// under the causal mask and one read of q, k, v. The kernel is bound by
// latency and by issue rate on the CUDA cores, not by device memory.
//
// What the design does about it:
// * One block per (batch * head, 16-query tile); its 4 warps own 4 query
//   rows each, so a 200-token prompt at 32 heads and batch 2 gives 832
//   blocks, enough to fill the 132 SMs.
// * Keys go through shared memory in tiles of 32, one key per lane: a lane
//   scores its key against the query row (q row broadcast from shared
//   memory, the key row padded by one float so the 32 lanes hit 32 banks),
//   the warp reduces max and sum with shuffles, and the p @ v update
//   broadcasts each lane's probability to the lanes that own the head dims.
// * The KV head is h / (H / KVH), read in place: the repeated KV the TPU
//   wrapper builds never exists.
// * Tiles wholly outside the causal frontier or the window are never
//   loaded; ragged sequence ends are masked, so any length works.
// * As on the TPU, p is rounded to the value type before the p @ v product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Contiguous q [B, Tq, H, hd],
// k/v [B, Tk, KVH, hd], o [B, Tq, H, hd] on the device; hd <= 128,
// H % KVH == 0. Returns the CUDA error code of the launch (0 = success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int Tq,
                                      int Tk, int H, int KVH, int hd,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KVH <= 0 || hd <= 0 ||
      hd > kMaxHd || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
