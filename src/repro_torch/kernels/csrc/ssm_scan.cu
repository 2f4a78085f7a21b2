// Mamba-1 selective scan for Hopper (sm_90a), forward and backward, fp32 and
// bf16 inputs, all arithmetic in fp32.
//
// Forward: replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan.py::ssm_scan. Per channel c of batch row b,
// with u_t = dt_t * x_t and a_t = exp(dt_t * A[c]):
//   h_t = a_t * h_{t-1} + u_t * B_t,   y_t = <h_t, C_t> + D[c] * x_t.
// The fp32 state [N] never leaves the registers, so the [B, T, d, N]
// trajectory is never stored. When the caller needs a gradient the kernel
// also writes the state at the start of every kChunk-step chunk to a
// [B, ceil(T / kChunk), d, N] fp32 scratch (the checkpoints).
//
// Backward: the Pallas kernel has none (jax.grad through the pallas_call
// fails), so this one has no TPU counterpart. It walks each chunk in
// reverse, recomputing the chunk's states from its checkpoint, and runs the
// adjoint recurrence with g_t = dL/dh_t:
//   g_t   = dy_t * C_t + a_{t+1} * g_{t+1}
//   dC_t  = sum_c dy_t * h_t          dB_t = sum_c g_t * u_t
//   du_t  = <g_t, B_t>                q_t  = g_t * h_{t-1} * a_t
//   ddt_t = <q_t, A[c]> + du_t * x_t  dx_t = du_t * dt_t + D[c] * dy_t
//   dA[c] = sum_{b,t} q_t * dt_t      dD[c] = sum_{b,t} dy_t * x_t
// dB and dC sum over channels, which live in different blocks: each block
// writes its own partial sums (a [B, blocks, T, 2 * kMaxN] fp32 scratch) and
// the wrapper adds them with one torch.sum, so every run gives the same bits
// (no float atomics). dA and dD are written per batch row and summed the
// same way.
//
// What bounds it on the H100: per (b, t, c, n) one exp on the SFU and a few
// FMAs; per (b, t, c) a few bytes in and out. At the training shapes
// (B = 2, T = 2048, d = 8192, N = 16) the exp count over the SFU rate and
// the bytes over the memory rate are both about 0.13 ms, but the recurrence
// is sequential in T and one thread owns one (b, c): 16,384 threads, about
// four warps per SM, so the kernels are bound by latency, not by either.
//
// What the design does about it (simple first; splitting N across lanes and
// reducing y_t with shuffles is the next step):
// * One thread per (batch row, channel), kThreads channels per block, any d
//   and any T (ragged ends are masked; states of N < kMaxN are padded with
//   A = 0, B = C = 0, which keeps them at 0).
// * The chunk's B_t and C_t (shared by every channel) are staged in shared
//   memory; x, dt, dy, y, dx, ddt are read and written coalesced across the
//   block's channels.
// * Backward memory: the states of a kChunk-step chunk would need 4 KB per
//   thread. A first pass from the checkpoint keeps only every kSub-th state
//   in shared memory; each kSub-step piece is then recomputed into shared
//   memory and walked in reverse. Cost: two extra forward passes, no extra
//   device memory.
// * The per-step channel sums of dB and dC reduce 2 * kMaxN = 32 values over
//   the 32 lanes of a warp with 31 shuffles (a transposing butterfly: lane
//   L ends with the sum of value L), then over the block's warps in shared
//   memory in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 16;     // largest state size: 2 * kMaxN = 32 lanes
constexpr int kChunk = 64;    // forward checkpoint interval (steps)
constexpr int kSub = 8;       // backward recompute piece (steps)
constexpr int kNSub = kChunk / kSub;

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

// Stage B_t and C_t of one chunk (steps t0 .. t0 + len - 1) into shared
// memory, zero-padded past len and past N.
template <typename T>
__device__ __forceinline__ void load_bc(float (*sB)[kMaxN],
                                        float (*sC)[kMaxN],
                                        const T* __restrict__ Bm,
                                        const T* __restrict__ Cm, int b,
                                        int t0, int len, int L, int N) {
  for (int e = threadIdx.x; e < kChunk * kMaxN; e += kThreads) {
    const int i = e / kMaxN, n = e % kMaxN;
    const bool ok = i < len && n < N;
    const size_t off = ((size_t)b * L + t0 + i) * N + n;
    sB[i][n] = ok ? to_f(Bm[off]) : 0.f;
    sC[i][n] = ok ? to_f(Cm[off]) : 0.f;
  }
}

// One forward step of the recurrence (shared by both kernels, so the
// backward recomputes exactly the forward's states).
__device__ __forceinline__ void step(float (&h)[kMaxN], const float (&Ar)[kMaxN],
                                     const float* sBt, float dv, float xv) {
  const float u = dv * xv;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const float a = expf(dv * Ar[n]);
    h[n] = fmaf(a, h[n], u * sBt[n]);
  }
}

// Sum v[m] over the warp for all 32 m at once; returns, in lane L, the
// warp's sum of v[L]. Five butterfly levels of 16, 8, 4, 2, 1 shuffles.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[2 * kMaxN],
                                                    int lane) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_fwd(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ Bm, const T* __restrict__ Cm,
            const float* __restrict__ A, const float* __restrict__ Dp,
            T* __restrict__ y, float* __restrict__ hc, int L, int d, int N) {
  __shared__ float sB[kChunk][kMaxN];
  __shared__ float sC[kChunk][kMaxN];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < d;
  const int nc = (L + kChunk - 1) / kChunk;
  float Ar[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    Ar[n] = (active && n < N) ? A[(size_t)c * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float Dv = active ? Dp[c] : 0.f;
  for (int k = 0; k < nc; ++k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, L - t0);
    if (hc != nullptr && active) {
      float* dst = hc + (((size_t)b * nc + k) * d + c) * N;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        if (n < N) dst[n] = h[n];
    }
    __syncthreads();  // the previous chunk is done with sB / sC
    load_bc(sB, sC, Bm, Cm, b, t0, len, L, N);
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      const size_t off = ((size_t)b * L + t0 + i) * d + c;
      const float xv = active ? to_f(x[off]) : 0.f;
      const float dv = active ? to_f(dt[off]) : 0.f;
      step(h, Ar, sB[i], dv, xv);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) acc = fmaf(h[n], sC[i][n], acc);
      if (active) y[off] = from_f<T>(fmaf(Dv, xv, acc));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_bwd(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ Bm, const T* __restrict__ Cm,
            const float* __restrict__ A, const float* __restrict__ Dp,
            const T* __restrict__ dy, const float* __restrict__ hc,
            T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ dbc,
            float* __restrict__ dA, float* __restrict__ dD, int L, int d,
            int N) {
  extern __shared__ float smem[];
  float* sub = smem;                          // [kNSub][kMaxN][kThreads]
  float* traj = sub + kNSub * kMaxN * kThreads;  // [kSub][kMaxN][kThreads]
  float(*sB)[kMaxN] =
      reinterpret_cast<float(*)[kMaxN]>(traj + kSub * kMaxN * kThreads);
  float(*sC)[kMaxN] = sB + kChunk;
  float* red = reinterpret_cast<float*>(sC + kChunk);  // [kSub][kWarps][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + tid;
  const bool active = c < d;
  const int nc = (L + kChunk - 1) / kChunk;
  float Ar[kMaxN], ga[kMaxN], dA_acc[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    Ar[n] = (active && n < N) ? A[(size_t)c * N + n] : 0.f;
    ga[n] = 0.f;  // a_{t+1} * g_{t+1}, zero past the last step
    dA_acc[n] = 0.f;
  }
  const float Dv = active ? Dp[c] : 0.f;
  float dD_acc = 0.f;
  auto S = [&](float* base, int slot, int n) -> float& {
    return base[(slot * kMaxN + n) * kThreads + tid];
  };

  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk is done with sB / sC / red
    load_bc(sB, sC, Bm, Cm, b, t0, len, L, N);
    float h[kMaxN];
    const float* src = hc + (((size_t)b * nc + k) * d + c) * N;
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) h[n] = (active && n < N) ? src[n] : 0.f;
    __syncthreads();

    // pass 1: the state at the start of every kSub-step piece
    for (int j = 0; j < kNSub; ++j) {
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) S(sub, j, n) = h[n];
      if (j + 1 == kNSub) break;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int tl = j * kSub + i;
        if (tl < len) {
          const size_t off = ((size_t)b * L + t0 + tl) * d + c;
          step(h, Ar, sB[tl], active ? to_f(dt[off]) : 0.f,
               active ? to_f(x[off]) : 0.f);
        }
      }
    }

    // pass 2: the pieces in reverse; recompute, then walk back
    for (int j = kNSub - 1; j >= 0; --j) {
      if (j * kSub >= len) continue;  // uniform over the block
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) h[n] = S(sub, j, n);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int tl = j * kSub + i;
        if (tl < len) {
          const size_t off = ((size_t)b * L + t0 + tl) * d + c;
          step(h, Ar, sB[tl], active ? to_f(dt[off]) : 0.f,
               active ? to_f(x[off]) : 0.f);
        }
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) S(traj, i, n) = h[n];
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int tl = j * kSub + i;
        float v[2 * kMaxN];  // [dB partials | dC partials] of this step
        if (tl < len) {
          const size_t off = ((size_t)b * L + t0 + tl) * d + c;
          const float xv = active ? to_f(x[off]) : 0.f;
          const float dv = active ? to_f(dt[off]) : 0.f;
          const float dyv = active ? to_f(dy[off]) : 0.f;
          const float u = dv * xv;
          float du = 0.f, qa = 0.f;
#pragma unroll
          for (int n = 0; n < kMaxN; ++n) {
            const float a = expf(dv * Ar[n]);
            const float g = fmaf(dyv, sC[tl][n], ga[n]);
            const float hp = i > 0 ? S(traj, i - 1, n) : S(sub, j, n);
            v[n] = g * u;
            v[kMaxN + n] = dyv * S(traj, i, n);
            du = fmaf(g, sB[tl][n], du);
            const float q = g * hp * a;
            qa = fmaf(q, Ar[n], qa);
            dA_acc[n] = fmaf(q, dv, dA_acc[n]);
            ga[n] = a * g;
          }
          if (active) {
            dx[off] = from_f<T>(fmaf(du, dv, Dv * dyv));
            ddt[off] = from_f<T>(fmaf(du, xv, qa));
          }
          dD_acc = fmaf(dyv, xv, dD_acc);
        } else {
#pragma unroll
          for (int m = 0; m < 2 * kMaxN; ++m) v[m] = 0.f;
        }
        red[(i * kWarps + warp) * 32 + lane] = warp_transpose_sum(v, lane);
      }
      __syncthreads();
      for (int e = tid; e < kSub * 32; e += kThreads) {
        const int i = e / 32, m = e % 32, tl = j * kSub + i;
        if (tl < len) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += red[(i * kWarps + w) * 32 + m];
          dbc[(((size_t)b * gridDim.x + blockIdx.x) * L + t0 + tl) * 32 + m] = s;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) dA[((size_t)b * d + c) * N + n] = dA_acc[n];
    dD[(size_t)b * d + c] = dD_acc;
  }
}

constexpr size_t kBwdSmem =
    sizeof(float) * ((size_t)(kNSub + kSub) * kMaxN * kThreads +
                     2 * kChunk * kMaxN + kSub * kWarps * 32);

template <typename T>
int launch_bwd_typed(const void* x, const void* dt, const void* Bm,
                     const void* Cm, const void* A, const void* D,
                     const void* dy, const void* hc, void* dx, void* ddt,
                     void* dbc, void* dA, void* dD, int B, int L, int d, int N,
                     cudaStream_t st) {
  // above 48 KB of shared memory a kernel has to ask for it
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((d + kThreads - 1) / kThreads, B), block(kThreads);
  ssm_bwd<T><<<grid, block, kBwdSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(hc),
      static_cast<T*>(dx), static_cast<T*>(ddt), static_cast<float*>(dbc),
      static_cast<float*>(dA), static_cast<float*>(dD), L, d, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dt [B, L, d]; Bm, Cm [B, L, N] (dtype 0: fp32, 1: bf16); A [d, N] and
// D [d] fp32 -> y [B, L, d]. hc: null, or the [B, ceil(L / 64), d, N] fp32
// checkpoint scratch.
extern "C" int ssm_scan_fwd_launch(int dtype, const void* x, const void* dt,
                                   const void* Bm, const void* Cm,
                                   const void* A, const void* D, void* y,
                                   void* hc, int B, int L, int d, int N,
                                   void* stream) {
  if (B <= 0 || L <= 0 || d <= 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kThreads - 1) / kThreads, B), block(kThreads);
  if (dtype == 0)
    ssm_fwd<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
        static_cast<const float*>(A), static_cast<const float*>(D),
        static_cast<float*>(y), static_cast<float*>(hc), L, d, N);
  else if (dtype == 1)
    ssm_fwd<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dt),
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(A),
        static_cast<const float*>(D), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(hc), L, d, N);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Gradients of ssm_scan_fwd_launch's y. dy [B, L, d] and hc (the forward's
// checkpoints) in; dx, ddt [B, L, d] in the input type, dbc [B,
// ceil(d / 64), L, 32] fp32 per-block partial sums (dB in [..., :N], dC in
// [..., 16:16 + N]), dA [B, d, N] and dD [B, d] fp32 per batch row out.
extern "C" int ssm_scan_bwd_launch(int dtype, const void* x, const void* dt,
                                   const void* Bm, const void* Cm,
                                   const void* A, const void* D,
                                   const void* dy, const void* hc, void* dx,
                                   void* ddt, void* dbc, void* dA, void* dD,
                                   int B, int L, int d, int N, void* stream) {
  if (B <= 0 || L <= 0 || d <= 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_typed<float>(x, dt, Bm, Cm, A, D, dy, hc, dx, ddt, dbc,
                                   dA, dD, B, L, d, N, st);
  if (dtype == 1)
    return launch_bwd_typed<__nv_bfloat16>(x, dt, Bm, Cm, A, D, dy, hc, dx,
                                           ddt, dbc, dA, dD, B, L, d, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
