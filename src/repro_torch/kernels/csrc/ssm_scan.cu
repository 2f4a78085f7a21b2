// Mamba-1 selective scan for Hopper (sm_90a), forward and backward, fp32 and
// bf16 inputs, all arithmetic in fp32.
//
// Forward: replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan.py::ssm_scan. Per channel c of batch row b,
// with u_t = dt_t * x_t and a_t = exp(dt_t * A[c]):
//   h_t = a_t * h_{t-1} + u_t * B_t,   y_t = <h_t, C_t> + D[c] * x_t.
// The fp32 state [N] never leaves the registers, so the [B, T, d, N]
// trajectory is never stored. When the caller needs a gradient the kernel
// also writes the state at the start of every kChunk-step tile to a
// [B, ceil(T / kChunk), d, N] fp32 scratch (the checkpoints).
//
// Backward: the Pallas kernel has none (jax.grad through the pallas_call
// fails), so this one has no TPU counterpart. It walks the tiles in
// reverse, recomputing each tile's states from its checkpoint, and runs the
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
// What bounds it on the H100: per (b, t, c, n) one exp on the SFU (16 per
// clock per SM) and a few FMAs; per (b, t, c) a few bytes in and out. At the
// training shapes (B = 2, T = 2048, d = 8192, N = 16) the exp count over the
// SFU rate and the bytes over the memory rate are both about 0.13 ms. The
// recurrence is sequential in T, but its critical path is one FMA a step:
// with enough threads in flight the kernels are bound by what each element
// costs the SM besides its exp, above all the shared-memory loads and the
// shuffles (each delivers 4-16 bytes to every lane of a warp, at 128 bytes a
// clock per SM), not by latency.
//
// The design:
// * kChLanes = 4 lanes per channel, each holding kS = 4 consecutive states
//   in registers (65,536 threads at the training shape); states of N <
//   kMaxN are padded with A = B = C = 0, which keeps them at 0. A lane's
//   step is 4 exp2s (on A * log2(e), formed once) and 4 FMAs of the
//   recurrence; the step's dt and u, and B and C of its 4 states, come in
//   as three vector loads from shared memory. (One lane per state, 16 lanes
//   a channel, measured 2.5x slower in the forward: every lane loads the
//   channel's dt and u, and the sums over n need 4x the shuffles.)
// * The streamed inputs come in as tiles of kChunk steps x the block's
//   channels: each thread loads kChunk / kChLanes elements of x, dt (and dy)
//   per tile, coalesced across the channels, one tile ahead into registers,
//   and writes them to shared memory in the form the loop reads: {dt, u =
//   dt x} (forward), {dt, u, dy, x} (backward). B_t and C_t (shared by
//   every channel) are staged beside them. y, dx and ddt leave through a
//   shared tile as coalesced stores. One barrier per tile; everything is
//   double-buffered across it.
// * The sums over n (y_t in the forward, du_t and <q_t, A> in the backward)
//   are not reduced step by step: a lane adds its 4 states, keeps 4 steps'
//   sums in registers, and one transposing butterfly over the channel's 4
//   lanes (3 shuffles) leaves step j's sum in lane j.
// * Backward: tiles of kChunk = 16 steps (the checkpoint interval), walked
//   in pieces of 4 steps. One pass over the tile from its checkpoint puts
//   the state before each piece in shared memory; each piece's states h_t
//   and factors a_t are then recomputed into registers and walked back, and
//   the walk reuses a_t: 1.75 exps per element, no trajectory stored.
// * dB_t and dC_t: a lane's 8 terms (4 states of each) are summed over the
//   warp's 8 channels by one transposing butterfly (7 shuffles; each lane
//   ends with one of the warp's 32 sums), then over the block's 8 warps in
//   shared memory in a fixed order; 64 channels a block keep the partials
//   at [B, ceil(d / 64), T, 32].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;   // largest state size
constexpr int kChunk = 16;  // steps per tile = checkpoint interval
// lanes per channel, kMaxN / kChLanes states each; the kernels take it (and
// the channels per block) as template parameters so that
// tools/ssm_lanes.py can time the other choices
constexpr int kChLanes = 4;
constexpr int kFwdCh = 32;  // channels per forward block (128 threads)
constexpr int kBwdCh = 64;  // channels per backward block (256 threads)
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^v on the SFU (one MUFU.EX2); tiny results flush to 0.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// One tile's inputs, loaded into registers one tile ahead by a block of
// kThreads threads covering kCh channels: element e = tid + r * kThreads of
// the [kChunk][kCh] tile of x, dt (and dy), and pair e of the
// [kChunk][kMaxN] tile of B and C. Zero past L, d and N.
template <int kCh, int kThreads>
struct Stage {
  static constexpr int kE = kChunk * kCh / kThreads;
  static constexpr int kEB = (kChunk * kMaxN + kThreads - 1) / kThreads;
  static_assert(kChunk * kCh % kThreads == 0, "whole tile rows a thread");
  float x[kE], dt[kE], dy[kE], B[kEB], C[kEB];

  template <typename T>
  __device__ __forceinline__ void load(const T* __restrict__ xp,
                                       const T* __restrict__ dtp,
                                       const T* __restrict__ dyp,
                                       const T* __restrict__ Bm,
                                       const T* __restrict__ Cm, int b, int t0,
                                       int c0, int L, int d, int N) {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int t = t0 + e / kCh, c = c0 + e % kCh;
      x[r] = dt[r] = dy[r] = 0.f;
      if (t < L && c < d) {
        const size_t off = ((size_t)b * L + t) * d + c;
        x[r] = to_f(xp[off]);
        dt[r] = to_f(dtp[off]);
        if (dyp != nullptr) dy[r] = to_f(dyp[off]);
      }
    }
#pragma unroll
    for (int r = 0; r < kEB; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int t = t0 + e / kMaxN, n = e % kMaxN;
      B[r] = C[r] = 0.f;
      if (e < kChunk * kMaxN && t < L && n < N) {
        const size_t off = ((size_t)b * L + t) * N + n;
        B[r] = to_f(Bm[off]);
        C[r] = to_f(Cm[off]);
      }
    }
  }
};

// K consecutive floats from 16-byte-aligned shared memory (K = 1, 2, 4k).
template <int K>
__device__ __forceinline__ void lds(float (&o)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = v.x;
      o[4 * q + 1] = v.y;
      o[4 * q + 2] = v.z;
      o[4 * q + 3] = v.w;
    }
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = p[0];
  }
}

// Sum v[m] over a group of W lanes for all W values of m at once; returns,
// in lane j of the group, the sum of v[j]. The group's lanes are j *
// kStride apart (W * kStride <= 32). Butterfly levels of W / 2, ..., 1
// shuffles: W - 1 in all.
template <int W, int kStride = 1>
__device__ __forceinline__ float transpose_sum(float (&v)[W], int j) {
#pragma unroll
  for (int o = W / 2; o >= 1; o >>= 1) {
    const bool upper = (j & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o * kStride);
    }
  }
  return v[0];
}

// The dB terms g_s * u and dC terms dy * h_s of a lane's kS states, summed
// over the 2 kS channels of a warp (lanes kStride apart); returns, in the
// lane with channel index wc, the sum of term wc of [dB terms | dC terms].
// The first butterfly level picks its halves as it forms the products, so
// that level needs no select after them.
template <int kS, int kStride>
__device__ __forceinline__ float channel_sum(const float (&g)[kS],
                                             const float (&h)[kS], float u,
                                             float dy, int wc) {
  const bool upper = (wc & kS) != 0;  // this lane ends with a dC sum
  const float fk = upper ? dy : u, fs = upper ? u : dy;
  float v[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const float keep = (upper ? h[s] : g[s]) * fk;
    const float send = (upper ? g[s] : h[s]) * fs;
    v[s] = keep + __shfl_xor_sync(0xffffffffu, send, kS * kStride);
  }
  return transpose_sum<kS, kStride>(v, wc);
}

// Forward. kLanes lanes per channel, each holding kS = kMaxN / kLanes
// consecutive states; thread tid holds channel tid / kLanes of the block
// and states from (tid % kLanes) * kS.
template <typename T, int kLanes, int kCh>
__global__ void __launch_bounds__(kCh * kLanes)
    ssm_fwd(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ Bm, const T* __restrict__ Cm,
            const float* __restrict__ A, const float* __restrict__ Dp,
            T* __restrict__ y, float* __restrict__ hc, int L, int d, int N) {
  constexpr int kS = kMaxN / kLanes, kThreads = kCh * kLanes;
  // a pitch of kCh + 32 / kLanes floats puts a warp's accesses of [t][ch]
  // (kLanes rows x its 32 / kLanes channels) in 32 different banks
  constexpr int kP = kCh + 32 / kLanes;
  using Tile = Stage<kCh, kThreads>;
  __shared__ float2 sDU[2][kChunk][kCh];  // {dt, u}
  __shared__ float sX[2][kChunk][kP];
  __shared__ __align__(16) float sB[2][kChunk][kMaxN];
  __shared__ __align__(16) float sC[2][kChunk][kMaxN];
  __shared__ float sY[2][kChunk][kP];
  const int tid = threadIdx.x, j = tid % kLanes, ch = tid / kLanes;
  const int b = blockIdx.y, c0 = blockIdx.x * kCh, c = c0 + ch;
  const int n0 = j * kS;
  float Al2[kS], h[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    Al2[s] = (c < d && n0 + s < N) ? A[(size_t)c * N + n0 + s] * kLog2e : 0.f;
    h[s] = 0.f;
  }
  const float Dv = c < d ? Dp[c] : 0.f;
  const int nt = (L + kChunk - 1) / kChunk;
  auto store_y = [&](int buf, int t0) {
#pragma unroll
    for (int r = 0; r < Tile::kE; ++r) {
      const int e = tid + r * kThreads, st = e / kCh, sc = e % kCh;
      if (t0 + st < L && c0 + sc < d)
        y[((size_t)b * L + t0 + st) * d + c0 + sc] = from_f<T>(sY[buf][st][sc]);
    }
  };

  Tile pre;
  pre.load(x, dt, (const T*)nullptr, Bm, Cm, b, 0, c0, L, d, N);
  for (int k = 0; k < nt; ++k) {
    const int buf = k & 1, t0 = k * kChunk;
#pragma unroll
    for (int r = 0; r < Tile::kE; ++r) {
      const int e = tid + r * kThreads, st = e / kCh, sc = e % kCh;
      sDU[buf][st][sc] = make_float2(pre.dt[r], pre.dt[r] * pre.x[r]);
      sX[buf][st][sc] = pre.x[r];
    }
#pragma unroll
    for (int r = 0; r < Tile::kEB; ++r) {
      const int e = tid + r * kThreads;
      if (e < kChunk * kMaxN) {
        sB[buf][e / kMaxN][e % kMaxN] = pre.B[r];
        sC[buf][e / kMaxN][e % kMaxN] = pre.C[r];
      }
    }
    __syncthreads();
    if (k + 1 < nt)
      pre.load(x, dt, (const T*)nullptr, Bm, Cm, b, t0 + kChunk, c0, L, d, N);
    if (k > 0) store_y(buf ^ 1, t0 - kChunk);
    if (hc != nullptr && c < d) {
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (n0 + s < N) hc[(((size_t)b * nt + k) * d + c) * N + n0 + s] = h[s];
    }
#pragma unroll
    for (int g = 0; g < kChunk; g += kLanes) {
      float p[kLanes];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        const float2 du = sDU[buf][g + i][ch];
        float Bv[kS], Cv[kS];
        lds(Bv, &sB[buf][g + i][n0]);
        lds(Cv, &sC[buf][g + i][n0]);
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          h[s] = fmaf(ex2(du.x * Al2[s]), h[s], du.y * Bv[s]);
          acc = fmaf(h[s], Cv[s], acc);
        }
        p[i] = acc;
      }
      const float sum = transpose_sum<kLanes>(p, j);  // <h, C> of step g + j
      sY[buf][g + j][ch] = fmaf(Dv, sX[buf][g + j][ch], sum);
    }
  }
  __syncthreads();
  store_y((nt - 1) & 1, (nt - 1) * kChunk);
}

// Backward shared memory, per buffer: the {dt, u, dy, x} and {dx, ddt}
// tiles, B and C, and the warps' sums of dB and dC for each step; and each
// thread's states before each piece of the current tile.
template <int kLanes, int kCh>
struct BwdSmem {
  static constexpr int kP = kCh + 32 / kLanes;
  static constexpr int kWarps = kCh * kLanes / 32;
  float4 in[2][kChunk][kP];
  float2 out[2][kChunk][kP];
  float B[2][kChunk][kMaxN];
  float C[2][kChunk][kMaxN];
  float red[2][kChunk][kWarps][2 * kMaxN];
  float hp[kChunk / kLanes][kCh * kLanes][kMaxN / kLanes];
};

// Backward, over the same lanes as the forward: thread tid holds channel
// tid / kLanes of the block and states from (tid % kLanes) * kS. A tile is
// walked in kChunk / kLanes pieces of kLanes steps, so the transposing sums
// of du and <q, A> over a piece leave step j's in lane j.
template <typename T, int kLanes, int kCh>
__global__ void __launch_bounds__(kCh * kLanes, 2)
    ssm_bwd(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ Bm, const T* __restrict__ Cm,
            const float* __restrict__ A, const float* __restrict__ Dp,
            const T* __restrict__ dy, const float* __restrict__ hc,
            T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ dbc,
            float* __restrict__ dA, float* __restrict__ dD, int L, int d,
            int N) {
  constexpr int kS = kMaxN / kLanes, kThreads = kCh * kLanes;
  constexpr int kPiece = kLanes, kPieces = kChunk / kPiece;
  constexpr int kWarpCh = 32 / kLanes;  // channels per warp
  static_assert(kWarpCh == 2 * kS, "one dB or dC value per lane");
  using Smem = BwdSmem<kLanes, kCh>;
  using Tile = Stage<kCh, kThreads>;
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, j = tid % kLanes, ch = tid / kLanes;
  const int warp = tid / 32, wc = (tid % 32) / kLanes;  // channel in warp
  const int b = blockIdx.y, c0 = blockIdx.x * kCh, c = c0 + ch;
  const int n0 = j * kS;
  // the dB (wc < kS) or dC value this lane holds after the channel sum
  const int m = wc < kS ? n0 + wc : kMaxN + n0 + wc - kS;
  float Av[kS], Al2[kS];
  float ga[kS];      // a_{t+1} * g_{t+1}, zero past the last step
  float dA_acc[kS];  // sum of q_t * dt_t
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    Av[s] = (c < d && n0 + s < N) ? A[(size_t)c * N + n0 + s] : 0.f;
    Al2[s] = Av[s] * kLog2e;
    ga[s] = dA_acc[s] = 0.f;
  }
  float dD_acc = 0.f;  // sum of dy_t * x_t over the steps this lane finishes
  const float Dv = c < d ? Dp[c] : 0.f;
  const int nt = (L + kChunk - 1) / kChunk;
  auto checkpoint = [&](int k, float (&h)[kS]) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
      h[s] = (c < d && n0 + s < N)
                 ? hc[(((size_t)b * nt + k) * d + c) * N + n0 + s]
                 : 0.f;
  };
  // the outputs of the tile at t0, once a barrier has passed since it ran
  auto flush = [&](int buf, int t0) {
#pragma unroll
    for (int r = 0; r < Tile::kE; ++r) {
      const int e = tid + r * kThreads, st = e / kCh, sc = e % kCh;
      if (t0 + st < L && c0 + sc < d) {
        const size_t off = ((size_t)b * L + t0 + st) * d + c0 + sc;
        const float2 o = S.out[buf][st][sc];
        dx[off] = from_f<T>(o.x);
        ddt[off] = from_f<T>(o.y);
      }
    }
#pragma unroll
    for (int e = tid; e < kChunk * 2 * kMaxN; e += kThreads) {
      const int i = e / (2 * kMaxN), mm = e % (2 * kMaxN);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < Smem::kWarps; w += 2) {
        s0 += S.red[buf][i][w][mm];
        if (w + 1 < Smem::kWarps) s1 += S.red[buf][i][w + 1][mm];
      }
      if (t0 + i < L)
        dbc[(((size_t)b * gridDim.x + blockIdx.x) * L + t0 + i) * 2 * kMaxN +
            mm] = s0 + s1;
    }
  };
  // One piece of kPiece steps at s0 of the tile in buffer buf, from the
  // states h0 before its first step: recompute, then walk back.
  auto piece = [&](int buf, int s0, const float (&h0)[kS]) {
    float hs[kPiece][kS], a[kPiece][kS];
#pragma unroll
    for (int i = 0; i < kPiece; ++i) {
      const float4 in = S.in[buf][s0 + i][ch];
      float Bv[kS];
      lds(Bv, &S.B[buf][s0 + i][n0]);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        a[i][s] = ex2(in.x * Al2[s]);
        hs[i][s] = fmaf(a[i][s], i > 0 ? hs[i - 1][s] : h0[s], in.y * Bv[s]);
      }
    }
    float du[kPiece], qa[kPiece];
#pragma unroll
    for (int i = kPiece - 1; i >= 0; --i) {
      const float4 in = S.in[buf][s0 + i][ch];  // dt, u, dy, x
      float Bv[kS], Cv[kS], g[kS];
      lds(Bv, &S.B[buf][s0 + i][n0]);
      lds(Cv, &S.C[buf][s0 + i][n0]);
      du[i] = qa[i] = 0.f;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        g[s] = fmaf(in.z, Cv[s], ga[s]);
        ga[s] = a[i][s] * g[s];
        const float q = ga[s] * (i > 0 ? hs[i - 1][s] : h0[s]);
        du[i] = fmaf(g[s], Bv[s], du[i]);
        qa[i] = fmaf(q, Av[s], qa[i]);
        dA_acc[s] = fmaf(q, in.x, dA_acc[s]);
      }
      S.red[buf][s0 + i][warp][m] =
          channel_sum<kS, kLanes>(g, hs[i], in.y, in.z, wc);
    }
    const float du_j = transpose_sum<kLanes>(du, j);  // of step s0 + j
    const float qa_j = transpose_sum<kLanes>(qa, j);
    const float4 in = S.in[buf][s0 + j][ch];
    S.out[buf][s0 + j][ch] =
        make_float2(fmaf(du_j, in.x, Dv * in.z), fmaf(du_j, in.w, qa_j));
    dD_acc = fmaf(in.z, in.w, dD_acc);
  };

  Tile pre;
  pre.load(x, dt, dy, Bm, Cm, b, (nt - 1) * kChunk, c0, L, d, N);
  float h_next[kS];
  checkpoint(nt - 1, h_next);
  for (int kk = 0; kk < nt; ++kk) {
    const int k = nt - 1 - kk, buf = kk & 1, t0 = k * kChunk;
#pragma unroll
    for (int r = 0; r < Tile::kE; ++r) {
      const int e = tid + r * kThreads, st = e / kCh, sc = e % kCh;
      S.in[buf][st][sc] = make_float4(pre.dt[r], pre.dt[r] * pre.x[r],
                                      pre.dy[r], pre.x[r]);
    }
#pragma unroll
    for (int r = 0; r < Tile::kEB; ++r) {
      const int e = tid + r * kThreads;
      if (e < kChunk * kMaxN) {
        S.B[buf][e / kMaxN][e % kMaxN] = pre.B[r];
        S.C[buf][e / kMaxN][e % kMaxN] = pre.C[r];
      }
    }
    float hcur[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) hcur[s] = h_next[s];
    __syncthreads();
    if (k > 0) {
      pre.load(x, dt, dy, Bm, Cm, b, t0 - kChunk, c0, L, d, N);
      checkpoint(k - 1, h_next);
    }
    if (kk > 0) flush(buf ^ 1, t0 + kChunk);
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
#pragma unroll
      for (int s = 0; s < kS; ++s) S.hp[p][tid][s] = hcur[s];
      if (p + 1 == kPieces) break;
#pragma unroll
      for (int i = 0; i < kPiece; ++i) {
        const int tl = p * kPiece + i;
        const float4 in = S.in[buf][tl][ch];
        float Bv[kS];
        lds(Bv, &S.B[buf][tl][n0]);
#pragma unroll
        for (int s = 0; s < kS; ++s)
          hcur[s] = fmaf(ex2(in.x * Al2[s]), hcur[s], in.y * Bv[s]);
      }
    }
#pragma unroll
    for (int p = kPieces - 1; p >= 0; --p) {
      float h0[kS];
      lds(h0, &S.hp[p][tid][0]);
      piece(buf, p * kPiece, h0);
    }
  }
  __syncthreads();
  flush((nt - 1) & 1, 0);
#pragma unroll
  for (int o = kLanes / 2; o >= 1; o >>= 1)
    dD_acc += __shfl_xor_sync(0xffffffffu, dD_acc, o);
  if (c < d) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (n0 + s < N) dA[((size_t)b * d + c) * N + n0 + s] = dA_acc[s];
    if (j == 0) dD[(size_t)b * d + c] = dD_acc;
  }
}

template <typename T>
int launch_bwd_typed(const void* x, const void* dt, const void* Bm,
                     const void* Cm, const void* A, const void* D,
                     const void* dy, const void* hc, void* dx, void* ddt,
                     void* dbc, void* dA, void* dD, int B, int L, int d, int N,
                     cudaStream_t st) {
  auto kernel = ssm_bwd<T, kChLanes, kBwdCh>;
  // above 48 KB of shared memory a kernel has to ask for it
  constexpr int kSmem = (int)sizeof(BwdSmem<kChLanes, kBwdCh>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((d + kBwdCh - 1) / kBwdCh, B), block(kBwdCh * kChLanes);
  kernel<<<grid, block, kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(hc),
      static_cast<T*>(dx), static_cast<T*>(ddt), static_cast<float*>(dbc),
      static_cast<float*>(dA), static_cast<float*>(dD), L, d, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_typed(const void* x, const void* dt, const void* Bm,
                     const void* Cm, const void* A, const void* D, void* y,
                     void* hc, int B, int L, int d, int N, cudaStream_t st) {
  const dim3 grid((d + kFwdCh - 1) / kFwdCh, B), block(kFwdCh * kChLanes);
  ssm_fwd<T, kChLanes, kFwdCh><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(hc), L, d, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dt [B, L, d]; Bm, Cm [B, L, N] (dtype 0: fp32, 1: bf16); A [d, N] and
// D [d] fp32 -> y [B, L, d]. hc: null, or the [B, ceil(L / 16), d, N] fp32
// checkpoint scratch.
extern "C" int ssm_scan_fwd_launch(int dtype, const void* x, const void* dt,
                                   const void* Bm, const void* Cm,
                                   const void* A, const void* D, void* y,
                                   void* hc, int B, int L, int d, int N,
                                   void* stream) {
  if (B <= 0 || L <= 0 || d <= 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_typed<float>(x, dt, Bm, Cm, A, D, y, hc, B, L, d, N, st);
  if (dtype == 1)
    return launch_fwd_typed<__nv_bfloat16>(x, dt, Bm, Cm, A, D, y, hc, B, L,
                                           d, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
