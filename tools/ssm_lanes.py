"""How many lanes per channel the selective-scan kernels should use: builds
``ssm_fwd`` and ``ssm_bwd`` from ``src/repro_torch/kernels/csrc/ssm_scan.cu``
at several (lanes per channel, channels per block) and times each on the
card at the Falcon-Mamba-7B train shape (B = 2, T = 2048, d = 8192, N = 16,
fp32), after holding it against the plain versions (1e-4 of the largest
value) at a ragged shape. The shipped kernels use 4 lanes (``kChLanes``).

    python3 tools/ssm_lanes.py        # on a machine with the card and nvcc

Prints the card's name and power limit, each variant's ptxas report and
one line per variant: max relative error and device ms per call. The
backward's time is the kernel's alone (no sum over its partials).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as Fn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402

FWD = [(16, 32), (8, 32), (4, 32), (2, 32), (1, 64)]  # (lanes, channels)
BWD = [(16, 32), (8, 64), (4, 64)]

HARNESS = """
#include "ssm_scan.cu"
namespace {
template <int kL, int kC>
int fwd(void* const* p, int B, int L, int d, int N, cudaStream_t s) {
  ssm_fwd<float, kL, kC><<<dim3((d + kC - 1) / kC, B), kC * kL, 0, s>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5],
      (float*)p[6], (float*)p[7], L, d, N);
  return (int)cudaGetLastError();
}
template <int kL, int kC>
int bwd(void* const* p, int B, int L, int d, int N, cudaStream_t s) {
  auto k = ssm_bwd<float, kL, kC>;
  constexpr int kSmem = (int)sizeof(BwdSmem<kL, kC>);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  k<<<dim3((d + kC - 1) / kC, B), kC * kL, kSmem, s>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5],
      (const float*)p[6], (const float*)p[7], (float*)p[8], (float*)p[9],
      (float*)p[10], (float*)p[11], (float*)p[12], L, d, N);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int run(int v, void* const* p, int B, int L, int d, int N,
                   void* st) {
  cudaStream_t s = (cudaStream_t)st;
  switch (v) {
%s
  }
  return 1;
}
"""


def build_harness():
    cases = [f"    case {i}: return fwd<{a}, {b}>(p, B, L, d, N, s);"
             for i, (a, b) in enumerate(FWD)]
    cases += [f"    case {100 + i}: return bwd<{a}, {b}>(p, B, L, d, N, s);"
              for i, (a, b) in enumerate(BWD)]
    src = build.BUILD_DIR / "ssm_lanes.cu"
    so = build.BUILD_DIR / "ssm_lanes.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(HARNESS % "\n".join(cases))
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    for line in chip_smoke.ptxas_report(out.stdout + out.stderr):
        if "<float" in line:
            print("ptxas:", line)
    if out.returncode != 0:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return lib


def inputs(B, T, d, N, gen):
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, dt = rnd(B, T, d, scale=0.5), Fn.softplus(rnd(B, T, d) - 4)
    Bs, Cs = rnd(B, T, N, scale=0.3), rnd(B, T, N, scale=0.3)
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).expand(
        d, N) * torch.exp(rnd(d, 1, scale=0.1))
    return (x, dt, Bs, Cs, A.contiguous(), 1 + rnd(d, scale=0.1)), rnd(B, T, d)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_lanes: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    lib = build_harness()
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(v, args, dy, states, shape):
        B, T, d, N = shape
        f = dict(device="cuda")
        if v < 100:
            outs = [torch.empty(B, T, d, **f),
                    torch.empty(ssm.states_shape(B, T, d, N), **f)]
            ptrs = [*args, *outs]
        else:
            ch = BWD[v - 100][1]
            outs = [torch.empty(B, T, d, **f), torch.empty(B, T, d, **f),
                    torch.empty(B, -(-d // ch), T, 32, **f),
                    torch.empty(B, d, N, **f), torch.empty(B, d, **f)]
            ptrs = [*args, dy, states, *outs]
        arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])

        def call():
            build.check("ssm_lanes", lib.run(v, arr, B, T, d, N, stream))
        return call, outs

    variants = [(i, f"fwd {a} lanes x {b} ch") for i, (a, b) in enumerate(FWD)]
    variants += [(100 + i, f"bwd {a} lanes x {b} ch")
                 for i, (a, b) in enumerate(BWD)]
    errs = {}
    for shape in [(2, 200, 8192, 16), (1, 37, 100, 5)]:
        args, dy = inputs(*shape, gen)
        _, states = ssm.launch(*args, save_states=True)
        want_y, want_g = ssm.plain(*args), ssm.plain_bwd(*args, dy)
        for v, _ in variants:
            call, outs = runner(v, args, dy, states, shape)
            call()
            torch.cuda.synchronize()
            if v < 100:
                got, want = [outs[0]], [want_y]
            else:
                N, part = shape[3], outs[2].sum(1)
                got = [outs[0], outs[1], part[..., :N],
                       part[..., 16:16 + N], outs[3].sum(0), outs[4].sum(0)]
                want = want_g
            err = max(float((g - w).abs().max()) / float(w.abs().max())
                      for g, w in zip(got, want))
            errs[v] = max(errs.get(v, 0.0), err)
    shape = (2, 2048, 8192, 16)
    args, dy = inputs(*shape, gen)
    _, states = ssm.launch(*args, save_states=True)
    for v, name in variants:
        call, _ = runner(v, args, dy, states, shape)
        ms = chip_smoke.time_ms(call, 10)
        ok = "ok" if errs[v] <= 1e-4 else "DIFFERS"
        print(f"ssm_lanes: {name:20s} max rel err {errs[v]:.2e} ({ok}) "
              f"{ms:.4f} ms at B,T,d,N={shape}", flush=True)
    return 0 if all(e <= 1e-4 for e in errs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
