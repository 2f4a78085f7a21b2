"""Where the two bf16 backward kernels spend their time, on the card.

Each backward launch (``flash_attention.launch_bwd`` at the Mixtral train
shape: B = 2, T = 2048, 32/8 heads, hd 128, causal; ``moe_gmm.launch_bwd``
at the EP train step: 8 slots of capacity 16384, 4096 routed rows,
max_fill 2048) runs several kernels. This runs each launch a few times
under ``torch.profiler`` and prints, per kernel, its device time per
launch, the flops it must do at these inputs, and its rate against the
989 TFLOP/s bf16 peak; then ptxas's report (registers, spills, and any
``wgmma`` serialization note) for every backward kernel.

    python3 tools/bwd_profile.py

Prints the card's name and power limit first.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402

PEAK = 989e12
REPS = 5


def demangle(symbol: str) -> str:
    try:
        return subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol


def by_kernel(fn) -> dict:
    """Device ms per launch of ``fn``, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / REPS
    return out


def report(label: str, times: dict, flops: dict) -> None:
    total = sum(times.values())
    print(f"{label}: {total:.3f} ms a launch", flush=True)
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        f = next((v for k, v in flops.items() if k in name), None)
        rate = "" if f is None else (
            f" {f / 1e9:.1f} GFLOP, {f / ms / 1e9:.0f} TFLOP/s = "
            f"{f / ms / 1e9 / (PEAK / 1e12):.1%} of peak")
        print(f"  {name[:60]:60s} {ms:.3f} ms{rate}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_profile: no CUDA device available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    info = build.build_all()
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)

    B, T, H, KVH, hd = 2, 2048, 32, 8, 128
    q, do = (torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(dt)
            for _ in range(2))
    lse = torch.empty(fa.stats_shape(B, T, H), device=dev)
    o = fa.launch(q, k, v, causal=True, lse=lse)
    pairs = B * H * T * (T + 1) // 2
    # dq: S, dP, dQ; dk/dv: S^T, dP^T, dV, dK; 2 hd flops per pair each
    report(f"flash_attention_bwd B,T,H,KVH,hd={B},{T},{H},{KVH},{hd} causal",
           by_kernel(lambda: fa.launch_bwd(q, k, v, o, lse, do)),
           {"dq": 3 * 2 * hd * pairs, "dkdv": 4 * 2 * hd * pairs})
    del q, k, v, o, do, lse

    C, fill, m = 16384, [700, 420, 0, 610, 530, 480, 650, 706], 2048
    S, D, F = len(fill), 4096, 14336
    w1, w3 = ((torch.randn(S, D, F, generator=gen, device=dev) / 64.0).to(dt)
              for _ in range(2))
    w2 = (torch.randn(S, F, D, generator=gen, device=dev) / F**0.5).to(dt)
    x = torch.zeros((S, C, D), dtype=dt, device=dev)
    for s, n in enumerate(fill):
        x[s, :n] = torch.randn(n, D, generator=gen, device=dev).to(dt)
    dy = torch.randn(S, C, D, generator=gen, device=dev).to(dt)
    fl = torch.tensor(fill, dtype=torch.int32, device=dev)
    rows = sum(min(n, m) for n in fill)
    mac = 2 * D * F * rows  # one product over the routed rows
    report(f"moe_gmm_bwd S,C,D,F={S},{C},{D},{F} rows={rows}",
           by_kernel(lambda: gmm.launch_bwd(x, w1, w3, w2, fl, m, dy)),
           {"gate": 3 * mac, "dx": 2 * mac, "dw13": 2 * mac,
            "dw2": mac})

    for name, v in info.items():
        for line in chip_smoke.ptxas_report(v["log"]):
            if "_wg<" in line or "gmm_bwd" in line:
                print(f"ptxas: {name}: {line}")
        for line in v["log"].splitlines():
            if "serializ" in line.lower() or "warning" in line.lower():
                fn = re.search(r"function '([^']+)'", line)
                print(f"ptxas: {name}: "
                      f"{demangle(fn.group(1)) if fn else ''}: "
                      f"{line.strip()[:160]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
