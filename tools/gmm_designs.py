"""Both bf16 ``moe_gmm`` forward designs at the main paths' fills, on the
card: the weight stream (``"stream"``, ``gmm_tc``) and the row tiles
(``"rows"``, ``gmm_rows``), each forced at every bf16 row of
``chip_smoke.GMM_CASES`` (or the rows named on the command line), held
against ``plain`` (twice, bit for bit, zeros past the fill) and timed beside
the bound, the bmm chain and, past 128 rows a slot, a per-slot ``torch.mm``
chain over exactly the filled rows. The timings are what
``moe_gmm.select_design``'s crossover is set from. Then, for each row on
the row tiles, each of its two kernels' device time under
``torch.profiler``: its flops and rate against the 989 TFLOP/s bf16 peak,
and the bytes its tiles read from L2 over that time (every stage of every
tile: 128 rows x 64 of x or mid, 16 KB, and half of the four 64 x 64
weight boxes, 16 KB, which the cluster's other block multicasts; 48 KB
land in each block's shared memory). Also prints ptxas's report (registers, spills and
warnings, such as a ``wgmma`` serialization note) for the ``moe_gmm``
kernels when it builds them (run it first in a call: a cached build has
no log).

    python3 tools/gmm_designs.py [decode chunk ... prefill-32k]

Prints the card's name and power limit first, one line a row (as
``chip_smoke.py`` phase 2 does) and a JSON line of the rows' figures last.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import bwd_profile  # noqa: E402
import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402

L2_BYTES = 32768  # read from L2 a stage of one block of rows::gmm_rows


def profile_rows(label, C, fill, m) -> None:
    """Pass 1's and pass 2's device time at one row, on the row tiles."""
    D, F = 4096, 14336
    gen = torch.Generator(device="cuda").manual_seed(1)
    S = len(fill)
    w1, w3 = ((torch.randn(S, D, F, generator=gen, device="cuda") / 64)
              .bfloat16() for _ in range(2))
    w2 = (torch.randn(S, F, D, generator=gen, device="cuda") / F ** 0.5
          ).bfloat16()
    x = torch.randn(S, C, D, generator=gen, device="cuda").bfloat16()
    fl = torch.tensor(fill, dtype=torch.int32, device="cuda")
    times = bwd_profile.by_kernel(lambda: gmm.launch(x, w1, w3, w2, fl, m))
    filled = sum(min(n, m, C) for n in fill)
    # row tiles in cluster pairs (an odd slot's last pair has one past
    # the fill, whose block still reads its stages)
    row_tiles = sum(2 * -(-min(n, m, C) // 256) for n in fill)
    work = {"gmm_rows<true>": (4 * D * F * filled,
                               row_tiles * -(-F // 128) * -(-D // 64)),
            "gmm_rows<false>": (2 * D * F * filled,
                                row_tiles * -(-D // 256) * -(-F // 64))}
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        flops, stages = next((v for k, v in work.items() if k in name),
                             (0, 0))
        print(f"profile: {label} {name[:40]:40s} {ms:.3f} ms"
              + (f"; {flops / 1e9:.0f} GFLOP, "
                 f"{flops / ms / 1e9 / bwd_profile.PEAK * 1e12:.1%} of "
                 f"peak; {stages * L2_BYTES / 1e9:.1f} GB from L2 at "
                 f"{stages * L2_BYTES / ms / 1e9:.2f} TB/s"
                 if flops else ""), flush=True)
    del x, w1, w3, w2
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("gmm_designs: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    info = build.build_all()
    for line in chip_smoke.ptxas_report(info["moe_gmm"]["log"]):
        print(f"build: moe_gmm: {line}", flush=True)
    labels = sys.argv[1:] or None
    results: list = []
    chip_smoke.run_gmm_checks(results, ("bfloat16",), labels)
    for label, C, fill, m in chip_smoke.GMM_CASES:
        if (labels is None or label in labels) and gmm.select_design(
                "tc", min(m, C)) == "rows":
            profile_rows(label, C, fill, m)
    print(json.dumps([{k: r[k] for k in ("case", "design", "designs_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "filled_rows_ms",
                                          "plain_ms")}
                      for r in results]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
