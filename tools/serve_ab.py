"""A serving phase of ``chip_smoke.py`` for two checkouts of this
repository, in turns A, B, B, A, each run in a process of its own from its
checkout's root.

    python3 tools/serve_ab.py OTHER_CHECKOUT [--phase serve|ssm|gmm]
    # on a machine with the card

``serve`` (the default) is phase 3: full Mixtral width, 4 layers, bf16, 4
greedy requests on the synchronous and then the warmed CUDA-graph loop.
``ssm`` is phase 4d: Falcon-Mamba-7B and Zamba2-2.7B at full size, bf16, 4
requests each on the dense slot pool. ``gmm`` is the bf16 ``moe_gmm``
forward at every ``GMM_CASES`` row of the checkout, each on the design
that checkout selects, from the same seeded inputs: device ms a call (20
calls).

A is ``OTHER_CHECKOUT`` (for example the parent commit, unpacked with
``git archive``), B this checkout. Prints the card's name and power limit,
each run's phase lines, then one line per run with each loop's (serve) or
each model's (ssm) decode-round p50 and p99 (ms) as that run printed them.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREAMBLE = (
    "import dataclasses, sys\n"
    "sys.path.insert(0, 'src')\n"
    "import chip_smoke\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.kernels import build\n"
    "build.build_all()\n"
)
PHASES = {
    # phase -> (code run after the preamble, line prefix, key of a line)
    "serve": ("chip_smoke.run_serve(dataclasses.replace(\n"
              "    get_config('mixtral-8x7b'), num_layers=4))\n",
              "serve:", re.compile(r"serve: (sync|warmed) loop")),
    "ssm": ("chip_smoke.run_ssm_serve()\n",
            "ssm-serve:", re.compile(r"ssm-serve: (\S+) x")),
    "gmm": ("import torch\n"
            "from repro_torch.kernels import moe_gmm as gmm\n"
            "gen = torch.Generator(device='cuda').manual_seed(0)\n"
            "w1, w3, w2 = ((torch.randn(12, *s, generator=gen, device='cuda')"
            " / s[0] ** 0.5).bfloat16() for s in ((4096, 14336),\n"
            "    (4096, 14336), (14336, 4096)))\n"
            "for label, C, fill, m in chip_smoke.GMM_CASES:\n"
            "    S = len(fill)\n"
            "    x = torch.randn(S, C, 4096, generator=gen,"
            " device='cuda').bfloat16()\n"
            "    fl = torch.tensor(fill, dtype=torch.int32, device='cuda')\n"
            "    ms = chip_smoke.time_ms(lambda: gmm.launch(x, w1[:S], w3[:S],"
            " w2[:S], fl, m), 20)\n"
            "    print(f'gmm: {label} {ms:.4f}ms', flush=True)\n",
            "gmm:", re.compile(r"gmm: (\S+) ")),
}
ROUND = re.compile(r"decode-round p50=([\d.]+)ms p99=([\d.]+)ms")
KERNEL_MS = re.compile(r" ([\d.]+)ms$")


def run_once(tree: Path, phase: str) -> dict:
    code, prefix, key = PHASES[phase]
    out = subprocess.run([sys.executable, "-c", PREAMBLE + code], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {phase} phase failed:\n{out.stderr}")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith(prefix)]
    print("\n".join(lines), flush=True)
    found = {}
    value = KERNEL_MS if phase == "gmm" else ROUND
    for ln in lines:
        k, r = key.search(ln), value.search(ln)
        if k and r:
            found[k.group(1)] = tuple(float(v) for v in r.groups())
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--phase", choices=sorted(PHASES), default="serve")
    args = ap.parse_args(argv)
    other = args.other.resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    results = []
    for name, tree in (("A", other), ("B", ROOT), ("B", ROOT), ("A", other)):
        results.append((name, run_once(tree, args.phase)))
    for name, r in results:
        print(f"serve_ab: {args.phase} {name} " + ", ".join(
            f"{k} {v[0]:.4f} ms" if args.phase == "gmm" else
            f"{k} p50/p99 {v[0]:.2f}/{v[1]:.2f} ms"
            for k, v in r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
