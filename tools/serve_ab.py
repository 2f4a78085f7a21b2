"""The serve phase of ``chip_smoke.py`` (phase 3: full Mixtral width, 4
layers, bf16, 4 greedy requests on the synchronous and then the warmed
CUDA-graph loop) for two checkouts of this repository, in turns A, B, B, A,
each run in a process of its own from its checkout's root.

    python3 tools/serve_ab.py OTHER_CHECKOUT   # on a machine with the card

A is ``OTHER_CHECKOUT`` (for example the parent commit, unpacked with
``git archive``), B this checkout. Prints the card's name and power limit,
each run's serve lines, then one line per run with the warmed and the
synchronous loop's decode-round p50 and p99 (ms) as that run printed them.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = (
    "import dataclasses, sys\n"
    "sys.path.insert(0, 'src')\n"
    "import chip_smoke\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.kernels import build\n"
    "build.build_all()\n"
    "chip_smoke.run_serve(dataclasses.replace(get_config('mixtral-8x7b'),\n"
    "                                         num_layers=4))\n"
)
ROUND = re.compile(r"serve: (sync|warmed) loop .*?decode-round "
                   r"p50=([\d.]+)ms p99=([\d.]+)ms")


def serve_once(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: serve phase failed:\n{out.stderr}")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("serve:")]
    print("\n".join(lines), flush=True)
    return {m.group(1): (float(m.group(2)), float(m.group(3)))
            for m in map(ROUND.search, lines) if m}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    results = []
    for name, tree in (("A", other), ("B", ROOT), ("B", ROOT), ("A", other)):
        results.append((name, serve_once(tree)))
    for name, r in results:
        print(f"serve_ab: {name} warmed p50/p99 {r['warmed'][0]:.2f}/"
              f"{r['warmed'][1]:.2f} ms, sync p50/p99 {r['sync'][0]:.2f}/"
              f"{r['sync'][1]:.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
