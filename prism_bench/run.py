"""Run one cell of the port's benchmark once.

    python3 prism_bench/run.py --workload mixtral-edge3-chat --seed 7 \\
        --seconds 51 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card. The cell,
its configuration and traffic mix are found by name through
``BENCHMARK.json``. Progress and what the numbers rest on go to standard
error, ending with each number that ``correct`` compares beside its limit;
the last line of standard output is the result object. Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits with code 2.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", type=Path, default=None,
                    help="write the compared requests here (for control.py)")
    args = ap.parse_args(argv)

    # every cache the program or its libraries keep lives in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(CHECKOUT / "src")]

    import torch

    from pbench import bench

    spec = bench.load_cell(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"correct: false: the cell needs {chips} CUDA device(s), this "
            f"machine has {torch.cuda.device_count()}; no result")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"correct: false: the program is not in this checkout ({e}); "
            "no result")
        return 3
    torch.cuda.set_device(0)
    result = bench.run_cell(ROOT, spec, args.seed, args.seconds,
                            bool(args.trace), T_PROCESS, dump=args.dump,
                            log=log)
    bad = bench.banned_modules()
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}; "
            "no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
