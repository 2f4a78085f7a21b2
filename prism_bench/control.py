"""The control of ``correct``, judged as a run is judged, on the chip.

    python3 prism_bench/run.py --workload mixtral-edge3-chat --seed 5 \\
        --seconds 51 --dump chiprun_out/dumps
    python3 prism_bench/control.py chiprun_out/dumps/*.npz

A run with ``--dump`` writes the requests it compared (prompts and served
tokens). For each, this puts three token streams through the comparison
that decides a run's ``correct`` (``bench.gap_check``: the mean gap against
the configuration's limit): the program's served tokens; the control, the
float32 reference's own tokens computed in float8 (``precision="fp8"``: at
each position the token the float8 reference puts first); and the served
tokens altered where they are produced (each replaced by the next id). It
prints each one's gaps and ``correct``, and exits with 1 unless the program
reads correct and the control and the altered tokens read not correct in
every dump.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(paths) -> int:
    sys.path[:0] = [str(ROOT)]
    os.environ["USE_FLAX"] = "0"
    import numpy as np
    import torch

    from pbench import bench
    from pbench.refs import reference_for

    device = "cuda" if torch.cuda.is_available() else "cpu"
    sound = True
    for path in paths:
        d = np.load(path)
        conf = bench.load_cell(ROOT, str(d["cell"]))["conf"]
        seed = int(d["seed"])
        ref = reference_for(ROOT, conf)
        seqs = np.split(d["tokens"].astype(np.int64), np.cumsum(d["lens"])[:-1])
        wanted = [range(p - 1, len(q) - 1) for p, q in zip(d["prompt"], seqs)]
        served = [torch.as_tensor(q[p:]) for p, q in zip(d["prompt"], seqs)]
        exact = ref.logits_at(conf, seed, seqs, wanted, device)
        low = ref.logits_at(conf, seed, seqs, wanted, device, precision="fp8")
        vocab = exact[0].shape[-1]
        streams = {
            "program": [ref.gaps(lg, t).cpu() for lg, t in zip(exact, served)],
            "control_fp8": [ref.gaps(lg, lo.argmax(-1)).cpu()
                            for lg, lo in zip(exact, low)],
            "altered_tokens": [ref.gaps(lg, (t + 1) % vocab).cpu()
                               for lg, t in zip(exact, served)],
        }
        line = [f"{d['cell']} seed {seed}: "
                f"{sum(len(g) for g in streams['program'])} positions"]
        for name, gaps in streams.items():
            gap, limit, ok = bench.gap_check(conf, gaps)
            line.append(f"{name} correct={ok} mean_gap {gap['mean']:.5f} "
                        f"(limit {limit}) widest {gap['widest']:.4f} "
                        f"mismatch {gap['mismatch']:.4f}")
            sound &= ok == (name == "program")
        print("; ".join(line), flush=True)
    print(f"control: {'sound' if sound else 'NOT sound'} over {len(paths)} "
          "dumps", flush=True)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
