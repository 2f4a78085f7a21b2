"""Where the launch phase's Mixtral steps spend their time, on the card.

``chip_smoke.py`` phase 8 times Mixtral-8x7B at full width (EP on one
virtual rank, bf16) through ``launch/perf.py`` at 1 and 2 of 32 layers.
This builds the same steps at 2 layers (``dryrun.build_step`` on the
card: ``train_4k`` at B = 1 under ``baseline`` and ``tp+dots``,
``prefill_32k`` at B = 1, ``decode_32k`` at B = 8), runs each once to
warm up and once under ``torch.profiler``, and prints the step's wall
time, its device time by kernel group (the library's GEMMs, the hand
kernels, the rest) and the device's busy share; for train also the
forward and backward alone, so that the optimizer's update is the
difference.

    python3 tools/launch_profile.py

Prints the card's name and power limit first.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402

CASES = [("train_4k", "baseline"), ("train_4k", "tp+dots"),
         ("prefill_32k", "baseline"), ("decode_32k", "baseline")]
LAYERS = 2


def device_ms(run) -> tuple:
    """(wall ms, {kernel group: device ms}) of ``run()`` under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = dict.fromkeys([g for g, _ in chip_smoke.PROFILE_GROUPS]
                           + ["other"], 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            low = e.name.lower()
            hit = next((g for g, keys in chip_smoke.PROFILE_GROUPS
                        if any(k in low for k in keys)), "other")
            groups[hit] += (e.time_range.end - e.time_range.start) / 1e3
    return wall, {k: v for k, v in groups.items() if v > 0}


def line(label, wall, groups) -> str:
    total = sum(groups.values())
    if not total:
        return f"{label}: {wall:.1f} ms wall; device time not measured"
    return (f"{label}: {wall:.1f} ms wall, device kernels {total:.1f} ms "
            f"(busy {total / wall:.0%}): "
            + ", ".join(f"{k} {v:.1f} ms ({v / total:.0%})"
                        for k, v in groups.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_profile: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    cfg = dryrun.depth_variant(get_config(chip_smoke.LAUNCH_ARCH), LAYERS)
    for shape_name, variant in CASES:
        base = INPUT_SHAPES[shape_name]
        shape = dataclasses.replace(
            base, global_batch=perf.CARD_BATCH[base.kind])
        kw = perf.VARIANTS[variant]
        torch.cuda.empty_cache()
        fn, kwargs = dryrun.build_step(cfg, shape, device="cuda", **kw)
        fn(**kwargs)
        label = (f"{chip_smoke.LAUNCH_ARCH} x{LAYERS} {shape_name} {variant} "
                 f"B={shape.global_batch}")
        print(line(f"{label} step", *device_ms(lambda: fn(**kwargs))),
              flush=True)
        if base.kind == "train":
            rt = dryrun.make_runtime(cfg, shape, device="cuda", **kw)
            pl = kwargs["placement"]
            tables = moe_mod.placement_to(pl, "cuda") if pl is not None \
                else None
            print(line(f"{label} forward+backward", *device_ms(
                lambda: loss_and_grads(rt, kwargs["params"], kwargs["tokens"],
                                       kwargs["targets"], tables))),
                  flush=True)
        del fn, kwargs
    return 0


if __name__ == "__main__":
    sys.exit(main())
