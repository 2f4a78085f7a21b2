"""Phase marks: one kernel per phase of a serving step that does nothing
and is named after its phase (``phase_mark_<phase>``, ``csrc/
phase_marks.cu``), so a device trace of a replayed step graph shows where
each phase starts. A kernel's phase is the last mark before it on the
stream; a call runs from its first mark (``chunk``, ``decode`` or
``regather``) to its ``end``. Launched only through
``ops.phase_mark``; counted by no launch counter."""

from __future__ import annotations

import torch

from repro_torch.kernels import build

PHASES = ("chunk", "decode", "attention", "moe", "head", "end", "regather",
          "mlp", "shared_expert")
PREFIX = "phase_mark_"  # the kernels' names: PREFIX + phase


def launch(phase: str, device) -> None:
    """Launch ``phase``'s marker on the current stream of ``device``."""
    fn = build.library("phase_marks").phase_mark_launch
    rc = fn(PHASES.index(phase), torch.cuda.current_stream(device).cuda_stream)
    build.check("phase_mark", rc)
