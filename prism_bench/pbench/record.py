"""What one run leaves for the metric readers, and the helpers they share.

A reader is a file ``metrics/<metric name>.py`` that defines
``read(run) -> float | None``; ``None`` means it found nothing to read, and
the metric is left out of the result line. Metrics that split one quantity
by the end-to-end metric they move (``step_mfu.chat``, ``step_mfu.docs``)
share ``metrics/<quantity>.py`` unless they have a file of their own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np

from pbench import refs
from pbench import trace as T


@dataclasses.dataclass
class Run:
    sizes: dict
    mix: dict
    recs: list  # loop.ReqRec, in due order
    ticks: list  # loop.Tick
    window: tuple  # (start, end) on the host clock
    seconds: float
    setup_s: float
    trace: dict | None = None  # see traced()
    # the system module that served the run: its arithmetic is the one
    # the readers apply to ``sizes`` (``pbench.refs``)
    system: object = dataclasses.field(
        default_factory=lambda: refs.system_for(refs.ROOT, {}))

    # -- selections ------------------------------------------------------
    def in_window(self, t: float | None) -> bool:
        return t is not None and self.window[0] <= t < self.window[1]

    def window_ticks(self) -> list:
        return [k for k in self.ticks if self.in_window(k.t1)]

    def due_in_window(self) -> list:
        return [r for r in self.recs if self.in_window(r.due_abs)]

    def tick_kind(self, k: int) -> str:
        t = self.ticks[k]
        if t.migrated:
            return "migration"
        if t.prefill:
            return "prefill"
        return "decode" if t.decode else "idle"

    def lagged(self, ticks) -> tuple[np.ndarray, np.ndarray]:
        """(routed rows, residency they were routed under) over ``ticks``:
        the rows a tick drains were launched one tick earlier, under the
        residency in force when that tick started."""
        L, N, E = self.ticks[0].delta.shape
        rows = np.zeros((L, N, E))
        local = np.zeros((L, N, E))
        for t in ticks:
            res = self.ticks[max(t.k - 1, 0)].res
            rows += t.delta
            local += t.delta * res
        return rows, local


def traced(dev: list, host: list) -> dict:
    """The trace's figures over the measured part it covers: the span
    ``traced`` bounds it; device intervals merged into busy time."""
    (t0, t1) = next((s, e) for name, s, e in host if name == "traced")
    busy = T.merged(dev, t0, t1)
    steps = {int(n[5:]): (s, e) for n, s, e in host if n.startswith("step#")}
    return dict(dev=dev, host=host, t0=t0, t1=t1, busy=busy,
                starts=[s for s, _ in busy], steps=steps,
                busy_us=sum(e - s for s, e in busy))


def traced_ticks(run: Run) -> list:
    """Ticks whose step span lies inside the traced part of the window."""
    tr = run.trace
    return [run.ticks[k] for k, (s, e) in sorted(tr["steps"].items())
            if s >= tr["t0"] and e <= tr["t1"] and k < len(run.ticks)]


def reader_path(root: Path, name: str) -> Path:
    """``metrics/<name>.py``, or, where there is none, the reader of the
    quantity that the name splits: ``metrics/<name up to its first
    dot>.py`` (``step_mfu.chat`` and ``step_mfu.docs`` read
    ``step_mfu.py``)."""
    path = root / "metrics" / f"{name}.py"
    return path if path.exists() else root / "metrics" / (
        name.split(".")[0] + ".py")


def load_reader(root: Path, name: str):
    path = reader_path(root, name)
    spec = importlib.util.spec_from_file_location(
        "pbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
