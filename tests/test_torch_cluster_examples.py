"""The port's cluster examples run end to end on the CPU: the 3-server
``EdgeCluster`` on both backends, and failover through a crash (each
example asserts its own outcome and prints ``OK``)."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["serve_edge_torch.py",
                                  "serve_edge_failover_torch.py"])
def test_example_runs_on_cpu(name):
    # the examples' prompts come from TaskTokenSource, seeded by hash()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "\nOK: " in out.stdout
