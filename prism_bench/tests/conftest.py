"""The harness's tests: its package and the program on ``sys.path``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
