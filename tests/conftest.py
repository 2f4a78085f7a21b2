import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests must see the real single
# CPU device. Multi-device SPMD tests run in subprocesses (test_multidevice).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:  # property tests prefer real hypothesis; fall back to the local
    # deterministic mini-implementation when it isn't installed
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_fallback
    sys.modules["hypothesis"] = _hypothesis_fallback

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one); run on "
        "the card with `PYTHONPATH=src python -m pytest --noconftest -q "
        "tests/test_torch_cuda.py`")
