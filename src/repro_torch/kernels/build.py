"""Build the port's CUDA kernels and load them through ``ctypes``.

Every source in ``csrc/`` is compiled by its own ``nvcc`` process for
``sm_90a`` into a shared library with a plain C interface, all of them
started together, into ``build/kernels/`` at the root of the checkout (a
git-ignored directory). Library names carry a hash of the source, of every
shared header (``csrc/*.cuh``) and of the flags, so an edited kernel or
header is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "moe_gmm": "moe_gmm.cu",
    "flash_attention": "flash_attention.cu",
    "ssm_scan": "ssm_scan.cu",
    "phase_marks": "phase_marks.cu",
    "paged_attention": "paged_attention.cu",
    "paged_mla": "paged_mla.cu",
}
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    f"-I{CSRC}",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the launch functions (see the extern "C" block of each
# .cu), by library: one library may hold several launch functions
SIGNATURES = {
    "moe_gmm": (
        ("moe_gmm_launch", [_I, _I] + [_P] * 8 + [_I] * 8 + [_P]),
        ("moe_gmm_bwd_launch", [_I, _I] + [_P] * 12 + [_I] * 5 + [_P]),
    ),
    "flash_attention": (
        (
            "flash_attention_launch",
            [_I, _I] + [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P],
        ),
        (
            "flash_attention_bwd_launch",
            [_I, _I] + [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P],
        ),
    ),
    "ssm_scan": (
        ("ssm_scan_fwd_launch", [_I] + [_P] * 8 + [_I] * 4 + [_P]),
        ("ssm_scan_bwd_launch", [_I] + [_P] * 13 + [_I] * 4 + [_P]),
    ),
    "phase_marks": (("phase_mark_launch", [_I, _P]),),
    "paged_attention": (
        ("paged_attention_launch",
         [_P] * 10 + [_I] * 13 + [ctypes.c_float, _P]),
    ),
    "paged_mla": (
        ("paged_mla_launch", [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P]),
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all() -> dict:
    """Compile every kernel that is not built yet, one ``nvcc`` per source,
    in parallel. Raises on any failure. Returns
    ``{name: {"seconds": float, "log": str, "cached": bool}}``; ``log``
    holds the compiler's output, including ptxas's register and shared
    memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
        )
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log, "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building every kernel on first use."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(name: str, rc: int) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
