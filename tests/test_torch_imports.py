"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither ``jax`` nor the reference package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    code = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25   # every submodule was imported


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_edge_torch.py",
    ROOT / "examples" / "serve_edge_failover_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    bad = [n for n in _imports(path) if _banned(n)]
    assert not bad, f"{path}: imports {bad}"


def test_ops_route_cpu_tensors_to_plain_versions_and_refuse_others():
    from repro_torch.kernels import flash_attention, moe_gmm, ops, ssm_scan

    x = torch.zeros((1, 2, 4))
    w = torch.zeros((1, 4, 4))
    before = moe_gmm.launches
    y = ops.moe_gmm(x, w, w, w, torch.tensor([1], dtype=torch.int32), 2)
    assert y.shape == x.shape and moe_gmm.launches == before
    q = torch.zeros((1, 3, 2, 8))
    kv = torch.zeros((1, 3, 1, 8))
    assert ops.flash_attention(q, kv, kv).shape == q.shape
    assert flash_attention.launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        ops.moe_gmm(x.to("meta"), w, w, w, None, 2)
    xs = torch.zeros((1, 5, 3), requires_grad=True)
    bc = torch.zeros((1, 5, 4))
    y = ops.ssm_scan(xs, xs, bc, bc, -torch.ones((3, 4)), torch.ones(3))
    assert y.shape == xs.shape and y.grad_fn is not None
    assert ssm_scan.launches == 0 and ssm_scan.bwd_launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssm_scan(xs.to("meta"), xs, bc, bc, None, None)
