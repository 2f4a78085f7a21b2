"""``BENCHMARK.json`` keeps to the benchmark's contract, every name it gives
has its file, a run imports neither JAX nor the JAX package, the reference
imports nothing of the program, and a run without a card prints no
result."""

import ast
import json
import os
import re
import subprocess
import sys

from pbench.record import reader_path
from pbench_tiny import ROOT

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BANNED = ("jax", "jaxlib", "flax", "repro")


def test_benchmark_keys_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["prism_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("prism_bench/")
        conf = json.loads((ROOT.parent / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert set(c["reduced"]) == set(conf["reduced_from"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / "reference" / f"{conf['reference']}.py").exists()
        assert len(c["why"]) <= 200
    cells = {}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
        cells[w["name"]] = w
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert reader_path(ROOT, m["name"]).exists()
        assert set(m.get("workloads", [])) <= set(cells)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reports = [m["name"] for m in BENCH["end_to_end"]
                   if w in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT.parent / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from pbench import bench, record, system\n"
        "from pbench.refs import reference_for\n"
        "import repro_torch.serving.cluster, repro_torch.serving.runtime\n"
        "import repro_torch.core.policies, repro_torch.core.baselines\n"
        "import repro_torch.serving.net, repro_torch.launch.serve\n"
        f"root = Path({str(ROOT)!r})\n"
        "for w in ('mixtral-edge3-chat', 'mixtral-edge3-docs'):\n"
        "    spec = bench.load_cell(root, w)\n"
        "    reference_for(root, spec['conf'])\n"
        "    for m in spec['end_to_end'] + spec['per_layer']:\n"
        "        record.load_reader(root, m)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops  # the port's name begins with "repro"
    assert not tops & set(BANNED)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_reference_imports_nothing_of_the_program():
    files = list((ROOT / "reference").glob("*.py"))
    files += [ROOT / "pbench" / "weights.py", ROOT / "pbench" / "tokens.py"]
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in BANNED + ("repro_torch",), (f, name)


def test_every_system_module_a_configuration_names_exists():
    from pbench.refs import system_path

    assert (ROOT / "systems" / "default.py").exists()
    for c in BENCH["configs"]:
        conf = json.loads((ROOT.parent / c["file"]).read_text())
        if "system" in conf:
            assert NAME.match(conf["system"]), c["name"]
        assert system_path(ROOT, conf).exists(), c["name"]


def test_system_modules_import_neither_jax_nor_the_jax_package():
    files = list((ROOT / "systems").glob("*.py"))
    files += list((ROOT / "tests").glob("*_system.py"))
    files += list((ROOT / "pbench").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in BANNED, (f, name)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "run.py"), "--workload",
         "mixtral-edge3-chat", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "correct: false" in out.stderr
