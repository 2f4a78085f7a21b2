"""A configuration file names the system module that serves it
(``pbench.refs``): without the key, the harness's own functions serve it;
a module of its own, added in new files only, serves a cell end to end;
and the readers take the arithmetic from the run, not from
``pbench.model``."""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from pbench import bench, model, readers, record, refs, system
from pbench import weights as W
from pbench.loop import ReqRec, Tick
from pbench.traffic import Req

from pbench_tiny import ROOT, tiny_mix, tiny_spec

TESTS = Path(__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
DEFAULT = {"sizes": W.sizes, "build_engine": system.build_engine,
           "prompt_flops": model.prompt_flops,
           "decode_flops": model.decode_flops,
           "gmm_least_seconds": model.gmm_least_seconds}

# pbench_tiny's reduced Mixtral written with DeepSeek-V2's key names for the
# routed experts; ``intermediate_size`` is a dense layer's width there
DEEPSEEK_KEYS = {
    "name": "deepseek-keys.tiny", "source": "a test configuration",
    "reference": "deepseek_keys", "system": "deepseek_keys",
    "hidden_size": 256, "intermediate_size": 1024,
    "moe_intermediate_size": 512, "n_routed_experts": 4,
    "num_experts_per_tok": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
    "torch_dtype": "float32", "reduced_from": {},
    "deployment": {"servers": 3, "slots_per_server": 2,
                   "mem_fraction": 0.7},
    "check": {"mean_gap": 1e-3}}
CELL = "deepseek-keys-tiny-chat"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_configuration_without_the_key_runs_the_harness_own_functions(
        cell):
    spec = bench.load_cell(ROOT, cell)
    assert "system" not in spec["conf"]
    assert refs.system_path(ROOT, spec["conf"]) == \
        ROOT / "systems" / "default.py"
    for name, fn in DEFAULT.items():
        assert getattr(spec["system"], name) is fn, name


def _checkout(tmp_path: Path) -> Path:
    """A copy of the harness with one configuration and one chat cell added
    in new files alone: the configuration, its system module and its
    reference, and entries in ``BENCHMARK.json``."""
    root = tmp_path / "prism_bench"
    for d in ("metrics", "traffic", "reference", "systems"):
        shutil.copytree(ROOT / d, root / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(TESTS / "deepseek_keys_system.py",
                root / "systems" / "deepseek_keys.py")
    shutil.copy(TESTS / "deepseek_keys_reference.py",
                root / "reference" / "deepseek_keys.py")
    (root / "configs").mkdir()
    (root / "configs" / "deepseek-keys.tiny.json").write_text(
        json.dumps(DEEPSEEK_KEYS))
    bench_json = json.loads(json.dumps(BENCH))
    bench_json["configs"].append({
        "name": DEEPSEEK_KEYS["name"], "source": "a test configuration",
        "file": "prism_bench/configs/deepseek-keys.tiny.json", "reduced": [],
        "why": "routed experts under DeepSeek-V2's key names"})
    bench_json["workloads"].append({
        "name": CELL, "config": DEEPSEEK_KEYS["name"], "traffic": "chat",
        "chips": 1, "why": "the chat mix on it"})
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if "mixtral-edge3-chat" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root


def test_a_new_system_module_serves_a_cell_end_to_end(tmp_path,
                                                     monkeypatch):
    import torch

    held = {}

    class Run(record.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            held["run"] = self

    monkeypatch.setattr(record, "Run", Run)
    root = _checkout(tmp_path)
    spec = bench.load_cell(root, CELL)
    assert Path(spec["system"].__file__) == \
        root / "systems" / "deepseek_keys.py"
    with pytest.raises(KeyError):  # the default module cannot read it
        W.sizes(spec["conf"])
    s = spec["system"].sizes(spec["conf"])
    assert s == W.sizes(tiny_spec()["conf"])  # pbench_tiny's sizes
    assert (s["experts"], s["ff"]) == (4, 512)
    spec["mix"] = tiny_mix(spec["mix"])
    logs = []
    torch.set_num_threads(2)
    res = bench.run_cell(root, spec, 2**33 + 31, 2.5, True,
                         time.perf_counter(), device="cpu", log=logs.append)
    assert "system: systems/deepseek_keys.py" in logs
    assert res["correct"], res["checks"]
    assert res["checks"]["mean_gap"]["value"] <= DEEPSEEK_KEYS["check"][
        "mean_gap"]
    assert set(res["metrics"]) <= set(spec["per_layer"])
    run = held["run"]
    assert run.system is spec["system"] and run.sizes == s
    # every chat metric reads the run, but the roofline, which needs the
    # card's kernel names in the trace, and the migration's tick, which
    # needs a placement to land before a loaded machine ends the run. Such
    # a machine may end no tick inside so short a window, so the metrics
    # of the window's ticks are read over every tick the run served.
    run.window = (run.ticks[0].t0, run.ticks[-1].t1 + 1.0)
    chat = set(spec["per_layer"])
    assert len(chat) == 8
    read = {m for m in chat if record.load_reader(root, m)(run) is not None}
    assert chat - {"moe_gmm_roofline.chat", "migration_tick_ms.chat"} <= \
        read


def _doubled_system(tmp_path: Path):
    """A system module whose arithmetic counts twice the default's."""
    (tmp_path / "systems").mkdir()
    (tmp_path / "systems" / "doubled.py").write_text(
        "from pbench import model\n"
        "from pbench.system import build_engine\n"
        "from pbench.weights import sizes\n\n\n"
        "def prompt_flops(s, prompt_len, skipped):\n"
        "    return 2 * model.prompt_flops(s, prompt_len, skipped)\n\n\n"
        "def decode_flops(s, prompt_len, k):\n"
        "    return 2 * model.decode_flops(s, prompt_len, k)\n\n\n"
        "def gmm_least_seconds(s, counts):\n"
        "    return 2 * model.gmm_least_seconds(s, counts)\n")
    return refs.system_for(tmp_path, {"system": "doubled"})


def _served_run(**kw) -> record.Run:
    """Three ticks of 0.5 s on one layer, two servers and three experts,
    traced, with a prompt admitted in the first and its tokens after each;
    ``moe_gmm`` busy 10 us of each tick on the trace's clock."""
    S = dict(layers=1, d=4096, heads=32, kv_heads=8, hd=128, ff=14336,
             experts=3, top_k=2, vocab=32000)
    delta = np.zeros((1, 2, 3))
    delta[0, 0, :2] = 1
    ticks = [Tick(k, k * 0.5, k * 0.5 + 0.5, k == 0, True, False, delta,
                  np.ones((1, 2, 3))) for k in range(3)]
    rec = ReqRec(Req(0, 0.0, 0, 0, np.zeros(40, np.int32), 3), 0.0,
                 admit_t=0.0, token_t=[0.5, 1.0, 1.5])
    run = record.Run(sizes=S, mix={}, recs=[rec], ticks=ticks,
                     window=(0.0, 1.5), seconds=1.5, setup_s=1.0, **kw)
    host = [("traced", 0.0, 1.5e6)] + [
        (f"step#{k}", k * 0.5e6, k * 0.5e6 + 0.5e6) for k in range(3)]
    dev = [("gmm_tc", k * 0.5e6 + 1.0, k * 0.5e6 + 11.0) for k in range(3)]
    run.trace = record.traced(dev, host)
    return run


def test_the_readers_take_the_arithmetic_from_the_run(tmp_path):
    default = _served_run()
    for name, fn in DEFAULT.items():
        assert getattr(default.system, name) is fn, name
    doubled = _served_run(system=_doubled_system(tmp_path))
    mfu = readers.step_mfu(default)
    assert mfu > 0
    assert readers.step_mfu(doubled) == pytest.approx(2 * mfu, rel=1e-12)
    roof = readers.gmm_roofline(default)
    assert roof > 0
    assert readers.gmm_roofline(doubled) == pytest.approx(2 * roof,
                                                          rel=1e-12)
