"""The reference against the port on reduced Mixtral on the CPU, through the
harness's whole run (EdgeCluster on the warmed loop, the window, the
sample, the reference), and the float8 control that has to fail."""

import numpy as np
import torch

from pbench_tiny import ROOT, run_tiny, tiny_spec


def test_port_matches_the_reference_and_the_control_does_not(tmp_path):
    spec = tiny_spec("mixtral-edge3-chat")
    res = run_tiny(spec, seed=2**33 + 11)
    checks = res["checks"]
    assert res["correct"], checks
    assert checks["mean_gap"]["value"] <= checks["mean_gap"]["limit"]
    assert "setup_s" in res["metrics"]
    assert set(res["metrics"]) <= {"ttft_p75_ms", "itl_p95_ms", "setup_s"}

    # the control: the reference in float8 in the program's place, read
    # at the same prompts and served tokens
    from pbench import bench
    from pbench.refs import reference_for

    run_dump = tmp_path / "dump"
    res = bench.run_cell(ROOT, spec, 2**33 + 11, 1.5, False, 0.0,
                         device="cpu", dump=run_dump, log=lambda m: None)
    (path,) = run_dump.glob("*.npz")
    d = np.load(path)
    ref = reference_for(ROOT, spec["conf"])
    seqs = np.split(d["tokens"].astype(np.int64), np.cumsum(d["lens"])[:-1])
    # every position of the prompts and served tokens: the run's few
    # served tokens alone may be too few for a rounding to show
    wanted = [range(len(q) - 1) for q in seqs]
    exact = ref.logits_at(spec["conf"], int(d["seed"]), seqs, wanted, "cpu")
    low = ref.logits_at(spec["conf"], int(d["seed"]), seqs, wanted, "cpu",
                        precision="fp8")
    served = [torch.as_tensor(q[p:]) for p, q in zip(d["prompt"], seqs)]
    prog = [ref.gaps(e[p - 1:], t)
            for e, t, p in zip(exact, served, d["prompt"])]
    ctrl = [ref.gaps(e, lo.argmax(-1)) for e, lo in zip(exact, low)]
    # judged by the comparison that decides a run's ``correct``
    prog_gap, limit, prog_ok = bench.gap_check(spec["conf"], prog)
    ctrl_gap, _, ctrl_ok = bench.gap_check(spec["conf"], ctrl)
    assert prog_ok and not ctrl_ok
    assert prog_gap["mean"] <= limit < ctrl_gap["mean"]


def test_docs_cell_runs_and_reads_its_layers():
    res = run_tiny(tiny_spec("mixtral-edge3-docs"), seconds=2.5, trace=True)
    assert res["correct"], res["checks"]
    # what a slow machine reads in a short window varies; these always are
    assert "step_mfu.docs" in res["metrics"]
    assert set(res["metrics"]) <= {
        "local_ratio.docs", "remote_kb_per_tok.docs", "prefix_hit_share.docs",
        "prefill_tick_ms.docs", "step_mfu.docs", "moe_gmm_roofline.docs",
        "device_idle.docs"}
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res
