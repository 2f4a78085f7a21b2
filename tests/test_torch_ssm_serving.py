"""SSM and hybrid architectures in the port's ``ServingRuntime`` (the
dense slot pool, whose rows hold the Mamba-1 / Mamba-2 states beside the
hybrid's shared-attention cache): token streams against the reference
runtime's and the port's own ``generate()``, and the serving launcher."""

import numpy as np
import pytest

from repro.serving.api import Request as JRequest
from repro.serving.runtime import ServingRuntime as JRuntime
from repro_torch.launch import serve as tserve
from repro_torch.serving.api import Request
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_runtime_tokens_equal_reference_and_generate(arch):
    """Exact: three greedy requests of 12 prompt tokens on two slots (the
    third waits for a row, whose states it then overwrites) and one
    sampled request of 9; the greedy streams equal ``generate()``'s."""
    jeng, teng = build_pair(arch, "dense", max_len=32)
    vocab = teng.rt.cfg.vocab_size
    greedy = prompts(vocab, 3, 12, seed=1)
    reqs = [(p, 0.0, 0) for p in greedy] + [(prompts(vocab, 1, 9, seed=2)[0],
                                             0.9, 7)]

    def serve(runtime_cls, request_cls, engine):
        rt = runtime_cls(engine, max_slots=2)
        hs = [rt.enqueue(request_cls(prompt=p, max_new_tokens=8,
                                     temperature=t, seed=s))
              for p, t, s in reqs]
        rt.run()
        return [h.result().tolist() for h in hs], rt

    want, _ = serve(JRuntime, JRequest, jeng)
    got, rt = serve(ServingRuntime, Request, teng)
    assert not rt.paged and rt.rounds > 0
    assert got == want
    gen, _ = teng.generate(greedy, steps=8)
    np.testing.assert_array_equal(np.asarray(got[:3]), gen)


def test_serve_launcher_runs_zamba2_on_cpu(capsys):
    """``repro_torch.launch.serve --arch zamba2-2.7b --device cpu`` serves
    its requests through the dense pool (no placement controller for a
    model without MoE layers)."""
    tserve.main(["--arch", "zamba2-2.7b", "--device", "cpu", "--requests",
                 "2", "--prompt", "8", "--steps", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 2 requests / 6 tokens" in out and "pool=dense[" in out
    assert "migrations=0" in out
