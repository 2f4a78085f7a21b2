"""A run whose timed path is broken underneath reads ``correct`` false: a
token altered where it is produced, the exchange between the servers' EP
ranks left out, a step that leaves the KV cache as it was. (Half of a
batch left out with the mean taken over the rest is a training fault; no
cell here trains.)"""

import pytest
import torch

from pbench_tiny import run_tiny, tiny_spec


def _alter_tokens(monkeypatch):
    from repro_torch.serving import runtime

    append = runtime.ServingRuntime._append_token

    def altered(self, slot, tok):
        return append(self, slot, (int(tok) + 1) % 512)

    monkeypatch.setattr(runtime.ServingRuntime, "_append_token", altered)


def _drop_exchange(monkeypatch):
    from repro_torch.models import moe

    monkeypatch.setattr(moe._AllToAll, "apply", staticmethod(lambda x: x))


def _keep_state(monkeypatch):
    from repro_torch.models import attention

    store = attention._store

    def unchanged(kk, vv, quantized):
        return store(torch.zeros_like(kk), torch.zeros_like(vv), quantized)

    monkeypatch.setattr(attention, "_store", unchanged)


@pytest.mark.parametrize("fault", [_alter_tokens, _drop_exchange,
                                   _keep_state])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_tiny(tiny_spec("mixtral-edge3-chat"), seed=2**33 + 21)
    assert not res["correct"]
    assert res["checks"]["mean_gap"]["value"] > \
        res["checks"]["mean_gap"]["limit"]
