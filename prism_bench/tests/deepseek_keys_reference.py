"""The plain reference for ``deepseek_keys_system``'s configurations
(``reference/<name>.py`` in a checkout that names it): the MoE decoder of
``reference/moe_decoder.py`` beside it, read from DeepSeek-V2's key names
for the routed experts."""

from pathlib import Path

from pbench.refs import reference_for

_base = reference_for(Path(__file__).resolve().parents[1],
                      {"reference": "moe_decoder"})
gaps = _base.gaps


def logits_at(conf: dict, seed: int, seqs, wanted, device,
              precision: str = "fp32"):
    conf = dict(conf, num_local_experts=conf["n_routed_experts"],
                intermediate_size=conf["moe_intermediate_size"])
    return _base.logits_at(conf, seed, seqs, wanted, device, precision)
