"""A system module for the harness's tests (``systems/<name>.py`` in a
checkout that names it): a configuration written with DeepSeek-V2's key
names for the routed experts (``n_routed_experts``,
``moe_intermediate_size``, ``num_experts_per_tok``), where
``intermediate_size`` is the width of a dense layer and not an expert's,
served by the default engine. It stands for a new architecture's module:
the harness reaches it only through the configuration's ``system`` key."""

from pbench import model, system
from pbench import weights as W


def as_default(conf: dict) -> dict:
    """The configuration under the default module's key names."""
    return dict(conf, num_local_experts=conf["n_routed_experts"],
                intermediate_size=conf["moe_intermediate_size"])


def sizes(conf: dict) -> dict:
    return W.sizes(as_default(conf))


def build_engine(conf: dict, seed: int, max_len: int, device: str):
    return system.build_engine(as_default(conf), seed, max_len, device)


prompt_flops = model.prompt_flops
decode_flops = model.decode_flops
gmm_least_seconds = model.gmm_least_seconds
