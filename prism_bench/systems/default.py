"""The system module of a configuration that names none: the decoder-only
MoE models with grouped-query attention and routed SwiGLU experts in every
layer (Mixtral-8x7B, Phi-3.5-MoE), read from Mixtral's key names. The
functions are the harness's own (``pbench.weights``, ``pbench.system``,
``pbench.model``); see ``pbench.refs`` for the contract."""

from pbench.model import decode_flops, gmm_least_seconds, prompt_flops
from pbench.system import build_engine
from pbench.weights import sizes

__all__ = ["sizes", "build_engine", "prompt_flops", "decode_flops",
           "gmm_least_seconds"]
