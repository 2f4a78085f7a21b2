"""A cell cut to a size the CPU serves in seconds, for the harness's tests:
reduced Mixtral (d_model 256, 2 layers, 4 heads over 2 kv heads of 64,
4 experts top-2 over three servers of 2 slots, vocabulary 512), float32,
and the chat or docs mix at a few requests."""

import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tiny_spec(cell: str = "mixtral-edge3-chat") -> dict:
    from pbench import bench

    spec = bench.load_cell(ROOT, cell)
    conf = dict(spec["conf"], hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2,
                num_hidden_layers=2, vocab_size=512, num_local_experts=4,
                torch_dtype="float32", check={"mean_gap": 1e-3})
    conf["deployment"] = dict(conf["deployment"], slots_per_server=2)
    spec.update(conf=conf, mix=tiny_mix(spec["mix"]))
    return spec


def tiny_mix(mix: dict) -> dict:
    """The chat or docs mix at a few requests of a few tokens."""
    mix = dict(mix, max_slots=4, warmup_s=1.0, check_tokens=16,
               placement=dict(mix["placement"], review_ticks=4))
    if mix["arrivals"] == "poisson":
        mix.update(rate_per_s=6.0, prompt_len=[20, 0.4, 8, 40],
                   output_len=[3, 0.3, 2, 4], system_prompt_tokens=16,
                   tail_s=3.0, max_len=64)
    else:
        mix.update(documents=8, doc_len=[40, 0.4, 24, 64],
                   question_len=[4, 8], ask_gap=[0, 3],
                   output_len=[3, 0.3, 2, 4], tail_s=20.0, max_len=96)
    return mix


def run_tiny(spec: dict, seed: int = 2**33 + 5, seconds: float = 1.5,
             trace: bool = False) -> dict:
    import torch

    from pbench import bench

    torch.set_num_threads(2)
    return bench.run_cell(ROOT, spec, seed, seconds, trace,
                          time.perf_counter(), device="cpu",
                          log=lambda m: None)
