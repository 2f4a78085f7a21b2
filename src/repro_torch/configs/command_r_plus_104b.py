"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no-bias."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    rope_theta=75e6, tie_embeddings=True, sliding_window=8192,
    source="hf:CohereForAI/c4ai-command-r-v01",
))
