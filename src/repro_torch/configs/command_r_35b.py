"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense GQA, no biases, parallel attention+MLP block, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8_000_000.0,
    parallel_block=True,
    tie_embeddings=True,
)
