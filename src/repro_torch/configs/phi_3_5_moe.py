"""Phi-3.5-MoE [arXiv:2404.14219] — paper Table 1: 60.8B total / 6.6B active,
16 experts top-2."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi-3.5-moe",
    family="moe",
    source="arXiv:2404.14219 (paper Table 1)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    sliding_window=131072,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400, layer_period=1),
)
