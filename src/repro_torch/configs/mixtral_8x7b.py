"""Mixtral-8x7B [arXiv:2401.04088] — paper Table 1: 47.0B total / 13.0B active,
8 experts top-2."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088 (paper Table 1)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336, layer_period=1),
)
