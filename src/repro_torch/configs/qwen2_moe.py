"""Qwen2-MoE [arXiv:2407.10671] — paper Table 1: 14.3B total / 2.7B active,
64 experts top-4 (fine-grained) + shared expert."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe",
    family="moe",
    source="arXiv:2407.10671 (paper Table 1)",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,
    vocab_size=151936,
    moe=MoEConfig(num_experts=64, top_k=4, d_ff_expert=1408, layer_period=1,
                  num_shared_experts=1, d_ff_shared=5632),
)
