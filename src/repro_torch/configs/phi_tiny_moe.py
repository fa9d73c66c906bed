"""Phi-tiny-MoE [arXiv:2404.14219; SlimMoE] — paper Table 1: 3.8B total /
1.1B active, 16 experts top-2.  Dims solved to match the published
total/active counts (d_model 2304, 36 heads GQA kv=9, d_ff_expert 915
-> 3.81B / 0.98B)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi-tiny-moe",
    family="moe",
    source="arXiv:2404.14219 (paper Table 1)",
    num_layers=32,
    d_model=2304,
    num_heads=36,
    num_kv_heads=9,
    head_dim=64,
    d_ff=915,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=915, layer_period=1),
)
