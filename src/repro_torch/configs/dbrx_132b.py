"""DBRX 132B [hf:databricks/dbrx-base].

Fine-grained MoE: 16 experts, top-4 routing, every layer MoE.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752, layer_period=1),
)
