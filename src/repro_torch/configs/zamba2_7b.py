"""Zamba2-7B hybrid [arXiv:2411.15242].

Mamba2 backbone with a single SHARED attention block applied periodically —
the shared transformer block is zamba2's signature. 81 layers, MHA (kv=32).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,                     # shared block's FFN
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64),
    hybrid=HybridConfig(attn_period=6, shared_attention=True),
)
