"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

Interleaved MoE (every other layer), 128 routed experts top-1 plus one shared
expert; chunked local attention (iRoPE-style) keeps decode sub-quadratic, so
this arch runs the long_500k shape. Early-fusion multimodality is out of the
backbone's scope (text token stream here).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,                      # dense layers' FFN
    vocab_size=202048,
    rope_theta=500_000.0,
    attention_chunk=8192,           # chunked local attention
    qk_norm=True,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        layer_period=2,             # interleaved: every other layer MoE
        num_shared_experts=1,
        d_ff_shared=8192,
    ),
)
