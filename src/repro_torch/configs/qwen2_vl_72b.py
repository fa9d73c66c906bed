"""Qwen2-VL-72B transformer backbone [arXiv:2409.12191].

M-RoPE (3D t/h/w rotary sections), dynamic-resolution vision frontend is a
stub supplying patch embeddings; the decoder consumes them as a prefix.
"""
from repro_torch.configs.base import ModelConfig, ModalityConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_style="mrope",
    rope_theta=1_000_000.0,
    attn_bias=True,  # qwen2 uses qkv bias
    modality=ModalityConfig(
        kind="vision",
        num_prefix_embeddings=1024,     # patch embeddings prepended
        mrope_sections=(16, 24, 24),    # t/h/w sections of head_dim//2 = 64
    ),
)
