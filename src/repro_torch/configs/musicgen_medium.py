"""MusicGen-medium decoder backbone [arXiv:2306.05284].

Decoder-only over EnCodec tokens: 4 parallel codebooks (vocab 2048 each) with
a delay interleaving pattern; codebook embeddings are summed at the input and
4 LM heads predict the next frame. Text conditioning enters as stub prefix
embeddings (the conditioner itself is out of scope per the build carve-out).
"""
from repro_torch.configs.base import ModelConfig, ModalityConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope_style="none",          # musicgen uses learned/sinusoidal positions
    gated_mlp=False,
    activation="gelu",
    modality=ModalityConfig(kind="audio", num_codebooks=4,
                            num_prefix_embeddings=64),
)
