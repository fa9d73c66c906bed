"""xLSTM-1.3B [arXiv:2405.04517].

Alternating mLSTM (matrix-memory, parallelizable) and sLSTM (scalar, scan)
blocks; no FFN (d_ff=0) — blocks carry their own up/down projections.
Recurrent state is O(1) in sequence length, so long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_style="none",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_mlstm=2.0),
)
