"""Config system for the Harvest reproduction framework.

One :class:`ModelConfig` describes any architecture in the assigned pool
(dense / MoE / SSM / hybrid / VLM / audio).  Architecture files live next to
this module (``src/repro_torch/configs/<arch_id>.py``) and export ``CONFIG``.

The config is a frozen dataclass, so it is hashable and safe to share.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    # every `layer_period`-th layer is MoE (1 = every layer, 2 = interleaved)
    layer_period: int = 1
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_jitter: float = 0.0
    # aux load-balance loss weight (train only)
    lb_loss_weight: float = 0.01
    # dispatch capacity factor (tokens_per_expert = t*k/E * cf)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style selective state space configuration."""

    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64           # mamba2 multi-head: d_inner / head_dim heads
    chunk_size: int = 256        # SSD block scan chunk


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention block."""

    attn_period: int = 6         # shared attention block applied every N layers
    shared_attention: bool = True  # one set of attn weights reused (zamba2 signature)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: alternating mLSTM / sLSTM blocks (scanned as pairs)."""

    slstm_every: int = 8         # one sLSTM block per `slstm_every` layers
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3334
    conv_width: int = 4


@dataclass(frozen=True)
class ModalityConfig:
    """Frontend stub description (VLM vision encoder / audio codec).

    Per the build instructions the frontend itself is NOT implemented; the
    launcher's ``input_specs`` supplies precomputed embeddings of the shape
    declared here and the decoder backbone consumes them.
    """

    kind: str                    # "vision" | "audio"
    # vision: number of patch embeddings prepended to the token stream
    num_prefix_embeddings: int = 0
    # audio (EnCodec): parallel codebooks, each with its own vocab + lm head
    num_codebooks: int = 1
    # M-RoPE 3D position sections (t, h, w) summing to head_dim//2
    mrope_sections: Optional[Tuple[int, int, int]] = None


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str                  # citation (arXiv / hf model card)

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // num_heads

    # attention flavour
    rope_style: str = "rope"     # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None     # SWA window (h2o-danube3)
    attention_chunk: Optional[int] = None    # chunked local attention (llama4)
    qk_norm: bool = False
    attn_bias: bool = False
    logit_softcap: Optional[float] = None

    # mlp flavour
    activation: str = "silu"     # "silu" | "gelu" | "relu2" (nemotron squared relu)
    mlp_bias: bool = False
    gated_mlp: bool = True       # SwiGLU-style gate; False -> plain 2-matrix MLP

    # norms / embeddings
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r style parallel attn+mlp

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    modality: Optional[ModalityConfig] = None

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return (layer_idx % self.moe.layer_period) == (self.moe.layer_period - 1)

    @property
    def num_moe_layers(self) -> int:
        if self.moe is None:
            return 0
        return sum(self.is_moe_layer(i) for i in range(self.num_layers))

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid state, SWA, or chunked attention."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
            or self.attention_chunk is not None
        )

    @property
    def has_kv_cache(self) -> bool:
        """Pure-SSM stacks keep recurrent state instead of a KV cache."""
        return self.family != "ssm"

    # ------------------------------------------------------------------
    # Parameter counting (used by Table 1 bench and the roofline's 6ND)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * hd * nq + 2 * d * hd * nkv + hd * nq * d  # q,k,v,o

        def ffn_params(d_ff: int) -> int:
            mats = 3 if self.gated_mlp else 2
            return mats * d * d_ff

        total = 0
        active = 0
        for i in range(self.num_layers):
            layer_total = 0
            layer_active = 0
            if self.family == "ssm" and self.xlstm is not None:
                # handled coarsely: mLSTM block ~ 4*d*(pf*d) + sLSTM ~ 4*d*d
                pf = self.xlstm.proj_factor_mlstm
                layer_total = int(4 * d * pf * d)
                layer_active = layer_total
            elif self.family in ("hybrid",) and self.ssm is not None:
                d_in = self.ssm.expand * d
                layer_total = 2 * d * d_in + d_in * d  # in/out proj (approx)
                layer_active = layer_total
            else:
                layer_total += attn
                layer_active += attn
                if self.is_moe_layer(i):
                    e = ffn_params(self.moe.d_ff_expert)
                    layer_total += self.moe.num_experts * e
                    layer_active += self.moe.top_k * e
                    if self.moe.num_shared_experts:
                        s = ffn_params(self.moe.d_ff_shared) * self.moe.num_shared_experts
                        layer_total += s
                        layer_active += s
                elif self.d_ff:
                    f = ffn_params(self.d_ff)
                    layer_total += f
                    layer_active += f
            total += layer_total
            active += layer_active
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.modality is not None and self.modality.num_codebooks > 1:
            emb = self.modality.num_codebooks * self.vocab_size * d * 2
        total += emb
        active += emb
        return {"total": total, "active": active}

    # ------------------------------------------------------------------
    # Reduced variant for CPU smoke tests
    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family, tiny dims: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv_heads = min(self.num_kv_heads, max(1, num_heads // self.q_per_kv if self.q_per_kv else num_heads))
        num_kv_heads = max(1, min(num_kv_heads, num_heads))
        while num_heads % num_kv_heads:
            num_kv_heads -= 1
        head_dim = min(self.resolved_head_dim, 64)
        changes = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=64 if self.sliding_window else None,
            attention_chunk=64 if self.attention_chunk else None,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                d_ff_shared=min(self.moe.d_ff_shared, 256),
                layer_period=1,
                capacity_factor=8.0,   # lossless dispatch for exactness tests
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16), head_dim=32,
                chunk_size=32,
            )
        if self.hybrid is not None:
            changes["hybrid"] = dataclasses.replace(self.hybrid, attn_period=2)
        if self.xlstm is not None:
            changes["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2)
        if self.modality is not None:
            changes["modality"] = dataclasses.replace(
                self.modality,
                num_prefix_embeddings=min(self.modality.num_prefix_embeddings, 8),
                mrope_sections=(16, 8, 8) if self.modality.mrope_sections else None,
            )
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


ASSIGNED_ARCHS = [
    "qwen2-vl-72b",
    "llama4-maverick-400b-a17b",
    "zamba2-7b",
    "command-r-35b",
    "xlstm-1.3b",
    "nemotron-4-15b",
    "h2o-danube-3-4b",
    "yi-6b",
    "musicgen-medium",
    "dbrx-132b",
]

# the paper's own MoE zoo (Table 1) used by the Fig 5/6 benchmarks
PAPER_ARCHS = ["mixtral-8x7b", "qwen2-moe", "phi-3.5-moe", "phi-tiny-moe"]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    """Load ``CONFIG`` from ``repro_torch.configs.<arch_id>`` (dashes -> underscores)."""
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ASSIGNED_ARCHS + PAPER_ARCHS}


def dryrun_pairs() -> list:
    """Every (arch, shape) pair exercised by the dry-run, with documented skips."""
    pairs = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in INPUT_SHAPES.values():
            if shape.name == "long_500k" and not cfg.supports_long_context:
                continue  # skip documented in DESIGN.md §Arch-applicability
            pairs.append((arch, shape.name))
    return pairs
