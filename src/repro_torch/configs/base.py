"""Base configuration dataclasses for the model zoo (a copy of the JAX
package's `repro/configs/base.py`, so the port imports nothing of it).

Every assigned architecture is expressed as a ``ModelConfig``. Families:
  dense | moe | ssm | hybrid | audio (enc-dec) | vlm
Attention variants are flags: GQA (n_kv_heads), MLA (kv_lora_rank>0),
SWA (sliding_window>0), qk_norm.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    d_ff_expert: int = 0          # per-expert intermediate size
    n_shared_experts: int = 0     # always-on shared experts (deepseek-style)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0   # leading dense layers (deepseek v2 uses 1)
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 0         # compressed kv dim (c_kv)
    q_lora_rank: int = 0          # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0              # N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # P
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec (whisper) / vlm (InternViT stub)."""
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    d_ff: int = 0
    source_len: int = 0           # audio frames / image patches
    frontend: str = "stub"        # modality frontend is a stub: input_specs()
                                  # provides precomputed frame/patch embeddings


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    qk_norm: bool = False
    sliding_window: int = 0       # 0 => full attention
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # hybrid (zamba2-style): a shared attention+MLP block is interleaved
    # every `shared_attn_every` ssm layers, reusing ONE set of params.
    shared_attn_every: int = 0
    # dtype policy
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    source: str = ""              # provenance tag

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.mla.kv_lora_rank > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    @property
    def is_vlm(self) -> bool:
        return self.family == "vlm"

    @property
    def subquadratic(self) -> bool:
        """True when the arch can run long_500k decode (sub-quadratic /
        bounded-state sequence mixing)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        """All assigned archs autogress; encoder-only would return False."""
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32 if cfg.head_dim else 0,
    )
    if cfg.is_moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.is_mla:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, q_lora_rank=0,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
        kw["n_layers"] = min(cfg.n_layers, 4)
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
    if cfg.encoder.n_layers:
        kw["encoder"] = dataclasses.replace(
            cfg.encoder, n_layers=2, d_model=128, n_heads=4, d_ff=256,
            source_len=16)
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return cfg.replace(**kw)
