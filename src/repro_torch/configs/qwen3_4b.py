"""Qwen3-4B — dense GQA with qk-norm.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)
