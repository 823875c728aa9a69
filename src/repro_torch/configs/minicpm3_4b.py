"""MiniCPM3-4B — dense with Multi-head Latent Attention.

62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    head_dim=96,                      # qk_nope(64) + qk_rope(32)
    rope_theta=10000.0,
    mla=MLAConfig(
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    source="hf:openbmb/MiniCPM3-4B; hf",
)
