"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64 vocab=32000.
One shared attention+MLP block (single param set) interleaved every 6
Mamba2 layers. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,                  # shared block MLP
    vocab=32000,
    shared_attn_every=6,
    ssm=SSMConfig(
        d_state=64,
        d_conv=4,
        expand=2,
        head_dim=64,
        n_groups=1,
        chunk=256,
    ),
    source="arXiv:2411.15242; hf",
)
