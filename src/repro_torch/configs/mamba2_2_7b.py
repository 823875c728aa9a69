"""Mamba2-2.7B — attention-free SSD (state-space duality).

64L d_model=2560 ssm_state=128 vocab=50280.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=0,                  # no MLP blocks: mamba2 blocks only
    vocab=50280,
    ssm=SSMConfig(
        d_state=128,
        d_conv=4,
        expand=2,            # d_inner = 5120
        head_dim=64,         # 80 ssm heads
        n_groups=1,
        chunk=256,
    ),
    source="arXiv:2405.21060; unverified",
)
