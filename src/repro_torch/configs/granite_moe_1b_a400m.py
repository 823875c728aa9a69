"""IBM Granite 3.0 1B-A400M base — small MoE.

24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155,
32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=32,
        top_k=8,
        d_ff_expert=512,
        n_shared_experts=0,
        capacity_factor=1.25,
    ),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
