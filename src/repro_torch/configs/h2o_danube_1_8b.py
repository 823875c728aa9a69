"""H2O-Danube 1.8B — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA(4096).
[arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    source="arXiv:2401.16818; hf",
)
