"""Llama-3 8B — dense GQA with 128k vocab.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783; unverified",
)
