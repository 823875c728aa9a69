"""Architecture registry: ``--arch <id>`` resolves here. The port
serves the ids in `PORTED`; the reference's other architectures raise
"not yet ported"."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401

_ARCH_MODULES = {
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
}

# every architecture of the JAX package, ported or not
ARCH_IDS: List[str] = [
    "deepseek-v2-236b", "granite-moe-1b-a400m", "minicpm3-4b",
    "h2o-danube-1.8b", "llama3-8b", "qwen3-4b", "mamba2-2.7b",
    "whisper-medium", "zamba2-2.7b", "internvl2-2b",
]
PORTED: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    """The config of a ported architecture id."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    if arch_id not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch '{arch_id}' is not yet ported; ported: {PORTED}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG
