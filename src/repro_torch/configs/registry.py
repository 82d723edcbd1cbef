"""Registry of assigned architectures (``--arch <id>``)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "command-r-35b": "command_r_35b",
    "minicpm3-4b": "minicpm3_4b",
    "minitron-8b": "minitron_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "chameleon-34b": "chameleon_34b",
    "whisper-tiny": "whisper_tiny",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get(arch_id: str) -> ArchConfig:
    key = arch_id.replace("_", "-")
    if key not in _MODULES:
        # allow module-style ids too
        for k, mod in _MODULES.items():
            if mod == arch_id:
                key = k
                break
        else:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG
