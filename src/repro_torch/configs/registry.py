"""Registry of assigned architectures (``--arch <id>``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, SHAPES, shape_applicable

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


def get_optimized(arch_id: str) -> ArchConfig:
    """The §Perf winning configuration per family: the shard_map MoE
    with lean capacity (one-hot dispatch, capacity 1.05, no overflow
    pass, the all_to_all results pinned by the named remat policy) for
    MoE archs; the pure-FSDP layout for mid-size dense archs; the
    baseline elsewhere."""
    cfg = get(arch_id)
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, shard_mode="smap",
                                  dispatch="onehot", capacity_factor=1.05,
                                  overflow_passes=0)
        remat = ("full_names" if cfg.parallel.remat == "full"
                 else "dots_names")
        return cfg.replace(moe=moe, parallel=dataclasses.replace(
            cfg.parallel, remat=remat))
    if cfg.family in ("dense", "vlm") and cfg.parallel.fsdp:
        return cfg.replace(parallel=dataclasses.replace(
            cfg.parallel, layout="fsdp"))
    return cfg


def all_cells():
    """Every (arch, shape) cell with its applicability flag and reason."""
    out = []
    for aid in ARCH_IDS:
        cfg = get(aid)
        for cell in SHAPES:
            ok, why = shape_applicable(cfg, cell)
            out.append((aid, cell, ok, why))
    return out
