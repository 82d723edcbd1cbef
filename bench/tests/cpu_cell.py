"""A cell's whole run on the CPU at a reduced size: the program's
``reduced()`` config, short prompts, a short window, the simulated
device pair's accelerator group.  Only ``cellrun.Overrides`` differs
from a run on the card."""
from __future__ import annotations

import os
import time

import torch

from bench.harness import cellrun, spec

PROMPT, NEW = 24, 4


def conf_of(conf: dict, cfg) -> dict:
    """The configuration file's keys rewritten to ``cfg``'s widths."""
    out = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
           "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads,
           "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
           "kv_lora_rank": cfg.mla.kv_lora_rank,
           "q_lora_rank": cfg.mla.q_lora_rank or None,
           "qk_nope_head_dim": cfg.mla.qk_nope_head_dim,
           "qk_rope_head_dim": cfg.mla.qk_rope_head_dim,
           "v_head_dim": cfg.mla.v_head_dim, "n_slots": 4}
    if cfg.moe is not None:
        out.update(n_routed_experts=cfg.moe.n_routed,
                   n_shared_experts=cfg.moe.n_shared,
                   num_experts_per_tok=cfg.moe.top_k,
                   moe_intermediate_size=cfg.moe.d_ff,
                   first_k_dense_replace=cfg.moe.n_dense_layers)
    return out


def program_env() -> None:
    os.environ.update({"REPRO_AUTOTUNE": "0", "REPRO_CALIB_CACHE": "off",
                       "REPRO_TRACE": "1"})


def run(cell_name: str, *, seed: int = 11, seconds: float = 3.0,
        trace: bool = False, limit: float = 0.01, plant=None,
        traffic: dict = None, cell: dict = None, control: bool = False):
    """(result, check lines) of a reduced run of ``cell_name``."""
    from repro_torch.configs import registry
    from repro_torch.core.hybrid_executor import detect_platform

    program_env()
    bench = spec.benchmark()
    entry = spec.cell(bench, cell_name)
    conf = spec.config(bench, entry["config"])
    over = cellrun.Overrides(
        arch=lambda cfg: cfg.reduced(),
        conf=conf_of(conf, registry.get(conf["registry_name"]).reduced()),
        traffic=dict({"prompt_len": PROMPT, "new_tokens": NEW,
                      "clients": 6, "pool_per_s": 40}, **(traffic or {})),
        cell=dict({"rate_rps": 4.0, "check_requests": 6, "gap_limit": limit},
                  **(cell or {})),
        group=detect_platform(device="cpu")[0][0], plant=plant)
    return cellrun.run(bench, entry, seed=seed, seconds=seconds, trace=trace,
                       device=torch.device("cpu"), t_start=time.monotonic(),
                       note=lambda msg: None, over=over, control=control)
