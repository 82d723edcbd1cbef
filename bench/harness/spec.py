"""Finding a cell and everything it names by name: ``BENCHMARK.json``
at the checkout's root, the configuration file, the traffic mix
(``bench/traffic/<name>.json``), the cell's own parameters
(``bench/cells/<name>.json``) and each metric's reader
(``bench/metrics/<name>.py``).  A later cell or metric is added by
adding files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def cell_params(name: str) -> dict:
    return load_json(BENCH / "cells" / f"{name}.json")


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of this cell reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; a metric with
    a ``workloads`` key only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    mod_name = "bench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in metric_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# the configuration file's keys (the published config's names) against
# the fields of the program's ArchConfig that must equal them
_TOP = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
        "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads",
        "intermediate_size": "d_ff", "vocab_size": "vocab_size",
        "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
        "tie_word_embeddings": "tie_embeddings", "hidden_act": "act"}
_MLA = {"kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
        "qk_nope_head_dim": "qk_nope_head_dim",
        "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim"}
_MOE = {"n_routed_experts": "n_routed", "n_shared_experts": "n_shared",
        "num_experts_per_tok": "top_k", "moe_intermediate_size": "d_ff",
        "first_k_dense_replace": "n_dense_layers"}


def mismatches(conf: dict, cfg) -> Dict[str, tuple]:
    """Every key of the configuration file that the program's
    ``ArchConfig`` does not run as written: {key: (file, program)}.
    Also the mechanisms the port lacks (a rope scaling, MiniCPM's
    scales) where the file states one."""
    out = {}

    def cmp(key, want, got):
        if want is None and key == "q_lora_rank":
            want = 0
        if isinstance(want, float) or isinstance(got, float):
            same = want is not None and abs(float(want) - float(got)) <= \
                1e-12 * max(1.0, abs(float(got)))
        else:
            same = want == got
        if not same:
            out[key] = (want, got)

    for key, field in _TOP.items():
        if key in conf:
            cmp(key, conf[key], getattr(cfg, field))
    if cfg.mla is None:
        out["kv_lora_rank"] = (conf.get("kv_lora_rank"), None)
    else:
        for key, field in _MLA.items():
            cmp(key, conf.get(key), getattr(cfg.mla, field))
    if "n_routed_experts" in conf:
        if cfg.moe is None:
            out["n_routed_experts"] = (conf["n_routed_experts"], None)
        else:
            for key, field in _MOE.items():
                cmp(key, conf.get(key), getattr(cfg.moe, field))
    elif cfg.moe is not None:
        out["n_routed_experts"] = (None, cfg.moe.n_routed)
    for key in ("rope_scaling", "scale_emb", "scale_depth",
                "dim_model_base"):
        if conf.get(key) is not None:
            out[key] = (conf[key], None)
    if cfg.attn_type != "mla" or cfg.sliding_window or cfg.qk_norm \
            or cfg.logit_softcap or cfg.norm_type != "rmsnorm" \
            or not cfg.mlp_gated or cfg.use_bias:
        out["architecture"] = ("mla, rmsnorm, gated ffn, no bias", cfg.name)
    return out
