"""Logical-axes trees for non-parameter state (caches, optimizer, batch).

Parameters carry their own axes (``model_zoo.param_specs``); caches and
optimizer states get theirs derived here, shaped like the port's own
trees:

  * caches are ``{"groups": [{"l<i>": layer cache}] * n_groups,
    "prefix": [layer cache] * n_dense}`` (an encoder-decoder's
    ``{"self": [...], "cross": [...]}`` a decoder layer each), with no
    stacked ``"layers"`` axis;
  * the optimizer state holds one leaf per per-layer parameter, and
    Adafactor's ``vr`` / ``vc`` follow ``optim.optimizer``'s factoring
    rule on those leaves.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.parallel.sharding import (NamedSharding, is_axes,
                                           map_axes, spec_for)

AX_ATTN = {"k": ("batch", "seq_kv", "kv_heads", None),
           "v": ("batch", "seq_kv", "kv_heads", None)}
AX_MLA = {"ckv": ("batch", "seq_kv", None), "kr": ("batch", "seq_kv", None)}
AX_MAMBA = {"conv": ("batch", None, "inner"),
            "h": ("batch", "inner", "state")}
AX_MLSTM = {"conv": ("batch", None, "inner"),
            "state": (("batch", None, None, None),
                      ("batch", None, None), ("batch", None))}
AX_SLSTM = (("batch", None, None),) * 3 + (("batch", None, None),)

__all__ = ["AX_ATTN", "AX_MLA", "AX_MAMBA", "AX_MLSTM", "AX_SLSTM",
           "batch_axes", "cache_axes", "is_axes", "opt_state_axes",
           "tree_shardings"]


def _layer_cache_axes(kind: str):
    return {"attn": AX_ATTN, "mla": AX_MLA, "mamba": AX_MAMBA,
            "mlstm": AX_MLSTM, "slstm": AX_SLSTM}[kind]


def cache_axes(cfg: ArchConfig):
    """Axes tree matching ``model_zoo.init_caches`` / ``input_specs``'
    caches."""
    if cfg.is_encoder_decoder:
        return {"self": [AX_ATTN] * cfg.n_layers,
                "cross": [AX_ATTN] * cfg.n_layers}
    kinds, _, n_groups = blocks.group_layout(cfg)
    group = {f"l{i}": _layer_cache_axes(k) for i, k in enumerate(kinds)}
    out = {"groups": [group] * n_groups}
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    if n_dense and cfg.block_pattern == "attn":
        kind = "mla" if cfg.attn_type == "mla" else "attn"
        out["prefix"] = [_layer_cache_axes(kind) for _ in range(n_dense)]
    return out


def batch_axes(batch_spec: Dict[str, Any]):
    """Axes for a train/prefill input batch dict."""
    return {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in batch_spec.items()}


def tree_shardings(axes_tree, shapes_tree, mesh, overrides=None):
    """NamedShardings for an (axes, shapes) tree pair."""
    def one(ax, sd):
        return NamedSharding(mesh, spec_for(ax, shape=tuple(sd.shape),
                                            mesh=mesh, rules=overrides))

    return map_axes(one, axes_tree, shapes_tree)


def _is_matrix(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def opt_state_axes(param_axes, param_shapes, kind: str):
    """Axes for the optimizer state, derived from the parameters'."""
    if kind == "adamw":
        return {"m": param_axes, "v": param_axes, "count": ()}

    def vr(ax, sd):
        return ax[:-1] if _is_matrix(sd.shape) else ax

    def vc(ax, sd):
        return ((ax[:-2] + ax[-1:]) if _is_matrix(sd.shape)
                else (None,) * len(sd.shape))

    return {"m": param_axes,
            "vr": map_axes(vr, param_axes, param_shapes),
            "vc": map_axes(vc, param_axes, param_shapes),
            "count": ()}
