"""Block assembly: attention + (mlp | moe).

Layers are organised into *groups* (the repeating unit — one layer for
homogeneous stacks) after an unrolled dense prefix (the first
``n_dense_layers`` of an MoE model use the dense FFN).  The reference
stacks the groups' parameters and runs a ``lax.scan`` over them; here
``params["groups"]`` is a list of per-group parameter dicts and the
stack is a Python loop over it.  Only ``attn`` stacks are ported:
``model_zoo`` refuses every other config before it reaches this module.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import init_mlp, init_norm, mlp, norm


# ---------------------------------------------------------------------------
# Group layout
# ---------------------------------------------------------------------------
def group_layout(cfg) -> Tuple[List[bool], int]:
    """Returns (moe_flags, n_groups): one layer per group in an ``attn``
    stack, after the dense prefix."""
    return [cfg.moe is not None], cfg.n_layers - _n_dense(cfg)


def _n_dense(cfg) -> int:
    return cfg.moe.n_dense_layers if cfg.moe else 0


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------
def init_layer(gen, cfg, use_moe: bool, dtype):
    p: dict = {"norm1": init_norm(cfg, gen.device),
               "mix": attn_mod.init_attention(gen, cfg, dtype)}
    if cfg.d_ff or use_moe:
        p["norm2"] = init_norm(cfg, gen.device)
        p["ffn"] = (moe_mod.init_moe(gen, cfg, dtype) if use_moe
                    else init_mlp(gen, cfg, dtype))
    return p


def _ffn(params, x, cfg, use_moe: bool):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in params:
        h = norm(params["norm2"], x, cfg)
        if use_moe:
            y, aux = moe_mod.moe_ffn(params["ffn"], h, cfg)
        else:
            y = mlp(params["ffn"], h, cfg)
        x = x + y
    return x, aux


def apply_layer(params, x, cfg, use_moe: bool, *, sin, cos,
                make_cache_len: int = 0):
    """Full-sequence layer. Returns (x, cache, aux_loss)."""
    h = norm(params["norm1"], x, cfg)
    y, cache = attn_mod.attention(params["mix"], h, cfg, sin=sin, cos=cos,
                                  make_cache_len=make_cache_len)
    x, aux = _ffn(params, x + y, cfg, use_moe)
    return x, cache, aux


def apply_layer_decode(params, x, cfg, use_moe: bool, cache,
                       position, *, sin, cos):
    """Single-token layer step at an int or a (B,) tensor of per-row
    positions. Returns (x, cache, aux); the cache is updated in place."""
    h = norm(params["norm1"], x, cfg)
    y, cache = attn_mod.attention_decode(params["mix"], h, cfg, cache,
                                         position, sin=sin, cos=cos)
    x, aux = _ffn(params, x + y, cfg, use_moe)
    return x, cache, aux


# ---------------------------------------------------------------------------
# Group (repeating unit) and stack
# ---------------------------------------------------------------------------
def init_group(gen, cfg, dtype):
    moe_flags, _ = group_layout(cfg)
    return {f"l{i}": init_layer(gen, cfg, mf, dtype)
            for i, mf in enumerate(moe_flags)}


def init_stack(gen, cfg, dtype):
    """Per-group params + the unrolled dense prefix."""
    _, n_groups = group_layout(cfg)
    p = {"groups": [init_group(gen, cfg, dtype) for _ in range(n_groups)]}
    if _n_dense(cfg):
        # dense prefix uses the dense d_ff (no MoE)
        p["prefix"] = [init_layer(gen, cfg, False, dtype)
                       for _ in range(_n_dense(cfg))]
    return p


def init_stack_caches(cfg, batch: int, max_len: int, device):
    """Empty bf16 decode caches (the activations' type)."""
    moe_flags, n_groups = group_layout(cfg)

    def one():
        return attn_mod.init_cache(cfg, batch, max_len, device)

    out = {"groups": [{f"l{i}": one() for i in range(len(moe_flags))}
                      for _ in range(n_groups)]}
    if _n_dense(cfg):
        out["prefix"] = [one() for _ in range(_n_dense(cfg))]
    return out


def apply_stack(params, x, cfg, *, sin, cos, make_cache_len: int = 0):
    """Returns (x, caches, aux)."""
    moe_flags, _ = group_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_caches = []
    for lp in params.get("prefix", []):
        x, c, a = apply_layer(lp, x, cfg, False, sin=sin, cos=cos,
                              make_cache_len=make_cache_len)
        prefix_caches.append(c)
        aux = aux + a
    group_caches = []
    for gp in params["groups"]:
        caches = {}
        for i, mf in enumerate(moe_flags):
            x, caches[f"l{i}"], a = apply_layer(
                gp[f"l{i}"], x, cfg, mf, sin=sin, cos=cos,
                make_cache_len=make_cache_len)
            aux = aux + a
        group_caches.append(caches)
    caches = None
    if make_cache_len:
        caches = {"groups": group_caches}
        if prefix_caches:
            caches["prefix"] = prefix_caches
    return x, caches, aux


def apply_stack_decode(params, x, cfg, caches, position, *, sin, cos):
    """Returns (x, caches, aux); the caches are updated in place."""
    moe_flags, _ = group_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, c in zip(params.get("prefix", []), caches.get("prefix", [])):
        x, _, a = apply_layer_decode(lp, x, cfg, False, c, position,
                                     sin=sin, cos=cos)
        aux = aux + a
    for gp, gc in zip(params["groups"], caches["groups"]):
        for i, mf in enumerate(moe_flags):
            x, _, a = apply_layer_decode(gp[f"l{i}"], x, cfg, mf,
                                         gc[f"l{i}"], position, sin=sin,
                                         cos=cos)
            aux = aux + a
    return x, caches, aux
