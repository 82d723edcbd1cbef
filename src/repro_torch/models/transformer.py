"""Decoder-only LM assembled from the block stack."""
from __future__ import annotations

import torch

from repro_torch.models import blocks
from repro_torch.models.layers import (embed, init_embedding, init_norm,
                                       init_unembed, norm, rope_table,
                                       unembed)


def init_lm(gen, cfg, dtype):
    p = {
        "embed": init_embedding(gen, cfg, dtype),
        "stack": blocks.init_stack(gen, cfg, dtype),
        "final_norm": init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_unembed(gen, cfg, dtype)
    return p


def lm_forward(params, inputs, cfg, *, make_cache_len: int = 0):
    """inputs: (B, T) int tokens.

    Returns (logits, caches, aux_loss); activations are bf16."""
    x = embed(params["embed"], inputs, cfg).to(torch.bfloat16)
    T = x.shape[1]
    sin, cos = rope_table(cfg.head_dim_(), T, cfg.rope_theta,
                          torch.arange(T, device=x.device))
    x, caches, aux = blocks.apply_stack(params["stack"], x, cfg, sin=sin,
                                        cos=cos,
                                        make_cache_len=make_cache_len)
    x = norm(params["final_norm"], x, cfg)
    logits = unembed(params.get("unembed"), x, cfg,
                     embed_params=params["embed"])
    return logits, caches, aux


def init_lm_caches(cfg, batch: int, max_len: int, device):
    return blocks.init_stack_caches(cfg, batch, max_len, device)


def lm_decode_step(params, inputs, cfg, caches, position):
    """inputs: (B, 1) token ids; position: an int, or a (B,) int tensor
    of per-row positions.

    Returns (logits (B, 1, V), caches); the caches are updated in place."""
    x = embed(params["embed"], inputs, cfg).to(torch.bfloat16)
    if isinstance(position, int):
        pos = torch.tensor([position], device=x.device)
        sin, cos = rope_table(cfg.head_dim_(), 1, cfg.rope_theta, pos)
    else:
        # one (1, 1, dh/2) table a row, broadcast over its heads
        sin, cos = rope_table(cfg.head_dim_(), 1, cfg.rope_theta,
                              position.to(x.device))
        sin, cos = sin[:, None, None, :], cos[:, None, None, :]
    x, caches, _ = blocks.apply_stack_decode(params["stack"], x, cfg,
                                             caches, position, sin=sin,
                                             cos=cos)
    x = norm(params["final_norm"], x, cfg)
    logits = unembed(params.get("unembed"), x, cfg,
                     embed_params=params["embed"])
    return logits, caches
