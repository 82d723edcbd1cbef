"""Decoder-only LM assembled from the block stack."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.layers import (embed, init_embedding, init_norm,
                                       init_unembed, norm, rope_table,
                                       unembed)
from repro_torch.parallel.sharding import shard_act


def _rope_dim(cfg) -> int:
    if cfg.attn_type == "mla" and cfg.mla is not None:
        return cfg.mla.qk_rope_head_dim
    return cfg.head_dim_()


def _has_attn(cfg) -> bool:
    kinds, _, _ = blocks.group_layout(cfg)
    return any(k in ("attn", "mla") for k in kinds)


def init_lm(gen, cfg, dtype):
    p = {
        "embed": init_embedding(gen, cfg, dtype),
        "stack": blocks.init_stack(gen, cfg, dtype),
        "final_norm": init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_unembed(gen, cfg, dtype)
    return p


def _inputs_to_h(params, inputs, cfg):
    if inputs.is_floating_point():
        # modality-frontend stub: precomputed patch/frame embeddings
        return inputs
    return embed(params["embed"], inputs, cfg)


def lm_forward(params, inputs, cfg, *, tp: int = 1, make_cache_len: int = 0):
    """inputs: (B, T) int tokens or (B, T, d) stub embeddings; ``tp`` the
    model-parallel degree the K/V heads are repeated for
    (``attention.kv_repeat_for``).

    Returns (logits, caches, aux_loss); activations are bf16."""
    x = _inputs_to_h(params, inputs, cfg).to(torch.bfloat16)
    x = shard_act(x, ("batch", None, "embed"))
    sin = cos = None
    if _has_attn(cfg):
        T = x.shape[1]
        sin, cos = rope_table(_rope_dim(cfg), T, cfg.rope_theta,
                              torch.arange(T, device=x.device))
    x, caches, aux = blocks.apply_stack(
        params["stack"], x, cfg, sin=sin, cos=cos,
        kv_repeat=attn_mod.kv_repeat_for(cfg, tp),
        make_cache_len=make_cache_len)
    x = norm(params["final_norm"], x, cfg)
    logits = unembed(params.get("unembed"), x, cfg,
                     embed_params=params["embed"])
    logits = shard_act(logits, ("batch", None, "vocab"))
    return logits, caches, aux


def init_lm_caches(cfg, batch: int, max_len: int, device, tp: int = 1):
    return blocks.init_stack_caches(cfg, batch, max_len, device,
                                    attn_mod.kv_repeat_for(cfg, tp))


def lm_decode_step(params, inputs, cfg, caches, position, *, tp: int = 1):
    """inputs: (B, 1) token ids (or (B, 1, d) embeds); position: an int,
    or a (B,) int tensor of per-row positions.

    Returns (logits (B, 1, V), caches); the caches are updated in place."""
    x = _inputs_to_h(params, inputs, cfg).to(torch.bfloat16)
    x = shard_act(x, ("batch", None, "embed"))
    sin = cos = None
    if _has_attn(cfg):
        dim = _rope_dim(cfg)
        if isinstance(position, int):
            pos = torch.tensor([position], device=x.device)
            sin, cos = rope_table(dim, 1, cfg.rope_theta, pos)
        else:
            # one (1, 1, dim/2) table a row, broadcast over its heads
            sin, cos = rope_table(dim, 1, cfg.rope_theta,
                                  position.to(x.device))
            sin, cos = sin[:, None, None, :], cos[:, None, None, :]
    x, caches, _ = blocks.apply_stack_decode(
        params["stack"], x, cfg, caches, position, sin=sin, cos=cos,
        kv_repeat=attn_mod.kv_repeat_for(cfg, tp))
    x = norm(params["final_norm"], x, cfg)
    logits = unembed(params.get("unembed"), x, cfg,
                     embed_params=params["embed"])
    return logits, caches
