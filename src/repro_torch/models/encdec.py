"""Encoder-decoder transformer (whisper-style).

The audio conv frontend is a STUB, as in the reference: the encoder
takes precomputed frame embeddings (B, S, d_model).  Positions use
fixed sinusoidal tables (no RoPE), layernorm + biases + non-gated GELU,
matching the whisper family.

The encoder's self-attention and the decoder's cross-attention are
unmasked: on the GPU both run K7's full (``causal=False``) route, the
cross-attention at T != S (T = 1 in a decode step).  The reference
stacks each side's layers for a ``lax.scan``; here ``enc_layers`` and
``dec_layers`` are lists of per-layer dicts, and the decode caches are
``{"self": [per-layer K/V cache], "cross": [per-layer encoder K/V]}``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_norm, init_unembed, mlp, norm,
                                       unembed)
from repro_torch.parallel.sharding import shard_act


def sinusoid_pos(T: int, d: int, offset: int = 0, device=None):
    """(T, d) f32: sin of positions ``offset .. offset + T - 1`` times
    each inverse frequency, then their cos."""
    pos = torch.arange(T, device=device) + offset
    inv = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d))
    ang = pos[:, None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
def init_enc_layer(gen, cfg, dtype):
    return {"norm1": init_norm(cfg, gen.device),
            "attn": attn_mod.init_attention(gen, cfg, dtype),
            "norm2": init_norm(cfg, gen.device),
            "mlp": init_mlp(gen, cfg, dtype)}


def init_dec_layer(gen, cfg, dtype):
    return {"norm1": init_norm(cfg, gen.device),
            "self_attn": attn_mod.init_attention(gen, cfg, dtype),
            "norm2": init_norm(cfg, gen.device),
            "cross_attn": attn_mod.init_cross_attention(gen, cfg, dtype),
            "norm3": init_norm(cfg, gen.device),
            "mlp": init_mlp(gen, cfg, dtype)}


def init_encdec(gen, cfg, dtype):
    return {
        "enc_layers": [init_enc_layer(gen, cfg, dtype)
                       for _ in range(cfg.n_enc_layers)],
        "enc_norm": init_norm(cfg, gen.device),
        "dec_embed": init_embedding(gen, cfg, dtype),
        "dec_layers": [init_dec_layer(gen, cfg, dtype)
                       for _ in range(cfg.n_layers)],
        "dec_norm": init_norm(cfg, gen.device),
        "unembed": init_unembed(gen, cfg, dtype),
    }


def encode(params, frames, cfg, *, tp: int = 1):
    """frames: (B, S, d) stub embeddings -> encoder output (bf16)."""
    pos = sinusoid_pos(frames.shape[1], cfg.d_model, device=frames.device)
    x = (frames + pos.to(frames.dtype)).to(torch.bfloat16)
    x = shard_act(x, ("batch", None, "embed"))
    kv_rep = attn_mod.kv_repeat_for(cfg, tp)
    for lp in params["enc_layers"]:
        h = norm(lp["norm1"], x, cfg)
        y, _ = attn_mod.attention(lp["attn"], h, cfg, causal=False,
                                  kv_repeat=kv_rep)
        x = x + y
        x = x + mlp(lp["mlp"], norm(lp["norm2"], x, cfg), cfg)
        x = shard_act(x, ("batch", None, "embed"))
    return norm(params["enc_norm"], x, cfg)


def _dec_layer(lp, x, enc_kv, cfg, kv_rep, make_cache_len=0):
    h = norm(lp["norm1"], x, cfg)
    y, new_cache = attn_mod.attention(lp["self_attn"], h, cfg,
                                      kv_repeat=kv_rep,
                                      make_cache_len=make_cache_len)
    x = x + y
    h = norm(lp["norm2"], x, cfg)
    x = x + attn_mod.cross_attention(lp["cross_attn"], h, enc_kv, cfg)
    x = x + mlp(lp["mlp"], norm(lp["norm3"], x, cfg), cfg)
    return x, new_cache


def decode_train(params, enc_out, dec_tokens, cfg, *, tp: int = 1,
                 make_cache_len: int = 0):
    """Teacher-forced decoder pass. Returns (logits, caches)."""
    kv_rep = attn_mod.kv_repeat_for(cfg, tp)
    x = embed(params["dec_embed"], dec_tokens, cfg)
    x = x + sinusoid_pos(x.shape[1], cfg.d_model,
                         device=x.device).to(x.dtype)
    x = shard_act(x, ("batch", None, "embed"))
    caches = []
    for lp in params["dec_layers"]:
        # cross-attn K/V computed per layer from encoder output
        enc_kv = attn_mod.encode_cross_kv(lp["cross_attn"], enc_out, cfg,
                                          kv_rep)
        x, cache = _dec_layer(lp, x, enc_kv, cfg, kv_rep,
                              make_cache_len=make_cache_len)
        caches.append(cache)
    x = norm(params["dec_norm"], x, cfg)
    logits = unembed(params["unembed"], x, cfg)
    return logits, (caches if make_cache_len else None)


def init_dec_caches(params, enc_out, cfg, batch: int, max_len: int,
                    tp: int = 1, dtype=torch.bfloat16):
    """Empty self-attn caches + precomputed cross K/V for every decoder
    layer, on ``enc_out``'s device."""
    dev = enc_out.device
    kv_rep = attn_mod.kv_repeat_for(cfg, tp)
    return {"self": [attn_mod.init_cache(cfg, batch, max_len, dev, dtype,
                                         kv_rep)
                     for _ in params["dec_layers"]],
            "cross": [attn_mod.encode_cross_kv(lp["cross_attn"], enc_out,
                                               cfg, kv_rep)
                      for lp in params["dec_layers"]]}


def decode_step(params, token, cfg, caches, position: int, *, tp: int = 1):
    """token: (B, 1); position: an int.  Returns (logits, caches); the
    self-attention caches are updated in place."""
    kv_rep = attn_mod.kv_repeat_for(cfg, tp)
    x = embed(params["dec_embed"], token, cfg)
    x = x + sinusoid_pos(1, cfg.d_model, offset=position,
                         device=x.device).to(x.dtype)
    for lp, self_c, cross_kv in zip(params["dec_layers"], caches["self"],
                                    caches["cross"]):
        h = norm(lp["norm1"], x, cfg)
        y, _ = attn_mod.attention_decode(lp["self_attn"], h, cfg, self_c,
                                         position, kv_repeat=kv_rep)
        x = x + y
        h = norm(lp["norm2"], x, cfg)
        x = x + attn_mod.cross_attention(lp["cross_attn"], h, cross_kv, cfg)
        x = x + mlp(lp["mlp"], norm(lp["norm3"], x, cfg), cfg)
    x = norm(params["dec_norm"], x, cfg)
    logits = unembed(params["unembed"], x, cfg)
    return logits, caches
