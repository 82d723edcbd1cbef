"""ArchConfig -> model functions (init / forward / prefill / decode).

A single functional interface over decoder-only LMs of plain attention
layers (with dense or MoE FFNs).  Every other config is refused here:
MLA, the jamba and xLSTM stacks and the encoder-decoder models come with
their own slices.  Every entry runs on the device its parameters lie
on; ``init`` puts them on the first GPU unless it is given
``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as tf_mod


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder:
        what = "encoder-decoder models are"
    elif cfg.block_pattern != "attn":
        what = f"{cfg.block_pattern} stacks are"
    elif cfg.attn_type == "mla":
        what = "MLA attention is"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {what} not ported yet "
                              f"(ROADMAP queue 1, item 6)")


def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> Any:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (default: the first GPU).  Matmul weights and
    embeddings are stored in bf16, norm parameters in f32."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tf_mod.init_lm(gen, cfg, torch.bfloat16)


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]):
    """Training/prefill forward. Returns (logits, aux_loss)."""
    _check_ported(cfg)
    logits, _, aux = tf_mod.lm_forward(params, batch["tokens"], cfg)
    return logits, aux


def prefill(cfg: ArchConfig, params, batch, cache_len: int):
    """Prefill pass that also materialises decode caches."""
    _check_ported(cfg)
    logits, caches, _ = tf_mod.lm_forward(params, batch["tokens"], cfg,
                                          make_cache_len=cache_len)
    return logits, caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device=None):
    """Empty bf16 decode caches on ``device`` (default: the first GPU)."""
    _check_ported(cfg)
    return tf_mod.init_lm_caches(cfg, batch, max_len,
                                 resolve_device(device))


def decode_step(cfg: ArchConfig, params, token, caches, position):
    """One-token decode at ``position``: an int, or a (B,) int tensor of
    per-row positions.  Returns (logits, caches); the caches are updated
    in place."""
    _check_ported(cfg)
    return tf_mod.lm_decode_step(params, token, cfg, caches, position)
