"""ArchConfig -> model functions (init / forward / prefill / decode).

A single functional interface over decoder-only LMs — stacks of plain
attention, MLA, mamba (jamba's interleave) or xLSTM layers, with dense
or MoE FFNs, token or stub-embedding inputs — and encoder-decoder
models.  Every entry runs on the device its parameters lie on; ``init``
puts them on the first GPU unless it is given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod


def init(cfg: ArchConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.bfloat16) -> Any:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (default: the first GPU).  Matmul weights and
    embeddings are stored in ``dtype`` (bf16 for serving; training
    passes f32, the reference's storage, so that the optimizer's small
    updates are not rounded away); norm parameters and the tensors the
    reference casts to f32 at use (mamba's ``A_log``, sLSTM's ``r``,
    xLSTM's ``gn_scale``) in f32.  Either storage gives the same values
    at use: the model casts a weight to the activations' type."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.is_encoder_decoder:
        return encdec_mod.init_encdec(gen, cfg, dtype)
    return tf_mod.init_lm(gen, cfg, dtype)


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]):
    """Training/prefill forward. Returns (logits, aux_loss)."""
    if cfg.is_encoder_decoder:
        enc_out = encdec_mod.encode(params, batch["frames"], cfg)
        logits, _ = encdec_mod.decode_train(params, enc_out,
                                            batch["dec_tokens"], cfg)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    inputs = batch.get("embeds", batch.get("tokens"))
    logits, _, aux = tf_mod.lm_forward(params, inputs, cfg)
    return logits, aux


def prefill(cfg: ArchConfig, params, batch, cache_len: int):
    """Prefill pass that also materialises decode caches.

    Encoder-decoder: as in the reference, the decoder's prompt is run
    teacher-forced but its self-attention K/V are not written: the
    caches are ``init_dec_caches``' (empty self-attention caches, the
    encoder's cross K/V)."""
    if cfg.is_encoder_decoder:
        enc_out = encdec_mod.encode(params, batch["frames"], cfg)
        logits, _ = encdec_mod.decode_train(params, enc_out,
                                            batch["dec_tokens"], cfg)
        caches = encdec_mod.init_dec_caches(
            params, enc_out, cfg, batch["dec_tokens"].shape[0], cache_len)
        return logits, caches
    inputs = batch.get("embeds", batch.get("tokens"))
    logits, caches, _ = tf_mod.lm_forward(params, inputs, cfg,
                                          make_cache_len=cache_len)
    return logits, caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device=None, params=None, enc_out=None):
    """Empty decode caches on ``device`` (default: the first GPU): bf16,
    the recurrent layers' states f32.
    Encoder-decoder: ``params`` and ``enc_out`` are required, and the
    caches lie on ``enc_out``'s device."""
    if cfg.is_encoder_decoder:
        if params is None or enc_out is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder's caches "
                             f"need params= and enc_out=")
        return encdec_mod.init_dec_caches(params, enc_out, cfg, batch,
                                          max_len)
    return tf_mod.init_lm_caches(cfg, batch, max_len,
                                 resolve_device(device))


def decode_step(cfg: ArchConfig, params, token, caches, position):
    """One-token decode at ``position``: an int, or (decoder-only) a (B,)
    int tensor of per-row positions.  Returns (logits, caches); the
    caches are updated in place."""
    if cfg.is_encoder_decoder:
        return encdec_mod.decode_step(params, token, cfg, caches, position)
    return tf_mod.lm_decode_step(params, token, cfg, caches, position)
