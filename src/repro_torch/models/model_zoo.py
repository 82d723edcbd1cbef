"""ArchConfig -> model functions (init / forward / prefill / decode).

A single functional interface over decoder-only LMs — stacks of plain
attention, MLA, mamba (jamba's interleave) or xLSTM layers, with dense
or MoE FFNs, token or stub-embedding inputs — and encoder-decoder
models.  Every entry runs on the device its parameters lie on; ``init``
puts them on the first GPU unless it is given ``device="cpu"``.

``param_specs`` and ``input_specs`` give shape stand-ins (fake tensors:
a shape and a type, no storage) for the sharding rules and the
dry-run; the parameters' logical axes come from the initialisers
(``models.param.recording_axes``).  ``tp=`` (every entry's, default 1)
is the model-parallel degree the K/V heads are repeated for
(``attention.kv_repeat_for``): it changes the caches' head count, never
the parameters or a value.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import param as param_mod
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


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            tp: int = 1):
    """Training/prefill forward. Returns (logits, aux_loss)."""
    if cfg.is_encoder_decoder:
        enc_out = encdec_mod.encode(params, batch["frames"], cfg, tp=tp)
        logits, _ = encdec_mod.decode_train(params, enc_out,
                                            batch["dec_tokens"], cfg, tp=tp)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    inputs = batch.get("embeds", batch.get("tokens"))
    logits, _, aux = tf_mod.lm_forward(params, inputs, cfg, tp=tp)
    return logits, aux


def prefill(cfg: ArchConfig, params, batch, cache_len: int, *,
            tp: int = 1):
    """Prefill pass that also materialises decode caches.

    Encoder-decoder: as in the reference, the decoder's prompt is run
    teacher-forced but its self-attention K/V are not written: the
    caches are ``init_dec_caches``' (empty self-attention caches, the
    encoder's cross K/V)."""
    if cfg.is_encoder_decoder:
        enc_out = encdec_mod.encode(params, batch["frames"], cfg, tp=tp)
        logits, _ = encdec_mod.decode_train(params, enc_out,
                                            batch["dec_tokens"], cfg, tp=tp)
        caches = encdec_mod.init_dec_caches(
            params, enc_out, cfg, batch["dec_tokens"].shape[0], cache_len,
            tp=tp)
        return logits, caches
    inputs = batch.get("embeds", batch.get("tokens"))
    logits, caches, _ = tf_mod.lm_forward(params, inputs, cfg, tp=tp,
                                          make_cache_len=cache_len)
    return logits, caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, tp: int = 1,
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
                                          max_len, tp=tp)
    return tf_mod.init_lm_caches(cfg, batch, max_len,
                                 resolve_device(device), tp=tp)


def decode_step(cfg: ArchConfig, params, token, caches, position, *,
                tp: int = 1):
    """One-token decode at ``position``: an int, or (decoder-only) a (B,)
    int tensor of per-row positions.  Returns (logits, caches); the
    caches are updated in place."""
    if cfg.is_encoder_decoder:
        return encdec_mod.decode_step(params, token, cfg, caches, position,
                                      tp=tp)
    return tf_mod.lm_decode_step(params, token, cfg, caches, position,
                                 tp=tp)


# ---------------------------------------------------------------------------
# Shape stand-ins for the sharding rules and the dry-run (no allocation)
# ---------------------------------------------------------------------------
def fake_mode():
    """The fake mode stand-ins are made in, as a context: the active one
    where one is active (so that ``param_specs`` and ``input_specs``
    called inside one ``with fake_mode():`` go into one step together),
    else a new one."""
    import contextlib

    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    active = detect_fake_mode()
    if active is not None:
        return contextlib.nullcontext(active)
    return FakeTensorMode()


def input_specs(cfg: ArchConfig, cell: ShapeCell, *, tp: int = 1
                ) -> Dict[str, Any]:
    """Stand-ins for every model input of this (arch x shape) cell: the
    batch dict for train / prefill; for decode one new ``token`` per
    row, a scalar ``position`` and the caches of ``cell.seq_len``
    tokens (``init_caches(tp=tp)``' tree, the K/V heads repeated for
    ``tp``; an encoder-decoder's holds its encoder's cross K/V)."""
    B, T = cell.global_batch, cell.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    with fake_mode():
        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype)

        if cell.kind in ("train", "prefill"):
            if cfg.is_encoder_decoder:
                return {"frames": sds((B, T, cfg.d_model), bf16),
                        "dec_tokens": sds((B, T), i32),
                        "labels": sds((B, T), i32)}
            if cfg.frontend != "none":
                return {"embeds": sds((B, T, cfg.d_model), bf16),
                        "labels": sds((B, T), i32)}
            return {"tokens": sds((B, T), i32), "labels": sds((B, T), i32)}

        # decode: one new token against a cache of T tokens
        token, position = sds((B, 1), i32), sds((), i32)
        if cfg.is_encoder_decoder:
            params = init(cfg, 0, device="cpu")
            caches = encdec_mod.init_dec_caches(
                params, sds((B, T, cfg.d_model), bf16), cfg, B, T, tp=tp)
        else:
            caches = tf_mod.init_lm_caches(cfg, B, T, torch.device("cpu"),
                                           tp=tp)
    return {"token": token, "caches": caches, "position": position}


def param_specs(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16):
    """(values, axes): stand-ins of ``init(cfg, dtype=dtype)``'s tree and
    the matching tree of logical-axes tuples (the reference's axes of
    each leaf without the stacked ``"layers"`` axis)."""
    with fake_mode(), param_mod.recording_axes():
        vals = init(cfg, 0, device="cpu", dtype=dtype)
        axes = param_mod.axes_of(vals)
    return vals, axes


def count_params(cfg: ArchConfig) -> int:
    vals, _ = param_specs(cfg)
    return sum(t.numel() for t in param_mod.leaves(vals))
