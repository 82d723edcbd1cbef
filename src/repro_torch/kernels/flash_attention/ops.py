"""Public flash-attention entries (grouped-query aware): the CUDA kernel
on a GPU tensor, the unblocked f32 oracle on a CPU tensor.

``sdpa`` is what model layers call for plain causal (or unmasked)
attention; ``flash_attention`` is the kernel's public entry, with
``use_kernel=False`` for the oracle on any device.  Both take q (B, T, H, d)
and k/v (B, S, Kv, d), H % Kv == 0, and return (B, T, H, d).  The
reference's model path routes through its kernel only on a tune-cache
hit or pin and then maps the kernel onto an XLA formulation, which has
a VJP; serving needs none, so here every CUDA call launches K7.

Autotuning is not ported yet: ``config=None`` is the only config, one
fixed tiling of the kernel (64-row query tiles, 64-key tiles).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda"}


def _flatten_gqa(q, k, v, repeat: bool = False):
    """(B, T, H, d) -> (B*H, T, d); K/V keep their Kv heads unless
    ``repeat``: the kernel reads query head h's K/V at h // (H / Kv),
    where the reference materialised the repeat."""
    B, T, H, d = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if repeat and H // Kv > 1:
        k = k.repeat_interleave(H // Kv, dim=2)
        v = v.repeat_interleave(H // Kv, dim=2)
        Kv = H
    qf = q.transpose(1, 2).reshape(B * H, T, d)
    kf = k.transpose(1, 2).reshape(B * Kv, S, d)
    vf = v.transpose(1, 2).reshape(B * Kv, S, d)
    return qf, kf, vf


def _check_config(config: Optional[Config]) -> None:
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"flash_attention: only {DEFAULT_CONFIG} until "
                         f"autotuning is ported, got {config}")


def sdpa(q, k, v, *, causal: bool = True,
         config: Optional[Config] = None) -> torch.Tensor:
    """Model-layer attention, plain causal (or no) masking only —
    sliding windows, softcaps and decode caches stay on the layers'
    einsum path."""
    return flash_attention(q, k, v, causal=causal, config=config)


def flash_attention(q, k, v, *, causal: bool = True, use_kernel: bool = True,
                    config: Optional[Config] = None) -> torch.Tensor:
    _check_config(config)
    B, T, H, d = q.shape
    if use_kernel and q.is_cuda:
        of = flash_attention_cuda(*_flatten_gqa(q, k, v), causal)
    elif not use_kernel or q.device.type == "cpu":
        of = attention_ref(*_flatten_gqa(q, k, v, repeat=True), causal)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return of.reshape(B, H, T, d).transpose(1, 2)
