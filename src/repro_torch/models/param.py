"""Parameter initialisers on an explicit ``torch.Generator``.

A parameter tree is nested dicts and lists of tensors.  The reference's
``P`` leaves (value + logical axis names) are sharding machinery and
wait for the mesh slice (ROADMAP queue 1, item 11).

Weights are drawn in f32 and stored in ``dtype``.  The model casts
matmul weights to the activations' type at use, so weights stored in
bf16 give the same values as the reference's f32 weights cast to bf16,
in half the memory; norm parameters stay f32.  A large tensor is drawn
in slices of its leading dimension, so no f32 temporary of the whole
tensor exists (an expert weight of kimi-k2 is 22.5 GB in f32).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.tree import leaves as tree_leaves

_CHUNK = 1 << 28                 # elements drawn in f32 at a time (1 GiB)


def _normal(gen: torch.Generator, shape: Tuple[int, ...], dtype,
            std: float) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = out.view(shape[0], -1)
    step = max(1, _CHUNK // max(rows.shape[1], 1))
    for lo in range(0, shape[0], step):
        part = rows[lo:lo + step]
        draw = torch.randn(part.shape, generator=gen, device=gen.device,
                           dtype=torch.float32)
        part.copy_(draw.mul_(std))
    return out


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float = 1.0, fan_in: int = 0) -> torch.Tensor:
    fan = fan_in or shape[0]
    return _normal(gen, tuple(shape), dtype, scale / math.sqrt(max(fan, 1)))


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, tuple(shape), dtype, 0.02)


def zeros_init(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones_init(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def leaves(tree):
    """Every tensor of a tree of dicts and lists, in ``core.tree``'s
    order (the reference's)."""
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            yield x
