"""Parameter initialisers on an explicit ``torch.Generator``.

A parameter tree is nested dicts and lists of tensors.  The reference's
``P`` leaves (value + logical axis names) become a second tree beside
it: every initialiser takes the leaf's logical ``axes`` and, inside
``recording_axes()``, notes them against the tensor it made; ``axes_of``
then maps a value tree to its axes tree (``model_zoo.param_specs``).
A leaf's axes are the reference's minus the leading ``"layers"`` that
its ``stack_layers`` prepends: the port keeps per-layer trees.

Weights are drawn in f32 and stored in ``dtype``.  The model casts
matmul weights to the activations' type at use, so weights stored in
bf16 give the same values as the reference's f32 weights cast to bf16,
in half the memory; norm parameters stay f32.  A large tensor is drawn
in slices of its leading dimension, so no f32 temporary of the whole
tensor exists (an expert weight of kimi-k2 is 22.5 GB in f32).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.tree import leaves as tree_leaves

_CHUNK = 1 << 28                 # elements drawn in f32 at a time (1 GiB)


class _Rec(threading.local):
    notes: Optional[dict] = None     # id(tensor) -> (tensor, axes)


_REC = _Rec()


@contextlib.contextmanager
def recording_axes():
    """Note every initialised leaf's logical axes on this thread for the
    block (read them back with ``axes_of``)."""
    old, _REC.notes = _REC.notes, {}
    try:
        yield
    finally:
        _REC.notes = old


def note_axes(t: torch.Tensor, axes) -> torch.Tensor:
    """Record ``t``'s logical axes (one name or None per dim) while
    recording; returns ``t``."""
    if _REC.notes is not None:
        if axes is None or len(axes) != t.dim():
            raise ValueError(f"axes {axes} for a leaf of shape "
                             f"{tuple(t.shape)}")
        _REC.notes[id(t)] = (t, tuple(axes))
    return t


def axes_of(values):
    """The axes tree of a value tree initialised inside the current
    ``recording_axes()`` block: the same dicts and lists, each tensor
    replaced by its tuple of logical axes."""
    notes = _REC.notes
    if notes is None:
        raise RuntimeError("axes_of: not inside recording_axes()")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        hit = notes.get(id(t))
        if hit is None or hit[0] is not t:
            raise KeyError(f"no axes recorded for a leaf of shape "
                           f"{tuple(t.shape)}")
        return hit[1]

    return walk(values)


def _normal(gen: torch.Generator, shape: Tuple[int, ...], dtype,
            std: float) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if is_fake(out):
        # a stand-in (``model_zoo.param_specs``) holds no values to draw
        return out
    rows = out.view(shape[0], -1)
    step = max(1, _CHUNK // max(rows.shape[1], 1))
    for lo in range(0, shape[0], step):
        part = rows[lo:lo + step]
        draw = torch.randn(part.shape, generator=gen, device=gen.device,
                           dtype=torch.float32)
        part.copy_(draw.mul_(std))
    return out


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float = 1.0, fan_in: int = 0, *,
               axes=None) -> torch.Tensor:
    fan = fan_in or shape[0]
    return note_axes(_normal(gen, tuple(shape), dtype,
                             scale / math.sqrt(max(fan, 1))), axes)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32, *,
               axes=None) -> torch.Tensor:
    return note_axes(_normal(gen, tuple(shape), dtype, 0.02), axes)


def zeros_init(shape, device, dtype=torch.float32, *,
               axes=None) -> torch.Tensor:
    return note_axes(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones_init(shape, device, dtype=torch.float32, *,
              axes=None) -> torch.Tensor:
    return note_axes(torch.ones(shape, dtype=dtype, device=device), axes)


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
