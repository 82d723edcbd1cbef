"""Blocked (flash) attention: the hand-written CUDA kernel.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (K7, the
port of ``flash_attention_pallas``): one block per (head, 64-row query
tile) walks the 64-key tiles with the running max, sum and accumulator
in f32, and reads query head ``bh``'s K/V at head ``bh // rep``, so a
grouped-query caller passes K/V with ``BH / rep`` heads and no repeat.

Its plain version is ``ref.attention_ref``, the unblocked f32 softmax:
the reference's own implementation off the TPU with its autotune
search off, and so the CPU path here.  The reference's other non-Pallas
candidate, ``attention_blocked_xla``, comes with the autotune slice,
the first thing that could select it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_cuda, launch

MAX_D = 256                      # the kernel's shared-memory tiles
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _kv_rep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    BH, T, d = q.shape
    if k.dim() != 3 or v.shape != k.shape or k.shape[2] != d \
            or k.shape[0] < 1 or BH % k.shape[0]:
        raise ValueError(f"flash_attention: need q (BH, T, d) and k/v "
                         f"(BH/rep, S, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return BH // k.shape[0]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q: (BH, T, d); k/v: (BH / rep, S, d), contiguous, f32 or bf16 on
    one GPU; d <= 256.  Returns (BH, T, d) in q's type.  The kernel
    defines no backward: inputs that require grad raise (the training
    slice brings the autograd.Function)."""
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    dev = check_cuda("flash_attention", q, k, v, dtypes=(q.dtype,) * 3)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no backward yet "
            "(ROADMAP queue 1, item 10)")
    if q.dim() != 3:
        raise ValueError(f"flash_attention: need q (BH, T, d), got "
                         f"{tuple(q.shape)}")
    rep = _kv_rep(q, k, v)
    BH, T, d = q.shape
    S = k.shape[1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: d={d} outside 1..{MAX_D}")
    if S < 1:
        raise ValueError("flash_attention: no keys (S = 0)")
    if BH > 65535:
        raise ValueError(f"flash_attention: BH={BH} exceeds the grid's "
                         f"limit of 65535")
    out = torch.empty_like(q)
    if BH and T:
        launch("flash_attention", _ENTRY[q.dtype], dev, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, T, S, d,
               rep, d ** -0.5, int(causal))
    return out
