"""Tiled 2-D convolution (paper §4.6 Conv): the hand-written CUDA kernel
and its CPU peer.

``conv2d_cuda`` launches ``csrc/conv2d.cu`` (K1, the port of
``conv2d_pallas``) on the C entry ``route`` picks:

* odd K <= 15 (every filter the workloads use) -> ``conv2d_reg_f32``:
  one block per 128x32 output tile, 4x4 outputs a thread in registers,
  K a compile-time value, a rolling window of input-row segments;
* any larger odd K -> ``conv2d_f32``, the first version: one block per
  32x8 tile, one output a thread.

Both stage the zero-padded halo window and the filter in shared memory
and sum each output's K^2 f32 FMAs in the same order, so they agree
bitwise.

``conv2d_shift_add`` is the same shifted multiply-add as plain PyTorch
tensor ops over the whole image — the reference's ``xla_shift``
candidate, which it names the CPU winner, and so the host lane here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import check_cuda, launch

TILE_H, TILE_W = 8, 32           # conv2d_f32's output tile
REG_TILE_H, REG_TILE_W = 32, 128  # conv2d_reg_f32's
REG_MAX_K = 15
REG_ENTRY, TILED_ENTRY = "conv2d_reg_f32", "conv2d_f32"
_SMEM_LIMIT = 48 * 1024          # static launch limit, no opt-in needed


def route(K: int) -> str:
    """The C entry point for an odd (K, K) filter: the register-blocked
    kernel (K a template argument) for K <= 15, else the first
    version."""
    return REG_ENTRY if K <= REG_MAX_K else TILED_ENTRY


def entries(K: int):
    """The C entry points that compute an odd (K, K) filter correctly:
    the register-blocked kernel only up to its template limit, the first
    version at every K — the autotune search's CUDA family."""
    return [REG_ENTRY, TILED_ENTRY] if K <= REG_MAX_K else [TILED_ENTRY]


def tile(entry: str):
    """(rows, columns) of one block's output tile on ``entry``."""
    if entry == REG_ENTRY:
        return REG_TILE_H, REG_TILE_W
    return TILE_H, TILE_W


def window(entry: str, K: int):
    """(rows, columns) of the halo window one block of ``entry`` stages:
    the register route starts it on the aligned column col0 - 8."""
    th, tw = tile(entry)
    if entry == REG_ENTRY:
        return th + K - 1, tw + 16
    return th + K - 1, tw + K - 1


def smem_bytes(entry: str, K: int) -> int:
    """Shared memory of one block of ``entry``: the halo window and the
    filter (rows padded to a multiple of 4 on the register route)."""
    wh, ww = window(entry, K)
    kp = (K + 3) // 4 * 4 if entry == REG_ENTRY else K
    return 4 * (wh * ww + K * kp)


def conv2d_cuda(img: torch.Tensor, w: torch.Tensor,
                entry: Optional[str] = None) -> torch.Tensor:
    """'same' 2-D correlation on the GPU. img: (H, W) f32; w: (K, K) f32,
    odd K.  ``entry`` names the C entry point (default: ``route(K)``);
    one that ``entries(K)`` does not list raises."""
    dev = check_cuda("conv2d", img, w, dtypes=(torch.float32,) * 2)
    if img.dim() != 2 or w.dim() != 2 or w.shape[0] != w.shape[1] \
            or w.shape[0] % 2 == 0:
        raise ValueError(f"conv2d: need (H, W) image and odd (K, K) "
                         f"filter, got {tuple(img.shape)}, "
                         f"{tuple(w.shape)}")
    H, W = img.shape
    K = w.shape[0]
    if entry is None:
        entry = route(K)
    elif entry not in entries(K):
        raise ValueError(f"conv2d: entry {entry!r} cannot run K={K} "
                         f"(valid: {entries(K)})")
    smem = smem_bytes(entry, K)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"conv2d: K={K} needs {smem} B of shared memory")
    if -(-H // tile(entry)[0]) > 65535:
        raise ValueError(f"conv2d: H={H} exceeds the grid's row limit")
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H and W:
        launch("conv2d", entry, dev, img.data_ptr(), w.data_ptr(),
               out.data_ptr(), H, W, K)
    return out


def conv2d_shift_add(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shifted multiply-add over the zero-padded image: K*K vector FMAs
    (the reference's ``conv2d_shift_add``)."""
    H, W = img.shape
    K = w.shape[0]
    r = K // 2
    padded = torch.nn.functional.pad(img, (r, r, r, r))
    acc = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for di in range(K):
        for dj in range(K):
            acc.addcmul_(padded[di:di + H, dj:dj + W], w[di, dj])
    return acc.to(img.dtype)
