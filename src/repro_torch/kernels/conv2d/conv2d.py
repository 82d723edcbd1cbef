"""Tiled 2-D convolution (paper §4.6 Conv): the hand-written CUDA kernel
and its CPU peer.

``conv2d_cuda`` launches ``csrc/conv2d.cu`` (K1, the port of
``conv2d_pallas``): one block per 32x8 output tile, halo window and
filter staged in shared memory, K^2 f32 FMAs per output.

``conv2d_shift_add`` is the same shifted multiply-add as plain PyTorch
tensor ops over the whole image — the reference's ``xla_shift``
candidate, which it names the CPU winner, and so the host lane here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_cuda, launch

TILE_H, TILE_W = 8, 32
_SMEM_LIMIT = 48 * 1024          # static launch limit, no opt-in needed


def conv2d_cuda(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'same' 2-D correlation on the GPU. img: (H, W) f32; w: (K, K) f32,
    odd K."""
    dev = check_cuda("conv2d", img, w, dtypes=(torch.float32,) * 2)
    if img.dim() != 2 or w.dim() != 2 or w.shape[0] != w.shape[1] \
            or w.shape[0] % 2 == 0:
        raise ValueError(f"conv2d: need (H, W) image and odd (K, K) "
                         f"filter, got {tuple(img.shape)}, "
                         f"{tuple(w.shape)}")
    H, W = img.shape
    K = w.shape[0]
    smem = 4 * ((TILE_W + K - 1) * (TILE_H + K - 1) + K * K)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"conv2d: K={K} needs {smem} B of shared memory")
    if -(-H // TILE_H) > 65535:
        raise ValueError(f"conv2d: H={H} exceeds the grid's row limit")
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H and W:
        launch("conv2d", "conv2d_f32", dev, img.data_ptr(), w.data_ptr(),
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
