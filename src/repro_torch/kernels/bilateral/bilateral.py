"""LUT bilateral filter (paper §4.6 Bilat): the hand-written CUDA kernel
and its CPU peer.

The paper's task-parallel insight: only (2r+1)^2 spatial weights and
256 range weights ever need a transcendental — both LUTs are built on
the host (``core.host_offload.bilateral_luts``) and the device filter
only looks them up.

``bilateral_cuda`` launches ``csrc/bilateral.cu`` (K6, the port of
``bilateral_pallas``): one block per 32x8 output tile stages its
edge-clamped halo window and both LUTs in shared memory.

``bilateral_lut_torch`` is the same LUT filter as K*K shifted lookups
in plain tensor ops — the reference's ``xla_lut`` candidate, its
default off the TPU, and so the host lane here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import check_cuda, launch

TILE_H, TILE_W = 8, 32
_SMEM_LIMIT = 48 * 1024          # static launch limit, no opt-in needed


def bilateral_cuda(img: torch.Tensor, sp: torch.Tensor, rl: torch.Tensor
                   ) -> torch.Tensor:
    """img: (H, W) f32 intensities in [0, 255]; sp: (K, K) f32 spatial
    LUT, odd K; rl: (n_levels,) f32 range LUT.  Edge-padded at the
    image's own border."""
    dev = check_cuda("bilateral", img, sp, rl, dtypes=(torch.float32,) * 3)
    if img.dim() != 2 or sp.dim() != 2 or sp.shape[0] != sp.shape[1] \
            or sp.shape[0] % 2 == 0 or rl.dim() != 1 or rl.numel() < 1:
        raise ValueError(f"bilateral: need an (H, W) image, an odd (K, K) "
                         f"spatial LUT and a (n,) range LUT, got "
                         f"{tuple(img.shape)}, {tuple(sp.shape)}, "
                         f"{tuple(rl.shape)}")
    H, W = img.shape
    K = sp.shape[0]
    n_levels = rl.shape[0]
    smem = 4 * ((TILE_W + K - 1) * (TILE_H + K - 1) + K * K + n_levels)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bilateral: K={K} with {n_levels} levels needs "
                         f"{smem} B of shared memory")
    if -(-H // TILE_H) > 65535:
        raise ValueError(f"bilateral: H={H} exceeds the grid's row limit")
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H and W:
        launch("bilateral", "bilateral_f32", dev, img.data_ptr(),
               sp.data_ptr(), rl.data_ptr(), out.data_ptr(), H, W, K,
               n_levels)
    return out


def bilateral_lut_torch(img: torch.Tensor, sp: torch.Tensor,
                        rl: torch.Tensor) -> torch.Tensor:
    """The LUT filter over the edge-padded image, K*K shifted lookups in
    the reference's order (di outer, dj inner)."""
    H, W = img.shape
    K = sp.shape[0]
    r = K // 2
    top = rl.shape[0] - 1
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    num = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    den = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for di in range(K):
        for dj in range(K):
            nb = padded[di:di + H, dj:dj + W]
            q = (nb - img).abs().long().clamp_(0, top)
            wgt = sp[di, dj] * rl[q]
            num += wgt * nb
            den += wgt
    return (num / den.clamp(min=1e-12)).to(img.dtype)
