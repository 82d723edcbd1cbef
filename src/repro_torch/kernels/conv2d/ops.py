"""Public conv2d entry: the CUDA kernel on a GPU tensor, the shift-add
peer on a CPU tensor.

Autotuning is not ported yet: ``config=None`` is the only config, one
fixed tiling of the kernel (32x8 output tiles) — the reference's
behaviour with its search disabled.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.conv2d.conv2d import (TILE_H, TILE_W, conv2d_cuda,
                                               conv2d_shift_add)

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda", "tile_h": TILE_H,
                          "tile_w": TILE_W}


def cost_terms(cfg: Config, H: int, W: int, K: int) -> CostTerms:
    """Analytic work of one implementation at one shape."""
    flops = 2.0 * H * W * K * K
    if cfg.get("impl") == "shift_add":
        # K^2 shifted multiply-accumulates, each streaming the image
        return CostTerms(flops=flops, bytes=4.0 * 2 * H * W * K * K,
                         steps=K * K)
    th = int(cfg.get("tile_h", TILE_H))
    tw = int(cfg.get("tile_w", TILE_W))
    tiles = -(-H // th) * -(-W // tw)
    halo = (th + K - 1) * (tw + K - 1)               # per-tile read
    return CostTerms(flops=flops, bytes=4.0 * (tiles * halo + H * W),
                     steps=1)


def conv2d(img: torch.Tensor, w: torch.Tensor, *,
           config: Optional[Config] = None) -> torch.Tensor:
    """'same' 2-D correlation of an (H, W) f32 image with an odd (K, K)
    filter, on the device the image lies on."""
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"conv2d: only {DEFAULT_CONFIG} until autotuning "
                         f"is ported, got {config}")
    if img.is_cuda:
        return conv2d_cuda(img, w)
    if img.device.type == "cpu":
        return conv2d_shift_add(img, w)
    raise ValueError(f"conv2d: unsupported device {img.device}")
