"""Bilateral filter: host-built LUTs + the device filter (paper §4.6 end
to end).  The CUDA kernel runs on a GPU tensor, the plain LUT filter
(the reference's ``xla_lut``, its default off the TPU) on a CPU tensor.

Autotuning is not ported yet: ``config=None`` is the only config, the
kernel's fixed tiling on the route ``bilateral.route`` picks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels.bilateral.bilateral import (bilateral_cuda,
                                                     bilateral_lut_torch)

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda"}


def bilateral_filter(img: torch.Tensor, sp: torch.Tensor, rl: torch.Tensor,
                     *, config: Optional[Config] = None) -> torch.Tensor:
    """LUT-consuming filter with precomputed LUTs on the image's device
    (workloads build the LUTs on the host pool)."""
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"bilateral_filter: only {DEFAULT_CONFIG} until "
                         f"autotuning is ported, got {config}")
    if img.is_cuda:
        return bilateral_cuda(img, sp, rl)
    if img.device.type == "cpu":
        return bilateral_lut_torch(img, sp, rl)
    raise ValueError(f"bilateral_filter: unsupported device {img.device}")


def bilateral(img: torch.Tensor, sigma_s: float, sigma_r: float,
              radius: int) -> torch.Tensor:
    """The whole pipeline: LUTs built on the host, filtering on the
    image's device (the direct oracle is ``ref.bilateral_ref``)."""
    sp, rl = bilateral_luts(sigma_s, sigma_r, radius)     # host task
    sp = torch.from_numpy(sp).to(img.device)
    rl = torch.from_numpy(rl).to(img.device)
    return bilateral_filter(img, sp, rl)
