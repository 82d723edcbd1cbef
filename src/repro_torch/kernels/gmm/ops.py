"""Public grouped-matmul entries: the CUDA kernel on a GPU tensor, the
f32 plain version on a CPU tensor.

``gmm_model`` is what MoE layers call.  The reference's model path maps
its kernel onto ``xla_einsum``, which has a VJP; serving needs none, so
here every CUDA call launches K8.

Autotuning is not ported yet: ``config=None`` is the only config, one
fixed tiling of each route of the kernel (128-column tiles of F, C tiles
of up to 128 rows, a contraction step of 32 on the CUDA cores and of 64
on the tensor cores).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gmm.gmm import gmm_cuda, gmm_torch

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda"}


def gmm_model(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Model-layer grouped matmul: x (E, C, D), w (E, D, F) -> (E, C, F)."""
    return gmm(x, w)


def gmm(x: torch.Tensor, w: torch.Tensor, *,
        config: Optional[Config] = None) -> torch.Tensor:
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"gmm: only {DEFAULT_CONFIG} until autotuning is "
                         f"ported, got {config}")
    if x.is_cuda:
        return gmm_cuda(x, w)
    if x.device.type == "cpu":
        return gmm_torch(x, w)
    raise ValueError(f"gmm: unsupported device {x.device}")
