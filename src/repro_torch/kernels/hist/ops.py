"""Public histogram entry: the CUDA kernel on a GPU tensor, bincount on
a CPU tensor.

Autotuning is not ported yet: ``config=None`` is the only config, the
kernel's one launch shape.  ``histogram_rows`` (the serving merge hook)
comes with the serving port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.hist.hist import hist_bincount, hist_cuda

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda", "threads": 1024}


def cost_terms(cfg: Config, n: int, n_bins: int) -> CostTerms:
    """Analytic work of one implementation at one shape: one read of
    every key, one write of every bin, for both implementations."""
    return CostTerms(flops=2.0 * n, bytes=4.0 * (n + n_bins))


def histogram(x: torch.Tensor, n_bins: int, *,
              config: Optional[Config] = None) -> torch.Tensor:
    """Counts of int32 keys in [0, n_bins), on the device ``x`` lies on."""
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"histogram: only {DEFAULT_CONFIG} until "
                         f"autotuning is ported, got {config}")
    xf = x.reshape(-1)
    if xf.is_cuda:
        return hist_cuda(xf, n_bins)
    if xf.device.type == "cpu":
        return hist_bincount(xf, n_bins)
    raise ValueError(f"histogram: unsupported device {xf.device}")
