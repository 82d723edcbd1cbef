"""Public row-sort entry: the bitonic CUDA kernel on a GPU tensor,
``torch.sort`` on a CPU tensor (the reference's ``xla_sort``, its
default off the TPU).

Autotuning is not ported yet: ``config=None`` is the only config, the
kernel's one launch shape.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.sort_bitonic.ref import sort_rows_ref
from repro_torch.kernels.sort_bitonic.sort_bitonic import sort_rows_cuda

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda"}


def sort_rows(x: torch.Tensor, *, config: Optional[Config] = None
              ) -> torch.Tensor:
    """Sort each row of (G, L) f32 ascending, on the device ``x`` lies
    on.  On a GPU, L must be a power of two."""
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"sort_rows: only {DEFAULT_CONFIG} until "
                         f"autotuning is ported, got {config}")
    if x.is_cuda:
        return sort_rows_cuda(x)
    if x.device.type == "cpu":
        return sort_rows_ref(x)
    raise ValueError(f"sort_rows: unsupported device {x.device}")
