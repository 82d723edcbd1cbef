"""Histogram (paper §4.2): the hand-written CUDA kernel and its CPU peer.

``hist_cuda`` launches ``csrc/hist.cu`` (K2, the port of
``hist_pallas``): per-block shared-memory histograms with atomics,
merged into the global bins — the paper's CUDA method, which the TPU
version had to replace with one-hot sums for want of atomics.

``hist_bincount`` is ``torch.bincount`` — the reference's
``xla_bincount`` / ``host_bincount`` candidates, the host lane here.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import check_cuda, launch

_MAX_BINS = 48 * 1024 // 4       # one int counter per bin in shared memory
_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _max_blocks(device: torch.device) -> int:
    """Grid cap of the grid-stride kernel, read once per device."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _BLOCKS_PER_SM * sms


def hist_cuda(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """x: (N,) int32 keys on a GPU. Returns (n_bins,) int32 counts;
    keys outside [0, n_bins) are ignored."""
    dev = check_cuda("hist", x, dtypes=(torch.int32,))
    if x.dim() != 1:
        raise ValueError(f"hist: need a 1-D key tensor, got {x.dim()}-D")
    if not 0 < n_bins <= _MAX_BINS:
        raise ValueError(f"hist: n_bins={n_bins} outside (0, {_MAX_BINS}]")
    out = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    if x.numel():
        launch("hist", "hist_i32", dev, x.data_ptr(), x.numel(), n_bins,
               _max_blocks(dev), out.data_ptr())
    return out


def hist_bincount(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``torch.bincount`` with the kernel's contract: keys outside
    [0, n_bins) are ignored, the result has exactly ``n_bins`` bins."""
    x = x.reshape(-1)
    if x.numel():
        lo, hi = torch.aminmax(x)
        if int(lo) < 0 or int(hi) >= n_bins:
            x = x[(x >= 0) & (x < n_bins)]
    return torch.bincount(x, minlength=n_bins)[:n_bins].to(torch.int32)
