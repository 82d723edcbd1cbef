"""Histogram (paper §4.2): the hand-written CUDA kernel and its CPU peer.

``hist_cuda`` launches ``csrc/hist.cu`` (K2, the port of
``hist_pallas``): per-block shared-memory histograms with atomics,
merged into the global bins — the paper's CUDA method, which the TPU
version had to replace with one-hot sums for want of atomics — on the
C entry ``route`` picks:

* n_bins <= 1816 (both main-path shapes) -> ``hist_priv_i32``: one
  1024-thread block an SM, 32 bank-private replicas of every counter,
  4 int4 loads in flight a thread; the first block of a launch to start
  zeroes ``out`` and publishes the launch's number, which every block
  waits for before adding its counts, so ``out`` needs no memset
  launch;
* more bins -> ``hist_i32``, the first version: one counter a bin in
  shared memory, ``out`` zeroed by the wrapper.

``hist_bincount`` is ``torch.bincount`` — the reference's
``xla_bincount`` candidate, the host lane here; ``hist_sort`` (sort +
``searchsorted``) and ``hist_host`` (``np.bincount`` on the host) are
its ``xla_sort`` and ``host_bincount``.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import check_cuda, launch

_MAX_BINS = 48 * 1024 // 4       # one int counter per bin in shared memory
_BLOCKS_PER_SM = 4               # hist_i32's grid cap
SMEM_MAX = 232448                # 227 KB, the most a block may opt in to
PRIV_MAX_BINS = SMEM_MAX // (32 * 4)   # 32 int replicas a bin: 1816
PRIV_ENTRY, SHARED_ENTRY = "hist_priv_i32", "hist_i32"


def route(n_bins: int) -> str:
    """The C entry point for ``n_bins`` counters: the bank-private
    kernel while 32 replicas of them fit a block's shared memory, else
    the first version."""
    return PRIV_ENTRY if n_bins <= PRIV_MAX_BINS else SHARED_ENTRY


def entries(n_bins: int):
    """The C entry points that count ``n_bins`` bins correctly: the
    bank-private kernel only while its replicas fit a block, the first
    version at every count the wrapper takes — the autotune search's
    CUDA family."""
    return ([PRIV_ENTRY, SHARED_ENTRY] if n_bins <= PRIV_MAX_BINS
            else [SHARED_ENTRY])


def smem_bytes(entry: str, n_bins: int) -> int:
    """Shared memory of one block of ``entry``."""
    return 4 * n_bins * (32 if entry == PRIV_ENTRY else 1)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The device's SMs, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class _Launches:
    """The launch numbers of ``hist_priv_i32`` on one (device, stream):
    a zeroed device buffer (the highest number started, the highest
    whose ``out`` is zeroed) and the next number, handed out under a
    lock held across the launch, so numbers rise in the stream's
    order."""

    def __init__(self, device: torch.device):
        self.state = torch.zeros(2, dtype=torch.int64, device=device)
        self.seq = 0
        self.lock = threading.Lock()


_LAUNCHES: Dict[Tuple[int, int], _Launches] = {}
_LAUNCHES_LOCK = threading.Lock()


def _launches(device: torch.device) -> _Launches:
    """The launch numbers of ``device``'s current stream: one set per
    (device, stream), so launches in flight on two streams never share
    one."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    with _LAUNCHES_LOCK:
        entry = _LAUNCHES.get(key)
        if entry is None:
            entry = _LAUNCHES[key] = _Launches(device)
    return entry


def hist_cuda(x: torch.Tensor, n_bins: int,
              entry: Optional[str] = None) -> torch.Tensor:
    """x: (N,) int32 keys on a GPU. Returns (n_bins,) int32 counts;
    keys outside [0, n_bins) are ignored.  ``entry`` names the C entry
    point (default: ``route(n_bins)``); one that ``entries(n_bins)``
    does not list raises."""
    dev = check_cuda("hist", x, dtypes=(torch.int32,))
    if x.dim() != 1:
        raise ValueError(f"hist: need a 1-D key tensor, got {x.dim()}-D")
    if not 0 < n_bins <= _MAX_BINS:
        raise ValueError(f"hist: n_bins={n_bins} outside (0, {_MAX_BINS}]")
    if entry is None:
        entry = route(n_bins)
    elif entry not in entries(n_bins):
        raise ValueError(f"hist: entry {entry!r} cannot count {n_bins} "
                         f"bins (valid: {entries(n_bins)})")
    if not x.numel():
        return torch.zeros(n_bins, dtype=torch.int32, device=dev)
    if entry == PRIV_ENTRY:
        out = torch.empty(n_bins, dtype=torch.int32, device=dev)
        nums = _launches(dev)
        with nums.lock:
            nums.seq += 1
            launch("hist", PRIV_ENTRY, dev, x.data_ptr(), x.numel(), n_bins,
                   _sm_count(dev), out.data_ptr(),
                   nums.state.data_ptr(), nums.seq)
    else:
        out = torch.zeros(n_bins, dtype=torch.int32, device=dev)
        launch("hist", SHARED_ENTRY, dev, x.data_ptr(), x.numel(), n_bins,
               _BLOCKS_PER_SM * _sm_count(dev), out.data_ptr())
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


def hist_sort(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Sort + searchsorted: counts are the differences of the bin edges'
    insertion points (no scatter); keys outside the bins fall before
    edge 0 or after edge n_bins."""
    xs = torch.sort(x.reshape(-1).to(torch.int32)).values
    edges = torch.searchsorted(
        xs, torch.arange(n_bins + 1, dtype=torch.int32, device=x.device))
    return torch.diff(edges).to(torch.int32)


def hist_host(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``np.bincount`` on the host, the result on ``x``'s device."""
    xv = x.reshape(-1).cpu().numpy()
    xv = xv[(xv >= 0) & (xv < n_bins)]
    counts = np.bincount(xv, minlength=n_bins)[:n_bins].astype(np.int32)
    return torch.from_numpy(counts).to(x.device)
