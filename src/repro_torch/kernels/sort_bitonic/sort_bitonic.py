"""Bitonic row sorter (paper §4.1 sort, the leaf sorter): the
hand-written CUDA kernel and its plain version.

``sort_rows_cuda`` launches ``csrc/sort_bitonic.cu`` (K5, the port of
``sort_rows_pallas``, C entry ``ENTRY``): the log2(L)*(log2(L)+1)/2
compare-exchange stages of a bitonic network with each thread's 8
elements in registers; a stage of stride j < 8 runs inside a thread,
j < 256 across a warp's lanes (``__shfl_xor_sync``), and only the
longer strides through shared memory.  It takes every row length the
wrapper accepts, so it is K5's only route.

``bitonic_rows_torch`` is the same network as plain tensor ops over the
whole array (the reference's ``_bitonic_rows``): the stride-j partner
of lane i is i^j, taken by a reshape and flip, never a gather.  Both
swap a pair only when one value is strictly less than the other, so
they run the same exchanges.  Their results equal ``torch.sort``'s
under ``==``; -0.0 and 0.0 compare equal, so the network leaves them
in its own order, which need not be ``torch.sort``'s.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_cuda, launch

MAX_L = 8192                     # one row in one block: 1024 threads x 8
ENTRY = "sort_rows_reg_f32"


def sort_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of a contiguous (G, L) f32 tensor on the GPU,
    ascending; L a power of two, at most ``MAX_L``.  Inputs hold no
    NaN."""
    dev = check_cuda("sort_bitonic", x, dtypes=(torch.float32,))
    if x.dim() != 2:
        raise ValueError(f"sort_bitonic: need (G, L) rows, got "
                         f"{tuple(x.shape)}")
    G, L = x.shape
    if L < 1 or L & (L - 1):
        raise ValueError(f"sort_bitonic: L={L} must be a power of two")
    if L > MAX_L:
        raise ValueError(f"sort_bitonic: L={L} exceeds {MAX_L}, the "
                         f"longest row one block holds")
    out = torch.empty_like(x)
    if G and L > 1:
        launch("sort_bitonic", ENTRY, dev, x.data_ptr(),
               out.data_ptr(), G, L)
    elif G:
        out.copy_(x)
    return out


def bitonic_rows_torch(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of (G, L) ascending with the bitonic network; L a
    power of two."""
    G, L = x.shape
    if L & (L - 1):
        raise ValueError(f"L={L} must be a power of two")
    lane = torch.arange(L, device=x.device)
    k = 2
    while k <= L:
        ascending = (lane & k) == 0
        j = k // 2
        while j >= 1:
            px = x.reshape(G, L // (2 * j), 2, j).flip(2).reshape(G, L)
            keep_min = ((lane & j) == 0) == ascending
            lo = torch.where(px < x, px, x)
            hi = torch.where(x < px, px, x)
            x = torch.where(keep_min, lo, hi)
            j //= 2
        k *= 2
    return x
