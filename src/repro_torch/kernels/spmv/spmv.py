"""Row-binned spmv (paper §4.3): the hand-written CUDA ELL kernel.

``spmv_ell_cuda`` launches ``csrc/spmv_ell.cu`` (K3, the port of
``spmv_ell_pallas``) on the C entry and threads a row that ``route``
names: ``spmv_ell_seg_f32`` for every K, TPR threads a row (a template
argument), 256/TPR rows a 256-thread block, every thread's 16-byte
loads of vals and idx issued before any gather, each row split into a
scalar head up to its first 16-byte boundary, a float4/int4 body and a
scalar tail; x is gathered through L1/L2 — so the reference's "x must
fit VMEM" limit does not apply.  When vals and idx lie in different
16-byte phases (``vector_loads``) the entry runs its scalar
instantiation.  The first version, ``spmv_ell_f32`` (a warp a row),
stays in the library for comparison and as an autotune candidate; no
route takes it.

Rows are sorted by nnz and split at a threshold exactly as in the
reference; the sparse tail goes to the COO segment-sum in ``ops.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.common import check_cuda, launch

SEG_ENTRY, WARP_ENTRY = "spmv_ell_seg_f32", "spmv_ell_f32"
THREADS = 256                    # a block of spmv_ell_seg_f32
TPRS = (32, 64, 128, 256)        # its instantiations: threads a row
# (largest K, threads a row), from the timings at 512 x K in PERF.md;
# past the last K, 256 threads a row
_TPR_BY_K = ((512, 32), (1024, 64), (2048, 128))


def route(K: int) -> Tuple[str, int]:
    """(C entry, threads a row) for ELL rows of K slots."""
    for k_max, tpr in _TPR_BY_K:
        if K <= k_max:
            return SEG_ENTRY, tpr
    return SEG_ENTRY, TPRS[-1]


def entries() -> List[Tuple[str, Optional[int]]]:
    """Every (C entry, threads a row) that computes an ELL product of
    any K: ``spmv_ell_seg_f32`` at each instantiation and the first
    version (threads a row None) — the autotune search's CUDA family."""
    return [(SEG_ENTRY, t) for t in TPRS] + [(WARP_ENTRY, None)]


def vector_loads(vals_ptr: int, idx_ptr: int) -> bool:
    """Whether rows of vals and idx starting at these addresses share
    their 16-byte boundaries, so the kernel can load both as float4 /
    int4 after a common scalar head; else its scalar instantiation
    runs."""
    return (vals_ptr - idx_ptr) % 16 == 0


def blocks(R: int, tpr: int) -> int:
    """Blocks of one ``spmv_ell_seg_f32`` launch over R rows."""
    return -(-R // (THREADS // tpr))


def spmv_ell_cuda(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
                  entry: Optional[str] = None, tpr: Optional[int] = None
                  ) -> torch.Tensor:
    """ELL spmv on a GPU: vals (R, K) f32 zero-padded, idx (R, K) int32,
    x (C,) f32. Returns (R,) f32; an index outside [0, C) adds 0.
    ``entry`` and ``tpr`` name the C entry point and its threads a row
    (default: ``route(K)``); a pair ``entries()`` does not list
    raises."""
    dev = check_cuda("spmv_ell", vals, idx, x,
                     dtypes=(torch.float32, torch.int32, torch.float32))
    if vals.dim() != 2 or idx.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"spmv_ell: need vals/idx (R, K) and x (C,), got "
                         f"{tuple(vals.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(x.shape)}")
    R, K = vals.shape
    y = torch.empty(R, dtype=torch.float32, device=dev)
    if entry is None:
        entry, tpr = route(K)
    elif (entry, tpr) not in entries():
        raise ValueError(f"spmv_ell: no entry {entry!r} at tpr={tpr} "
                         f"(valid: {entries()})")
    if R and entry == WARP_ENTRY:
        launch("spmv_ell", entry, dev, vals.data_ptr(), idx.data_ptr(),
               x.data_ptr(), y.data_ptr(), R, K, x.shape[0])
    elif R:
        launch("spmv_ell", entry, dev, vals.data_ptr(), idx.data_ptr(),
               x.data_ptr(), y.data_ptr(), R, K, x.shape[0], tpr,
               int(vector_loads(vals.data_ptr(), idx.data_ptr())))
    return y
