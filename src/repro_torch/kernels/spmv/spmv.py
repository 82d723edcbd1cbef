"""Row-binned spmv (paper §4.3): the hand-written CUDA ELL kernel.

``spmv_ell_cuda`` launches ``csrc/spmv_ell.cu`` (K3, the port of
``spmv_ell_pallas``): one warp per row, coalesced reads of the
row-major (R, K) values and indices, x gathered through L1/L2 — so the
reference's "x must fit VMEM" limit does not apply.  Rows are sorted
by nnz and split at a threshold exactly as in the reference; the
sparse tail goes to the COO segment-sum in ``ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_cuda, launch


def spmv_ell_cuda(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor
                  ) -> torch.Tensor:
    """ELL spmv on a GPU: vals (R, K) f32 zero-padded, idx (R, K) int32,
    x (C,) f32. Returns (R,) f32; an index outside [0, C) adds 0."""
    dev = check_cuda("spmv_ell", vals, idx, x,
                     dtypes=(torch.float32, torch.int32, torch.float32))
    if vals.dim() != 2 or idx.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"spmv_ell: need vals/idx (R, K) and x (C,), got "
                         f"{tuple(vals.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(x.shape)}")
    R, K = vals.shape
    y = torch.empty(R, dtype=torch.float32, device=dev)
    if R:
        launch("spmv_ell", "spmv_ell_f32", dev, vals.data_ptr(),
               idx.data_ptr(), x.data_ptr(), y.data_ptr(), R, K,
               x.shape[0])
    return y
