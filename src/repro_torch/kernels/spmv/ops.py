"""Hybrid spmv: row-binning preprocessing + ELL kernel + COO tail.

The paper's §4.3 algorithm end to end: sort rows by nnz, rearrange,
dense bin -> the ELL kernel (CUDA on a GPU tensor, the reference's
``xla_ell`` gather-sum on a CPU tensor), sparse tail -> a COO
segment-sum.  ``prepare`` is the amortized preprocessing ("spmv is used
over multiple iterations"); it packs with numpy, as the reference does,
and places the result on the requested device.

Autotuning is not ported yet: ``config=None`` is the only config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.spmv.ref import spmv_ell_ref
from repro_torch.kernels.spmv.spmv import spmv_ell_cuda

Config = dict
DEFAULT_CONFIG: Config = {"impl": "cuda", "layout": "seg_rows"}


def cost_terms(cfg: Config, R: int, K: int) -> CostTerms:
    """Analytic work of the ELL product at one shape: vals + idx + the
    gathered x read, y written."""
    return CostTerms(flops=2.0 * R * K, bytes=4.0 * (3 * R * K + 2 * R))


def spmv_ell(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor, *,
             config: Optional[Config] = None) -> torch.Tensor:
    """ELL spmv on the device the operands lie on."""
    if config is not None and config != DEFAULT_CONFIG:
        raise ValueError(f"spmv_ell: only {DEFAULT_CONFIG} until "
                         f"autotuning is ported, got {config}")
    if vals.is_cuda:
        return spmv_ell_cuda(vals, idx, x)
    if vals.device.type == "cpu":
        return spmv_ell_ref(vals, idx, x)
    raise ValueError(f"spmv_ell: unsupported device {vals.device}")


def spmv_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """COO spmv via segment-sum (``index_add_``): the sparse-tail path."""
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows.long(), vals * x[cols.long()])


@dataclass
class BinnedCSR:
    """Preprocessed matrix: ELL dense bin + COO tail + row permutation."""
    ell_vals: torch.Tensor           # (R_dense, K)
    ell_idx: torch.Tensor            # (R_dense, K) int32
    ell_rows: torch.Tensor           # (R_dense,) original row ids
    coo_rows: torch.Tensor           # (nnz_tail,)
    coo_cols: torch.Tensor
    coo_vals: torch.Tensor
    n_rows: int
    n_cols: int


def prepare(dense: np.ndarray, k_threshold: int = 32,
            device=None) -> BinnedCSR:
    """Row-bin a dense matrix (paper: sort rows by nnz, split at K) and
    place it on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    A = np.asarray(dense)
    R, C = A.shape
    nnz_per_row = (A != 0).sum(1)
    dense_rows = np.where(nnz_per_row <= k_threshold)[0]
    tail_rows = np.where(nnz_per_row > k_threshold)[0]
    K = max(int(nnz_per_row[dense_rows].max()) if len(dense_rows) else 1, 1)
    ell_vals = np.zeros((len(dense_rows), K), A.dtype)
    ell_idx = np.zeros((len(dense_rows), K), np.int32)
    for i, r in enumerate(dense_rows):
        cols = np.nonzero(A[r])[0]
        ell_vals[i, :len(cols)] = A[r, cols]
        ell_idx[i, :len(cols)] = cols
    rr, cc = np.nonzero(A[tail_rows])
    rr = tail_rows[rr].astype(np.int32)
    cc = cc.astype(np.int32)
    vv = A[rr, cc]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return BinnedCSR(put(ell_vals), put(ell_idx),
                     put(dense_rows.astype(np.int32)), put(rr), put(cc),
                     put(vv), R, C)


def spmv(m: BinnedCSR, x: torch.Tensor,
         config: Optional[Config] = None) -> torch.Tensor:
    """Binned spmv: ELL head through ``spmv_ell``, COO tail through the
    segment-sum, on the device the matrix lies on."""
    y = torch.zeros(m.n_rows, dtype=x.dtype, device=x.device)
    y[m.ell_rows.long()] = spmv_ell(m.ell_vals, m.ell_idx, x, config=config)
    if m.coo_vals.shape[0]:
        y += spmv_coo(m.coo_rows, m.coo_cols, m.coo_vals, x, m.n_rows)
    return y
