"""Hybrid spmv: row-binning preprocessing + ELL kernel + COO tail.

The paper's §4.3 algorithm end to end: sort rows by nnz, rearrange,
dense bin -> the autotuned ELL product, sparse tail -> a COO
segment-sum.  ``prepare`` is the amortized preprocessing ("spmv is used
over multiple iterations"); it packs with numpy, as the reference does,
and places the result on the requested device.

The ELL config space (``spmv_ell(config=None)`` resolves it via
``kernels/autotune.py``):

* ``{"impl": "cuda", "entry": ..., "tpr": ...}`` — the hand-written
  kernel: ``spmv_ell_seg_f32`` at each threads-a-row of ``TPRS`` and
  PR 11's ``spmv_ell_f32`` (``spmv.entries()``); listed for a CUDA
  tensor only.  Without ``entry`` it takes ``spmv.route(K)``'s.
* ``{"impl": "torch_ell"}`` — the gather-sum ``spmv_ell_ref`` (the
  reference's ``xla_ell``).

With the search off a CUDA tensor runs ``DEFAULT_CONFIG`` (the route's
kernel) and a CPU tensor ``CPU_CONFIG`` (the gather-sum).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          default_config)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.spmv.ref import spmv_ell_ref
from repro_torch.kernels.spmv.spmv import (WARP_ENTRY, entries, route,
                                           spmv_ell_cuda)

# the kernel on the route's entry (segmented rows): the default on a
# CUDA tensor
DEFAULT_CONFIG: Config = {"impl": "cuda", "layout": "seg_rows"}
CPU_CONFIG: Config = {"impl": "torch_ell"}


def candidates(R: int, K: int, device="cpu"):
    cands = [{"impl": "torch_ell"}]
    if torch.device(device).type == "cuda":
        cands += [{"impl": "cuda", "entry": e, "tpr": t,
                   "layout": "warp_rows" if e == WARP_ENTRY else "seg_rows"}
                  for e, t in entries()]
    return cands


def shape_bucket(R: int, K: int) -> str:
    return f"R{bucket(R)}_K{bucket(K)}"


def cost_terms(cfg: Config, R: int, K: int) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search): vals
    + idx + the gathered x read, y written.  Within the CUDA family the
    roofline terms are equal, and occupancy, which they cannot see,
    decides; the ranking is then ``route``'s measured sweep (PR 17):
    each doubling of threads a row away from the route's costs a
    quarter more, and the first version (a warp a row, scalar loads)
    prices as 32 threads a row."""
    by = 4.0 * (3 * R * K + 2 * R)
    if cfg.get("impl") != "cuda":
        return CostTerms(flops=2.0 * R * K, bytes=by)
    best = route(K)[1]
    tpr = 32 if cfg.get("entry") == WARP_ENTRY else cfg.get("tpr") or best
    hops = abs(math.log2(tpr / best))
    if cfg.get("entry") == WARP_ENTRY:
        hops += 1.0
    return CostTerms(flops=2.0 * R * K, bytes=by * (1.0 + 0.25 * hops))


def _ell_cfg(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
             cfg: Config) -> torch.Tensor:
    impl = cfg.get("impl")
    if impl == "cuda":
        return spmv_ell_cuda(vals, idx, x, entry=cfg.get("entry"),
                             tpr=cfg.get("tpr"))
    if impl == "torch_ell":
        return spmv_ell_ref(vals, idx, x)
    raise ValueError(f"spmv_ell: no implementation {impl!r} (config "
                     f"{cfg})")


def tuned_config(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor
                 ) -> Config:
    R, K = vals.shape
    dev = vals.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    return autotune(
        "spmv", shape_bucket(R, K), candidates(R, K, dev),
        lambda cfg: lambda: _ell_cfg(vals, idx, x, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, R, K), device=dev)


def spmv_ell(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor, *,
             config: Optional[Config] = None) -> torch.Tensor:
    """ELL spmv on the device the operands lie on; config=None ->
    autotuned."""
    if vals.device.type not in ("cuda", "cpu"):
        raise ValueError(f"spmv_ell: unsupported device {vals.device}")
    if config is None:
        config = tuned_config(vals, idx, x)
    return _ell_cfg(vals, idx, x, config)


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
    """Binned spmv: ELL head through ``spmv_ell`` (config=None ->
    autotuned), COO tail through the segment-sum, on the device the
    matrix lies on."""
    y = torch.zeros(m.n_rows, dtype=x.dtype, device=x.device)
    y[m.ell_rows.long()] = spmv_ell(m.ell_vals, m.ell_idx, x, config=config)
    if m.coo_vals.shape[0]:
        y += spmv_coo(m.coo_rows, m.coo_cols, m.coo_vals, x, m.n_rows)
    return y
