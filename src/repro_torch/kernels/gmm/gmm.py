"""Grouped (per-expert) matmul, the MoE dense-path hot spot: the
hand-written CUDA kernel and its plain version.

``gmm_cuda`` launches K8, the port of ``gmm_pallas``, on one of two
routes that ``route`` picks from the dtype and the shape:

* bf16 with 16-byte rows (``D % 8 == 0`` and ``F % 8 == 0``) and
  16-byte aligned bases -> ``csrc/gmm_wgmma.cu``, the tensor-core kernel:
  out^T = w^T x^T on ``wgmma`` (the weight's F axis as its 64 rows, the
  few tokens C as its N), the weights streamed by TMA through a 4-stage
  mbarrier ring;
* f32 and any other shape -> ``csrc/gmm.cu``, the CUDA-core kernel
  (f32 FMAs; TF32 would break the 2e-4 f32 tolerance).

Both sum in f32 over the contraction and store in x's type, one block
per (expert, 128-column tile of F, tile of C rows).

``gmm_torch`` is the plain version and the CPU peer: the Pallas
kernel's arithmetic (operands upcast to f32, an f32 product, the result
cast to x's type), a few experts at a time so that no f32 copy of a
whole expert weight exists (kimi-k2's is 22.5 GB).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import check_cuda, launch

WGMMA_ENTRY = "gmm_wgmma_bf16"
FMA_ENTRY = {torch.float32: "gmm_fma_f32", torch.bfloat16: "gmm_fma_bf16"}
_CHUNK = 1 << 28                 # f32 weight elements upcast at a time


def route(dtype: torch.dtype, D: int, F: int, aligned: bool = True) -> str:
    """The C entry point for operands of ``dtype`` with contraction ``D``
    and width ``F``: the tensor-core kernel for bf16 with 16-byte rows
    and 16-byte aligned bases (``aligned``), else the CUDA-core kernel."""
    if dtype not in FMA_ENTRY:
        raise ValueError(f"gmm: dtype {dtype} not supported")
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 and aligned:
        return WGMMA_ENTRY
    return FMA_ENTRY[dtype]


def entries(dtype: torch.dtype, D: int, F: int, aligned: bool = True):
    """The C entry points that compute operands of ``dtype`` correctly:
    the tensor-core kernel only where ``route`` may take it (never f32:
    TF32 would break the 2e-4 tolerance), the CUDA-core kernel of the
    dtype always — the autotune search's CUDA family."""
    first = route(dtype, D, F, aligned)
    return [first] + ([FMA_ENTRY[dtype]] if first == WGMMA_ENTRY else [])


def _shapes(x: torch.Tensor, w: torch.Tensor):
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm: need x (E, C, D) and w (E, D, F), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    return E, C, D, w.shape[2]


def gmm_cuda(x: torch.Tensor, w: torch.Tensor,
             entry: Optional[str] = None) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F), contiguous, both f32 or both bf16 on
    one GPU.  Returns (E, C, F) in x's type.  The kernel defines no
    backward, as the reference's defines no VJP: inputs that require
    grad raise.  A differentiated MoE layer takes the reference's
    differentiable formulation (``ops.gmm_model``'s ``torch_einsum``)
    and never reaches this call.  ``entry`` names the C
    entry point (default: ``route``'s); one that ``entries`` does not
    list raises."""
    if x.dtype not in FMA_ENTRY:
        raise ValueError(f"gmm: dtype {x.dtype} not supported")
    dev = check_cuda("gmm", x, w, dtypes=(x.dtype, x.dtype))
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError(
            "gmm: the CUDA kernel has no backward (the reference's kernel "
            "has no VJP); a differentiated MoE layer takes the "
            "reference's differentiable formulation, gmm_model's "
            "torch_einsum")
    E, C, D, F = _shapes(x, w)
    if E > 65535 or -(-C // 128) > 65535:
        raise ValueError(f"gmm: E={E}, C={C} exceed the grid's limits")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if entry is None:
        entry = route(x.dtype, D, F, aligned)
    elif entry not in entries(x.dtype, D, F, aligned):
        raise ValueError(f"gmm: entry {entry!r} cannot run {x.dtype} at "
                         f"D={D}, F={F} (valid: "
                         f"{entries(x.dtype, D, F, aligned)})")
    out = torch.empty((E, C, F), dtype=x.dtype, device=dev)
    if E and C and F:
        if D:
            launch("gmm", entry, dev, x.data_ptr(),
                   w.data_ptr(), out.data_ptr(), E, C, D, F)
        else:
            out.zero_()
    return out


def gmm_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's type, f32 inside."""
    E, C, D, F = _shapes(x, w)
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    step = max(1, _CHUNK // max(D * F, 1))
    for lo in range(0, E, step):
        hi = min(lo + step, E)
        out[lo:hi] = torch.matmul(x[lo:hi].float(),
                                  w[lo:hi].float()).to(x.dtype)
    return out
