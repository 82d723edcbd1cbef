"""Blocked (flash) attention: the hand-written CUDA kernel.

``flash_attention_cuda`` launches K7, the port of
``flash_attention_pallas``, on one of two routes that ``route`` picks
from the dtype and the shape:

* bf16 with 16-byte rows (``d % 8 == 0``), ``d <= 128`` and 16-byte
  aligned bases -> ``csrc/flash_attention_wgmma.cu``, the tensor-core
  kernel: TMA streams the K/V tiles through an mbarrier ring and one
  warpgroup runs q k^T and p v on ``wgmma``;
* f32 and any other shape -> ``csrc/flash_attention.cu``, the CUDA-core
  kernel (f32 FMAs; TF32 would break the 2e-5 f32 tolerance).

Both walk the 64-key tiles of a 64-row query tile with the running max,
sum and accumulator in f32, and read query head ``bh``'s K/V at head
``bh // rep``, so a grouped-query caller passes K/V with ``BH / rep``
heads and no repeat.

Its plain version is ``ref.attention_ref``, the unblocked f32 softmax:
the reference's own implementation off the TPU with its autotune
search off, and so the CPU path here.  ``attention_blocked_torch`` is
the reference's other non-Pallas candidate, ``attention_blocked_xla``:
each query block attends only its causal key prefix.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import check_cuda, launch

MAX_D = 256                      # the CUDA-core kernel's shared memory
WGMMA_MAX_D = 128                # the tensor-core kernel's accumulator
WGMMA_ENTRY = "flash_attention_wgmma_bf16"
FMA_ENTRY = {torch.float32: "flash_attention_fma_f32",
             torch.bfloat16: "flash_attention_fma_bf16"}


def route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The C entry point for inputs of ``dtype`` with head size ``d``:
    the tensor-core kernel for bf16 with 16-byte rows, ``d <= 128`` and
    16-byte aligned bases (``aligned``), else the CUDA-core kernel."""
    if dtype not in FMA_ENTRY:
        raise ValueError(f"flash_attention: dtype {dtype} not supported")
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= WGMMA_MAX_D \
            and aligned:
        return WGMMA_ENTRY
    return FMA_ENTRY[dtype]


def entries(dtype: torch.dtype, d: int, aligned: bool = True):
    """The C entry points that compute inputs of ``dtype`` with head size
    ``d`` correctly: the tensor-core kernel only where ``route`` may
    take it (never f32: TF32 would break the 2e-5 tolerance), the
    CUDA-core kernel of the dtype always — the autotune search's CUDA
    family."""
    first = route(dtype, d, aligned)
    return [first] + ([FMA_ENTRY[dtype]] if first == WGMMA_ENTRY else [])


def _kv_rep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    BH, T, d = q.shape
    if k.dim() != 3 or v.shape != k.shape or k.shape[2] != d \
            or k.shape[0] < 1 or BH % k.shape[0]:
        raise ValueError(f"flash_attention: need q (BH, T, d) and k/v "
                         f"(BH/rep, S, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return BH // k.shape[0]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, entry: Optional[str] = None
                         ) -> torch.Tensor:
    """q: (BH, T, d); k/v: (BH / rep, S, d), contiguous, f32 or bf16 on
    one GPU; d <= 256.  Returns (BH, T, d) in q's type.  The kernel
    defines no backward, as the reference's defines no VJP: inputs that
    require grad raise.  A differentiated model layer takes the
    reference's differentiable formulation (``models.attention._sdpa``)
    and never reaches this call.  ``entry`` names the C entry
    point (default: ``route``'s); one that ``entries`` does not list
    raises."""
    if q.dtype not in FMA_ENTRY:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    dev = check_cuda("flash_attention", q, k, v, dtypes=(q.dtype,) * 3)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no backward (the "
            "reference's kernel has no VJP); a differentiated model "
            "layer takes the reference's differentiable formulation, "
            "models.attention._sdpa")
    if q.dim() != 3:
        raise ValueError(f"flash_attention: need q (BH, T, d), got "
                         f"{tuple(q.shape)}")
    rep = _kv_rep(q, k, v)
    BH, T, d = q.shape
    S = k.shape[1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: d={d} outside 1..{MAX_D}")
    if S < 1:
        raise ValueError("flash_attention: no keys (S = 0)")
    if BH > 65535:
        raise ValueError(f"flash_attention: BH={BH} exceeds the grid's "
                         f"limit of 65535")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if entry is None:
        entry = route(q.dtype, d, aligned)
    elif entry not in entries(q.dtype, d, aligned):
        raise ValueError(f"flash_attention: entry {entry!r} cannot run "
                         f"{q.dtype} at d={d} (valid: "
                         f"{entries(q.dtype, d, aligned)})")
    out = torch.empty_like(q)
    if BH and T:
        launch("flash_attention", entry, dev,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               BH, T, S, d, rep, d ** -0.5, int(causal))
    return out


def attention_blocked_torch(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            block_q: int = 256) -> torch.Tensor:
    """Blocked attention in plain tensor ops (the reference's
    ``attention_blocked_xla``): each query block attends only its
    (causal) key prefix, skipping ~half the FLOPs of the unblocked
    softmax.  q: (BH, T, d); k/v: (BH, S, d); f32 inside."""
    BH, T, d = q.shape
    S = k.shape[1]
    block_q = max(min(block_q, T), 1)
    scale = d ** -0.5
    kf, vf = k.float(), v.float()
    outs = []
    for lo in range(0, T, block_q):
        hi = min(lo + block_q, T)
        qi = q[:, lo:hi].float() * scale
        # causal: keys beyond the last query of this block never score
        klim = max(min(hi, S) if causal else S, 1)
        s = torch.einsum("btd,bsd->bts", qi, kf[:, :klim])
        if causal:
            mask = (torch.arange(klim, device=q.device)[None, :]
                    <= (lo + torch.arange(hi - lo, device=q.device))[:, None])
            s = torch.where(mask[None], s, -1e30)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        outs.append(torch.einsum("bts,bsd->btd", w, vf[:, :klim]))
    return torch.cat(outs, dim=1).to(q.dtype)
