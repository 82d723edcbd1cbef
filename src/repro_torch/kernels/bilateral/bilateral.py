"""LUT bilateral filter (paper §4.6 Bilat): the hand-written CUDA kernel
and its CPU peer.

The paper's task-parallel insight: only (2r+1)^2 spatial weights and
256 range weights ever need a transcendental — both LUTs are built on
the host (``core.host_offload.bilateral_luts``) and the device filter
only looks them up.

``bilateral_cuda`` launches ``csrc/bilateral.cu`` (K6, the port of
``bilateral_pallas``) on the C entry ``route`` picks:

* odd K <= 15 and at most 256 levels (every radius the workloads use)
  -> ``bilateral_reg_f32``: one block per 64x16 output tile, 2x2
  pixels a thread, K a compile-time value, the range LUT replicated
  across the 32 shared-memory banks;
* any other K or level count -> ``bilateral_f32``, the first version:
  one block per 32x8 tile, one pixel a thread.

Both stage the edge-clamped halo window and the LUTs in shared memory.

``bilateral_lut_torch`` is the same LUT filter as K*K shifted lookups
in plain tensor ops — the reference's ``xla_lut`` candidate, its
default off the TPU, and so the host lane here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import check_cuda, kernel_lib, launch

TILE_W, TILE_H = 32, 8           # bilateral_f32's output tile
REG_TILE_W, REG_TILE_H = 64, 16  # bilateral_reg_f32's
REG_MAX_K, REG_MAX_LEVELS = 15, 256
REG_ENTRY, TILED_ENTRY = "bilateral_reg_f32", "bilateral_f32"
_SMEM_LIMIT = 48 * 1024          # static launch limit, no opt-in needed


def route(K: int, n_levels: int) -> str:
    """The C entry point for a (K, K) spatial LUT and ``n_levels`` range
    levels: the register-blocked kernel (K a template argument, the
    range LUT replicated 32 times) for odd K <= 15 and at most 256
    levels, else the first version."""
    if K % 2 and K <= REG_MAX_K and n_levels <= REG_MAX_LEVELS:
        return REG_ENTRY
    return TILED_ENTRY


def entries(K: int, n_levels: int):
    """The C entry points that filter with a (K, K) spatial LUT and
    ``n_levels`` range levels correctly: the register-blocked kernel
    only inside its K and level limits, the first version at every
    shape — the autotune search's CUDA family."""
    return ([REG_ENTRY, TILED_ENTRY] if route(K, n_levels) == REG_ENTRY
            else [TILED_ENTRY])


def smem_bytes(entry: str, K: int, n_levels: int) -> int:
    """Shared memory of one block of ``entry``: the halo window, the
    spatial LUT and the range LUT (32 copies on the register route)."""
    if entry == REG_ENTRY:
        return 4 * ((REG_TILE_W + K - 1) * (REG_TILE_H + K - 1) + K * K
                    + 32 * n_levels)
    return 4 * ((TILE_W + K - 1) * (TILE_H + K - 1) + K * K + n_levels)


def bilateral_cuda(img: torch.Tensor, sp: torch.Tensor, rl: torch.Tensor,
                   entry: Optional[str] = None) -> torch.Tensor:
    """img: (H, W) f32 intensities in [0, 255]; sp: (K, K) f32 spatial
    LUT, odd K; rl: (n_levels,) f32 range LUT.  Edge-padded at the
    image's own border.  ``entry`` names the C entry point (default:
    ``route(K, n_levels)``); one that ``entries`` does not list
    raises."""
    dev = check_cuda("bilateral", img, sp, rl, dtypes=(torch.float32,) * 3)
    if img.dim() != 2 or sp.dim() != 2 or sp.shape[0] != sp.shape[1] \
            or sp.shape[0] % 2 == 0 or rl.dim() != 1 or rl.numel() < 1:
        raise ValueError(f"bilateral: need an (H, W) image, an odd (K, K) "
                         f"spatial LUT and a (n,) range LUT, got "
                         f"{tuple(img.shape)}, {tuple(sp.shape)}, "
                         f"{tuple(rl.shape)}")
    H, W = img.shape
    K = sp.shape[0]
    n_levels = rl.shape[0]
    if entry is None:
        entry = route(K, n_levels)
    elif entry not in entries(K, n_levels):
        raise ValueError(f"bilateral: entry {entry!r} cannot run K={K} "
                         f"with {n_levels} levels (valid: "
                         f"{entries(K, n_levels)})")
    smem = smem_bytes(entry, K, n_levels)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bilateral: K={K} with {n_levels} levels needs "
                         f"{smem} B of shared memory")
    tile_h = REG_TILE_H if entry == REG_ENTRY else TILE_H
    if -(-H // tile_h) > 65535:
        raise ValueError(f"bilateral: H={H} exceeds the grid's row limit")
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H and W:
        launch("bilateral", entry, dev, img.data_ptr(), sp.data_ptr(),
               rl.data_ptr(), out.data_ptr(), H, W, K, n_levels)
    return out


def level_index_mismatches(lo: int, hi: int, n_levels: int,
                           device: torch.device) -> int:
    """How many f32 bit patterns in [lo, hi) (NaNs skipped) the register
    route's level index (trunc(|t|) by an add rounded toward zero, then
    one min) maps elsewhere than ``(int)|t|`` clamped to
    [0, n_levels - 1]; counted on the GPU.  Not a launch of K6."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    err = kernel_lib().bilateral_level_index_check(
        lo, hi, n_levels, count.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilateral_level_index_check: CUDA error {err}")
    return int(count.item())


def bilateral_lut_torch(img: torch.Tensor, sp: torch.Tensor,
                        rl: torch.Tensor) -> torch.Tensor:
    """The LUT filter over the edge-padded image, K*K shifted lookups in
    the reference's order (di outer, dj inner)."""
    H, W = img.shape
    K = sp.shape[0]
    r = K // 2
    top = rl.shape[0] - 1
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    num = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    den = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for di in range(K):
        for dj in range(K):
            nb = padded[di:di + H, dj:dj + W]
            q = (nb - img).abs().long().clamp_(0, top)
            wgt = sp[di, dj] * rl[q]
            num += wgt * nb
            den += wgt
    return (num / den.clamp(min=1e-12)).to(img.dtype)
