"""Public conv2d entry, with autotuned configs.

``conv2d(img, w)`` resolves the best implementation for the image's
device and shape bucket via ``kernels/autotune.py``; pass ``config=`` to
pin one.  The config space:

* ``{"impl": "cuda", "entry": ...}`` — the hand-written kernel on one
  of its C entries (``conv2d.entries(K)``: ``conv2d_reg_f32`` for
  K <= 15, ``conv2d_f32`` at every K); listed for a CUDA tensor only.
  Without ``entry`` it takes ``conv2d.route(K)``'s.
* ``{"impl": "torch_conv"}`` — ``F.conv2d``, the plain correlation (the
  reference's ``xla_conv``), with TF32 off on a GPU;
* ``{"impl": "torch_shift"}`` — ``conv2d_shift_add`` (the reference's
  ``xla_shift``).

With the search off (``REPRO_AUTOTUNE=0``) a CUDA tensor runs
``DEFAULT_CONFIG`` (the route's kernel) and a CPU tensor
``CPU_CONFIG`` (the shift-add), what each ran before autotuning.

``conv2d_batched`` is the batched form of ``torch_conv``, for the
serving merge hook.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          default_config)
from repro_torch.kernels.conv2d.conv2d import (REG_TILE_H, REG_TILE_W,
                                               conv2d_cuda,
                                               conv2d_shift_add, entries,
                                               route, tile, window)
from repro_torch.kernels.conv2d.ref import conv2d_ref

# the kernel on the route's entry: the default on a CUDA tensor
DEFAULT_CONFIG: Config = {"impl": "cuda", "tile_h": REG_TILE_H,
                          "tile_w": REG_TILE_W}
# the default on a CPU tensor: the shift-add peer
CPU_CONFIG: Config = {"impl": "torch_shift"}


def candidates(H: int, W: int, K: int, device="cpu"):
    """Per-shape config space: the native variants everywhere, the
    kernel's entries on a CUDA device."""
    cands = [{"impl": "torch_conv"}, {"impl": "torch_shift"}]
    if torch.device(device).type == "cuda":
        for e in entries(K):
            th, tw = tile(e)
            cands.append({"impl": "cuda", "entry": e, "tile_h": th,
                          "tile_w": tw})
    return cands


def shape_bucket(H: int, W: int, K: int) -> str:
    return f"H{bucket(H)}_W{bucket(W)}_K{K}"


def cost_terms(cfg: Config, H: int, W: int, K: int) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search)."""
    flops = 2.0 * H * W * K * K
    impl = cfg.get("impl")
    if impl == "torch_conv":
        return CostTerms(flops=flops, bytes=4.0 * (2 * H * W + K * K))
    if impl == "torch_shift":
        # K^2 shifted multiply-accumulates, each streaming the image
        return CostTerms(flops=flops, bytes=4.0 * 2 * H * W * K * K,
                         steps=K * K)
    # the entry's tiling: each tile reads its halo window and the filter
    entry = cfg.get("entry") or route(K)
    th, tw = tile(entry)
    tiles = -(-H // th) * -(-W // tw)
    wh, ww = window(entry, K)
    return CostTerms(flops=flops,
                     bytes=4.0 * (tiles * (wh * ww + K * K) + H * W),
                     steps=1)


def _torch_conv(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` with TF32 off on a GPU: cuDNN's default TF32 keeps
    about three decimal digits, outside conv's 2e-4."""
    if not img.is_cuda or not torch.backends.cudnn.allow_tf32:
        return conv2d_ref(img, w)
    torch.backends.cudnn.allow_tf32 = False
    try:
        return conv2d_ref(img, w)
    finally:
        torch.backends.cudnn.allow_tf32 = True


def conv2d_batched(imgs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Batched 'same' 2-D correlation: ``(R, H, W)`` images against
    ``(R, K, K)`` per-row filters -> ``(R, H, W)``, one grouped
    ``F.conv2d`` call for the whole stack (TF32 off on a GPU).

    The batched form of the ``torch_conv`` impl only: the serving merge
    hook engages where the solo path resolves to ``torch_conv`` and the
    device is one on which this call is bitwise equal to it row by row
    (``workloads/requests.py``, ``CONV_MERGE_DEVICES``)."""
    R, _, _ = imgs.shape
    K = ws.shape[-1]

    def run():
        return F.conv2d(imgs[None].float(), ws[:, None].float(),
                        padding=K // 2, groups=R)[0].to(imgs.dtype)

    if not imgs.is_cuda or not torch.backends.cudnn.allow_tf32:
        return run()
    torch.backends.cudnn.allow_tf32 = False
    try:
        return run()
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _conv2d_cfg(img: torch.Tensor, w: torch.Tensor, cfg: Config
                ) -> torch.Tensor:
    impl = cfg.get("impl")
    if impl == "cuda":
        return conv2d_cuda(img, w, entry=cfg.get("entry"))
    if impl == "torch_conv":
        return _torch_conv(img, w)
    if impl == "torch_shift":
        return conv2d_shift_add(img, w)
    raise ValueError(f"conv2d: no implementation {impl!r} (config {cfg})")


def tuned_config(img: torch.Tensor, w: torch.Tensor) -> Config:
    """Resolve (searching at most once per backend/shape bucket) the
    tuned config for this input — callable outside the timed path."""
    H, W = img.shape
    K = w.shape[0]
    dev = img.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    return autotune(
        "conv2d", shape_bucket(H, W, K), candidates(H, W, K, dev),
        lambda cfg: lambda: _conv2d_cfg(img, w, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, H, W, K), device=dev)


def conv2d(img: torch.Tensor, w: torch.Tensor, *,
           config: Optional[Config] = None) -> torch.Tensor:
    """'same' 2-D correlation of an (H, W) f32 image with an odd (K, K)
    filter, on the device the image lies on; config=None -> autotuned."""
    if img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv2d: unsupported device {img.device}")
    if config is None:
        config = tuned_config(img, w)
    return _conv2d_cfg(img, w, config)
