"""Bilateral filter: host-built LUTs + the device filter (paper §4.6 end
to end), with the device filter autotuned.

``bilateral_filter(img, sp, rl)`` resolves the best implementation for
the image's device and shape bucket via ``kernels/autotune.py``; pass
``config=`` to pin one.  The config space:

* ``{"impl": "cuda", "entry": ...}`` — the hand-written kernel on one
  of its C entries (``bilateral.entries(K, n_levels)``:
  ``bilateral_reg_f32`` for odd K <= 15 and at most 256 levels,
  ``bilateral_f32`` at every shape); listed for a CUDA tensor only.
  Without ``entry`` it takes ``bilateral.route``'s.
* ``{"impl": "torch_lut"}`` — the plain LUT filter
  ``bilateral_lut_torch`` (the reference's ``xla_lut``).

With the search off a CUDA tensor runs ``DEFAULT_CONFIG`` (the route's
kernel) and a CPU tensor ``CPU_CONFIG`` (the plain LUT filter).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          default_config)
from repro_torch.kernels.bilateral.bilateral import (REG_ENTRY, REG_TILE_H,
                                                     REG_TILE_W, TILE_H,
                                                     TILE_W, bilateral_cuda,
                                                     bilateral_lut_torch,
                                                     entries, route)

DEFAULT_CONFIG: Config = {"impl": "cuda"}
CPU_CONFIG: Config = {"impl": "torch_lut"}
N_LEVELS = 256                   # the range LUT of ``bilateral_luts``


def candidates(H: int, W: int, K: int, device="cpu",
               n_levels: int = N_LEVELS):
    cands = [{"impl": "torch_lut"}]
    if torch.device(device).type == "cuda":
        cands += [{"impl": "cuda", "entry": e}
                  for e in entries(K, n_levels)]
    return cands


def shape_bucket(H: int, W: int, K: int) -> str:
    return f"H{bucket(H)}_W{bucket(W)}_K{K}"


def cost_terms(cfg: Config, H: int, W: int, K: int,
               n_levels: int = N_LEVELS) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search).
    K is the LUT window (2*radius+1): K^2 weighted taps per pixel."""
    flops = 6.0 * H * W * K * K                    # weight, mul, 2 sums
    if cfg.get("impl") != "cuda":
        return CostTerms(flops=flops, bytes=4.0 * 2 * H * W * K * K,
                         steps=K * K)
    # the entry's tiling: each tile reads its halo window and the LUTs
    entry = cfg.get("entry") or route(K, n_levels)
    th, tw = ((REG_TILE_H, REG_TILE_W) if entry == REG_ENTRY
              else (TILE_H, TILE_W))
    tiles = -(-H // th) * -(-W // tw)
    halo = (th + K - 1) * (tw + K - 1)
    return CostTerms(flops=flops,
                     bytes=4.0 * (tiles * (halo + K * K + n_levels)
                                  + H * W))


def _bilat_cfg(img: torch.Tensor, sp: torch.Tensor, rl: torch.Tensor,
               cfg: Config) -> torch.Tensor:
    impl = cfg.get("impl")
    if impl == "cuda":
        return bilateral_cuda(img, sp, rl, entry=cfg.get("entry"))
    if impl == "torch_lut":
        return bilateral_lut_torch(img, sp, rl)
    raise ValueError(f"bilateral_filter: no implementation {impl!r} "
                     f"(config {cfg})")


def tuned_config(img: torch.Tensor, sp: torch.Tensor, rl: torch.Tensor
                 ) -> Config:
    H, W = img.shape
    K = sp.shape[0]
    n_levels = rl.shape[0]
    dev = img.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    return autotune(
        "bilateral", shape_bucket(H, W, K),
        candidates(H, W, K, dev, n_levels),
        lambda cfg: lambda: _bilat_cfg(img, sp, rl, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, H, W, K, n_levels), device=dev)


def bilateral_filter(img: torch.Tensor, sp: torch.Tensor, rl: torch.Tensor,
                     *, config: Optional[Config] = None) -> torch.Tensor:
    """LUT-consuming filter with precomputed LUTs on the image's device
    (workloads build the LUTs on the host pool); config=None ->
    autotuned."""
    if img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bilateral_filter: unsupported device "
                         f"{img.device}")
    if config is None:
        config = tuned_config(img, sp, rl)
    return _bilat_cfg(img, sp, rl, config)


def bilateral(img: torch.Tensor, sigma_s: float, sigma_r: float,
              radius: int, *, config: Optional[Config] = None
              ) -> torch.Tensor:
    """The whole pipeline: LUTs built on the host, filtering on the
    image's device with the tuned implementation (the direct oracle is
    ``ref.bilateral_ref``)."""
    sp, rl = bilateral_luts(sigma_s, sigma_r, radius)     # host task
    sp = torch.from_numpy(sp).to(img.device)
    rl = torch.from_numpy(rl).to(img.device)
    return bilateral_filter(img, sp, rl, config=config)
