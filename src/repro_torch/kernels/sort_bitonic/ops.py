"""Public row-sort entry, with autotuned configs.

``sort_rows(x)`` resolves the best implementation for the rows' device
and shape bucket via ``kernels/autotune.py``; pass ``config=`` to pin
one.  The config space:

* ``{"impl": "cuda"}`` — the bitonic kernel's one C entry,
  ``sort_rows_reg_f32``; listed for a CUDA tensor whose rows are a
  power of two no longer than ``MAX_L``;
* ``{"impl": "torch_sort"}`` — ``torch.sort`` (the reference's
  ``xla_sort``);
* ``{"impl": "torch_bitonic"}`` — the same network as plain tensor ops,
  ``bitonic_rows_torch`` (the reference's ``xla_bitonic``); power-of-two
  rows only.

With the search off a CUDA tensor runs ``DEFAULT_CONFIG`` (the kernel)
and a CPU tensor ``CPU_CONFIG`` (``torch.sort``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          default_config)
from repro_torch.kernels.sort_bitonic.ref import sort_rows_ref
from repro_torch.kernels.sort_bitonic.sort_bitonic import (
    MAX_L, bitonic_rows_torch, sort_rows_cuda)

DEFAULT_CONFIG: Config = {"impl": "cuda"}
CPU_CONFIG: Config = {"impl": "torch_sort"}


def candidates(G: int, L: int, device="cpu"):
    cands = [{"impl": "torch_sort"}]
    if L >= 1 and not L & (L - 1):
        cands.append({"impl": "torch_bitonic"})
        if torch.device(device).type == "cuda" and L <= MAX_L:
            cands.append({"impl": "cuda"})
    return cands


def shape_bucket(G: int, L: int) -> str:
    return f"G{bucket(G)}_L{L}"


def cost_terms(cfg: Config, G: int, L: int) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search)."""
    lg = max(math.log2(max(L, 2)), 1.0)
    net = lg * (lg + 1) / 2                        # bitonic stages
    impl = cfg.get("impl")
    if impl == "torch_sort":
        return CostTerms(flops=4.0 * G * L * lg, bytes=8.0 * G * L * lg)
    if impl == "torch_bitonic":
        return CostTerms(flops=4.0 * G * L * net, bytes=8.0 * G * L * net,
                         steps=int(3 * net))
    # the kernel keeps each row in registers: one read, one write
    return CostTerms(flops=4.0 * G * L * net, bytes=8.0 * G * L)


def _sort_cfg(x: torch.Tensor, cfg: Config) -> torch.Tensor:
    impl = cfg.get("impl")
    if impl == "cuda":
        return sort_rows_cuda(x)
    if impl == "torch_sort":
        return sort_rows_ref(x)
    if impl == "torch_bitonic":
        return bitonic_rows_torch(x)
    raise ValueError(f"sort_rows: no implementation {impl!r} (config "
                     f"{cfg})")


def tuned_config(x: torch.Tensor) -> Config:
    G, L = x.shape
    dev = x.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    return autotune(
        "sort_bitonic", shape_bucket(G, L), candidates(G, L, dev),
        lambda cfg: lambda: _sort_cfg(x, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, G, L), device=dev)


def sort_rows(x: torch.Tensor, *, config: Optional[Config] = None
              ) -> torch.Tensor:
    """Sort each row of (G, L) f32 ascending, on the device ``x`` lies
    on; config=None -> autotuned.  The kernel takes power-of-two L."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sort_rows: unsupported device {x.device}")
    if config is None:
        config = tuned_config(x)
    return _sort_cfg(x, config)
