"""Public histogram entry, with autotuned configs.

``histogram(x, n_bins)`` resolves the best implementation for the keys'
device and shape bucket via ``kernels/autotune.py``; pass ``config=`` to
pin one.  The config space (keys outside [0, n_bins) count nowhere in
every one):

* ``{"impl": "cuda", "entry": ...}`` — the hand-written kernel on one
  of its C entries (``hist.entries(n_bins)``: ``hist_priv_i32`` up to
  1816 bins, ``hist_i32`` at every count); listed for a CUDA tensor
  only.  Without ``entry`` it takes ``hist.route(n_bins)``'s.
* ``{"impl": "torch_bincount"}`` — ``torch.bincount`` (the reference's
  ``xla_bincount``);
* ``{"impl": "torch_sort"}`` — sort + ``searchsorted`` of the bin edges
  (the reference's ``xla_sort``);
* ``{"impl": "host_bincount"}`` — ``np.bincount`` on the host (the
  reference's ``host_bincount``), the keys copied there and the counts
  back.

With the search off a CUDA tensor runs ``DEFAULT_CONFIG`` (the route's
kernel) and a CPU tensor ``CPU_CONFIG`` (``torch.bincount``).
``histogram_rows`` serves the serving merge hook.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          default_config)
from repro_torch.kernels.hist.hist import (SHARED_ENTRY, entries,
                                           hist_bincount, hist_cuda,
                                           hist_host, hist_sort)

DEFAULT_CONFIG: Config = {"impl": "cuda", "threads": 1024}
CPU_CONFIG: Config = {"impl": "torch_bincount"}


def candidates(n: int, n_bins: int, device="cpu"):
    cands = [{"impl": "torch_bincount"}, {"impl": "torch_sort"},
             {"impl": "host_bincount"}]
    if torch.device(device).type == "cuda":
        cands += [{"impl": "cuda", "entry": e} for e in entries(n_bins)]
    return cands


def shape_bucket(n: int, n_bins: int) -> str:
    return f"N{bucket(n)}_B{n_bins}"


def cost_terms(cfg: Config, n: int, n_bins: int) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search)."""
    impl = cfg.get("impl")
    if impl == "torch_bincount":
        return CostTerms(flops=2.0 * n, bytes=4.0 * (n + n_bins))
    if impl == "torch_sort":
        lg = max(math.log2(max(n, 2)), 1.0)
        return CostTerms(flops=4.0 * n * lg, bytes=8.0 * n * lg)
    if impl == "host_bincount":
        return CostTerms(flops=2.0 * n, host_bytes=4.0 * (n + n_bins))
    # one read of every key, one write of every bin; the first version
    # also zeroes the bins in a memset launch
    return CostTerms(flops=2.0 * n, bytes=4.0 * (n + n_bins),
                     steps=2 if cfg.get("entry") == SHARED_ENTRY else 1)


def _hist_cfg(x: torch.Tensor, n_bins: int, cfg: Config) -> torch.Tensor:
    impl = cfg.get("impl")
    if impl == "cuda":
        return hist_cuda(x, n_bins, entry=cfg.get("entry"))
    if impl == "torch_bincount":
        return hist_bincount(x, n_bins)
    if impl == "torch_sort":
        return hist_sort(x, n_bins)
    if impl == "host_bincount":
        return hist_host(x, n_bins)
    raise ValueError(f"histogram: no implementation {impl!r} (config "
                     f"{cfg})")


def tuned_config(x: torch.Tensor, n_bins: int) -> Config:
    n = int(x.numel())
    dev = x.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    xf = x.reshape(-1)
    return autotune(
        "hist", shape_bucket(n, n_bins), candidates(n, n_bins, dev),
        lambda cfg: lambda: _hist_cfg(xf, n_bins, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, n, n_bins), device=dev)


def histogram(x: torch.Tensor, n_bins: int, *,
              config: Optional[Config] = None) -> torch.Tensor:
    """Counts of int32 keys in [0, n_bins), on the device ``x`` lies on;
    config=None -> autotuned."""
    xf = x.reshape(-1)
    if xf.device.type not in ("cuda", "cpu"):
        raise ValueError(f"histogram: unsupported device {xf.device}")
    if config is None:
        config = tuned_config(xf, n_bins)
    return _hist_cfg(xf, n_bins, config)


def histogram_rows(x2d: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Row-wise batched histogram: ``(R, n)`` int keys in ``[0, n_bins)``
    -> ``(R, n_bins)`` int32 counts, one ``torch.bincount`` over
    row-offset keys for the whole stack (keys outside the range count
    nowhere, as in ``histogram``: they go to a dropped last bin).

    The serving merge hook stacks same-bucket histogram requests into
    this one call.  Counts are exact integer sums, so every row equals
    the solo ``histogram`` of that row bit for bit whatever impl the
    solo path runs, on either device."""
    R = x2d.shape[0]
    x = x2d.long()
    offs = torch.arange(R, device=x.device)[:, None] * n_bins
    keys = torch.where((x >= 0) & (x < n_bins), x + offs, R * n_bins)
    counts = torch.bincount(keys.reshape(-1), minlength=R * n_bins + 1)
    return counts[:R * n_bins].reshape(R, n_bins).to(torch.int32)
