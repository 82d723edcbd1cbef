"""Public grouped-matmul entries, autotuned.

``gmm(x, w)`` resolves the best implementation for the operands' device
and shape bucket via ``kernels/autotune.py``; pass ``config=`` to pin
one.  ``gmm_model`` is what MoE layers call: it resolves its config
with ``autotune.cached_or_default`` (a pin, else a tune-cache hit when
the search is on, else the device's default; nothing is timed).  A
``cuda`` config launches K8 on a CUDA tensor that autograd does not
record and runs ``torch_einsum`` otherwise, as the reference's model
path maps its kernel onto ``xla_einsum``, which has a VJP; with no pin
and no hit a call that autograd records runs ``torch_einsum`` too.

The config space:

* ``{"impl": "cuda", "entry": ...}`` — the hand-written kernel on one
  of its C entries (``gmm.entries``: the tensor-core ``gmm_wgmma_bf16``
  where ``route`` may take it, never for f32; the CUDA-core entry of
  the dtype always); listed for a CUDA tensor only.  Without ``entry``
  it takes ``route``'s.
* ``{"impl": "torch_einsum"}`` — ``torch.einsum`` in the operands' type
  (the reference's ``xla_einsum``, ``ref.gmm_ref``);
* ``{"impl": "torch_plain"}`` — ``gmm_torch``, the plain version: f32
  inside, the result cast to x's type.

With the search off a CUDA tensor runs ``DEFAULT_CONFIG`` (the route's
kernel) and a CPU tensor ``CPU_CONFIG`` (the plain version; the
reference's default is its einsum).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          cached_or_default, default_config)
from repro_torch.kernels.common import differentiated
from repro_torch.kernels.gmm.gmm import (WGMMA_ENTRY, entries, gmm_cuda,
                                         gmm_torch, route)
from repro_torch.kernels.gmm.ref import gmm_ref

DEFAULT_CONFIG: Config = {"impl": "cuda"}
CPU_CONFIG: Config = {"impl": "torch_plain"}


def candidates(E: int, C: int, D: int, F: int, device="cpu",
               dtype: torch.dtype = torch.float32, aligned: bool = True):
    cands = [{"impl": "torch_einsum"}, {"impl": "torch_plain"}]
    if torch.device(device).type == "cuda":
        cands += [{"impl": "cuda", "entry": e}
                  for e in entries(dtype, D, F, aligned)]
    return cands


def shape_bucket(E: int, C: int, D: int, F: int) -> str:
    return f"E{bucket(E)}_C{bucket(C)}_D{bucket(D)}_F{bucket(F)}"


def cost_terms(cfg: Config, E: int, C: int, D: int, F: int,
               word: int = 4) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search);
    ``word`` is the bytes of an operand element."""
    flops = 2.0 * E * C * D * F
    impl = cfg.get("impl")
    if impl == "torch_einsum":
        return CostTerms(flops=flops,
                         bytes=word * E * (C * D + D * F + C * F),
                         compute="matmul")
    if impl == "torch_plain":
        # the operands upcast to f32 (written, then read) before the
        # f32 product
        return CostTerms(flops=flops,
                         bytes=(word + 8.0) * E * (C * D + D * F)
                         + 4.0 * E * C * F, compute="matmul")
    # one pass over the weights, one block per (expert, F tile, C tile)
    entry = cfg.get("entry") or route(
        torch.bfloat16 if word == 2 else torch.float32, D, F)
    return CostTerms(flops=flops, bytes=word * E * (C * D + D * F + C * F),
                     compute="matmul" if entry == WGMMA_ENTRY
                     else "elementwise")


def _gmm_cfg(x: torch.Tensor, w: torch.Tensor, cfg: Config) -> torch.Tensor:
    impl = cfg.get("impl")
    if impl == "cuda":
        return gmm_cuda(x, w, entry=cfg.get("entry"))
    if impl == "torch_einsum":
        return gmm_ref(x, w)
    if impl == "torch_plain":
        return gmm_torch(x, w)
    raise ValueError(f"gmm: no implementation {impl!r} (config {cfg})")


def tuned_config(x: torch.Tensor, w: torch.Tensor) -> Config:
    E, C, D = x.shape
    F = w.shape[2]
    dev = x.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    word = x.element_size()
    return autotune(
        "gmm", shape_bucket(E, C, D, F),
        candidates(E, C, D, F, dev, x.dtype, aligned),
        lambda cfg: lambda: _gmm_cfg(x, w, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, E, C, D, F, word), device=dev)


def gmm_model(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Model-layer grouped matmul: x (E, C, D), w (E, D, F) -> (E, C, F),
    through the pin or the tune-cache hit of its shape bucket, else the
    device's default.  K8, like the reference's kernel, defines no
    backward: a call that autograd records runs ``torch_einsum``, the
    reference's differentiable formulation, where the config names the
    kernel (or, with no pin and no hit, always), and so does a ``cuda``
    config on a CPU tensor."""
    E, C, D = x.shape
    recorded = differentiated(x, w)
    default = ({"impl": "torch_einsum"} if recorded else
               default_config(DEFAULT_CONFIG, CPU_CONFIG, x.device))
    cfg = cached_or_default("gmm", shape_bucket(E, C, D, w.shape[2]),
                            default, device=x.device)
    if cfg.get("impl") == "cuda" and (recorded or x.device.type != "cuda"):
        cfg = {**cfg, "impl": "torch_einsum"}
    return _gmm_cfg(x, w, cfg)


def gmm(x: torch.Tensor, w: torch.Tensor, *,
        config: Optional[Config] = None) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F); config=None ->
    autotuned."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gmm: unsupported device {x.device}")
    if config is None:
        config = tuned_config(x, w)
    return _gmm_cfg(x, w, config)
