"""Public flash-attention entries (grouped-query aware), autotuned.

``flash_attention`` is the kernel's public entry: ``config=None``
resolves the best implementation for the inputs' device and shape
bucket via ``kernels/autotune.py``, ``config=`` pins one and
``use_kernel=False`` runs the oracle on any device.  ``sdpa`` is what
model layers call for plain causal (or unmasked) attention, with the
config ``model_config`` resolved for the call (a pin or a tune-cache
hit, never a search) or, with none, the device's default: K7 on its
route on a CUDA tensor.  A ``cuda`` pin or hit stays K7 on a CUDA
tensor that autograd does not record; on a CPU tensor, or where
autograd records, it becomes the nearest differentiable formulation
(``_differentiable``: the reference maps its kernel so in every model
layer).  With no pin and no hit a layer that autograd records never
calls ``sdpa``: it takes the grouped einsum ``models.attention._sdpa``,
the reference's differentiable route.  All take q (B, T, H, d) and k/v
(B, S, Kv, d), H % Kv == 0, and return (B, T, H, d).

The config space:

* ``{"impl": "cuda", "entry": ...}`` — the hand-written kernel on one
  of its C entries (``flash_attention.entries``: the tensor-core
  ``flash_attention_wgmma_bf16`` where ``route`` may take it, never for
  f32; the CUDA-core entry of the dtype always); listed for a CUDA
  tensor only.  Without ``entry`` it takes ``route``'s.
* ``{"impl": "torch_blocked", "block_q": ...}`` — blocked attention
  ``attention_blocked_torch`` (the reference's ``xla_blocked``);
* ``{"impl": "torch_ref"}`` — the unblocked f32 softmax
  ``attention_ref`` (the reference's ``xla_ref``), searched for
  non-causal shapes only, as in the reference.

With the search off a CUDA tensor runs ``DEFAULT_CONFIG`` (the route's
kernel) and a CPU tensor ``CPU_CONFIG`` (the unblocked softmax).  A
config naming another impl (the reference's ``pallas``, ``xla_ref``,
``xla_blocked`` among them) raises a ``ValueError`` that names it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import CostTerms, backend_key
from repro_torch.kernels.autotune import (Config, autotune, bucket,
                                          default_config, get_tune_cache,
                                          pinned_config, search_enabled)
from repro_torch.kernels.common import differentiated
from repro_torch.kernels.flash_attention.flash_attention import (
    WGMMA_ENTRY, attention_blocked_torch, entries, flash_attention_cuda,
    route)
from repro_torch.kernels.flash_attention.ref import attention_ref

DEFAULT_CONFIG: Config = {"impl": "cuda"}
CPU_CONFIG: Config = {"impl": "torch_ref"}
_TILE = 64                       # both CUDA routes' query and key tiles


def candidates(T: int, S: int, d: int, causal: bool = True, device="cpu",
               dtype: torch.dtype = torch.float32, aligned: bool = True):
    # for causal shapes torch_ref is strictly dominated (it is
    # torch_blocked with one block, minus the causal prefix skip), so
    # it only enters the non-causal search
    cands = [] if causal else [{"impl": "torch_ref"}]
    for bq in (128, 256, 512):
        if bq // 2 < T:
            cands.append({"impl": "torch_blocked", "block_q": bq})
    if not cands:
        # tiny causal shapes prune everything above; a single-block
        # torch_blocked (block_q clamps to T) IS the reference
        cands.append({"impl": "torch_blocked", "block_q": 128})
    if torch.device(device).type == "cuda":
        cands += [{"impl": "cuda", "entry": e}
                  for e in entries(dtype, d, aligned)]
    return cands


def shape_bucket(BH: int, T: int, S: int, d: int, causal: bool) -> str:
    # causal is part of the key: the blocked path wins on causal inputs
    # by skipping ~half the FLOPs, a win that does not transfer to
    # causal=False calls of the same shape
    return f"BH{bucket(BH)}_T{bucket(T)}_S{bucket(S)}_D{d}_c{int(causal)}"


def _flatten_gqa(q, k, v, repeat: bool = False):
    """(B, T, H, d) -> contiguous (B*H, T, d); K/V keep their Kv heads
    unless ``repeat``: the kernel reads query head h's K/V at
    h // (H / Kv), where the reference materialised the repeat.  (At
    B = 1 the reshape of the transpose is a strided view, which the
    kernel refuses: hence the copy.)"""
    B, T, H, d = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if repeat and H // Kv > 1:
        k = k.repeat_interleave(H // Kv, dim=2)
        v = v.repeat_interleave(H // Kv, dim=2)
        Kv = H
    qf = q.transpose(1, 2).reshape(B * H, T, d).contiguous()
    kf = k.transpose(1, 2).reshape(B * Kv, S, d).contiguous()
    vf = v.transpose(1, 2).reshape(B * Kv, S, d).contiguous()
    return qf, kf, vf


def _granularity(block: int) -> float:
    """The reference's contraction-efficiency penalty for small blocks
    of its XLA formulations (blocked attention at block_q=128 ran ~20%
    slower than 256 despite fewer FLOPs)."""
    return min(1.0, block / 256.0)


def cost_terms(cfg: Config, BH: int, T: int, S: int, d: int,
               causal: bool, word: int = 4) -> CostTerms:
    """Analytic work of one candidate (ranks the autotune search);
    ``word`` is the bytes of an element of q/k/v."""
    impl = cfg.get("impl")
    base = 4.0 * BH * T * S * d                    # QK^T + PV
    if impl == "torch_ref":
        # full score matrix materialized, causal or not
        return CostTerms(flops=base,
                         bytes=4.0 * BH * (2 * T * S + 2 * (T + 2 * S) * d),
                         compute="matmul")
    if impl == "torch_blocked":
        bq = min(max(int(cfg.get("block_q", 256)), 1), T)
        nb = -(-T // bq)
        # exact causal prefix-block factor: block i attends i+1 blocks
        cf = (nb + 1) / (2.0 * nb) if causal else 1.0
        return CostTerms(flops=base * cf / _granularity(bq),
                         bytes=4.0 * BH * (2 * T * S * cf
                                           + 2 * (T + 2 * S) * d),
                         steps=nb, compute="matmul")
    # online softmax over 64 x 64 tiles: no score matrix in memory, K/V
    # re-read per query tile, the tiles above the diagonal skipped
    nq, nk = -(-T // _TILE), -(-S // _TILE)
    cf = (nq + 1) / (2.0 * nq) if causal else 1.0
    tensor_cores = cfg.get("entry", route(
        torch.bfloat16 if word == 2 else torch.float32, d)) == WGMMA_ENTRY
    return CostTerms(flops=base * cf,
                     bytes=word * BH * (2 * T * d + nq * 2 * S * d * cf),
                     compute="matmul" if tensor_cores else "elementwise")


def _attn_flat(q, k, v, causal: bool, cfg: Config) -> torch.Tensor:
    """One config on (B, T, H, d) inputs -> (B*H, T, d)."""
    impl = cfg.get("impl")
    if impl == "cuda":
        return flash_attention_cuda(*_flatten_gqa(q, k, v), causal,
                                    entry=cfg.get("entry"))
    if impl == "torch_ref":
        return attention_ref(*_flatten_gqa(q, k, v, repeat=True), causal)
    if impl == "torch_blocked":
        return attention_blocked_torch(
            *_flatten_gqa(q, k, v, repeat=True), causal,
            block_q=int(cfg.get("block_q", 256)))
    raise ValueError(f"flash_attention: no implementation {impl!r} "
                     f"(config {cfg})")


def _attn_cfg(q, k, v, causal: bool, cfg: Config) -> torch.Tensor:
    B, T, H, d = q.shape
    return _attn_flat(q, k, v, causal, cfg).reshape(B, H, T, d) \
        .transpose(1, 2)


def tuned_config(q, k, v, *, causal: bool = True) -> Config:
    """Resolve (searching at most once per backend/shape bucket) the
    tuned config for (B, T, H, d) q and (B, S, Kv, d) k/v."""
    B, T, H, d = q.shape
    S = k.shape[1]
    BH = B * H
    dev = q.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    bkt = shape_bucket(BH, T, S, d, causal)
    word = q.element_size()
    return autotune(
        "flash_attention", bkt,
        candidates(T, S, d, causal, dev, q.dtype),
        lambda cfg: lambda: _attn_flat(q, k, v, causal, cfg), default,
        cost_fn=lambda cfg: cost_terms(cfg, BH, T, S, d, causal, word),
        device=dev)


def _differentiable(cfg: Config, causal: bool) -> Config:
    """K7 defines no backward (nor does the reference's kernel): a model
    layer that autograd records, or that runs on a CPU tensor, maps a
    ``cuda`` config onto the nearest differentiable formulation, the
    blocked attention if causal (it keeps the prefix skip), else the
    unblocked softmax.  The reference's ``pallas`` -> ``xla_blocked`` /
    ``xla_ref``."""
    if cfg.get("impl") == "cuda":
        return {**cfg, "impl": "torch_blocked" if causal else "torch_ref"}
    return cfg


def model_config(q, k, v, *, causal: bool = True) -> Optional[Config]:
    """The config a model layer runs for (B, T, H, d) q and (B, S, Kv,
    d) k/v when a pin or a tune-cache hit (under q's backend key) exists
    for this shape bucket, else None: a pure lookup, nothing is timed.
    A ``cuda`` config stays K7 only on a CUDA tensor that autograd does
    not record (``_differentiable`` elsewhere).  Pass the result to
    ``sdpa(config=...)``, which raises a ``ValueError`` naming an impl
    the port lacks."""
    dev = q.device
    default = default_config(DEFAULT_CONFIG, CPU_CONFIG, dev)
    pin = pinned_config("flash_attention")
    if pin is not None:
        cfg = {**default, **pin}
    elif not search_enabled():
        return None
    else:
        B, T, H, d = q.shape
        hit = get_tune_cache().get(
            backend_key(dev), "flash_attention",
            shape_bucket(B * H, T, k.shape[1], d, causal))
        if hit is None or not isinstance(hit.get("config"), dict):
            return None
        cfg = {**default, **hit["config"]}
    if dev.type != "cuda" or differentiated(q, k, v):
        cfg = _differentiable(cfg, causal)
    return cfg


def sdpa(q, k, v, *, causal: bool = True,
         config: Optional[Config] = None) -> torch.Tensor:
    """Model-layer attention, plain causal (or no) masking only —
    sliding windows, softcaps and decode caches stay on the layers'
    einsum path.  ``config`` comes from ``model_config``; ``None`` is
    the device's default (no tune cache is read): K7 on its route on a
    GPU."""
    if config is None:
        config = default_config(DEFAULT_CONFIG, CPU_CONFIG, q.device)
    return flash_attention(q, k, v, causal=causal, config=config)


def flash_attention(q, k, v, *, causal: bool = True, use_kernel: bool = True,
                    config: Optional[Config] = None) -> torch.Tensor:
    """q: (B, T, H, d); k/v: (B, S, Kv, d) with H % Kv == 0; config=None
    -> autotuned.  Returns (B, T, H, d)."""
    if not use_kernel:
        config = {"impl": "torch_ref"}
    elif q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    elif config is None:
        config = tuned_config(q, k, v, causal=causal)
    return _attn_cfg(q, k, v, causal, config)
