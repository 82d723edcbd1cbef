"""Optimizers: AdamW and Adafactor (factored second moment for the
trillion-parameter archs), with global-norm clipping and LR schedules.

The reference's arithmetic in the same types: every scalar (the
schedule, the bias corrections, Adafactor's decay) is an f32 tensor, so
the learning rate and the corrections round as the reference's f32
``jnp`` values do, not as Python's f64 floats.  States are trees over
the parameters (nested dicts and lists, ``core.tree``).  ``apply_updates``
writes the new parameters and state into the given tensors, leaf by
leaf, under ``torch.no_grad()``: no second copy of a tree exists at any
time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.tree import leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # bf16 first moment halves optimizer memory for the giant archs
    m_dtype: str = "float32"


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptConfig, step, device=None) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``: an f32
    0-d tensor."""
    step = _f32(step, device)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, device) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return _f32(cfg.lr, device) * warm * frac


def _is_matrix(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def init_opt_state(cfg: OptConfig, params):
    mdt = _DTYPES[cfg.m_dtype]
    first = leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    m = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
    if cfg.kind == "adamw":
        return {"m": m,
                "v": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "count": count}
    if cfg.kind == "adafactor":
        def vr(p):
            shape = p.shape[:-1] if _is_matrix(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = (p.shape[:-2] + p.shape[-1:] if _is_matrix(p)
                     else (1,) * p.dim())
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return {"m": m, "vr": tree_map(vr, params),
                "vc": tree_map(vc, params), "count": count}
    raise ValueError(cfg.kind)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' f32 sums of squares, summed in
    leaf order."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _clipped(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state, step):
    """One update at ``step``: writes the new parameters into ``params``'
    tensors and the new moments into ``state``'s, and returns
    (params, state, metrics) with metrics ``grad_norm`` and ``lr``
    (f32 0-d tensors).  The gradients are read, never written."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    dev = gn.device
    lr = schedule(cfg, step, dev)
    count = state["count"] + 1
    cf = count.float()
    b1 = _f32(cfg.b1, dev)
    ps, gs = leaves(params), leaves(grads)
    if cfg.kind == "adamw":
        bc1 = 1 - b1 ** cf
        bc2 = 1 - _f32(cfg.b2, dev) ** cf
        for p, g, m, v in zip(ps, gs, leaves(state["m"]),
                              leaves(state["v"])):
            gf = _clipped(g, scale).float()
            m2 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
            mh = m2 / bc1
            vh = v2 / bc2
            step_ = mh / (torch.sqrt(vh) + cfg.eps)
            if p.dim() >= 2:
                step_ = step_ + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step_)
            m.copy_(m2)
            v.copy_(v2)
    else:  # adafactor w/ momentum
        decay = 1.0 - cf ** -0.8
        for p, g, m, vr, vc in zip(ps, gs, leaves(state["m"]),
                                   leaves(state["vr"]),
                                   leaves(state["vc"])):
            gf = _clipped(g, scale).float()
            g2 = torch.square(gf) + 1e-30
            if _is_matrix(p):
                vr2 = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
                vc2 = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
                rfac = (vr2 / torch.clamp(
                    torch.mean(vr2, dim=-1, keepdim=True), min=1e-30)
                        )[..., None]
                u = gf / (torch.sqrt(rfac) * torch.sqrt(vc2)[..., None, :]
                          + cfg.eps)
                vc.copy_(vc2)
            else:
                vr2 = decay * vr + (1 - decay) * g2
                u = gf / (torch.sqrt(vr2) + cfg.eps)
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            m2 = cfg.b1 * m.float() + (1 - cfg.b1) * u
            step_ = m2
            if p.dim() >= 2:
                step_ = step_ + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step_)
            m.copy_(m2)
            vr.copy_(vr2)
    state["count"] = count
    return params, state, {"grad_norm": gn, "lr": lr}
