"""Train-step factory: loss, grads, optimizer update, microbatching.

``value_and_grad`` takes the loss and its gradients with
``torch.autograd.grad`` on detached leaves that require grad, so the
caller's parameters never do.  Under autograd the model's layers take
the reference's differentiable formulations (``models.attention._sdpa``
for attention, ``torch_einsum`` for the MoE's grouped matmuls): the
kernels K7 and K8, like the reference's, define no backward.
``make_train_step`` accumulates gradients over micro-batches in a loop
in the reduce dtype (the reference's ``lax.scan``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import model_zoo
from repro_torch.optim.optimizer import OptConfig, apply_updates

REDUCE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                 "f32": torch.float32, "float32": torch.float32}


def to_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.pipeline.TokenStream``) on ``device``:
    integer arrays (tokens, labels) as int64, the embedding's and the
    gather's index type; float arrays as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


def cross_entropy(logits, labels, mask=None):
    """Mean CE in fp32. logits: (B, T, V); labels: (B, T) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, batch: Dict, cfg: ArchConfig, *, tp: int = 1):
    logits, aux = model_zoo.forward(cfg, params, batch, tp=tp)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def value_and_grad(params, batch: Dict, cfg: ArchConfig, *, tp: int = 1):
    """(loss, parts, grads): ``grads`` a tree like ``params`` (a leaf
    the loss does not reach gets zeros)."""
    ps = leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in ps]
        loss, parts = loss_fn(unflatten(params, req), batch, cfg, tp=tp)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            unflatten(params, list(grads)))


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *, tp: int = 1,
                    accum: int = 1, grad_reduce_dtype: Optional[str] = None):
    """Returns train_step(params, opt_state, batch, step) ->
    (params, opt_state, metrics).  With accum > 1 the leading batch dim
    is split into ``accum`` micro-batches run one after another, their
    gradients summed in the reduce dtype.  The update is written into
    ``params`` and ``opt_state`` (``optim.optimizer.apply_updates``)."""
    rdt = REDUCE_DTYPES[grad_reduce_dtype or cfg.parallel.grad_reduce_dtype]

    def train_step(params, opt_state, batch, step):
        if accum == 1:
            loss, parts, grads = value_and_grad(params, batch, cfg, tp=tp)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            dev = leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            ce = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=rdt,
                                                   device=p.device), params)
            acc = leaves(grads)
            for i in range(accum):
                mb = {k: v[i] for k, v in micro.items()}
                loss_i, parts_i, g = value_and_grad(params, mb, cfg, tp=tp)
                for a, x in zip(acc, leaves(g)):
                    a.add_(x.to(a.dtype))
                del g
                loss = loss + loss_i
                ce = ce + parts_i["ce"]
            loss = loss / accum
            parts = {"ce": ce / accum, "aux": loss * 0}
            for a in acc:
                a.div_(accum)
        params, opt_state, om = apply_updates(opt_cfg, params, grads,
                                              opt_state, step)
        metrics = {"loss": loss, **parts, **om}
        return params, opt_state, metrics

    return train_step
