"""Mixture-of-Experts with hybrid dense/tail dispatch.

The paper's spmv insight (§4.3: dense rows -> GPU, sparse tail -> CPU)
applied to MoE routing: tokens are packed per expert up to a *capacity*
into a dense grouped-matmul path, and the *overflow tail* is
re-dispatched through extra small grouped-matmul passes instead of
being dropped.

Dispatch is per group (group = batch row), as in the reference, whose
``vmap`` over rows becomes a batch dimension here: the B groups' capacity
buffers are folded into the grouped matmul's C axis, so each pass makes
one K8 launch per matmul on (E, B*C, D).  Each row's math is unchanged;
a row's slots are rows b*C .. b*C + C-1 of every expert.

``shard_mode="smap"`` under an active mesh runs the shard_map MoE
(``models.moe_shard_map``); without a mesh the dense path below runs,
as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.models.layers import ACTS, init_linear, linear, softmax
from repro_torch.models.param import dense_init
from repro_torch.parallel.sharding import (active_mesh, grouped_blocks,
                                           local_blocks, shard_act)


def init_moe(gen, cfg, dtype):
    m = cfg.moe
    E, dff, d = m.n_routed, m.d_ff, cfg.d_model
    p = {
        "router": init_linear(gen, d, E, dtype, axes=("embed", None)),
        "w_up": dense_init(gen, (E, d, dff), dtype, fan_in=d,
                           axes=("expert", "embed", "mlp")),
        "w_gate": dense_init(gen, (E, d, dff), dtype, fan_in=d,
                             axes=("expert", "embed", "mlp")),
        "w_down": dense_init(gen, (E, dff, d), dtype, fan_in=dff,
                             axes=("expert", "mlp", "embed")),
    }
    if m.n_shared:
        # shared experts fused into one wide dense GLU
        p["shared"] = {
            "up": init_linear(gen, d, m.n_shared * dff, dtype,
                              axes=("embed", "mlp")),
            "gate": init_linear(gen, d, m.n_shared * dff, dtype,
                                axes=("embed", "mlp")),
            "down": init_linear(gen, m.n_shared * dff, d, dtype,
                                axes=("mlp", "embed")),
        }
    return p


def _dispatch_indices(flat_expert: torch.Tensor, E: int):
    """flat_expert: (..., Nk) expert id per assignment, per group.

    Returns (sort order, expert id sorted, position-in-expert) — the
    paper's 'sort rows by density then bin' transform.  The sort is
    stable and ``searchsorted`` left-sided, as ``jnp.argsort`` and
    ``jnp.searchsorted`` are.
    """
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_e = torch.gather(flat_expert, -1, order)
    experts = torch.arange(E, device=flat_expert.device).expand(
        *flat_expert.shape[:-1], E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    nk = flat_expert.shape[-1]
    pos = (torch.arange(nk, device=flat_expert.device)
           - torch.gather(starts, -1, sorted_e))
    return order, sorted_e, pos


def _dispatch_onehot(flat_expert: torch.Tensor, E: int):
    """Sort-free dispatch (§Perf): position-in-expert via a one-hot
    cumsum; no argsort, no un-sort gather.  Returns (expert ids,
    positions) in ORIGINAL assignment order."""
    oh = F.one_hot(flat_expert, E)                         # (..., Nk, E)
    pos = torch.cumsum(oh, dim=-2) - 1
    pos = torch.gather(pos, -1, flat_expert[..., None])[..., 0]
    return flat_expert, pos


def _scatter(x_sorted, sorted_e, pos, C: int, E: int):
    """Pack (B, Nk, d) assignments into the (E, B*C, d) capacity buffer:
    group b's slots are rows b*C .. b*C + C-1 of every expert.  Returns
    (buffer, expert row, slot row, kept); assignments with pos >= C are
    not packed (later passes take them)."""
    B, Nk, d = x_sorted.shape
    keep = pos < C
    e_idx = torch.where(keep, sorted_e, E)      # E == drop row
    rows = (torch.arange(B, device=pos.device)[:, None] * C
            + torch.where(keep, pos, 0))
    buf = torch.zeros((E + 1, B * C, d), dtype=x_sorted.dtype,
                      device=x_sorted.device)
    buf[e_idx, rows] = x_sorted
    return buf[:E], e_idx, rows, keep


def _unpack(out, e_idx, rows, keep, E: int):
    """Each assignment's row of the (E, B*C, d) expert outputs, zeros
    where it was not packed: (B, Nk, d)."""
    # the drop row E is no row of ``out``: gather row E-1 there, then zero
    gathered = out[e_idx.clamp(max=E - 1), rows]
    return torch.where(keep[..., None], gathered, 0.0)


# (batch dim, head dim) of the MoE's per-row tensors and of the capacity
# buffer (rows b*C .. of every expert) for ``local_blocks``: under a mesh
# routing, packing and unpacking stay on each rank's rows
_B, _ROWS = (0, None), (1, None)


def _one_pass(x_sorted, weights, sorted_e, pos, C: int, E: int, cfg):
    """Scatter -> grouped matmul -> gather for one capacity pass.

    x_sorted: (B, Nk, d) token features in dispatch order, per group.
    Returns per-assignment outputs (B, Nk, d); assignments with
    pos >= C contribute zeros (handled by later passes).
    """
    act = ACTS[cfg.act]
    buf, e_idx, rows, keep = local_blocks(
        lambda *a: _scatter(*a, C, E), (x_sorted, sorted_e, pos),
        (_B, _B, _B), (_ROWS, _B, _B, _B))
    if cfg.moe.shard_dispatch:
        # keep the dispatch buffer expert-sharded end to end (§Perf)
        buf = shard_act(buf, ("expert", None, None))
    # grouped matmul (dense path — the "dense rows"), K8 on the GPU; under
    # a mesh on each rank's blocks
    h = grouped_blocks(gmm_ops.gmm_model, buf,
                       weights["w_up"].to(buf.dtype))
    g = grouped_blocks(gmm_ops.gmm_model, buf,
                       weights["w_gate"].to(buf.dtype))
    h = h * act(g)
    out = grouped_blocks(gmm_ops.gmm_model, h,
                         weights["w_down"].to(buf.dtype))
    if cfg.moe.shard_dispatch:
        out = shard_act(out, ("expert", None, None))
    return local_blocks(lambda *a: _unpack(*a, E), (out, e_idx, rows, keep),
                        (_ROWS, _B, _B, _B), _B)


def _top_k(probs: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (as
    ``lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, cfg):
    """Per-row routing of (B, T, d) tokens: (gates (B, T, k), router
    probabilities (B, T, E), each token's expert counts (B, T, E), expert
    id and position-in-expert of each of the T*k assignments, their
    features in dispatch order (B, T*k, d), the dispatch order or None)."""
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.n_routed, m.top_k
    logits = linear({"w": router}, x).float()                   # (B,T,E)
    probs = softmax(logits)
    gate_vals, topk_idx = _top_k(probs, k)                      # (B,T,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    counts = F.one_hot(topk_idx, E).float().sum(dim=2)
    flat_e = topk_idx.reshape(B, T * k)
    xk = x.repeat_interleave(k, dim=1)          # (B, T*k, d) per assignment
    if m.dispatch == "onehot":
        # sort-free dispatch (§Perf optimized path)
        e_ids, pos = _dispatch_onehot(flat_e, E)
        return gate_vals, probs, counts, e_ids, pos, xk, None
    order, e_ids, pos = _dispatch_indices(flat_e, E)
    x_in = torch.gather(xk, 1, order[..., None].expand(-1, -1, d))
    return gate_vals, probs, counts, e_ids, pos, x_in, order


def _unsort(y_out, order):
    inv = torch.argsort(order, dim=-1)
    return torch.gather(y_out, 1, inv[..., None].expand(-1, -1,
                                                         y_out.shape[-1]))


def moe_ffn(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d). Returns (y, aux_loss).  Under a mesh the routing, the
    packing of the capacity buffers and their unpacking run on each
    rank's batch rows (``local_blocks``) and the grouped matmuls on each
    rank's experts and columns (``grouped_blocks``)."""
    m = cfg.moe
    if m.shard_mode == "smap" and active_mesh() is not None:
        from repro_torch.models.moe_shard_map import moe_ffn_shard_map
        return moe_ffn_shard_map(params, x, cfg)
    B, T, d = x.shape
    E, k = m.n_routed, m.top_k
    gate_vals, probs, counts, e_ids, pos, x_in, order = local_blocks(
        lambda x, r: _route(x, r, cfg), (x, params["router"]["w"]),
        (_B, (None, None)), (_B,) * 7)

    # ---- load-balancing aux loss (Switch-style) ----
    me = probs.mean(dim=(0, 1))                                     # (E,)
    ce = counts.mean(dim=(0, 1)) / k                                # (E,)
    aux = m.aux_loss_coef * E * torch.sum(me * ce)

    C = max(1, int(T * k / E * m.capacity_factor))
    y_out = _one_pass(x_in, params, e_ids, pos, C, E, cfg)
    # ---- the sparse tail: re-dispatch overflow at C_tail ----
    for p_ in range(m.overflow_passes):
        C_tail = max(1, C // 4)
        pos_t = pos - C - p_ * C_tail
        y_out = y_out + _one_pass(
            x_in, params, e_ids,
            torch.where(pos_t >= 0, pos_t, C_tail), C_tail, E, cfg)
    if order is not None:
        y_out = local_blocks(_unsort, (y_out, order), (_B, _B), _B)
    y_flat = y_out.reshape(B, T, k, d)
    y = torch.sum(y_flat * gate_vals[..., None].to(y_flat.dtype), dim=2)
    y = shard_act(y, ("batch", None, None))
    if "shared" in params:
        sp = params["shared"]
        h = linear(sp["up"], x) * ACTS[cfg.act](linear(sp["gate"], x))
        y = y + linear(sp["down"], h)
    return y, aux
