"""shard_map MoE (§Perf optimized path, shard_mode="smap").

A deterministic collective schedule over the active device mesh, each
rank computing on its local shards (the reference's ``shard_map``):

  * expert weights sharded E over the 'data' axis, FFN dim over 'model'
    (hierarchical EP x TP);
  * tokens sharded over the batch axes (pod, data) and replicated over
    'model', so routing and capacity dispatch are entirely LOCAL;
  * one all_to_all over 'data' ships each expert's capacity buffer to
    its owner (and one ships the results back);
  * the f-contraction partial sums fold into ONE activation-sized sum
    over 'model' (combine is linear, so the sum commutes past it).

The collectives are ``torch.distributed``'s differentiable functional
collectives on the mesh's process groups; on a one-rank axis each is
the identity.  The three expert products go through
``gmm_ops.gmm_model``: K8 on a CUDA tensor that autograd does not
record, the differentiable grouped einsum under autograd.  The two
all_to_all results carry the reference's checkpoint names
(``moe_a2a_in`` / ``moe_a2a_out``), so the named remat policies keep
them and the backward re-runs no all_to_all.

A parameter is its full (replicated) value and this rank takes its
block of it, as ``shard_map``'s ``in_specs`` do; ``x`` and the output
are this rank's batch shard.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed._functional_collectives as fc
import torch.nn.functional as F

from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.models.layers import ACTS, checkpoint_name, softmax
from repro_torch.models.moe import _dispatch_indices, _dispatch_onehot, _top_k
from repro_torch.parallel.sharding import (PartitionSpec as P, active_mesh,
                                           mesh_axis_names)


def _block(t, spec: P, mesh):
    """This rank's block of the full tensor ``t`` under ``spec``."""
    for dim, entry in enumerate(spec):
        for ax in (entry,) if isinstance(entry, str) else (entry or ()):
            n = mesh.size(mesh_axis_names(mesh).index(ax))
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"smap MoE: dim {dim} of {tuple(t.shape)} "
                                 f"does not split over {ax}={n}")
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.get_local_rank(ax) * size, size)
    return t.contiguous()


def _a2a(t, group):
    """Tiled all_to_all along dim 0: chunk j goes to rank j; the chunk
    from rank i lands at position i.  The differentiable op where
    autograd records (it has no kernel of its own under inference
    mode), the plain one elsewhere."""
    op = (fc.all_to_all_single_autograd
          if torch.is_grad_enabled() and t.requires_grad
          else fc.all_to_all_single)
    return fc.wait_tensor(op(t, None, None, group))


def _sum(t, group):
    return fc.wait_tensor(fc.all_reduce(t, "sum", group))


def _local_moe(params, x_loc, cfg, mesh) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-rank computation. x_loc: (B_loc, T, d); params: local blocks."""
    m = cfg.moe
    B_loc, T, d = x_loc.shape
    E, k = m.n_routed, m.top_k
    n_data = mesh.size(mesh_axis_names(mesh).index("data"))
    E_loc = E // n_data
    act = ACTS[cfg.act]
    data_g, model_g = mesh.get_group("data"), mesh.get_group("model")

    logits = (x_loc @ params["router"]["w"].to(x_loc.dtype)).float()
    probs = softmax(logits)
    gate, topk_idx = _top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # aux loss over the full batch: local means, averaged over data
    me = _sum(probs.mean(dim=(0, 1)), data_g) / n_data
    oh = F.one_hot(topk_idx, E).float()
    ce = _sum(oh.sum(dim=2).mean(dim=(0, 1)) / k, data_g) / n_data
    aux = m.aux_loss_coef * E * torch.sum(me * ce)

    # ONE dispatch group per rank (not per batch row): the capacity
    # averages over all local tokens
    N = B_loc * T
    C_dev = max(1, int(N * k / E * m.capacity_factor))
    # the paper's sparse tail: overflow slots appended on the capacity
    # axis, so ONE all_to_all + ONE grouped matmul cover both passes
    C_tail = max(1, C_dev // 4) if m.overflow_passes else 0
    Ct = C_dev + C_tail * m.overflow_passes

    flat_e = topk_idx.reshape(-1)                          # (N*k,)
    xk = x_loc.reshape(N, d).repeat_interleave(k, dim=0)
    if m.dispatch == "onehot":
        e_ids, pos = _dispatch_onehot(flat_e, E)
        x_in, order = xk, None
    else:
        order, e_ids, pos = _dispatch_indices(flat_e, E)
        x_in = xk[order]
    keep = pos < Ct
    ei = torch.where(keep, e_ids, E)                       # E == drop row
    pi = torch.where(keep, pos, 0)
    buf = torch.zeros((E + 1, Ct, d), dtype=x_loc.dtype,
                      device=x_loc.device)
    buf[ei, pi] = x_in
    buf = buf[:E]                                          # (E, Ct, d)

    # ---- a2a over data: ship buffers to expert owners ----
    with checkpoint_name("moe_a2a_in"):
        recv = _a2a(buf, data_g)                           # (nd*E_loc, Ct, d)
    buf_x = recv.view(n_data, E_loc, Ct, d).transpose(0, 1).reshape(
        E_loc, n_data * Ct, d)
    h = gmm_ops.gmm_model(buf_x, params["w_up"].to(buf_x.dtype))
    g = gmm_ops.gmm_model(buf_x, params["w_gate"].to(buf_x.dtype))
    out = gmm_ops.gmm_model(h * act(g), params["w_down"].to(buf_x.dtype))
    # ---- a2a back (partial over f) ----
    out = out.view(E_loc, n_data, Ct, d).transpose(0, 1).contiguous()
    with checkpoint_name("moe_a2a_out"):
        out = _a2a(out, data_g)                            # (nd, E_loc, Ct, d)
    out = out.reshape(E, Ct, d)

    gathered = out[ei.clamp(max=E - 1), pi]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    if order is not None:
        gathered = gathered[torch.argsort(order)]
    y = torch.sum(gathered.reshape(N, k, d)
                  * gate.reshape(N, k)[..., None].to(x_loc.dtype),
                  dim=1).reshape(B_loc, T, d)

    if "shared" in params:
        sp = params["shared"]
        h = (x_loc @ sp["up"]["w"].to(x_loc.dtype)) * act(
            x_loc @ sp["gate"]["w"].to(x_loc.dtype))
        y = y + h @ sp["down"]["w"].to(x_loc.dtype)
    # fold the f-contraction partials into one activation sum
    y = _sum(y, model_g)
    return y, aux


def moe_ffn_shard_map(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for moe_ffn when a mesh is active."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("smap MoE needs an active mesh")
    n_data = mesh.size(mesh_axis_names(mesh).index("data"))
    E = cfg.moe.n_routed
    if E % n_data:
        raise ValueError(f"smap MoE: {E} experts over data={n_data}")

    pspec = {
        "router": {"w": P()},
        "w_up": P("data", None, "model"),
        "w_gate": P("data", None, "model"),
        "w_down": P("data", "model", None),
    }
    if "shared" in params:
        pspec["shared"] = {
            "up": {"w": P(None, "model")},
            "gate": {"w": P(None, "model")},
            "down": {"w": P("model", None)},
        }

    def local(p, s):
        if isinstance(s, dict):
            return {key: local(p[key], s[key]) for key in s}
        return _block(p, s, mesh)

    return _local_moe(local(params, pspec), x, cfg, mesh)
