"""Block assembly: (attn | mla | mamba | mlstm | slstm) + (mlp | moe).

Layers are organised into *groups* (the repeating unit — one layer for
homogeneous stacks, 8 layers for jamba's attn:mamba interleave,
``slstm_every`` layers for xLSTM) after an unrolled dense prefix (the
first ``n_dense_layers`` of an MoE model of attention layers use the
dense FFN).  The reference stacks the groups' parameters and runs a
``lax.scan`` over them; here ``params["groups"]`` is a list of
per-group parameter dicts and the stack is a Python loop over it.

A decode step writes every layer's cache in place: attention and MLA
their K/V slot, the recurrent layers (mamba, mLSTM, sLSTM) their whole
state, with ``copy_``.  The cache tree a step is given is the tree it
returns.  At a (B,) position tensor (the continuous engine's slots) the
recurrent layers run their batched products (and the mLSTM gates'
projections) row by row (``per_row``), so each row computes the bits of
its solo step.

``kv_repeat`` (``attention.kv_repeat_for``: the KV heads repeated so that
they divide a model axis of size ``tp``) reaches every attention layer
and its cache; MLA and the recurrent mixers take none, as in the
reference.

A training forward (autograd recording, no caches) wraps each group in
the config's ``parallel.remat``: ``"dots"`` keeps the matmuls' outputs
and recomputes the rest in the backward (the reference's
``checkpoint_dots``), ``"full"`` recomputes the whole group.  The named
policies keep what ``layers.checkpoint_name`` names as well:
``"dots_names"`` the matmuls and the smap MoE's all_to_all results
(``moe_a2a_in`` / ``moe_a2a_out``), ``"full_names"`` only those, and
``"boundaries"`` only each layer's residual outputs (``blk_attn_out`` /
``blk_ffn_out``).  None changes a value.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (checkpoint_name,
                                       current_checkpoint_name, init_mlp,
                                       init_norm, mlp, norm)
from repro_torch.parallel.sharding import shard_act


# ---------------------------------------------------------------------------
# Group layout
# ---------------------------------------------------------------------------
def group_layout(cfg) -> Tuple[List[str], List[bool], int]:
    """Returns (kinds, moe_flags, n_groups) for the repeating group."""
    if cfg.block_pattern == "jamba":
        g = cfg.attn_every
        kinds = ["attn" if i == cfg.attn_offset else "mamba"
                 for i in range(g)]
        moe_flags = [cfg.moe is not None and i % cfg.moe.every == 1
                     for i in range(g)]
        return kinds, moe_flags, cfg.n_layers // g
    if cfg.block_pattern == "xlstm":
        g = cfg.xlstm.slstm_every
        kinds = ["slstm" if i == g - 1 else "mlstm" for i in range(g)]
        return kinds, [False] * g, cfg.n_layers // g
    return [_attn_kind(cfg)], [cfg.moe is not None], \
        cfg.n_layers - _n_dense(cfg)


def _attn_kind(cfg) -> str:
    return "mla" if cfg.attn_type == "mla" else "attn"


def _n_dense(cfg) -> int:
    return cfg.moe.n_dense_layers if cfg.moe else 0


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------
def init_layer(gen, cfg, kind: str, use_moe: bool, dtype):
    p: dict = {"norm1": init_norm(cfg, gen.device)}
    if kind == "attn":
        p["mix"] = attn_mod.init_attention(gen, cfg, dtype)
    elif kind == "mla":
        p["mix"] = mla_mod.init_mla(gen, cfg, dtype)
    elif kind == "mamba":
        p["mix"] = ssm_mod.init_mamba(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mix"] = xlstm_mod.init_mlstm_block(gen, cfg, dtype)
    elif kind == "slstm":
        p["mix"] = xlstm_mod.init_slstm_block(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    if cfg.d_ff or use_moe:
        p["norm2"] = init_norm(cfg, gen.device)
        p["ffn"] = (moe_mod.init_moe(gen, cfg, dtype) if use_moe
                    else init_mlp(gen, cfg, dtype))
    return p


def init_layer_cache(cfg, kind: str, batch: int, max_len: int, device,
                     kv_repeat: int = 1):
    """Empty decode cache of one layer: bf16 (the activations' type)
    but for the recurrent states, which are f32 as in the reference."""
    if kind == "attn":
        return attn_mod.init_cache(cfg, batch, max_len, device,
                                   kv_repeat=kv_repeat)
    if kind == "mla":
        return mla_mod.init_mla_cache(cfg, batch, max_len, device)
    if kind == "mamba":
        return ssm_mod.init_mamba_cache(cfg, batch, device)
    if kind == "mlstm":
        return xlstm_mod.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm_mod.init_slstm_cache(cfg, batch, device)
    raise ValueError(kind)


def _residual(x, y, cfg, name=None):
    """``x + y`` constrained to the residual's axes, and named where
    ``name`` is given (the full-sequence layer's two block
    boundaries)."""
    seq_ax = "seq" if cfg.parallel.seq_parallel else None
    with checkpoint_name(name) if name else contextlib.nullcontext():
        return shard_act(x + y, ("batch", seq_ax, "embed"))


def _ffn(params, x, cfg, use_moe: bool, boundary: bool = False):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in params:
        h = norm(params["norm2"], x, cfg)
        if use_moe:
            y, aux = moe_mod.moe_ffn(params["ffn"], h, cfg)
        else:
            y = mlp(params["ffn"], h, cfg)
        x = _residual(x, y, cfg, "blk_ffn_out" if boundary else None)
    return x, aux


def apply_layer(params, x, cfg, kind: str, use_moe: bool, *, sin, cos,
                kv_repeat: int = 1, make_cache_len: int = 0):
    """Full-sequence layer. Returns (x, cache, aux_loss)."""
    h = norm(params["norm1"], x, cfg)
    if kind == "attn":
        y, cache = attn_mod.attention(params["mix"], h, cfg, sin=sin,
                                      cos=cos, kv_repeat=kv_repeat,
                                      make_cache_len=make_cache_len)
    elif kind == "mla":
        y, cache = mla_mod.mla_attention(params["mix"], h, cfg, sin=sin,
                                         cos=cos,
                                         make_cache_len=make_cache_len)
    elif kind == "mamba":
        y, cache = ssm_mod.mamba(params["mix"], h, cfg,
                                 make_cache=make_cache_len > 0)
    elif kind == "mlstm":
        y, cache = xlstm_mod.mlstm_block(params["mix"], h, cfg,
                                         make_cache=make_cache_len > 0)
    elif kind == "slstm":
        y, st = xlstm_mod.slstm_block(params["mix"], h, cfg)
        cache = st if make_cache_len > 0 else None
    else:
        raise ValueError(kind)
    x = _residual(x, y, cfg, "blk_attn_out")
    x, aux = _ffn(params, x, cfg, use_moe, boundary=True)
    return x, cache, aux


def apply_layer_decode(params, x, cfg, kind: str, use_moe: bool, cache,
                       position, *, sin, cos, kv_repeat: int = 1):
    """Single-token layer step at an int or a (B,) tensor of per-row
    positions. Returns (x, cache, aux); the cache is updated in place."""
    h = norm(params["norm1"], x, cfg)
    per_row = not isinstance(position, int)
    if kind == "attn":
        y, cache = attn_mod.attention_decode(params["mix"], h, cfg, cache,
                                             position, sin=sin, cos=cos,
                                             kv_repeat=kv_repeat)
    elif kind == "mla":
        y, cache = mla_mod.mla_decode(params["mix"], h, cfg, cache,
                                      position, sin=sin, cos=cos)
    elif kind == "mamba":
        y, cache = ssm_mod.mamba_decode(params["mix"], h, cfg, cache,
                                        per_row=per_row)
    elif kind == "mlstm":
        y, cache = xlstm_mod.mlstm_block(params["mix"], h, cfg,
                                         decode_state=cache, per_row=per_row)
    elif kind == "slstm":
        y, cache = xlstm_mod.slstm_block(params["mix"], h, cfg, state=cache,
                                         per_row=per_row)
    else:
        raise ValueError(kind)
    x, aux = _ffn(params, _residual(x, y, cfg), cfg, use_moe)
    return x, cache, aux


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------
# the dot products whose outputs "dots" keeps: every matmul and einsum
# reaches the dispatcher as one of these
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default]


# the named policies: (keep the dots too, the names they keep)
_A2A_NAMES = ("moe_a2a_in", "moe_a2a_out")
_NAMED = {"dots_names": (True, _A2A_NAMES),
          "full_names": (False, _A2A_NAMES),
          "boundaries": (False, ("blk_attn_out", "blk_ffn_out"))}


def _named_policy(dots: bool, names):
    """Selective-checkpoint policy: save the outputs of every op
    dispatched under one of ``names`` (and of the dots if ``dots``), so
    the recompute never re-runs them (an all_to_all among them);
    recompute the rest."""
    def policy(ctx, op, *args, **kwargs):
        if current_checkpoint_name() in names or (dots and op in _DOTS):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _remat_wrap(fn, cfg):
    """``fn`` under the config's rematerialisation policy."""
    remat = cfg.parallel.remat
    if remat == "none":
        return fn
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _DOTS)
    elif remat == "full":
        ctx = None
    elif remat in _NAMED:
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _named_policy(*_NAMED[remat]))
    else:
        raise ValueError(f"remat={remat!r}")
    if ctx is None:
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 context_fn=ctx)


# ---------------------------------------------------------------------------
# Group (repeating unit) and stack
# ---------------------------------------------------------------------------
def init_group(gen, cfg, dtype):
    kinds, moe_flags, _ = group_layout(cfg)
    return {f"l{i}": init_layer(gen, cfg, kind, mf, dtype)
            for i, (kind, mf) in enumerate(zip(kinds, moe_flags))}


def _n_prefix(cfg) -> int:
    return _n_dense(cfg) if cfg.block_pattern == "attn" else 0


def init_stack(gen, cfg, dtype):
    """Per-group params + the unrolled dense prefix."""
    _, _, n_groups = group_layout(cfg)
    p = {"groups": [init_group(gen, cfg, dtype) for _ in range(n_groups)]}
    if _n_prefix(cfg):
        # dense prefix uses the dense d_ff (no MoE)
        p["prefix"] = [init_layer(gen, cfg, _attn_kind(cfg), False, dtype)
                       for _ in range(_n_prefix(cfg))]
    return p


def init_stack_caches(cfg, batch: int, max_len: int, device,
                      kv_repeat: int = 1):
    """Empty decode caches (``init_layer_cache``'s types)."""
    kinds, _, n_groups = group_layout(cfg)
    out = {"groups": [{f"l{i}": init_layer_cache(cfg, kind, batch, max_len,
                                                 device, kv_repeat)
                       for i, kind in enumerate(kinds)}
                      for _ in range(n_groups)]}
    if _n_prefix(cfg):
        out["prefix"] = [init_layer_cache(cfg, _attn_kind(cfg), batch,
                                          max_len, device, kv_repeat)
                         for _ in range(_n_prefix(cfg))]
    return out


def apply_stack(params, x, cfg, *, sin, cos, kv_repeat: int = 1,
                make_cache_len: int = 0):
    """Returns (x, caches, aux)."""
    kinds, moe_flags, _ = group_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_caches = []
    for lp in params.get("prefix", []):
        x, c, a = apply_layer(lp, x, cfg, _attn_kind(cfg), False, sin=sin,
                              cos=cos, kv_repeat=kv_repeat,
                              make_cache_len=make_cache_len)
        prefix_caches.append(c)
        aux = aux + a

    def group(gp, x, aux):
        caches = {}
        for i, (kind, mf) in enumerate(zip(kinds, moe_flags)):
            x, caches[f"l{i}"], a = apply_layer(
                gp[f"l{i}"], x, cfg, kind, mf, sin=sin, cos=cos,
                kv_repeat=kv_repeat, make_cache_len=make_cache_len)
            aux = aux + a
        return x, aux, caches

    if torch.is_grad_enabled() and not make_cache_len:
        remat = _remat_wrap(lambda gp, x, aux: group(gp, x, aux)[:2], cfg)
        for gp in params["groups"]:
            x, aux = remat(gp, x, aux)
        return x, None, aux
    group_caches = []
    for gp in params["groups"]:
        x, aux, caches = group(gp, x, aux)
        group_caches.append(caches)
    caches = None
    if make_cache_len:
        caches = {"groups": group_caches}
        if prefix_caches:
            caches["prefix"] = prefix_caches
    return x, caches, aux


def apply_stack_decode(params, x, cfg, caches, position, *, sin, cos,
                       kv_repeat: int = 1):
    """Returns (x, caches, aux); the caches are updated in place."""
    kinds, moe_flags, _ = group_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, c in zip(params.get("prefix", []), caches.get("prefix", [])):
        x, _, a = apply_layer_decode(lp, x, cfg, _attn_kind(cfg), False, c,
                                     position, sin=sin, cos=cos,
                                     kv_repeat=kv_repeat)
        aux = aux + a
    for gp, gc in zip(params["groups"], caches["groups"]):
        for i, (kind, mf) in enumerate(zip(kinds, moe_flags)):
            x, _, a = apply_layer_decode(gp[f"l{i}"], x, cfg, kind, mf,
                                         gc[f"l{i}"], position, sin=sin,
                                         cos=cos, kv_repeat=kv_repeat)
            aux = aux + a
    return x, caches, aux
