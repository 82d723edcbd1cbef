"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3).

Train/prefill use the naive (expanded) form; decode uses the *absorbed*
form working directly in the latent space so the cache is just
``(c_kv, k_rope)``.  The reference computes both outside any Pallas
kernel, so both stay einsums here (cuBLAS on the GPU): the scores of
the ``nope`` and ``rope`` parts are summed in f32, the softmax is f32,
the weights are rounded to the activations' type before ``w v``.

The decode step takes an int position (every row at the same depth)
or a (B,) tensor of per-row positions (the continuous engine's slots):
the latent cache is written at ``[arange(B), position]`` in place, each
row masks its own valid prefix, and each row's attention runs alone,
so a row at a tensor position computes bitwise what it computes alone
at that int.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_rope, init_linear, linear,
                                       rms_norm_simple, softmax)
from repro_torch.models.param import ones_init
from repro_torch.parallel.sharding import shard_act


def _dims(cfg):
    m = cfg.mla
    return (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
            m.kv_lora_rank)


def init_mla(gen, cfg, dtype):
    dn, dr, dv, kvl = _dims(cfg)
    H, d = cfg.n_heads, cfg.d_model
    p = {}
    if cfg.mla.q_lora_rank:
        p["wq_a"] = init_linear(gen, d, cfg.mla.q_lora_rank, dtype,
                                axes=("embed", "q_lora"))
        p["q_norm"] = ones_init((cfg.mla.q_lora_rank,), gen.device,
                                axes=(None,))
        p["wq_b"] = init_linear(gen, cfg.mla.q_lora_rank, H * (dn + dr),
                                dtype, axes=("q_lora", "q_hidden"))
    else:
        p["wq"] = init_linear(gen, d, H * (dn + dr), dtype,
                              axes=("embed", "q_hidden"))
    p["wkv_a"] = init_linear(gen, d, kvl + dr, dtype, axes=("embed", None))
    p["kv_norm"] = ones_init((kvl,), gen.device, axes=(None,))
    p["wkv_b"] = init_linear(gen, kvl, H * (dn + dv), dtype,
                             axes=("kv_lora", "q_hidden"))
    p["wo"] = init_linear(gen, H * dv, d, dtype, axes=("q_hidden", "embed"))
    return p


def _queries(params, x, cfg, sin, cos):
    dn, dr, _, _ = _dims(cfg)
    B, T, _ = x.shape
    if cfg.mla.q_lora_rank:
        ql = rms_norm_simple(linear(params["wq_a"], x), params["q_norm"],
                             cfg.norm_eps)
        q = linear(params["wq_b"], ql)
    else:
        q = linear(params["wq"], x)
    q = q.reshape(B, T, cfg.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, sin, cos)


def _latent_kv(params, x, cfg, sin, cos):
    _, _, _, kvl = _dims(cfg)
    kv = linear(params["wkv_a"], x)
    c_kv, k_rope = kv[..., :kvl], kv[..., kvl:]
    c_kv = rms_norm_simple(c_kv, params["kv_norm"], cfg.norm_eps)
    # one rope head, shared by every query head
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0]
    return c_kv, k_rope


def _weights(s, mask, dtype):
    """f32 scores -> masked f32 softmax -> ``dtype``, as the reference."""
    s = torch.where(mask, s, -1e30)
    return softmax(s).to(dtype)


def mla_attention(params, x, cfg, *, sin=None, cos=None,
                  make_cache_len: int = 0, kv_repeat: int = 1):
    """Naive (expanded) MLA for train/prefill. Returns (y, cache); the
    cache is the latent ``ckv`` / ``kr`` padded to ``make_cache_len``.
    ``kv_repeat`` is taken and unused, as in the reference: the latent
    cache has no KV heads to repeat."""
    dn, dr, dv, _ = _dims(cfg)
    B, T, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _queries(params, x, cfg, sin, cos)
    c_kv, k_rope = _latent_kv(params, x, cfg, sin, cos)
    kv = linear(params["wkv_b"], c_kv).reshape(B, T, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]

    scale = (dn + dr) ** -0.5
    s = (torch.einsum("bthd,bshd->bhts", q_nope.float(), k_nope.float())
         + torch.einsum("bthd,bsd->bhts", q_rope.float(), k_rope.float())
         ) * scale
    t = torch.arange(T, device=x.device)
    mask = t[None, :] <= t[:, None]
    w = _weights(s, mask[None, None], x.dtype)
    out = torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, H * dv)
    y = linear(params["wo"], out)
    cache = None
    if make_cache_len:
        pad = (0, 0, 0, make_cache_len - T)
        cache = {"ckv": F.pad(c_kv, pad), "kr": F.pad(k_rope, pad)}
    return y, cache


def init_mla_cache(cfg, batch: int, max_len: int, device,
                   dtype=torch.bfloat16):
    _, dr, _, kvl = _dims(cfg)
    return {"ckv": torch.zeros((batch, max_len, kvl), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, max_len, dr), dtype=dtype,
                              device=device)}


def _absorbed(q_nope, q_rope, ckv, kr, valid, wk, wv, scale, dtype):
    """The absorbed attention of decode rows against their latent cache:
    (B, 1, H, dv) from (B, 1, H, dn/dr) queries, (B, L, kvl/dr) caches
    and a (B or 1, 1, 1, L) valid mask."""
    # absorb: q_lat[b,h,l] = sum_d q_nope[b,h,d] * wk[l,h,d]
    q_lat = torch.einsum("bthd,lhd->bthl", q_nope, wk)
    s = (torch.einsum("bthl,bsl->bhts", q_lat.float(), ckv.float())
         + torch.einsum("bthd,bsd->bhts", q_rope.float(), kr.float())
         ) * scale
    w = _weights(s, valid, dtype)
    ctx = torch.einsum("bhts,bsl->bthl", w, ckv)            # latent context
    return torch.einsum("bthl,lhd->bthd", ctx, wv)


def mla_decode(params, x, cfg, cache, position, *, sin=None, cos=None,
               kv_repeat: int = 1):
    """Absorbed-form single-token decode against the latent cache
    (``kv_repeat`` taken and unused, as in the reference).
    x: (B, 1, d); position: an int or a (B,) int tensor.  The new latent
    row is written into the cache in place; the returned cache is the
    same dict.

    At a tensor position (the continuous engine's slots) each row's
    attention runs as its own one-row call: cuBLAS picks its kernel (a
    split-K one among them) from the batch count, so the (B, H, L)
    score and context products of a batch would not sum in the order
    a row sums alone.  One-row calls give every row the bits of its
    ``int`` step."""
    dn, dr, dv, kvl = _dims(cfg)
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"mla_decode: one token a step, got T={T}")
    H = cfg.n_heads
    q_nope, q_rope = _queries(params, x, cfg, sin, cos)   # (B,1,H,dn/dr)
    c_kv, k_rope = _latent_kv(params, x, cfg, sin, cos)   # (B,1,kvl),(B,1,dr)
    ckv, kr = cache["ckv"], cache["kr"]
    L = ckv.shape[1]
    idx = torch.arange(L, device=x.device)
    wkv_b = params["wkv_b"]["w"].to(x.dtype).reshape(kvl, H, dn + dv)
    wk, wv = wkv_b[..., :dn], wkv_b[..., dn:]
    scale = (dn + dr) ** -0.5
    if isinstance(position, int):
        ckv[:, position] = c_kv[:, 0]
        kr[:, position] = k_rope[:, 0]
    else:
        pos = position.to(x.device)
        rows = torch.arange(B, device=x.device)
        ckv[rows, pos] = c_kv[:, 0]
        kr[rows, pos] = k_rope[:, 0]
    ckv = shard_act(ckv, ("batch", "seq_kv", None))
    if isinstance(position, int):
        valid = (idx <= position).reshape(1, 1, 1, L)
        out = _absorbed(q_nope, q_rope, ckv, kr, valid, wk, wv, scale,
                        x.dtype)
    else:
        valid = (idx[None, :] <= pos[:, None]).reshape(B, 1, 1, L)
        out = torch.cat([
            _absorbed(q_nope[b:b + 1], q_rope[b:b + 1], ckv[b:b + 1],
                      kr[b:b + 1], valid[b:b + 1], wk, wv, scale, x.dtype)
            for b in range(B)])
    y = linear(params["wo"], out.reshape(B, T, H * dv))
    return y, cache
