"""Attention: MHA/GQA/MQA with RoPE, sliding-window, QK-norm, KV caches.

Three entry points:
  * ``attention(...)``            — full-sequence (train / prefill)
  * ``attention_decode(...)``     — single-token step against a KV cache
  * ``cross_attention(...)``      — decoder queries against the encoder's
                                    precomputed K/V (encoder-decoder)

Plain causal (or unmasked) attention goes through
``kernels.flash_attention.ops.sdpa``: K7 on the GPU, its full
(``causal=False``) route for the encoder and the cross-attention.
Sliding windows and logit softcaps keep the grouped-einsum ``_sdpa``,
and so does the decode step, as in the reference.  With no pin and no
tune-cache hit for the shape (``flash_ops.model_config``), a call that
autograd records (grad mode on, an input or weight that requires grad)
takes ``_sdpa`` too: K7, like the reference's kernel, defines no
backward, and the reference's differentiated layers take this
formulation.  With a pin or a hit the layer runs ``sdpa`` on that
config, also where autograd records (``model_config`` then maps K7 onto
a differentiable formulation), as the reference's layers do; under an
active mesh no pin or hit is read, as in the reference, and the route is
the one above.  The reference's ``shard_act`` sites are kept
(``parallel.sharding``).

KV-head handling: when the model-parallel degree ``tp`` exceeds
``n_kv_heads`` the K/V *activations* (and the caches) are repeated
``kv_repeat``-fold along the head axis (``kv_repeat_for``), each head
next to its copies, so that the head axis shards evenly; the parameters
keep the architecture's ``n_kv_heads``.  Every query head reads the
values it reads at ``kv_repeat`` 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import differentiated
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import (apply_rope, init_linear, linear,
                                       rms_norm_simple, softmax)
from repro_torch.models.param import ones_init
from repro_torch.parallel.sharding import (active_mesh, local_blocks,
                                           merge_heads, shard_act,
                                           split_heads)


def kv_repeat_for(cfg, tp_hint: int) -> int:
    """Replication factor for KV heads given a TP degree hint."""
    if tp_hint <= cfg.n_kv_heads:
        return 1
    return max(1, min(cfg.n_heads, tp_hint) // cfg.n_kv_heads)


def init_attention(gen, cfg, dtype):
    dh = cfg.head_dim_()
    p = {
        "wq": init_linear(gen, cfg.d_model, cfg.n_heads * dh, dtype,
                          cfg.use_bias, axes=("embed", "q_hidden")),
        "wk": init_linear(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype,
                          cfg.use_bias, axes=("embed", "kv_hidden")),
        "wv": init_linear(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype,
                          cfg.use_bias, axes=("embed", "kv_hidden")),
        "wo": init_linear(gen, cfg.n_heads * dh, cfg.d_model, dtype,
                          cfg.use_bias, axes=("q_hidden", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones_init((dh,), gen.device, axes=(None,))
        p["k_norm"] = ones_init((dh,), gen.device, axes=(None,))
    return p


def _repeat_kv(k, v, kv_repeat: int):
    """K/V (B, S, Kv, dh) with each head repeated ``kv_repeat`` times
    next to itself (the reference's ``jnp.repeat`` along the head
    axis)."""
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    return k, v


def _qkv(params, x, cfg, sin, cos, kv_repeat: int = 1):
    dh = cfg.head_dim_()
    q = split_heads(linear(params["wq"], x), cfg.n_heads, dh)
    k = split_heads(linear(params["wk"], x), cfg.n_kv_heads, dh)
    v = split_heads(linear(params["wv"], x), cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm_simple(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm_simple(k, params["k_norm"], cfg.norm_eps)
    if sin is not None:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return (q, *_repeat_kv(k, v, kv_repeat))


def _sdpa(q, k, v, mask, cfg):
    """Grouped scaled-dot-product attention.

    q: (B, T, H, dh); k/v: (B, S, Kv, dh) with H % Kv == 0.
    mask: (T, S) or (B, 1, 1, T, S) boolean, True = attend.
    """
    B, T, H, dh = q.shape
    Kv = k.shape[2]
    G = H // Kv
    q = q.reshape(B, T, Kv, G, dh)
    scale = dh ** -0.5
    scores = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) * scale
    if cfg.logit_softcap:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None, None]
        scores = torch.where(mask, scores, -1e30)
    # the weights are rounded to q's type before p v, as in the reference
    w = softmax(scores).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v)
    return out.reshape(B, T, H, dh)


def causal_mask(T: int, S: int, window: int = 0, device=None):
    """mask[t, s] = attendable."""
    t = torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :]
    m = s <= t
    if window:
        m &= s > (t - window)
    return m


def _flash(cfg, causal: bool, q, k, v):
    """The layer's attention through ``flash_ops.sdpa`` where it takes
    this call, else None (the caller's einsum ``_sdpa``).  Sliding
    windows and logit softcaps never take it.  Outside a mesh a pin or
    tune-cache hit for the shape takes it on its config (differentiable
    where autograd records); otherwise, as under a mesh, the device's
    default takes it where autograd does not record."""
    if cfg.logit_softcap or (causal and cfg.sliding_window):
        return None
    tuned = (flash_ops.model_config(q, k, v, causal=causal)
             if active_mesh() is None else None)
    if tuned is not None:
        return flash_ops.sdpa(q, k, v, causal=causal, config=tuned)
    if differentiated(q, k, v):
        return None
    return flash_ops.sdpa(q, k, v, causal=causal)


def _core(cfg, causal: bool, q, k, v):
    """Full-sequence attention of (B, T, H, dh) q against (B, S, Kv, dh)
    k/v: ``_flash`` where it takes the call, else ``_sdpa``."""
    out = _flash(cfg, causal, q, k, v)
    if out is None:
        T, S = q.shape[1], k.shape[1]
        mask = (causal_mask(T, S, cfg.sliding_window, device=q.device)
                if causal else None)
        out = _sdpa(q, k, v, mask, cfg)
    return out


# (batch dim, head dim) of q, k, v and the attention's output, for
# ``local_blocks``: under a mesh each rank attends its rows and heads
_BH = (0, 2)


def attention(params, x, cfg, *, sin=None, cos=None, kv_repeat: int = 1,
              causal: bool = True, make_cache_len: int = 0):
    """Full-sequence attention. Returns (y, cache_or_None); the cache
    holds ``n_kv_heads * kv_repeat`` heads."""
    q, k, v = _qkv(params, x, cfg, sin, cos, kv_repeat)
    q = shard_act(q, ("batch", None, "heads", None))
    k = shard_act(k, ("batch", "seq_kv", "heads", None))
    v = shard_act(v, ("batch", "seq_kv", "heads", None))
    out = local_blocks(lambda q, k, v: _core(cfg, causal, q, k, v),
                       (q, k, v), (_BH, _BH, _BH), _BH)
    y = linear(params["wo"], merge_heads(out))
    cache = None
    if make_cache_len:
        L = make_cache_len
        if cfg.sliding_window:
            L = min(L, cfg.sliding_window)
            k, v = k[:, -L:], v[:, -L:]
        pad = (0, 0, 0, 0, 0, L - k.shape[1])
        kc, vc = local_blocks(
            lambda k, v: (torch.nn.functional.pad(k, pad),
                          torch.nn.functional.pad(v, pad)),
            (k, v), (_BH, _BH), (_BH, _BH))
        cache = {"k": kc, "v": vc}
    return y, cache


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16, kv_repeat: int = 1):
    """Empty decode cache of ``n_kv_heads * kv_repeat`` heads. SWA archs
    get a ring buffer of window size."""
    L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, L, cfg.n_kv_heads * kv_repeat, cfg.head_dim_())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params, x, cfg, cache, position, *, sin=None,
                     cos=None, kv_repeat: int = 1):
    """One-token decode. x: (B, 1, d). position: an int (tokens so far,
    the same for every row) or a (B,) int tensor (each row's own: the
    continuous engine's slots sit at different decode depths).

    Full-attention caches index by absolute position; sliding-window caches
    are ring buffers indexed by ``position % window``.  The new K/V are
    written into the cache's slot in place (the reference returns an
    updated copy); the returned cache is the same dict.  A row at a
    tensor position computes what it computes alone at that ``int``.
    """
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"attention_decode: one token a step, got T={T}")
    q, k, v = _qkv(params, x, cfg, sin, cos, kv_repeat)
    L = cache["k"].shape[1]
    idx = torch.arange(L, device=x.device)
    if isinstance(position, int):
        slot = position % L if cfg.sliding_window > 0 else position
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        pos = position
    else:
        pos = position.to(x.device)
        slot = pos % L if cfg.sliding_window > 0 else pos
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        pos, idx = pos[:, None], idx[None, :]
    cache["k"] = shard_act(cache["k"], ("batch", "seq_kv", "heads", None))
    cache["v"] = shard_act(cache["v"], ("batch", "seq_kv", "heads", None))
    if cfg.sliding_window:
        # ring buffer: until it wraps only slots <= position are valid;
        # once full, every slot holds one of the last L tokens.
        valid = ((pos < L) & (idx <= pos)) | (pos >= L)
    else:
        valid = idx <= pos
    # (1 or B, 1, 1, 1, L): one mask for every row, or one a row
    mask = valid.reshape(-1, 1, 1, 1, L)
    out = local_blocks(lambda q, k, v, m: _sdpa(q, k, v, m, cfg),
                       (q, cache["k"], cache["v"], mask),
                       (_BH, _BH, _BH, (0 if mask.shape[0] > 1 else None,
                                        None)), _BH)
    y = linear(params["wo"], merge_heads(out))
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------
def init_cross_attention(gen, cfg, dtype):
    return init_attention(gen, cfg, dtype)


def cross_attention(params, x, enc_kv, cfg, kv_repeat: int = 1):
    """x: (B, T, d) decoder side; enc_kv: precomputed {"k", "v"} from the
    encoder (``encode_cross_kv``, already repeated: ``kv_repeat`` is
    taken and unused, as in the reference).  No mask: every query sees
    every encoder frame."""
    dh = cfg.head_dim_()
    q = split_heads(linear(params["wq"], x), cfg.n_heads, dh)
    out = local_blocks(lambda q, k, v: _core(cfg, False, q, k, v),
                       (q, enc_kv["k"], enc_kv["v"]), (_BH, _BH, _BH), _BH)
    return linear(params["wo"], merge_heads(out))


def encode_cross_kv(params, enc_out, cfg, kv_repeat: int = 1):
    dh = cfg.head_dim_()
    k = split_heads(linear(params["wk"], enc_out), cfg.n_kv_heads, dh)
    v = split_heads(linear(params["wv"], enc_out), cfg.n_kv_heads, dh)
    k, v = _repeat_kv(k, v, kv_repeat)
    return {"k": k, "v": v}
