"""Mamba (S6) selective-state-space block.

Prefill runs the reference's time loop (its ``lax.scan``, a Python loop
here) over ``dA`` and ``dBu`` materialised for the whole sequence, as
the reference does; decode is one recurrent update against
``(conv, h)``, written into the cache in place.  The reference computes
every step in plain ``jnp``, with no Pallas kernel.  With ``per_row``
(a step at a (B,) position tensor: the continuous engine's slots) the
state's read-out product runs as one-row calls, so that each row
computes the bits it computes alone.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ACTS, conv_step, copy_state,
                                       init_linear, linear, rowwise,
                                       softplus)
from repro_torch.models.param import (dense_init, note_axes, ones_init,
                                      zeros_init)
from repro_torch.parallel.sharding import shard_act

_silu = ACTS["silu"]


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(1, math.ceil(cfg.d_model / 16))
    return d_inner, s.d_state, s.d_conv, dt_rank


def init_mamba(gen, cfg, dtype):
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    dev = gen.device
    return {
        "in_proj": init_linear(gen, cfg.d_model, 2 * d_inner, dtype,
                               axes=("embed", "inner")),
        "conv_w": dense_init(gen, (d_conv, d_inner), dtype, fan_in=d_conv,
                             axes=("conv", "inner")),
        "conv_b": zeros_init((d_inner,), dev, dtype, axes=("inner",)),
        "x_proj": init_linear(gen, d_inner, dt_rank + 2 * d_state, dtype,
                              axes=("inner", None)),
        "dt_proj": init_linear(gen, dt_rank, d_inner, dtype, use_bias=True,
                               axes=(None, "inner")),
        "out_proj": init_linear(gen, d_inner, cfg.d_model, dtype,
                                axes=("inner", "embed")),
        # S4D-real initialisation of A (negative log-spaced), f32: the
        # reference casts it to f32 at use
        "A_log": note_axes(torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=dev)).expand(
                d_inner, d_state).contiguous(), ("inner", "state")),
        "D": ones_init((d_inner,), dev, dtype, axes=("inner",)),
    }


def _ssm_params(params, u, cfg):
    """u: (B, T, d_inner) -> (dt, B_mat, C_mat) data-dependent params."""
    _, d_state, _, dt_rank = _dims(cfg)
    xdbc = linear(params["x_proj"], u)
    dt = xdbc[..., :dt_rank]
    Bm = xdbc[..., dt_rank:dt_rank + d_state]
    Cm = xdbc[..., dt_rank + d_state:]
    dt = softplus(linear(params["dt_proj"], dt))            # (B,T,d_inner)
    return dt, Bm, Cm


def _conv_full(params, x, cfg):
    """Causal depthwise conv over time. x: (B, T, d_inner)."""
    _, _, d_conv, _ = _dims(cfg)
    w = params["conv_w"].to(x.dtype)                        # (K, d_inner)
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(d_conv))
    return out + params["conv_b"].to(x.dtype)


def _readout(h, C, per_row: bool):
    """``einsum("bds,bs->bd", h, C)``, per row when asked."""
    if per_row:
        return rowwise(lambda a, b: torch.einsum("bds,bs->bd", a, b), h, C)
    return torch.einsum("bds,bs->bd", h, C)


def mamba(params, x, cfg, *, make_cache: bool = False):
    """Full-sequence Mamba block. x: (B, T, d_model)."""
    d_inner, d_state, d_conv, _ = _dims(cfg)
    B_, T, _ = x.shape
    xz = linear(params["in_proj"], x)
    pre, z = xz.chunk(2, dim=-1)
    u = _silu(_conv_full(params, pre, cfg))
    u = shard_act(u, ("batch", None, "inner"))

    dt, Bm, Cm = _ssm_params(params, u, cfg)
    A = -torch.exp(params["A_log"].float())                 # (d_inner, d_state)
    dA = torch.exp(dt.float()[..., None] * A)               # (B,T,di,ds)
    dBu = (dt * u).float()[..., None] * Bm.float()[..., None, :]
    Cf = Cm.float()

    h = torch.zeros((B_, d_inner, d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(T):
        h = dA[:, t] * h + dBu[:, t]                        # (B,di,ds)
        ys.append(_readout(h, Cf[:, t], False))
    del dA, dBu
    y = torch.stack(ys, dim=1).to(x.dtype)                  # (B,T,di)
    y = y + u * params["D"].to(x.dtype)
    y = y * _silu(z)
    out = linear(params["out_proj"], y)
    cache = None
    if make_cache:
        # conv state: last (d_conv-1) inputs of the *pre-conv* stream
        conv_state = pre[:, -(d_conv - 1):] if T >= d_conv - 1 else F.pad(
            pre, (0, 0, d_conv - 1 - T, 0))
        cache = {"conv": conv_state.contiguous(), "h": h}
    return out, cache


def init_mamba_cache(cfg, batch: int, device, dtype=torch.bfloat16):
    d_inner, d_state, d_conv, _ = _dims(cfg)
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                             device=device)}


def mamba_decode(params, x, cfg, cache, *, per_row: bool = False):
    """Single-token recurrent update. x: (B, 1, d_model).  The new state
    is written into ``cache`` in place; returns (y, cache)."""
    xz = linear(params["in_proj"], x)
    u, z = xz.chunk(2, dim=-1)                              # (B,1,di)
    window = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
    u_c = _silu(conv_step(window, params["conv_w"],
                          params["conv_b"])[:, None])
    dt, Bm, Cm = _ssm_params(params, u_c, cfg)
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt.float()[..., None] * A)[:, 0]
    dBu = ((dt * u_c).float()[..., None]
           * Bm.float()[..., None, :])[:, 0]
    h = dA * cache["h"] + dBu
    y = _readout(h, Cm[:, 0].float(), per_row)[:, None]
    y = y.to(x.dtype) + u_c * params["D"].to(x.dtype)
    y = y * _silu(z)
    out = linear(params["out_proj"], y)
    return out, copy_state(cache, {"conv": window[:, 1:], "h": h})
