"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM prefill uses the *chunkwise-parallel* form — O(T·C) memory
instead of O(T^2) — with log-space gate stabilisation; decode is the
O(1) recurrent update.  ``mlstm_recurrent`` is also the step-by-step
oracle of the tests.  sLSTM is sequential (recurrent gate connections).
The reference's ``lax.scan`` loops are Python loops here; the math, its
types and its stabilisers (``NEG``, ``max(|den|, exp(-m))``) are the
reference's.  The reference computes every step in plain ``jnp``, with
no Pallas kernel, so the products stay einsums (cuBLAS on the GPU).

A decode step updates its cache in place (``copy_``) and returns it.
With ``per_row`` (a step at a (B,) position tensor: the continuous
engine's slots) the batched products of the recurrence and the mLSTM
gates' projections run as one-row calls, so that each row computes the
bits it computes alone: cuBLAS picks its kernel from the batch count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ACTS, _mean_last, conv_step,
                                       copy_state, init_linear, linear,
                                       log_sigmoid, rowwise)
from repro_torch.models.param import dense_init, ones_init, zeros_init
from repro_torch.parallel.sharding import shard_act

NEG = -1e30
_silu = ACTS["silu"]


def _mdims(cfg):
    d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
    nh = cfg.n_heads
    dh = d_inner // nh
    return d_inner, nh, dh


def _weak(scale: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scale as JAX weak-types it: rounded to ``like``'s type
    (a bf16 ``q * scale`` multiplies by bf16(scale))."""
    return torch.tensor(scale, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------
def mlstm_chunkwise(q, k, v, li, lf, chunk: int):
    """q,k,v: (B,T,nh,dh);  li/lf: (B,T,nh) log input/forget gates.
    Returns h: (B,T,nh,dh) and final (C, n, m) state."""
    B, T, nh, dh = q.shape
    assert T % chunk == 0, (T, chunk)
    nc = T // chunk
    scale = dh ** -0.5
    f32 = torch.float32

    def resh(x):
        return x.reshape(B, nc, chunk, *x.shape[2:])

    qs, ks, vs = resh(q * _weak(scale, q)), resh(k), resh(v)
    lis, lfs = resh(li.float()), resh(lf.float())

    C_st = torch.zeros((B, nh, dh, dh), dtype=f32, device=q.device)
    n_st = torch.zeros((B, nh, dh), dtype=f32, device=q.device)
    m_st = torch.full((B, nh), NEG, dtype=f32, device=q.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    hs = []
    for c in range(nc):
        qc, kc, vc = qs[:, c].float(), ks[:, c].float(), vs[:, c].float()
        lic, lfc = lis[:, c], lfs[:, c]                     # (B,C,nh)
        b = torch.cumsum(lfc, dim=1)
        # intra-chunk log weights D[t,s] = b_t - b_s + li_s   (s <= t)
        D = b[:, :, None] - b[:, None, :] + lic[:, None, :]  # (B,t,s,nh)
        D = torch.where(tri[None, :, :, None], D, NEG)
        m_intra = D.amax(dim=2)                             # (B,t,nh)
        m_inter = b + m_st[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        S = torch.exp(D - m_t[:, :, None])
        qk = torch.einsum("bthd,bshd->btsh", qc, kc)
        W = S * qk
        num_intra = torch.einsum("btsh,bshd->bthd", W, vc)
        den_intra = W.sum(dim=2)
        c_inter = torch.exp(m_inter - m_t)
        num_inter = torch.einsum("bthd,bhde->bthe", qc,
                                 C_st) * c_inter[..., None]
        den_inter = torch.einsum("bthd,bhd->bth", qc, n_st) * c_inter
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])

        # ---- state update to end of chunk ----
        G = b[:, -1]                                        # (B,nh)
        a_log = G[:, None] - b + lic                        # (B,s,nh)
        m_new = torch.maximum(G + m_st, a_log.amax(dim=1))
        a = torch.exp(a_log - m_new[:, None])
        decay = torch.exp(G + m_st - m_new)
        ka = kc * a[..., None]
        C_st = (decay[:, :, None, None] * C_st
                + torch.einsum("bshd,bshe->bhde", ka, vc))
        n_st = decay[:, :, None] * n_st + ka.sum(dim=1)
        m_st = m_new
    h = torch.stack(hs, dim=1).reshape(B, T, nh, dh)
    return h.to(q.dtype), (C_st, n_st, m_st)


def mlstm_recurrent(q, k, v, li, lf, state=None, *, per_row: bool = False):
    """Step-by-step oracle / decode. Shapes as above (any T).  Returns
    h (B,T,nh,dh) and new (C, n, m) tensors (``state`` is not
    written)."""
    B, T, nh, dh = q.shape
    scale = dh ** -0.5
    f32 = torch.float32
    if state is None:
        state = (torch.zeros((B, nh, dh, dh), dtype=f32, device=q.device),
                 torch.zeros((B, nh, dh), dtype=f32, device=q.device),
                 torch.full((B, nh), NEG, dtype=f32, device=q.device))
    C, n, m = state
    li, lf = li.float(), lf.float()
    hs = []
    for t in range(T):
        kt, vt = k[:, t].float(), v[:, t].float()           # (B,nh,dh)
        lit, lft = li[:, t], lf[:, t]                       # (B,nh)
        m_new = torch.maximum(lft + m, lit)
        f_ = torch.exp(lft + m - m_new)[..., None]
        i_ = torch.exp(lit - m_new)[..., None]
        C = f_[..., None] * C + i_[..., None] * (kt[..., :, None]
                                                 * vt[..., None, :])
        n = f_ * n + i_ * kt
        qf = q[:, t].float() * scale
        if per_row:
            num = rowwise(lambda a, b: torch.einsum("bhd,bhde->bhe", a, b),
                          qf, C)
            den = rowwise(lambda a, b: torch.einsum("bhd,bhd->bh", a, b),
                          qf, n)
        else:
            num = torch.einsum("bhd,bhde->bhe", qf, C)
            den = torch.einsum("bhd,bhd->bh", qf, n)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------
def init_mlstm_block(gen, cfg, dtype):
    d_inner, nh, dh = _mdims(cfg)
    conv_w = cfg.xlstm.conv_width
    d = cfg.d_model
    return {
        "up": init_linear(gen, d, 2 * d_inner, dtype,
                          axes=("embed", "inner")),
        "conv_w": dense_init(gen, (conv_w, d_inner), dtype, fan_in=conv_w,
                             axes=("conv", "inner")),
        "conv_b": zeros_init((d_inner,), gen.device, dtype,
                             axes=("inner",)),
        "wq": init_linear(gen, d_inner, d_inner, dtype,
                          axes=("inner", None)),
        "wk": init_linear(gen, d_inner, d_inner, dtype,
                          axes=("inner", None)),
        "wv": init_linear(gen, d_inner, d_inner, dtype,
                          axes=("inner", None)),
        "wi": init_linear(gen, d, nh, dtype, use_bias=True,
                          axes=("embed", None)),
        "wf": init_linear(gen, d, nh, dtype, use_bias=True,
                          axes=("embed", None)),
        "gn_scale": ones_init((d_inner,), gen.device, axes=("inner",)),
        "down": init_linear(gen, d_inner, d, dtype, axes=("inner", "embed")),
    }


def _causal_conv(x, w, b):
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    w = w.to(x.dtype)
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return out + b.to(x.dtype)


def _group_norm(h, scale, nh, eps=1e-6):
    """Per-head group norm. h: (B,T,nh,dh) -> (B,T,nh*dh).  The means
    sum in ``_mean_last``'s two fixed stages: a row's bits do not depend
    on the batch's row count."""
    B, T, _, dh = h.shape
    hf = h.float()
    mu = _mean_last(hf)
    var = _mean_last(torch.square(hf - mu))
    hn = (hf - mu) * torch.rsqrt(var + eps)
    return (hn.reshape(B, T, -1) * scale.float()).to(h.dtype)


def mlstm_block(params, x, cfg, *, make_cache: bool = False,
                decode_state=None, per_row: bool = False):
    """x: (B,T,d). If ``decode_state`` is given, runs the recurrent path
    and writes the new state into it in place."""
    d_inner, nh, dh = _mdims(cfg)
    B, T, _ = x.shape
    xz = linear(params["up"], x)
    xm, z = xz.chunk(2, dim=-1)
    decode = decode_state is not None
    if decode:
        window = torch.cat([decode_state["conv"].to(xm.dtype), xm], 1)
        xc = conv_step(window, params["conv_w"], params["conv_b"])[:, None]
        xc = _silu(xc)
    else:
        xc = _silu(_causal_conv(xm, params["conv_w"], params["conv_b"]))
        xc = shard_act(xc, ("batch", None, "inner"))
    q = linear(params["wq"], xc).reshape(B, T, nh, dh)
    k = linear(params["wk"], xc).reshape(B, T, nh, dh)
    v = linear(params["wv"], xm).reshape(B, T, nh, dh)
    # the gates' projections to nh outputs: at M = 4 rows cuBLAS picks
    # another kernel than for one row, whose sums round otherwise now
    # and then, so the slots' gates are one-row calls
    gate = ((lambda p, a: rowwise(lambda r: linear(p, r), a)) if per_row
            else linear)
    li = gate(params["wi"], x)                              # (B,T,nh) raw
    lf = log_sigmoid(gate(params["wf"], x).float())
    if decode:
        h, state = mlstm_recurrent(q, k, v, li, lf, decode_state["state"],
                                   per_row=per_row)
        new_state = copy_state(decode_state,
                                {"conv": window[:, 1:], "state": state})
    else:
        h, state = mlstm_chunkwise(q, k, v, li, lf,
                                   min(cfg.xlstm.chunk_size, T))
        new_state = None
        if make_cache:
            K = params["conv_w"].shape[0]
            conv = xm[:, -(K - 1):] if T >= K - 1 else F.pad(
                xm, (0, 0, K - 1 - T, 0))
            new_state = {"conv": conv.contiguous(), "state": state}
    hn = _group_norm(h, params["gn_scale"], nh)
    out = linear(params["down"], hn * _silu(z))
    return out, new_state


def init_mlstm_cache(cfg, batch: int, device, dtype=torch.bfloat16):
    d_inner, nh, dh = _mdims(cfg)
    K = cfg.xlstm.conv_width
    f32 = torch.float32
    return {"conv": torch.zeros((batch, K - 1, d_inner), dtype=dtype,
                                device=device),
            "state": (torch.zeros((batch, nh, dh, dh), dtype=f32,
                                  device=device),
                      torch.zeros((batch, nh, dh), dtype=f32, device=device),
                      torch.full((batch, nh), NEG, dtype=f32,
                                 device=device))}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, recurrent gates)
# ---------------------------------------------------------------------------
def init_slstm_block(gen, cfg, dtype):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    d = cfg.d_model
    return {
        # 4 gates (i, f, z, o), input part
        "wx": init_linear(gen, d, 4 * d, dtype, use_bias=True,
                          axes=("embed", "inner")),
        # recurrent part: block-diagonal per head, f32 (cast to f32 at use)
        "r": dense_init(gen, (nh, dh, 4 * dh), torch.float32, fan_in=dh,
                        axes=(None, None, None)),
        "gn_scale": ones_init((d,), gen.device, axes=("embed",)),
        "out": init_linear(gen, d, d, dtype, axes=("embed", "embed2")),
    }


def slstm_block(params, x, cfg, state=None, *, per_row: bool = False):
    """x: (B,T,d). Sequential over T (recurrent gate connections).
    Returns (y, (c, n, h, m)); a given ``state`` is written in place."""
    B, T, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    gx = linear(params["wx"], x).reshape(B, T, nh, 4 * dh)
    r = params["r"].float()
    if state is None:
        zero = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        carry = (zero, zero, zero,
                 torch.full((B, nh, dh), NEG, dtype=torch.float32,
                            device=x.device))
    else:
        carry = state
    c, n, h, m = carry
    hs = []
    for t in range(T):
        if per_row:
            rec = rowwise(lambda a: torch.einsum("bhd,hde->bhe", a, r), h)
        else:
            rec = torch.einsum("bhd,hde->bhe", h, r)        # (B,nh,4dh)
        g = gx[:, t].float() + rec
        gi, gf, gz, go = g.chunk(4, dim=-1)
        lsf = log_sigmoid(gf)
        m_new = torch.maximum(lsf + m, gi)
        i_ = torch.exp(gi - m_new)
        f_ = torch.exp(lsf + m - m_new)
        c = f_ * c + i_ * torch.tanh(gz)
        n = f_ * n + i_
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    new = (c, n, h, m)
    if state is not None:
        new = copy_state(state, new)
    hseq = torch.stack(hs, dim=1).reshape(B, T, nh, dh)
    hn = _group_norm(hseq, params["gn_scale"], nh)
    return linear(params["out"], hn.to(x.dtype)), new


def init_slstm_cache(cfg, batch: int, device):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    f32 = torch.float32
    return tuple(torch.zeros((batch, nh, dh), dtype=f32, device=device)
                 for _ in range(3)) + (
        torch.full((batch, nh, dh), NEG, dtype=f32, device=device),)
