"""Core layers: norms, linear, MLP/GLU, embeddings, RoPE.

Each function computes what its counterpart in the reference's
``models/layers.py`` computes, in the same types: norms in f32 with an
f32 scale (the mean summed in two fixed stages, the same bits for a
row in a batch of any size), matmul weights cast to the
activations' type at use, the
embedding gathered in bf16, RoPE in f32 on split halves.  The
reference's ``shard_act`` annotations are kept at the same sites with
the same logical axes (``parallel.sharding``): a no-op without a mesh
and for this rank's plain tensors, a redistribution for a DTensor.
Every initialiser takes the leaf's logical axes (``models.param``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.param import (dense_init, embed_init, ones_init,
                                      zeros_init)
from repro_torch.parallel.sharding import shard_act

def _silu(x):
    # jax.nn.silu's formula, one rounding per op in the input's type
    # (as XLA rounds a bf16 elementwise chain); F.silu rounds once and
    # differs from the reference by an ulp in about a third of bf16 inputs
    return x * (1.0 / (1.0 + torch.exp(-x)))


def softplus(x):
    """jax.nn.softplus's formula (``jnp.logaddexp(x, 0)``), one rounding
    per op in the input's type; F.softplus is linear past a threshold
    and rounds once."""
    out = torch.maximum(x, torch.zeros_like(x)) + torch.log1p(
        torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def log_sigmoid(x):
    """jax.nn.log_sigmoid: ``-softplus(-x)``."""
    return -softplus(-x)


def softmax(x, dim: int = -1):
    """jax.nn.softmax's formula: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


ACTS = {
    "silu": _silu,
    # jax.nn.gelu is the tanh approximation unless told otherwise
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(cfg, device, dim: int = 0):
    d = dim or cfg.d_model
    p = {"scale": ones_init((d,), device, axes=(None,))}
    if cfg.norm_type == "layernorm":
        p["bias"] = zeros_init((d,), device, axes=(None,))
    return p


def _mean_last(x):
    """Mean over the last dim (keepdim) in two fixed stages: the sums of
    64-wide slices, then their sum (the dim zero-padded to a multiple of
    256).  A row's mean is then the same bits in a tensor of any number
    of rows.  A one-stage reduction splits a row of 768 or more across
    warps by the number of rows (on the GPU a row of a 4-row batch sums
    in another order than alone), and the continuous engine's slot step
    must give each row the bits of its solo step; in two stages every
    row's first stage has many outputs and its second few values, so
    neither stage's split depends on the row count
    (``tests/test_torch_cuda.py::test_norm_rows_bitwise_on_gpu``)."""
    n = x.shape[-1]
    m = -(-n // 256) * 256
    x = F.pad(x, (0, m - n))
    return x.view(*x.shape[:-1], m // 64, 64).sum(-1).sum(
        -1, keepdim=True) / n


def norm(params, x, cfg):
    dtype = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        x = x - _mean_last(x)
    var = _mean_last(x.square())
    x = x * torch.rsqrt(var + cfg.norm_eps)
    out = x * params["scale"].float()
    if cfg.norm_type == "layernorm":
        out = out + params["bias"].float()
    return out.to(dtype)


def rms_norm_simple(x, scale, eps: float = 1e-6):
    """Scale-only RMS norm over the last dim (for QK-norm etc.)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(_mean_last(x.square()) + eps)
    return (x * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------
def init_linear(gen, d_in: int, d_out: int, dtype, use_bias: bool = False,
                scale: float = 1.0, *, axes=(None, None)):
    p = {"w": dense_init(gen, (d_in, d_out), dtype, scale=scale, axes=axes)}
    if use_bias:
        p["b"] = zeros_init((d_out,), gen.device, dtype, axes=(axes[1],))
    return p


def linear(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg, dtype, d_ff: int = 0):
    d_ff = d_ff or cfg.d_ff
    p = {"up": init_linear(gen, cfg.d_model, d_ff, dtype, cfg.use_bias,
                           axes=("embed", "mlp")),
         "down": init_linear(gen, d_ff, cfg.d_model, dtype, cfg.use_bias,
                             axes=("mlp", "embed"))}
    if cfg.mlp_gated:
        p["gate"] = init_linear(gen, cfg.d_model, d_ff, dtype, cfg.use_bias,
                                axes=("embed", "mlp"))
    return p


def mlp(params, x, cfg):
    act = ACTS[cfg.act]
    h = linear(params["up"], x)
    if "gate" in params:
        h = h * act(linear(params["gate"], x))
    else:
        h = act(h)
    h = shard_act(h, ("batch", None, "mlp"))
    return linear(params["down"], h)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(gen, cfg, dtype):
    return {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                axes=("vocab", "embed"))}


def embed(params, token_ids, cfg):
    return params["table"].to(torch.bfloat16)[token_ids]


def init_unembed(gen, cfg, dtype):
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                            fan_in=cfg.d_model, axes=("embed", "vocab"))}


def unembed(params, x, cfg, embed_params=None):
    if cfg.tie_embeddings and embed_params is not None:
        w = embed_params["table"].to(x.dtype).T
    else:
        w = params["w"].to(x.dtype)
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_table(dim: int, max_len: int, theta: float = 10000.0,
               positions: Optional[torch.Tensor] = None, device=None):
    """sin/cos tables of shape (..., L, dim/2), f32."""
    if positions is None:
        positions = torch.arange(max_len, device=device)
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., L, H, dh); sin/cos: (L, dh/2) or broadcastable."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if sin.dim() == 2:  # (L, dh/2) -> broadcast over batch and heads
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Checkpoint names (the reference's ``checkpoint_name``)
# ---------------------------------------------------------------------------
class _Name(threading.local):
    name: Optional[str] = None


_NAME = _Name()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the tensors computed in the block (the reference names one
    tensor with ``jax.ad_checkpoint.checkpoint_name``).  A named remat
    policy (``blocks._remat_wrap``) sees every op dispatched inside the
    block under this name, saves its outputs in the forward and never
    re-runs it in the backward's recompute; without such a policy the
    name does nothing."""
    old, _NAME.name = _NAME.name, name
    try:
        yield
    finally:
        _NAME.name = old


def current_checkpoint_name() -> Optional[str]:
    return _NAME.name


# ---------------------------------------------------------------------------
# Recurrent-layer helpers (xLSTM, mamba)
# ---------------------------------------------------------------------------
def rowwise(fn, *xs):
    """``fn`` over the one-row slices of ``xs`` (batch axis 0), the
    results concatenated: each row's product is the call it makes in a
    batch of one."""
    return torch.cat([fn(*(x[b:b + 1] for x in xs))
                      for b in range(xs[0].shape[0])])


def conv_step(window, w, b):
    """The decode step's causal conv, ``einsum("bkd,kd->bd", window, w)``
    + b, as a dot rounds it: f32 products, f32 sums over the K taps,
    one rounding.  Elementwise, so a row's taps sum alone."""
    y = (window.float() * w.float()).sum(dim=1).to(window.dtype)
    return y + b.to(window.dtype)


def copy_state(cache, new):
    """Write ``new`` (a tree like ``cache``) into ``cache``'s tensors."""
    if isinstance(cache, dict):
        for k in cache:
            copy_state(cache[k], new[k])
    elif isinstance(cache, (list, tuple)):
        for c, n in zip(cache, new):
            copy_state(c, n)
    else:
        cache.copy_(new)
    return cache
