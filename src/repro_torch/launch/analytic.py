"""Analytic FLOPs / HBM-bytes model per architecture x shape.

Closed forms on the config, per (arch x shape) cell, for the whole step
on all devices:

  * ``hlo_flops``   — engineering FLOPs (exact closed forms per block,
                      every loop's trip count included; a compiled or
                      traced step's counted FLOPs are held to it);
  * ``model_flops`` — the assignment's MODEL_FLOPS: 6*N*D (dense) or
                      6*N_active*D (MoE), 2*N*D when not training;
  * ``hbm_bytes``   — HBM traffic: weights, activations, caches and
                      optimizer state per step.

Copied from the reference; N is the port's ``model_zoo.count_params``
(the same count as the reference's) and the layer layout
``blocks.group_layout``.
"""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import blocks, model_zoo


@functools.lru_cache(maxsize=None)
def _count_params(cfg: ArchConfig) -> int:
    return model_zoo.count_params(cfg)


def _attn_flops(cfg: ArchConfig, T: int, kv_len: int, fwd_only: bool
                ) -> float:
    """Per-layer attention flops for T query tokens against kv_len keys."""
    d = cfg.d_model
    dh = cfg.head_dim_()
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    if cfg.attn_type == "mla":
        m = cfg.mla
        dn, dr, dv, kvl = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                           m.v_head_dim, m.kv_lora_rank)
        proj = 2 * T * (
            (m.q_lora_rank and d * m.q_lora_rank
             + m.q_lora_rank * H * (dn + dr)) or d * H * (dn + dr)
        ) + 2 * T * d * (kvl + dr) + 2 * T * kvl * H * (dn + dv) \
            + 2 * T * H * dv * d
        attn = 2 * T * kv_len * H * (dn + dr) + 2 * T * kv_len * H * dv
    else:
        proj = 2 * T * d * (H * dh + 2 * Kv * dh + H * dh)
        win = min(kv_len, cfg.sliding_window) if cfg.sliding_window \
            else kv_len
        attn = 2 * T * win * H * dh * 2
    mult = 1 if fwd_only else 3
    return (proj + attn) * mult


def _mlp_flops(cfg, T, d_ff, fwd_only):
    n_mats = 3 if cfg.mlp_gated else 2
    return 2 * T * cfg.d_model * d_ff * n_mats * (1 if fwd_only else 3)


def _moe_flops(cfg, T, fwd_only):
    m = cfg.moe
    # dense path processes capacity_factor * k assignments per token +
    # the overflow tail pass (C/4); router + shared experts extra
    eff_k = m.top_k * (m.capacity_factor + 0.25) / 1.0
    routed = 2 * T * eff_k * cfg.d_model * m.d_ff * 3
    shared = 2 * T * cfg.d_model * (m.n_shared * m.d_ff) * 3
    router = 2 * T * cfg.d_model * m.n_routed
    return (routed + shared + router) * (1 if fwd_only else 3)


def _mamba_flops(cfg, T, fwd_only):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    ds = cfg.ssm.d_state
    dtr = max(1, -(-d // 16))
    proj = 2 * T * d * 2 * di + 2 * T * di * (dtr + 2 * ds) \
        + 2 * T * dtr * di + 2 * T * di * d
    scan = T * di * ds * 6                      # per-step elementwise+dots
    conv = 2 * T * di * cfg.ssm.d_conv
    return (proj + scan + conv) * (1 if fwd_only else 3)


def _mlstm_flops(cfg, T, fwd_only):
    d = cfg.d_model
    di = int(cfg.xlstm.proj_factor * d)
    nh = cfg.n_heads
    dh = di // nh
    Cn = min(cfg.xlstm.chunk_size, T)
    proj = 2 * T * d * 2 * di + 3 * 2 * T * di * di + 2 * T * di * d
    # chunkwise: intra QK^T + PV (T*C per head) + state updates
    intra = 2 * T * Cn * di * 2
    state = T * di * dh * 4
    return (proj + intra + state) * (1 if fwd_only else 3)


def _slstm_flops(cfg, T, fwd_only):
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    proj = 2 * T * d * 4 * d + 2 * T * d * d
    rec = 2 * T * nh * dh * 4 * dh
    return (proj + rec) * (1 if fwd_only else 3)


def hlo_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """Engineering-FLOPs estimate for the whole step (global, all chips)."""
    B = cell.global_batch
    fwd_only = cell.kind != "train"
    if cell.kind == "decode":
        T_q, kv = 1, cell.seq_len
    else:
        T_q = kv = cell.seq_len
    toks = B * T_q

    kinds, moe_flags, n_groups = blocks.group_layout(cfg)
    per_group = 0.0
    for kind, mf in zip(kinds, moe_flags):
        if kind in ("attn", "mla"):
            per_group += _attn_flops_tok(cfg, B, T_q, kv, fwd_only)
        elif kind == "mamba":
            per_group += _mamba_flops(cfg, toks, fwd_only)
        elif kind == "mlstm":
            per_group += _mlstm_flops(cfg, toks, fwd_only)
        elif kind == "slstm":
            per_group += _slstm_flops(cfg, toks, fwd_only)
        if mf and cfg.moe:
            per_group += _moe_flops(cfg, toks, fwd_only)
        elif cfg.d_ff:
            per_group += _mlp_flops(cfg, toks, cfg.d_ff, fwd_only)
    total = per_group * n_groups
    # dense prefix layers (MoE archs)
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    for _ in range(n_dense):
        total += _attn_flops_tok(cfg, B, T_q, kv, fwd_only)
        total += _mlp_flops(cfg, toks, cfg.d_ff, fwd_only)
    # encoder (whisper): bidirectional self-attn + mlp over T_enc
    if cfg.is_encoder_decoder:
        enc_toks = B * cell.seq_len
        enc = (_attn_flops_tok(cfg, B, cell.seq_len, cell.seq_len, True)
               + _mlp_flops(cfg, enc_toks, cfg.d_ff, True)) \
            * cfg.n_enc_layers
        # cross attention per decoder layer
        cross = (2 * toks * cfg.d_model * cfg.n_heads * cfg.head_dim_() * 2
                 + 2 * toks * cell.seq_len * cfg.n_heads * cfg.head_dim_()
                 * 2) * cfg.n_layers
        total += (enc + cross) * (1 if fwd_only else 3)
    # unembed
    total += 2 * toks * cfg.d_model * cfg.vocab_size * (1 if fwd_only else 3)
    # optimizer update ~ 10 flops/param
    if cell.kind == "train":
        total += 10 * _count_params(cfg)
    return float(total)


def _attn_flops_tok(cfg, B, T_q, kv, fwd_only):
    """Attention flops with B sequences of T_q queries x kv keys."""
    return _attn_flops(cfg, B * T_q, kv, fwd_only)


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """Assignment MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE)."""
    N = _count_params(cfg)
    if cfg.moe:
        m = cfg.moe
        kinds, moe_flags, n_groups = blocks.group_layout(cfg)
        moe_layers = sum(moe_flags) * n_groups
        expert_params = m.n_routed * 3 * cfg.d_model * m.d_ff * moe_layers
        active_expert = (m.top_k + m.n_shared) * 3 * cfg.d_model * m.d_ff \
            * moe_layers
        N = N - expert_params + active_expert
    D = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    mult = 6 if cell.kind == "train" else 2
    return float(mult * N * D)


def hbm_bytes(cfg: ArchConfig, cell: ShapeCell) -> float:
    """Analytic HBM traffic (global, all chips): weights + activations +
    caches + optimizer state, per step."""
    N = _count_params(cfg)
    B = cell.global_batch
    T = cell.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    if cell.kind == "decode":
        toks = B
        # weights once (active experts only for MoE), cache read+write
        w = 2 * N
        if cfg.moe:
            m = cfg.moe
            kinds, moe_flags, n_groups = blocks.group_layout(cfg)
            moe_layers = sum(moe_flags) * n_groups
            w = 2 * (N - m.n_routed * 3 * d * m.d_ff * moe_layers) \
                + 2 * min(m.n_routed, B * m.top_k) * 3 * d * m.d_ff \
                * moe_layers
        cache = _cache_bytes(cfg, B, T)
        act = toks * d * L * 8 * 2
        return float(w + 2 * cache + act)
    toks = B * T
    mult = 3 if cell.kind == "train" else 1
    w = 2 * N * mult                       # fwd + bwd reads + grad write
    if cell.kind == "train":
        w += 12 * N                        # adam m,v read+write fp32-ish
    act = toks * d * L * 2 * 4 * mult      # block I/O activations bf16
    return float(w + act)


def _cache_bytes(cfg: ArchConfig, B: int, T: int) -> float:
    kinds, _, n_groups = blocks.group_layout(cfg)
    per = 0.0
    for kind in kinds:
        if kind == "attn":
            win = min(T, cfg.sliding_window) if cfg.sliding_window else T
            per += B * win * cfg.n_kv_heads * cfg.head_dim_() * 2 * 2
        elif kind == "mla":
            per += B * T * (cfg.mla.kv_lora_rank
                            + cfg.mla.qk_rope_head_dim) * 2
        elif kind == "mamba":
            di = cfg.ssm.expand * cfg.d_model
            per += B * di * cfg.ssm.d_state * 4
        elif kind == "mlstm":
            di = int(cfg.xlstm.proj_factor * cfg.d_model)
            nh = cfg.n_heads
            per += B * nh * (di // nh) ** 2 * 4
        elif kind == "slstm":
            per += B * cfg.d_model * 4 * 4
    total = per * n_groups
    if cfg.moe and cfg.moe.n_dense_layers:
        win = min(T, cfg.sliding_window) if cfg.sliding_window else T
        kv = (B * win * cfg.n_kv_heads * cfg.head_dim_() * 2 * 2
              if cfg.attn_type != "mla" else
              B * T * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2)
        total += cfg.moe.n_dense_layers * kv
    if cfg.is_encoder_decoder:
        total = cfg.n_layers * (
            B * T * cfg.n_kv_heads * cfg.head_dim_() * 2 * 2 * 2)
    return total
