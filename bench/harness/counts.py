"""Operations of the served models, from the configuration file's widths
(never from the program): a prompt's prefill FLOPs."""
from __future__ import annotations


def _mla_params(c: dict) -> int:
    """Matmul parameters of one MLA layer."""
    D, H = int(c["hidden_size"]), int(c["num_attention_heads"])
    dn, dr = int(c["qk_nope_head_dim"]), int(c["qk_rope_head_dim"])
    dv, kvl = int(c["v_head_dim"]), int(c["kv_lora_rank"])
    ql = c.get("q_lora_rank") or 0
    q = D * ql + ql * H * (dn + dr) if ql else D * H * (dn + dr)
    return q + D * (kvl + dr) + kvl * H * (dn + dv) + H * dv * D


def active_params(c: dict) -> int:
    """Matmul parameters one token passes through: attention, the dense
    or active expert FFNs (and the router), and the output head."""
    D, L = int(c["hidden_size"]), int(c["num_hidden_layers"])
    dense_ffn = 3 * D * int(c["intermediate_size"])
    if "n_routed_experts" in c:
        n_dense = int(c.get("first_k_dense_replace", 0))
        F, E = int(c["moe_intermediate_size"]), int(c["n_routed_experts"])
        k, s = int(c["num_experts_per_tok"]), int(c.get("n_shared_experts", 0))
        moe_ffn = D * E + 3 * D * F * (k + s)
        ffn = n_dense * dense_ffn + (L - n_dense) * moe_ffn
    else:
        ffn = L * dense_ffn
    return L * _mla_params(c) + ffn + D * int(c["vocab_size"])


def attention_flops(c: dict, T: int) -> float:
    """Causal attention's score and value products over T tokens: T^2/2
    query-key pairs a head, each 2 * (dn + dr) + 2 * dv FLOPs."""
    H, L = int(c["num_attention_heads"]), int(c["num_hidden_layers"])
    dqk = int(c["qk_nope_head_dim"]) + int(c["qk_rope_head_dim"])
    return L * H * (T * T / 2) * 2 * (dqk + int(c["v_head_dim"]))


def prefill_flops(c: dict, T: int) -> float:
    """One prompt's prefill: 2 x active matmul parameters x tokens (the
    output head over every position, as the program computes it) plus
    causal attention."""
    return 2.0 * active_params(c) * T + attention_flops(c, T)
