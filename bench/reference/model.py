"""Plain float32 reference of the served decoder-only models.

Multi-head latent attention (DeepSeek-V2, MiniCPM3; the query either a
full-rank projection or a low-rank one with its RMS norm), the top-k
mixture of experts with shared experts (DeepSeek-V2), the dense gated
FFN, RMS norms and rotary embeddings, written from the published
equations in plain ``torch`` operations, one layer at a time over the
whole sequence, with no cache and no kernels.  The weights arrive as
plain tensors (any type) and are cast to float32 one layer at a time,
so the reference fits beside the served weights.  TF32 is switched off
(``exact_matmuls``).

Read from the configuration file (the published ``config.json``'s
names), with these departures, each listed in that file:

- RoPE rotates the two halves of the rope dims (the published
  DeepSeek-V2 code rotates interleaved pairs: the same map under a
  fixed permutation of the rope columns of the projections).
- MiniCPM's ``scale_emb``, ``scale_depth`` and ``dim_model_base`` are
  applied only where the file gives them (it gives null for each).
- The routed gates are renormalised to sum to 1 where
  ``norm_topk_prob`` is true.  Every token reaches its experts: no
  capacity, no dropped assignment (the published MoE).
- A ``rope_scaling`` (YaRN, LongRoPE) is not implemented: a file that
  states one is refused.

``mm`` (default ``a @ b``) is every linear layer's product: the control
of the correctness check passes one that rounds both operands to fp8.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact_matmuls() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, positions, theta: float):
    """x: (B, T, H, d); the two halves of d rotated by position."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[:, None] * inv[None, :]          # (T, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """``conf``: the configuration file (published names).  ``weights``:
    {"embed" (V, D), "unembed" (D, V) or None (tied), "final_norm" (D,),
    "layers": [per-layer dicts]}; a layer holds "attn_norm", "wq" or
    ("wq_a", "q_norm", "wq_b"), "wkv_a", "kv_norm", "wkv_b", "wo",
    "ffn_norm" and either "mlp" {"up", "gate", "down"} or "moe"
    {"router", "w_up", "w_gate", "w_down", "s_up", "s_gate", "s_down"}.
    Every matrix maps rows: ``y = x @ W``."""

    def __init__(self, conf: dict, weights: dict,
                 mm: Optional[MatMul] = None):
        self.c = conf
        self.w = weights
        self.mm = mm or _mm
        self.eps = float(conf["rms_norm_eps"])
        self.theta = float(conf.get("rope_theta", 10000.0))
        self.H = int(conf["num_attention_heads"])
        self.dn = int(conf["qk_nope_head_dim"])
        self.dr = int(conf["qk_rope_head_dim"])
        self.dv = int(conf["v_head_dim"])
        self.kvl = int(conf["kv_lora_rank"])
        self.n_layers = int(conf["num_hidden_layers"])
        if conf.get("rope_scaling") is not None:
            raise NotImplementedError(
                f"the reference has no rope scaling: {conf['rope_scaling']}")

    # -- layers ------------------------------------------------------
    def attention(self, x, lw, positions):
        """Expanded MLA over the whole causal sequence: (B, T, D)."""
        B, T, _ = x.shape
        H, dn, dr, dv, kvl = self.H, self.dn, self.dr, self.dv, self.kvl
        mm = self.mm
        if "wq" in lw:
            q = mm(x, lw["wq"])
        else:
            q = mm(rms_norm(mm(x, lw["wq_a"]), lw["q_norm"], self.eps),
                   lw["wq_b"])
        q = q.view(B, T, H, dn + dr)
        q_nope, q_pe = q[..., :dn], rope(q[..., dn:], positions, self.theta)
        kv = mm(x, lw["wkv_a"])
        c_kv = rms_norm(kv[..., :kvl], lw["kv_norm"], self.eps)
        k_pe = rope(kv[..., kvl:][:, :, None, :], positions, self.theta)
        kvb = mm(c_kv, lw["wkv_b"]).view(B, T, H, dn + dv)
        k_nope, v = kvb[..., :dn], kvb[..., dn:]
        scale = 1.0 / math.sqrt(dn + dr)
        mask = torch.ones(T, T, dtype=torch.bool,
                          device=x.device).tril()
        outs = []
        for b in range(B):        # one sequence's (H, T, T) scores at a time
            s = (torch.einsum("thd,shd->hts", q_nope[b], k_nope[b])
                 + torch.einsum("thd,sd->hts", q_pe[b], k_pe[b, :, 0])
                 ) * scale
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            outs.append(torch.einsum("hts,shd->thd", p, v[b]))
        o = torch.stack(outs).reshape(B, T, H * dv)
        return mm(o, lw["wo"])

    def mlp(self, x, w):
        return self.mm(silu(self.mm(x, w["gate"])) * self.mm(x, w["up"]),
                       w["down"])

    def moe(self, x, w):
        c = self.c
        E, k = int(c["n_routed_experts"]), int(c["num_experts_per_tok"])
        B, T, D = x.shape
        probs = torch.softmax(self.mm(x, w["router"]), dim=-1)
        gates, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        gates, experts = gates[..., :k], experts[..., :k]
        if c.get("norm_topk_prob"):
            gates = gates / gates.sum(-1, keepdim=True)
        gates = gates * float(c.get("routed_scaling_factor", 1.0))
        flat = x.reshape(B * T, D)
        y = torch.zeros_like(flat)
        ex, gt = experts.reshape(B * T, k), gates.reshape(B * T, k)
        for e in range(E):
            rows, slot = torch.nonzero(ex == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = flat[rows]
            h = silu(self.mm(xe, w["w_gate"][e])) * self.mm(xe, w["w_up"][e])
            y.index_add_(0, rows, self.mm(h, w["w_down"][e])
                         * gt[rows, slot][:, None])
        if "s_up" in w:
            y = y + self.mlp(flat, {"up": w["s_up"], "gate": w["s_gate"],
                                    "down": w["s_down"]})
        return y.view(B, T, D)

    # -- model -------------------------------------------------------
    def logits(self, tokens: torch.Tensor,
               score_at: List[int]) -> torch.Tensor:
        """Float32 logits (B, len(score_at), V) of ``tokens`` (B, L) at
        positions ``score_at``."""
        c, w = self.c, self.w
        dev = w["embed"].device
        tokens = tokens.to(dev)
        L = tokens.shape[1]
        positions = torch.arange(L, device=dev)
        h = w["embed"][tokens].float()
        if c.get("scale_emb") is not None:
            h = h * float(c["scale_emb"])
        depth = (float(c["scale_depth"]) / math.sqrt(self.n_layers)
                 if c.get("scale_depth") is not None else 1.0)
        for layer in w["layers"]:
            lw = _f32(layer)
            a = self.attention(rms_norm(h, lw["attn_norm"], self.eps), lw,
                               positions)
            h = h + depth * a
            z = rms_norm(h, lw["ffn_norm"], self.eps)
            f = (self.moe(z, lw["moe"]) if "moe" in lw
                 else self.mlp(z, lw["mlp"]))
            h = h + depth * f
            del lw
        z = rms_norm(h[:, score_at], w["final_norm"].float(), self.eps)
        if c.get("dim_model_base") is not None:
            z = z / (int(c["hidden_size"]) / float(c["dim_model_base"]))
        head = (w["unembed"] if w.get("unembed") is not None
                else w["embed"].T)
        return self.mm(z, head.float())


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product with both operands rounded to fp8 (e4m3): the
    activations scaled per row, the weight per column, each to e4m3's
    largest value, products summed in float32.  The precision below the
    served bfloat16: the correctness check's control."""
    return _fp8(a, -1) @ _fp8(b, -2)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    top = torch.finfo(torch.float8_e4m3fn).max
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / top
    return (t / s).to(torch.float8_e4m3fn).float() * s


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each token's logit lies:
    (..., V) logits, (...) tokens -> (...) gaps, 0 where the token is
    the reference's own argmax."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens[..., None].to(ref_logits.device))
    return best - got[..., 0]
