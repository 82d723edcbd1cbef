"""Architecture configuration schema.

Every assigned architecture is expressed as an ``ArchConfig``.  The model
zoo (``repro_torch.models.model_zoo``) consumes this to build a parameter
tree and apply function.  Pure data, copied from the JAX package's
``configs/base.py`` so that the port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0                # routed experts
    n_shared: int = 0                # always-on shared experts
    top_k: int = 0
    d_ff: int = 0                    # per-expert FFN width
    n_dense_layers: int = 0          # first k layers use dense FFN
    every: int = 1                   # MoE every `every` layers (jamba: 2)
    capacity_factor: float = 1.25
    # Paper §4.3 adaptation: overflow tokens from the dense (capacity)
    # path are re-dispatched through an extra small grouped-matmul pass
    # (the "sparse tail"), instead of being dropped.
    overflow_passes: int = 1
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    # dispatch implementation: "sort" (argsort-based, baseline) or
    # "onehot" (sort-free cumsum positions — §Perf optimization)
    dispatch: str = "sort"
    # explicitly constrain dispatch buffers to (batch, expert) sharding
    # (§Perf optimization: stops XLA from resharding through permutes)
    shard_dispatch: bool = False
    # expert-weight sharding (§Perf): "ep" shards the expert axis over
    # the model mesh axis (baseline; dispatch scatter/gather cross-shard)
    # or "tp" shards the per-expert FFN dim instead (expert slicing:
    # dispatch is local, combine is one activation-sized all-reduce)
    shard_mode: str = "ep"


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 => direct full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8             # one sLSTM block per `slstm_every` layers
    proj_factor: float = 2.0         # mLSTM up-projection factor
    conv_width: int = 4
    chunk_size: int = 256            # chunkwise-parallel mLSTM chunk


@dataclass(frozen=True)
class ParallelConfig:
    """Per-arch distribution hints (consumed by parallel.sharding)."""
    fsdp: bool = False               # shard params over data axis too (giant archs)
    # "tp" (default): megatron tensor-parallel over the model axis.
    # "fsdp" (§Perf): pure ZeRO-3 — params sharded over (data, model) on
    # the embed axis, batch over every axis, no activation all-reduces.
    layout: str = "tp"
    remat: str = "dots"              # none | dots | full
    scan_layers: bool = True
    # gradient all-reduce dtype ("bf16" halves the collective term)
    grad_reduce_dtype: str = "bf16"
    # shard KV-cache sequence dim over the model axis (flash-decode style);
    # beyond-paper perf option, see EXPERIMENTS.md §Perf.
    seq_shard_kv: bool = False
    # Megatron-SP style: shard the residual stream's sequence dim over
    # the model axis between layers (§Perf: 16x smaller boundary
    # activations -> pinning them beats recomputing TP collectives)
    seq_parallel: bool = False


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla
    sliding_window: int = 0          # 0 => full attention
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0

    # --- block layout ---
    block_pattern: str = "attn"      # attn | xlstm | jamba
    attn_every: int = 0              # jamba: one attn layer per `attn_every`
    attn_offset: int = 0             # position of the attn layer in the block

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # --- modality frontend (STUB: input_specs provides embeddings) ---
    frontend: str = "none"           # none | audio_stub | vq_stub

    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "silu"
    mlp_gated: bool = True
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    max_seq_len: int = 131072

    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    # Whether decode-style shapes apply (encoder-only archs: False).
    supports_decode: bool = True
    # Whether long_500k applies (sub-quadratic / bounded-KV archs only).
    supports_long_context: bool = False

    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4 if self.block_pattern != "jamba" else 8),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            max_seq_len=1024,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            parallel=dataclasses.replace(self.parallel, fsdp=False, remat="none"),
        )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32,
                q_lora_rank=(48 if self.mla.q_lora_rank else 0),
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed=8, n_shared=min(self.moe.n_shared, 1),
                top_k=2, d_ff=64,
                n_dense_layers=min(self.moe.n_dense_layers, 1))
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2, chunk_size=32)
        if self.is_encoder_decoder:
            kw["n_enc_layers"] = 2
        return self.replace(**kw)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_applicable(arch: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether a shape cell applies to an arch (per assignment rules)."""
    if cell.kind == "decode" and not arch.supports_decode:
        return False, "encoder-only: no decode step"
    if cell.name == "long_500k" and not arch.supports_long_context:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention")
    return True, ""
