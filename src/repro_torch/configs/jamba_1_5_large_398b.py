"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; MoE 16 routed
top-2 every 2nd layer. Super-block of 8 layers: attention at offset 4,
mamba elsewhere; scanned 9x. Mamba-dominated => supports long_500k.
FSDP sharding for the 398B parameter tree.
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, ParallelConfig,
                                SSMConfig)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    block_pattern="jamba",
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(n_routed=16, n_shared=0, top_k=2, d_ff=24576, every=2,
                  capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_seq_len=524288,
    supports_long_context=True,
    parallel=ParallelConfig(fsdp=True, remat="full"),
)
