"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) vocab=163840; MoE 384 routed top-8 with
expert d_ff=2048 + 1 shared expert; first layer dense (d_ff=18432).
Full attention => long_500k SKIPPED.  FSDP sharding (params over data
axis too) so fp32 optimizer state fits 512 chips.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,                   # dense first-layer FFN width
    vocab_size=163840,
    head_dim=112,
    moe=MoEConfig(n_routed=384, n_shared=1, top_k=8, d_ff=2048,
                  n_dense_layers=1, capacity_factor=1.25),
    max_seq_len=131072,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=True, remat="full"),
)
