"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Full attention => long_500k SKIPPED.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    act="relu2",                  # nemotron-family squared-relu MLP
    mlp_gated=False,
    max_seq_len=131072,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=True, remat="dots"),
)
