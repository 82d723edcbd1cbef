"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
Pure full attention => long_500k is SKIPPED (see DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    rope_theta=8_000_000.0,
    use_bias=False,
    tie_embeddings=True,          # command-r ties input/output embeddings
    max_seq_len=131072,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=True, remat="dots"),
)
