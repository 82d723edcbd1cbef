"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
Window-bounded KV cache => supports the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    sliding_window=4096,
    rope_theta=10000.0,
    max_seq_len=524288,
    supports_long_context=True,
    parallel=ParallelConfig(fsdp=False, remat="dots"),
)
