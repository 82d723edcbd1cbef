"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, QK-norm.
Backbone only: the VQ tokenizer frontend is a STUB — input_specs()
provides precomputed token embeddings. Full attention => long_500k SKIPPED.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    frontend="vq_stub",
    max_seq_len=131072,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=True, remat="dots"),
)
