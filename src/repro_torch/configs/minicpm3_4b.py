"""minicpm3-4b [dense] — MLA [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA q_lora=768 kv_lora=256,
qk_nope=64 qk_rope=32 v_head=64. Full attention => long_500k SKIPPED.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, ParallelConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=96,                  # qk_nope + qk_rope
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    max_seq_len=131072,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=False, remat="dots"),
)
