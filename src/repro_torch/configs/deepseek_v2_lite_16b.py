"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed
top-6 [arXiv:2405.04434].

27L d_model=2048 16H vocab=102400; expert d_ff=1408; first layer dense
(d_ff=10944). Full attention => long_500k SKIPPED.

Config note (DESIGN.md §5): the assignment's primary spec says
"MoE 64e top-6" while its descriptor mentions 160 routed; we follow the
primary spec (64 routed), which matches the public HF config.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                   # dense first-layer FFN width
    vocab_size=102400,
    head_dim=192,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff=1408,
                  n_dense_layers=1, capacity_factor=1.25),
    max_seq_len=131072,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=False, remat="dots"),
)
