"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 (block-internal projections only) vocab=50304.
Linear-time recurrence => supports the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern="xlstm",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, conv_width=4,
                      chunk_size=256),
    tie_embeddings=False,
    max_seq_len=524288,
    supports_long_context=True,
    parallel=ParallelConfig(fsdp=False, remat="dots"),
)
