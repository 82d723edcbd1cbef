"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865, layernorm+bias,
non-gated GELU. The log-mel conv frontend is a STUB — input_specs()
provides precomputed frame embeddings. Enc-dec full attention =>
long_500k SKIPPED; decode shapes run against the decoder.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_enc_layers=4,
    norm_type="layernorm",
    use_bias=True,
    mlp_gated=False,
    act="gelu",
    frontend="audio_stub",
    max_seq_len=65536,
    supports_long_context=False,
    parallel=ParallelConfig(fsdp=False, remat="none"),
)
