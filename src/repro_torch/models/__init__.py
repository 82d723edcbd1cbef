"""The LM stack that serving drives: layers, attention (through K7),
MLA, MoE (through K8), block assembly, the decoder-only LM, the
encoder-decoder and the model zoo's functional interface."""
