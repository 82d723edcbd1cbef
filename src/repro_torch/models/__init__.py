"""The LM stack that serving drives: layers, attention (through K7),
MoE (through K8), block assembly, the decoder-only LM and the model
zoo's functional interface."""
