"""Training input: the deterministic token stream and its prefetch."""
