"""Serving: batched prefill + greedy decode.  The scheduler and the
continuous-batching engine come with the serving-core slice."""
