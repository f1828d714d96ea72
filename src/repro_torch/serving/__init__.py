"""Serving over the COW-paged KV cache: the cache and the batched decode
engine (``SMCDecoder`` and the scheduler stack are still to port)."""
