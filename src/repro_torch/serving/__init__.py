"""Continuous paged serving: scheduler, KV cache, engine, model pool."""
