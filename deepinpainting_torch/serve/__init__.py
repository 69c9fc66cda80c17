"""Serving: the in-memory inference session and its micro-batcher."""
