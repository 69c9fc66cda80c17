"""Serving: the WSGI app, the inference session and its micro-batcher."""
