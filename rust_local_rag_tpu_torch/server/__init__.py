"""Serving entry point of the port: the search micro-batcher."""
