"""Retrieval engine of the port: device slab, persistence, search lanes."""
