"""Corpus sharding of the port (port of rust_local_rag_tpu/parallel/ without
train.py): a device mesh, row-sharded tensors, and the sharded exact
first stages with their hierarchical merge, driven from one process."""
