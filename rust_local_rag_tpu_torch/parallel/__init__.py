"""Parallelism of the port (port of rust_local_rag_tpu/parallel/): a device
mesh, row-sharded tensors, the sharded exact first stages with their
hierarchical merge, and the encoder's data x model parallel training step
(train.py), all driven from one process."""
