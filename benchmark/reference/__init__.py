"""The plain reference of the benchmark: plain PyTorch and NumPy, importing
nothing of the program (rust_local_rag_tpu_torch) and nothing of JAX."""
