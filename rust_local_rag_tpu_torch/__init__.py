"""PyTorch/CUDA port of rust_local_rag_tpu for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors a module there by name and is held against it by the tests in
tests/test_torch_*.py. This package imports torch and never jax, and
nothing of the JAX package. Entry points run on the card (``"cuda"``)
unless the caller asks for the CPU.
"""
