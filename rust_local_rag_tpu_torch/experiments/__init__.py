"""The exact top-k experiments on the card: one module for each TPU
experiment script in scripts/exp_*.py that ran a Pallas kernel, with the
script's names inside and its sweeps in main(). Run one with

    python -m rust_local_rag_tpu_torch.experiments.<name>

(on the card; --device cpu runs the plain versions at the given sizes and
times nothing)."""
