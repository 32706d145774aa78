"""The exact top-k experiments on the card: one module for each script of
scripts/ that studied the top-k pipeline, with the script's names inside
and its sweeps in main(): the TPU kernel experiments (exp_split_pipeline,
exp_split2, exp_stream_kernel, exp_isolate_kernel, exp_isolate2,
exp_dma_probe), the pipeline's profiles (profile_topk, exp_qscale,
exp_qscale2, exp_blockn) and the XLA-formulation studies (exp_rw_segmax,
exp_xla_blocked, exp_xla_segmax, exp_partialreduce: library formulations
here, beside the score + segment-max kernel). Run one with

    python -m rust_local_rag_tpu_torch.experiments.<name>

(on the card; --device cpu runs the plain versions at the given sizes and
times nothing)."""
