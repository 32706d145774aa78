"""The model-update loop's tools on the port: the offline calibration
studies of the serving gate (judge_dev, gate_grid, blend_offline,
joint_ood, query_cosine_floor), the live sweeps against the port's server
(sweep_common and the seven sweeps), and the operational checks
(oracle_check, scale_check, soak); beside them, the engine's
decompositions (server_profile, dispatch_profile) and the host's serving
ceilings (stack_ceiling, http_ceiling, proto_ceiling, reuseport, over
ceiling_common). One module for each script of scripts/ that drives the
JAX package, with its names, points and printed lines. Run one with

    python -m rust_local_rag_tpu_torch.tools.<name> [--device cpu]

(on the card unless --device cpu is given; the ceilings use no card and
take no device). The loop: train
(training/train_encoder, train_reranker), calibrate the gate for the new
judge (judge_dev, gate_grid, then the sweeps with ENCODER_WEIGHTS /
RERANKER_WEIGHTS naming the checkpoints), then serve them with the same
variables."""
