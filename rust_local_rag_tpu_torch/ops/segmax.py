"""Segment max of a score matrix: the CUDA kernel of csrc/segmax.cu and its
plain PyTorch version.

Port of the segment-max-only TPU kernels of the split exact top-k
experiments, make_segmax_qn (scripts/exp_split_pipeline.py:30-71) and
make_segmax (scripts/exp_split2.py:18-55): scores [Q, N] f32 ->
out[q, t] = max(scores[q, seg t : seg t + seg]), seg 64 or 128. The split
pipeline runs it between a library GEMM and the two-stage selection.

segmax launches the kernel for CUDA tensors and runs the plain version
only for CPU tensors; there is no fallback from one to the other. blkc
(columns a block reduces) and slots (loads a lane keeps in flight) are
the TPU kernel's knobs carried to the card (csrc/segmax.cu says how);
neither changes the result.
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.kernels import build


def segmax_plain(scores: torch.Tensor, seg: int = 128) -> torch.Tensor:
    """[R, C] f32 -> [R, C / seg] f32, the max of each seg-column segment."""
    r, c = scores.shape
    return scores.view(r, c // seg, seg).amax(dim=2)


def _check(scores: torch.Tensor, seg: int, blkc: int, slots: int) -> None:
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"segmax: expects scores [R, C] float32, got {tuple(scores.shape)} {scores.dtype}")
    if seg not in (64, 128):
        raise ValueError(f"segmax: seg must be 64 or 128, got {seg}")
    c = scores.shape[1]
    if blkc < 128 or blkc % 128 or c % blkc:
        raise ValueError(f"segmax: blkc must be a multiple of 128 that divides C (blkc={blkc}, C={c})")
    if slots < 1:
        raise ValueError(f"segmax: slots must be >= 1, got {slots}")
    if scores.device.type == "cuda" and (not scores.is_contiguous() or scores.data_ptr() % 16):
        raise ValueError("segmax: scores must be contiguous and 16-byte aligned")


def segmax(scores: torch.Tensor, seg: int = 128, blkc: int = 32768, slots: int = 2) -> torch.Tensor:
    """scores [R, C] f32 -> [R, C / seg] f32.

    CUDA tensors launch the kernel (and count the launch in
    ``segmax.launches``); CPU tensors take segmax_plain."""
    _check(scores, seg, blkc, slots)
    dev = scores.device
    if dev.type == "cpu":
        return segmax_plain(scores, seg)
    if dev.type != "cuda":
        raise ValueError(f"segmax: unsupported device {dev}")
    lib = build.load("segmax")
    r, c = scores.shape
    out = torch.empty((r, c // seg), dtype=torch.float32, device=dev)
    err = lib.segmax_rows(scores.data_ptr(), out.data_ptr(), r, c, seg, blkc, slots, dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segmax kernel launch failed: {lib.segmax_error_string(err).decode()} ({err})")
    segmax.launches += 1
    return out


segmax.launches = 0
