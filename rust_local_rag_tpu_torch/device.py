"""Device selection for the port.

Entry points take an explicit ``device``; the default is ``"cuda"`` and it
raises when no card is present rather than running on the CPU. The CPU is
used only when the caller asks for it (the tests do).

f32 slabs score at full f32 in the JAX package (Precision.HIGHEST,
ops/hybrid.py and ops/pallas_topk.py there), so TF32 and reduced-precision
reductions are switched off whenever a device is resolved.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def set_full_precision() -> None:
    """f32 matmuls in f32 (no TF32), bf16 GEMMs reduce in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """-> torch.device; raises RuntimeError for a CUDA device when no card
    is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    set_full_precision()
    return dev
