"""Reading a safetensors file (8-byte little-endian header length, a JSON
header, raw little-endian tensors) into f32 tensors, for the reference's
copies of the committed models."""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

import numpy as np
import torch

_NUMPY = {"F32": "<f4", "F16": "<f2"}


def metadata(path: str) -> Dict[str, str]:
    """The file's metadata entry, without reading its tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n).decode("utf-8")).get("__metadata__") or {}


def read(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """-> ({name: f32 tensor on the CPU}, metadata)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    meta = header.pop("__metadata__", None) or {}
    base = 8 + n
    out = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        raw = data[base + lo:base + hi]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=_NUMPY[info["dtype"]]).astype(np.float32)
        out[name] = torch.from_numpy(arr.reshape(info["shape"]).copy())
    return out, meta
