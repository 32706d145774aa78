"""safetensors reading without the ``safetensors`` package, and the
carry-over of JAX parameter pytrees into the port's state_dict.

A safetensors file is an 8-byte little-endian header length, a JSON header
({name: {dtype, shape, data_offsets}, "__metadata__": {str: str}}) and the
raw little-endian tensor bytes. The committed assets store F16; BF16 and
F32 are read too. Every tensor is widened to f32 numpy, as the JAX
package's load_safetensors_params widens its half-precision storage.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

import numpy as np
import torch

_HEADER_LIMIT = 100 * 1024 * 1024


def _decode(raw: bytes, dtype: str, shape) -> np.ndarray:
    if dtype == "F32":
        arr = np.frombuffer(raw, dtype="<f4")
    elif dtype == "F16":
        arr = np.frombuffer(raw, dtype="<f2").astype(np.float32)
    elif dtype == "BF16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        raise ValueError(f"unsupported safetensors dtype {dtype}")
    return arr.reshape(shape).astype(np.float32, copy=True)


def read_safetensors(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """-> ({name: f32 array}, metadata dict)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if n > _HEADER_LIMIT or 8 + n > len(data):
        raise ValueError(f"{path}: bad header length {n}")
    header = json.loads(data[8 : 8 + n].decode("utf-8"))
    meta = header.pop("__metadata__", None) or {}
    base = 8 + n
    tensors: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        if not (0 <= lo <= hi <= len(data) - base):
            raise ValueError(f"{path}: tensor {name} lies outside the file")
        tensors[name] = _decode(data[base + lo : base + hi], info["dtype"], info["shape"])
    return tensors, meta


def params_from_jax(np_params) -> Dict[str, torch.Tensor]:
    """JAX encoder pytree ({"embed", "final_norm", "layers": [{...}],
    "out_proj"?}, leaves as numpy) -> flat f32 state_dict of the port's
    Encoder ("layers.<i>.<name>", the safetensors naming)."""
    flat: Dict[str, torch.Tensor] = {}
    for key, val in np_params.items():
        if key == "layers":
            for i, layer in enumerate(val):
                for name, arr in layer.items():
                    flat[f"layers.{i}.{name}"] = torch.tensor(np.asarray(arr, dtype=np.float32))
        else:
            flat[key] = torch.tensor(np.asarray(val, dtype=np.float32))
    return flat
