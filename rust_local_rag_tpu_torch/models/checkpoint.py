"""safetensors reading and writing without the ``safetensors`` package
(port of rust_local_rag_tpu/models/checkpoint.py), and the carry-over of
parameters between JAX pytrees and the port's state_dict.

A safetensors file is an 8-byte little-endian header length, a JSON header
({name: {dtype, shape, data_offsets}, "__metadata__": {str: str}}) and the
raw little-endian tensor bytes. The committed assets store F16; BF16 and
F32 are read too. Every tensor is widened to f32 numpy, as the JAX
package's load_safetensors_params widens its half-precision storage.

save_params writes F32 (F16 for f32 tensors with half=True) in the layout
the ``safetensors`` package writes and checks: tensors in order of their
offsets with no gap, the header padded with spaces to 8 bytes. Flat naming
as in the JAX package: embed, final_norm, out_proj / lm_head,
layers.<i>.<name>.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Dict, Optional, Tuple

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
    """JAX encoder or reranker pytree ({"embed", "final_norm", "layers":
    [{...}], and "out_proj" or "lm_head"}, leaves as numpy) -> flat f32
    state_dict of the port's Encoder or Reranker ("layers.<i>.<name>", the
    safetensors naming)."""
    flat: Dict[str, torch.Tensor] = {}
    for key, val in np_params.items():
        if key == "layers":
            for i, layer in enumerate(val):
                for name, arr in layer.items():
                    flat[f"layers.{i}.{name}"] = torch.tensor(np.asarray(arr, dtype=np.float32))
        else:
            flat[key] = torch.tensor(np.asarray(val, dtype=np.float32))
    return flat


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The reverse of params_from_jax: a flat state_dict ("layers.<i>.<name>")
    -> the JAX pytree ({"embed", "final_norm", "layers": [{...}], ...}) with
    f32 numpy leaves."""
    out: Dict = {"layers": []}
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for key, val in state.items():
        arr = _numpy(val)
        if key.startswith("layers."):
            _, idx, name = key.split(".", 2)
            layers.setdefault(int(idx), {})[name] = arr
        else:
            out[key] = arr
    out["layers"] = [layers[i] for i in sorted(layers)]
    return out


def _numpy(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        val = val.detach().to("cpu", torch.float32).numpy()
    return np.asarray(val, dtype=np.float32)


def flatten_params(params) -> Dict[str, np.ndarray]:
    """A model, a flat state_dict or a JAX-style pytree -> {safetensors name:
    C-contiguous f32 numpy}.

    The contiguous copy is load-bearing: a transposed tensor's numpy is a
    strided view, and a writer that dumps the raw buffer would scramble it
    on disk. The JAX package shipped scrambled reranker lm_heads this way
    (its flatten_params): ranking partly survived while the absolute
    calibration a rejection threshold reads was destroyed."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    flat: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        if key == "layers" and not isinstance(val, (torch.Tensor, np.ndarray)):
            for i, layer in enumerate(val):
                for name, arr in layer.items():
                    flat[f"layers.{i}.{name}"] = np.ascontiguousarray(_numpy(arr))
        else:
            flat[key] = np.ascontiguousarray(_numpy(val))
    return flat


_ENCODE = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}


def save_params(params, path: str, metadata: Optional[Dict[str, str]] = None, half: bool = False) -> None:
    """Write parameters (see flatten_params) to a safetensors file, atomically
    (a temporary file in the target directory, then os.replace).

    ``metadata`` rides in the header (the trainers store the architecture
    config there; the loaders read it back); its values must be strings.
    ``half=True`` stores f32 tensors as f16, as the committed assets are
    stored; the readers widen them to f32."""
    flat = flatten_params(params)
    if half:
        flat = {k: v.astype("<f2") for k, v in flat.items()}
    header: Dict[str, dict] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata must map str to str")
        header["__metadata__"] = dict(metadata)
    offset = 0
    blobs = []
    for name in sorted(flat):
        arr = np.ascontiguousarray(flat[name])
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _ENCODE[np.dtype(arr.dtype)], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".safetensors.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(struct.pack("<Q", len(head)))
            f.write(head)
            for raw in blobs:
                f.write(raw)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Inverse of save_params: {safetensors name: f32 tensor}, the state_dict
    of the port's Encoder or Reranker."""
    tensors, _ = read_safetensors(path)
    return {k: torch.from_numpy(v) for k, v in tensors.items()}
