"""Device-resident chunk store: an embedding slab plus host-side metadata
(port of rust_local_rag_tpu/engine/chunk_store.py: f32, bf16 and int8
slabs, on one device or row-sharded over a mesh).

  * device: a preallocated [capacity, D] embedding tensor and a [capacity]
    bool validity mask. New rows are written in place; a document
    replacement frees its slots (mask cleared, slot on the free list) and
    new chunks refill holes first. Capacity doubles from 1024 on demand.
  * host: per-slot metadata and an id -> slot map. Embeddings live only on
    the device; persistence snapshots read the slab back in one copy.
  * ``mutations`` counts every change of what the slots hold (add, remove,
    compact), as in the JAX store: the response serializer keys its
    "every fragment registered" state on it.
  * quantized=True (the int8 capacity mode): an int8 [capacity, D] slab,
    per-row f32 scales [capacity, 1] and l1 [capacity] (scale_i *
    ||v_i8||_1, the exactness certificate's bound), all on the device.
    Rows are quantised on the host with the JAX store's numpy code, so
    values, scales and l1 are bit-identical with its; snapshots
    dequantise (f32), so the saved format is the same.
  * mesh (parallel/mesh.Mesh): slab, mask, scales and l1 are
    parallel/mesh.ShardedTensors row-sharded over `corpus_axis` (one
    tensor a shard on that shard's device, replicated over the mesh's
    other axes), searched by parallel/sharded_search. The capacity is a
    multiple of the shard count; writes go to the owning shard's
    replicas; growth rebuilds every shard, since a shard's rows are
    capacity / shards and doubling the capacity moves slots between
    shards. Snapshots are in slot order, so a sharded index saves the
    same file as an unsharded one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.ops.quantized import QuantizedCorpus, gather_dequantized
from rust_local_rag_tpu_torch.parallel.mesh import ShardedTensor, as_axes


@dataclass
class ChunkMeta:
    """Host-side chunk record (the device holds only the embedding row)."""

    id: str
    document_name: str
    text: str
    chunk_index: int
    page_number: int = 0
    section: Optional[str] = None
    metadata: dict = field(default_factory=dict)


class ChunkStore:
    def __init__(
        self,
        dim: int,
        dtype: torch.dtype = torch.float32,
        initial_capacity: int = 1024,
        device: str | torch.device = "cuda",
        quantized: bool = False,
        mesh=None,
        corpus_axis="corpus",
    ):
        """quantized=True stores int8 rows and their scales (dtype is then
        ignored, as in the JAX store). mesh row-shards the tensors over
        corpus_axis (an axis name, or a tuple of them, outer first); the
        store's device is then the mesh's lead device."""
        self.quantized = bool(quantized)
        if self.quantized:
            dtype = torch.int8
        elif dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"slab dtype must be float32 or bfloat16, got {dtype}")
        self.dim = int(dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self._axes = as_axes(corpus_axis)
        if mesh is not None:
            self.device = mesh.lead
            shards = ShardedTensor.shard_count(mesh, self._axes)
            initial_capacity = -(-int(initial_capacity) // shards) * shards
        self._capacity = int(initial_capacity)
        self._emb = self._zeros((self._capacity, self.dim), dtype)
        self._scales = self._zeros((self._capacity, 1)) if self.quantized else None
        self._l1 = self._zeros((self._capacity,)) if self.quantized else None
        self._mask = self._zeros((self._capacity,), torch.bool)
        self._meta: List[Optional[ChunkMeta]] = [None] * self._capacity
        self._id_to_slot: Dict[str, int] = {}
        self._free: List[int] = []
        self._high_water = 0  # slots [0, high_water) may be valid
        self.mutations = 0

    # ----- introspection -------------------------------------------------

    def __len__(self) -> int:
        return len(self._id_to_slot)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def high_water(self) -> int:
        return self._high_water

    def _zeros(self, shape, dtype: torch.dtype = torch.float32):
        if self.mesh is not None:
            return ShardedTensor.zeros(self.mesh, self._axes, shape, dtype)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _write(self, t, slots, values) -> None:
        """Rows `slots` of t := values (a host tensor, cast to t's dtype on
        the device, or a scalar)."""
        if isinstance(t, ShardedTensor):
            t.set_rows(np.asarray(slots, dtype=np.int64), values)
            return
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        t[idx] = values.to(self.device, t.dtype) if torch.is_tensor(values) else values

    def corpus(self):
        """[capacity, D] device slab (rows outside the mask are garbage); a
        ShardedTensor on a mesh."""
        return self._emb

    def scales(self) -> torch.Tensor:
        """[capacity, 1] f32 per-row dequantisation scales (int8 store)."""
        if self._scales is None:
            raise RuntimeError("store is not quantized")
        return self._scales

    def l1(self) -> torch.Tensor:
        """[capacity] f32 dequantised L1 norms scale_i * ||v_i8||_1 (int8
        store): the exactness certificate's error bound."""
        if self._l1 is None:
            raise RuntimeError("store is not quantized")
        return self._l1

    def quantized_corpus(self) -> QuantizedCorpus:
        """The int8 slab and its scales as ops/quantized's QuantizedCorpus."""
        return QuantizedCorpus(values=self._emb, scales=self.scales())

    def valid_mask(self):
        """[capacity] device bool mask of live slots."""
        return self._mask

    def gather_rows(self, slots: torch.Tensor) -> torch.Tensor:
        """Rows `slots` ([...] int) on the store's device: the slab's dtype
        (f32 or bf16), an int8 store's rows dequantised to f32."""
        idx = torch.as_tensor(slots, device=self.device).long()
        if self.mesh is None:
            if self.quantized:
                return gather_dequantized(self._emb, self._scales, idx)
            return self._emb[idx]
        rows = self._emb.take(idx)
        return rows.float() * self._scales.take(idx) if self.quantized else rows

    def meta_for_slot(self, slot: int) -> ChunkMeta:
        m = self._meta[slot]
        if m is None:
            raise KeyError(f"slot {slot} is empty")
        return m

    def slot_for_id(self, chunk_id: str) -> int:
        return self._id_to_slot[chunk_id]

    def contains(self, chunk_id: str) -> bool:
        return chunk_id in self._id_to_slot

    def chunk_ids(self) -> List[str]:
        return list(self._id_to_slot.keys())

    def iter_meta(self):
        for slot in self._id_to_slot.values():
            yield slot, self._meta[slot]

    def document_names(self) -> List[str]:
        """Sorted unique document names."""
        return sorted({m.document_name for _, m in self.iter_meta()})

    # ----- mutation -------------------------------------------------------

    def _grow(self, min_capacity: int) -> None:
        new_cap = self._capacity
        while new_cap < min_capacity:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        pad = new_cap - self._capacity

        def grown(t):
            if isinstance(t, ShardedTensor):
                return t.resized(new_cap)
            return torch.cat([t, torch.zeros((pad, *t.shape[1:]), dtype=t.dtype, device=self.device)])

        self._emb, self._mask = grown(self._emb), grown(self._mask)
        if self.quantized:
            self._scales, self._l1 = grown(self._scales), grown(self._l1)
        self._meta.extend([None] * pad)
        self._capacity = new_cap

    def _alloc_slots(self, n: int) -> List[int]:
        slots: List[int] = []
        while self._free and len(slots) < n:
            slots.append(self._free.pop())
        remaining = n - len(slots)
        if remaining:
            if self._high_water + remaining > self._capacity:
                self._grow(self._high_water + remaining)
            slots.extend(range(self._high_water, self._high_water + remaining))
            self._high_water += remaining
        return slots

    def add_chunks(self, metas: Sequence[ChunkMeta], embeddings: np.ndarray) -> List[int]:
        """Insert chunks (embeddings already unit-normalised). Returns slots."""
        if len(metas) != embeddings.shape[0]:
            raise ValueError("metas/embeddings length mismatch")
        if not metas:
            return []
        if embeddings.shape[1] != self.dim:
            raise ValueError(f"embedding dim {embeddings.shape[1]} != store dim {self.dim}")
        for m in metas:
            if m.id in self._id_to_slot:
                raise ValueError(f"duplicate chunk id {m.id}")
        slots = self._alloc_slots(len(metas))
        for slot, meta in zip(slots, metas):
            self._meta[slot] = meta
            self._id_to_slot[meta.id] = slot
        emb32 = np.asarray(embeddings, dtype=np.float32)
        if self.quantized:
            # the JAX store's host quantisation, line for line
            absmax = np.maximum(np.abs(emb32).max(axis=1, keepdims=True), 1e-10)
            scale = (absmax / 127.0).astype(np.float32)
            q = np.clip(np.round(emb32 / scale), -127, 127).astype(np.int8)
            l1 = (scale[:, 0] * np.abs(q).astype(np.float32).sum(axis=1)).astype(np.float32)
            self._write(self._emb, slots, torch.from_numpy(q))
            self._write(self._scales, slots, torch.from_numpy(scale))
            self._write(self._l1, slots, torch.from_numpy(l1))
        else:
            self._write(self._emb, slots, torch.from_numpy(emb32))
        self._write(self._mask, slots, True)
        self.mutations += 1
        return slots

    def remove_ids(self, chunk_ids: Sequence[str]) -> int:
        doomed = [self._id_to_slot[c] for c in chunk_ids if c in self._id_to_slot]
        if not doomed:
            return 0
        for slot in doomed:
            meta = self._meta[slot]
            if meta is not None:
                del self._id_to_slot[meta.id]
            self._meta[slot] = None
            self._free.append(slot)
        self._write(self._mask, doomed, False)
        self.mutations += 1
        return len(doomed)

    def compact(self) -> None:
        """Repack live slots to the front, in slot order (one gather)."""
        live = sorted(self._id_to_slot.values())
        n = len(live)
        new_meta: List[Optional[ChunkMeta]] = [None] * self._capacity
        id_to_slot: Dict[str, int] = {}
        for new_slot, old_slot in enumerate(live):
            meta = self._meta[old_slot]
            new_meta[new_slot] = meta
            id_to_slot[meta.id] = new_slot
        self._meta = new_meta
        self._id_to_slot = id_to_slot
        self._free = []
        self._high_water = n
        idx = torch.as_tensor(live, dtype=torch.long, device=self.device)

        def repack(t):
            if isinstance(t, ShardedTensor):
                return t.repacked(np.asarray(live, dtype=np.int64))
            out = torch.zeros_like(t)
            out[:n] = t[idx]
            return out

        self._emb = repack(self._emb)
        if self.quantized:
            self._scales = repack(self._scales)
            self._l1 = repack(self._l1)
        self._mask = self._zeros((self._capacity,), torch.bool)
        self._write(self._mask, np.arange(n), True)
        self.mutations += 1

    # ----- persistence helpers -------------------------------------------

    def snapshot_host(self):
        """(embeddings [n, D] f32 numpy, metas) for live chunks, slot-ordered;
        an int8 store's rows dequantised (emb * scale, on the host as the
        JAX store does), so the saved format is f32 either way."""
        live = sorted(self._id_to_slot.values())
        if not live:
            return np.zeros((0, self.dim), np.float32), []
        idx = torch.as_tensor(live, dtype=torch.long)

        def host(t) -> torch.Tensor:
            if isinstance(t, ShardedTensor):
                return t.take(idx, device="cpu")
            return t[idx.to(self.device)].cpu()

        emb = host(self._emb).float().numpy()
        if self.quantized:
            emb = emb * host(self._scales).numpy()
        return emb, [self._meta[s] for s in live]
