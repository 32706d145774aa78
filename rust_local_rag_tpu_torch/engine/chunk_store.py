"""Device-resident chunk store: an embedding slab plus host-side metadata
(port of rust_local_rag_tpu/engine/chunk_store.py, f32/bf16 slabs, one
device, no quantised mode and no mesh).

  * device: a preallocated [capacity, D] embedding tensor and a [capacity]
    bool validity mask. New rows are written in place; a document
    replacement frees its slots (mask cleared, slot on the free list) and
    new chunks refill holes first. Capacity doubles from 1024 on demand.
  * host: per-slot metadata and an id -> slot map. Embeddings live only on
    the device; persistence snapshots read the slab back in one copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rust_local_rag_tpu_torch.device import resolve_device


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
    ):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"slab dtype must be float32 or bfloat16, got {dtype}")
        self.dim = int(dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._capacity = int(initial_capacity)
        self._emb = torch.zeros((self._capacity, self.dim), dtype=dtype, device=self.device)
        self._mask = torch.zeros((self._capacity,), dtype=torch.bool, device=self.device)
        self._meta: List[Optional[ChunkMeta]] = [None] * self._capacity
        self._id_to_slot: Dict[str, int] = {}
        self._free: List[int] = []
        self._high_water = 0  # slots [0, high_water) may be valid

    # ----- introspection -------------------------------------------------

    def __len__(self) -> int:
        return len(self._id_to_slot)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def high_water(self) -> int:
        return self._high_water

    def corpus(self) -> torch.Tensor:
        """[capacity, D] device slab (rows outside the mask are garbage)."""
        return self._emb

    def valid_mask(self) -> torch.Tensor:
        """[capacity] device bool mask of live slots."""
        return self._mask

    def meta_for_slot(self, slot: int) -> ChunkMeta:
        m = self._meta[slot]
        if m is None:
            raise KeyError(f"slot {slot} is empty")
        return m

    def slot_for_id(self, chunk_id: str) -> int:
        return self._id_to_slot[chunk_id]

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
        self._emb = torch.cat(
            [self._emb, torch.zeros((pad, self.dim), dtype=self.dtype, device=self.device)]
        )
        self._mask = torch.cat(
            [self._mask, torch.zeros((pad,), dtype=torch.bool, device=self.device)]
        )
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
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        rows = torch.as_tensor(np.asarray(embeddings, dtype=np.float32))
        self._emb[idx] = rows.to(self.device, self.dtype)
        self._mask[idx] = True
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
        self._mask[torch.as_tensor(doomed, dtype=torch.long, device=self.device)] = False
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
        emb = torch.zeros_like(self._emb)
        emb[:n] = self._emb[torch.as_tensor(live, dtype=torch.long, device=self.device)]
        self._emb = emb
        self._mask = torch.zeros_like(self._mask)
        self._mask[:n] = True

    # ----- persistence helpers -------------------------------------------

    def snapshot_host(self):
        """(embeddings [n, D] f32 numpy, metas) for live chunks, slot-ordered."""
        live = sorted(self._id_to_slot.values())
        if not live:
            return np.zeros((0, self.dim), np.float32), []
        idx = torch.as_tensor(live, dtype=torch.long, device=self.device)
        emb = self._emb[idx].float().cpu().numpy()
        return emb, [self._meta[s] for s in live]
