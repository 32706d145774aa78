"""Device mesh and row-sharded tensors (port of
rust_local_rag_tpu/parallel/mesh.py).

The JAX package serves a corpus larger than one chip from ONE controller:
one process drives every device through one shard_map program. The port
keeps that design. One process puts each shard on its own device, queues
every shard's work before it waits on any (CUDA launches return at once),
and merges the candidates on the lead device. It needs no process group:
torch.distributed.DeviceMesh would want one process a device.

  * Mesh: a numpy object array of torch.devices shaped by the axis sizes,
    with axis_names, and shape[name] as in jax.sharding.Mesh.
  * ShardedTensor: a [N, ...] tensor row-split over some mesh axes and
    replicated over the others, the counterpart of an array placed with
    NamedSharding(mesh, P(axes, None)).

A mesh may name one device several times: on the CPU every position is
the CPU (CPU_DEVICES of them, the counterpart of the JAX tests' forced
host device count), and on one card several shards may stand on it.
Positions that hold the same block on the same device share one tensor.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rust_local_rag_tpu_torch.device import resolve_device

# virtual devices on the CPU: the JAX tests' platform has 8
# (tests/conftest.py, --xla_force_host_platform_device_count=8)
CPU_DEVICES = 8


class Mesh:
    """Devices laid out on named axes (jax.sharding.Mesh's interface:
    devices, axis_names, shape[name], size)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError("axis_sizes and axis_names length mismatch")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device that merges and returns results (the first)."""
        return self.devices.flat[0]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Mesh)
            and self.axis_names == other.axis_names
            and self.devices.shape == other.devices.shape
            and list(self.devices.flat) == list(other.devices.flat)
        )

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def available_devices(device: str | torch.device = "cuda") -> list:
    """The devices a mesh may span: every card for a CUDA device (raises
    without one), CPU_DEVICES times the CPU for the CPU. The engine asks
    this function alone for its devices."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] * CPU_DEVICES


def build_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("corpus",),
    devices: Optional[Sequence] = None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """A Mesh over `devices` (default: available_devices(device)).

    Default: a 1-D "corpus" mesh over all of them. axis_sizes factors the
    list, e.g. build_mesh((2, 4), ("data", "corpus")); its product must be
    the device count, as in the JAX package. An explicit list may repeat a
    device."""
    devices = list(devices if devices is not None else available_devices(device))
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    total = int(np.prod(axis_sizes))
    if total != len(devices):
        raise ValueError(f"axis sizes {tuple(axis_sizes)} need {total} devices, have {len(devices)}")
    if len(axis_sizes) != len(axis_names):
        raise ValueError("axis_sizes and axis_names length mismatch")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(tuple(axis_sizes)), axis_names)


def as_axes(axis) -> tuple:
    """A mesh axis name, or a tuple of them (outer first), as a tuple."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class ShardedTensor:
    """A [N, ...] tensor row-split over the mesh axes `axes` and
    replicated over the others: shard s (flat index of its position on
    `axes`, outer axis first) holds rows [s * rows, (s + 1) * rows).
    parts[pos] is the block on mesh.devices[pos]; equal (device, shard)
    pairs share one tensor. axes == () is a replicated tensor."""

    def __init__(self, mesh: Mesh, axes: tuple, parts: np.ndarray, n: int):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.parts = parts
        self._n = int(n)

    # ----- layout ------------------------------------------------------------

    @staticmethod
    def _shard_of(mesh: Mesh, axes: tuple, pos: tuple) -> int:
        if not axes:
            return 0
        names = mesh.axis_names
        return int(np.ravel_multi_index([pos[names.index(a)] for a in axes],
                                        [mesh.shape[a] for a in axes]))

    @staticmethod
    def shard_count(mesh: Mesh, axes: tuple) -> int:
        return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1

    @classmethod
    def _build(cls, mesh: Mesh, axes: tuple, n: int, make) -> "ShardedTensor":
        """make(device, shard) -> that shard's block; called once for each
        distinct (device, shard)."""
        axes = tuple(axes)
        if n % cls.shard_count(mesh, axes):
            raise ValueError(f"{n} rows must divide across {cls.shard_count(mesh, axes)} shards")
        made: dict = {}
        parts = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*mesh.devices.shape):
            dev = mesh.devices[pos]
            key = (str(dev), cls._shard_of(mesh, axes, pos))
            if key not in made:
                made[key] = make(dev, key[1])
            parts[pos] = made[key]
        return cls(mesh, axes, parts, n)

    @classmethod
    def zeros(cls, mesh: Mesh, axes, shape: tuple, dtype: torch.dtype) -> "ShardedTensor":
        axes = as_axes(axes) if axes else ()
        rows = shape[0] // cls.shard_count(mesh, axes)
        return cls._build(mesh, axes, shape[0],
                          lambda dev, s: torch.zeros((rows, *shape[1:]), dtype=dtype, device=dev))

    @classmethod
    def from_tensor(cls, mesh: Mesh, axes, x: torch.Tensor) -> "ShardedTensor":
        """x placed row-sharded over `axes` (() replicates it). A block on
        the device x lies on is a view of x."""
        axes = as_axes(axes) if axes else ()
        rows = x.shape[0] // cls.shard_count(mesh, axes)
        return cls._build(mesh, axes, x.shape[0], lambda dev, s: x[s * rows:(s + 1) * rows].to(dev))

    @property
    def shape(self) -> tuple:
        first = self.parts.flat[0]
        return (self._n, *first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts.flat[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    @property
    def n_shards(self) -> int:
        return self.shard_count(self.mesh, self.axes)

    @property
    def rows(self) -> int:
        """Rows a shard."""
        return self._n // self.n_shards

    @property
    def spec(self) -> tuple:
        """PartitionSpec-like: (axes or the one axis, None, ...)."""
        first = self.axes if len(self.axes) > 1 else (self.axes[0] if self.axes else None)
        return (first, *([None] * (len(self.shape) - 1)))

    def block(self, pos: tuple) -> torch.Tensor:
        return self.parts[pos]

    def blocks(self) -> list:
        """[(tensor, shard)] for every distinct tensor (replicas included)."""
        seen, out = set(), []
        for pos in np.ndindex(*self.parts.shape):
            t = self.parts[pos]
            if id(t) not in seen:
                seen.add(id(t))
                out.append((t, self._shard_of(self.mesh, self.axes, pos)))
        return out

    def shards(self) -> list:
        """One tensor a shard, in shard order: the first replica, the one on
        the device of the shard's first mesh position."""
        first: dict = {}
        for t, s in self.blocks():
            first.setdefault(s, t)
        return [first[s] for s in range(self.n_shards)]

    # ----- reads -------------------------------------------------------------

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor in row order on `device` (default: the lead)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([t.to(dev) for t in self.shards()])

    def take(self, slots, device=None) -> torch.Tensor:
        """Rows `slots` ([...] int, global) gathered from their shards onto
        `device` (default: the lead) -> [..., *row shape]."""
        dev = self.device if device is None else torch.device(device)
        slots = torch.as_tensor(slots, device=dev).long()
        out = torch.empty((*slots.shape, *self.shape[1:]), dtype=self.dtype, device=dev)
        owner = torch.div(slots, self.rows, rounding_mode="floor")
        for s, t in enumerate(self.shards()):
            sel = owner == s
            local = (slots[sel] - s * self.rows).to(t.device)
            out[sel] = t[local].to(dev)
        return out

    # ----- writes ------------------------------------------------------------

    def set_rows(self, slots: np.ndarray, values) -> None:
        """Rows `slots` (global, numpy int) := values ([len(slots), ...]
        tensor, cast to this dtype on each device, or a scalar), in every
        replica of their shards."""
        slots = np.asarray(slots, dtype=np.int64)
        owner = slots // self.rows
        for t, s in self.blocks():
            sel = owner == s
            if not sel.any():
                continue
            idx = torch.as_tensor(slots[sel] - s * self.rows, device=t.device)
            t[idx] = values[torch.from_numpy(sel)].to(t.device, t.dtype) if torch.is_tensor(values) else values

    def resized(self, n: int) -> "ShardedTensor":
        """A copy with n rows (rows past the old end zero). Each shard
        holds n / shards rows now, so rows move between shards: every
        block is rebuilt from the old blocks that overlap it, on its own
        device."""
        old_rows, olds = self.rows, self.shards()
        new_rows = n // self.n_shards

        def make(dev, s):
            out = torch.zeros((new_rows, *self.shape[1:]), dtype=self.dtype, device=dev)
            lo, hi = s * new_rows, min((s + 1) * new_rows, self._n)
            for src in range(lo // old_rows, -(-hi // old_rows)):  # empty past the old end
                a, b = max(lo, src * old_rows), min(hi, (src + 1) * old_rows)
                out[a - lo:b - lo] = olds[src][a - src * old_rows:b - src * old_rows].to(dev)
            return out

        return self._build(self.mesh, self.axes, n, make)

    def repacked(self, live: np.ndarray) -> "ShardedTensor":
        """A copy whose rows [0, len(live)) are the rows `live` in order
        and the rest zero (compaction), each block gathered onto its own
        device."""
        rows = self.rows

        def make(dev, s):
            out = torch.zeros((rows, *self.shape[1:]), dtype=self.dtype, device=dev)
            src = live[s * rows:(s + 1) * rows]
            if len(src):
                out[:len(src)] = self.take(src, device=dev)
            return out

        return self._build(self.mesh, self.axes, self._n, make)
