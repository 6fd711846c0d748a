"""Device mesh and collectives — port of ``audio_raytracing_studio_tpu/parallel/mesh.py``.

One process drives every shard, as one JAX controller drives every local
device: ``render_batch(device_mesh=m)``, ``RenderService(device_mesh=m)``,
``render_long`` and ``graft_entry.dryrun_multichip`` are each called once
and return whole host arrays.  A shard's work runs inside ``Axis.on(k)``:
on its device and on a CUDA stream of its own, created at first use, so
shards on one card overlap as shards on several cards would.

Axes:
  "data"  — independent clips (embarrassingly parallel; the primary axis),
  "block" — sample blocks of one long clip (overlap-add halo exchange by
            ``ppermute``; the audio analog of sequence parallelism).

A device may repeat: ``make_mesh(devices=["cuda:0"] * 8)`` lets one card
stand in for eight, as the JAX tests' ``--xla_force_host_platform_device_count=8``
does, and ``["cpu"] * 8`` is the CPU tests' mesh.  The mesh's streams are
its own, so two shards on one card still order their work apart and hand
tensors over by event, as shards on two cards must.

The collectives are plain functions over lists of per-shard tensors, one
list entry per shard of an axis.  Every hop makes a fresh tensor on the
destination shard's device, filled on that shard's stream after an event
recorded on the source shard's stream — never an alias, even when both
shards are the same device.

Across processes the port exchanges host results only (``render_batch``
returns NumPy), so ``initialize_distributed`` opens a gloo process group.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.runtime import ensure_device

DATA_AXIS = "data"
BLOCK_AXIS = "block"


class Mesh:
    """A (data, block) grid of ``torch.device``s, all of one type.

    ``shape`` maps each axis name to its size (``mesh.shape[DATA_AXIS]``, as
    JAX reads it); ``devices[i][j]`` is the device at data index i, block
    index j.
    """

    axis_names = (DATA_AXIS, BLOCK_AXIS)

    def __init__(self, devices: Sequence[Sequence]):
        rows = tuple(tuple(ensure_device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        kinds = {d.type for row in rows for d in row}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {sorted(kinds)}")
        self.devices = rows
        self.shape: Dict[str, int] = {DATA_AXIS: len(rows), BLOCK_AXIS: len(rows[0])}
        self.is_cuda = rows[0][0].type == "cuda"
        self._streams: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[BLOCK_AXIS]

    def stream(self, i: int, j: int) -> Optional["torch.cuda.Stream"]:
        """The stream of the shard at (i, j), made on its device at first use;
        None on the CPU."""
        if not self.is_cuda:
            return None
        with self._lock:
            if (i, j) not in self._streams:
                self._streams[(i, j)] = torch.cuda.Stream(self.devices[i][j])
            return self._streams[(i, j)]

    def synchronize(self) -> None:
        """Wait until the work enqueued on every shard's stream has ended."""
        with self._lock:
            streams = list(self._streams.values())
        for s in streams:
            s.synchronize()

    def axis(self, name: str) -> "Axis":
        """The shards along ``name`` (at index 0 of the other axis: a sharded
        value is replicated over the other axis, and one replica is enough)."""
        if name == DATA_AXIS:
            return Axis(self, [(i, 0) for i in range(self.shape[DATA_AXIS])])
        if name == BLOCK_AXIS:
            return Axis(self, [(0, j) for j in range(self.shape[BLOCK_AXIS])])
        raise ValueError(f"unknown mesh axis {name!r} (axes: {self.axis_names})")


class Axis:
    """The shards of one mesh axis, in axis order."""

    def __init__(self, mesh: Mesh, positions: List[Tuple[int, int]]):
        self.mesh = mesh
        self.positions = positions
        self.devices = [mesh.devices[i][j] for i, j in positions]
        self.size = len(positions)

    def stream(self, k: int):
        return self.mesh.stream(*self.positions[k])

    @contextlib.contextmanager
    def on(self, k: int):
        """Run the body on shard ``k``: its device and its stream current."""
        dev = self.devices[k]
        if not self.mesh.is_cuda:
            yield dev
            return
        with torch.cuda.device(dev), torch.cuda.stream(self.stream(k)):
            yield dev

    def map(self, fn, *shard_lists) -> list:
        """``[fn(a[k], b[k], …) for each shard k]``, each call on its shard."""
        out = []
        for k in range(self.size):
            with self.on(k):
                out.append(fn(*(s[k] for s in shard_lists)))
        return out


def _copy(t: torch.Tensor, src_stream, dev: torch.device, dst_stream) -> torch.Tensor:
    """A fresh copy of ``t`` on ``dev``, made on ``dst_stream`` once the work
    enqueued on ``src_stream`` so far has ended (streams None on the CPU)."""
    if dst_stream is None:
        return t.to(dev, copy=True)
    ready = torch.cuda.Event()
    ready.record(src_stream)
    with torch.cuda.device(dev), torch.cuda.stream(dst_stream):
        dst_stream.wait_event(ready)
        out = torch.empty(t.shape, dtype=t.dtype, device=dev)
        out.copy_(t, non_blocking=True)
    if t.is_cuda:
        # the allocator must not hand ``t``'s memory on before this copy has read it
        t.record_stream(dst_stream)
    return out


def _current(dev: torch.device):
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def transfer(axis: Axis, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Shard ``src``'s tensor ``t`` → a fresh copy on shard ``dst``."""
    return _copy(t, axis.stream(src), axis.devices[dst], axis.stream(dst))


def ppermute(axis: Axis, shards: List[torch.Tensor], perm) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    each (src, dst) in ``perm``; a shard that receives nothing gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * axis.size
    for src, dst in perm:
        out[dst] = transfer(axis, shards[src], src, dst)
    for k in range(axis.size):
        if out[k] is None:
            with axis.on(k):
                out[k] = torch.zeros_like(shards[k])
    return out


def ring(axis: Axis) -> List[Tuple[int, int]]:
    """The permutation that hands each shard's tensor to the next, the last to the first."""
    return [(k, (k + 1) % axis.size) for k in range(axis.size)]


def _reduce(axis: Axis, shards: List[torch.Tensor], op) -> List[torch.Tensor]:
    """``op`` over the stacked shards on shard 0, then a copy back to each shard."""
    gathered = [transfer(axis, t, k, 0) for k, t in enumerate(shards)]
    with axis.on(0):
        total = op(torch.stack(gathered))
    return [total] + [transfer(axis, total, 0, k) for k in range(1, axis.size)]


def pmax(axis: Axis, shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.pmax``: the elementwise maximum over the shards, on every shard."""
    return _reduce(axis, shards, lambda s: s.amax(dim=0))


def psum(axis: Axis, shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.psum``: the elementwise sum over the shards, on every shard."""
    return _reduce(axis, shards, lambda s: s.sum(dim=0))


def replicate(axis: Axis, t: torch.Tensor) -> List[torch.Tensor]:
    """A tensor of the caller's (on its current stream) → a copy on every
    shard; replaces the JAX package's ``replicated`` sharding."""
    return [_copy(t, _current(t.device), dev, axis.stream(k))
            for k, dev in enumerate(axis.devices)]


def scatter(axis: Axis, t: torch.Tensor, dim: int = -1) -> List[torch.Tensor]:
    """A tensor of the caller's → its equal chunks along ``dim``, one per shard."""
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"length {n} not divisible by {axis.size}")
    parts = t.split(n // axis.size, dim=dim)
    return [_copy(p, _current(t.device), dev, axis.stream(k))
            for k, (p, dev) in enumerate(zip(parts, axis.devices))]


def gather(axis: Axis, shards: List[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Per-shard tensors → one tensor on the first shard's device,
    concatenated along ``dim``, on the caller's current stream there."""
    dev = axis.devices[0]
    dst = _current(dev)
    with torch.cuda.device(dev) if dst is not None else contextlib.nullcontext():
        return torch.cat([_copy(t, axis.stream(k), dev, dst) for k, t in enumerate(shards)],
                         dim=dim)


def shard_rows(mesh: Mesh, batch: int) -> List[slice]:
    """The rows of a batch each data shard renders; replaces the JAX
    package's ``batch_sharding``."""
    d = mesh.shape[DATA_AXIS]
    if batch % d:
        raise ValueError(f"batch {batch} not divisible by data axis {d}")
    b = batch // d
    return [slice(k * b, (k + 1) * b) for k in range(d)]


def check_mesh(device_mesh, device: torch.device) -> Mesh:
    """``device_mesh`` when it is a ``Mesh`` whose devices are of
    ``device``'s type; otherwise raise (an entry point's ``device`` and its
    mesh must not disagree about where it renders)."""
    if not isinstance(device_mesh, Mesh):
        raise TypeError(f"device_mesh must be a parallel.mesh.Mesh, got {type(device_mesh)}")
    kind = device_mesh.devices[0][0].type
    if kind != device.type:
        raise ValueError(f"device_mesh's devices are {kind}, device is {device}")
    return device_mesh


def make_mesh(data: Optional[int] = None, block: int = 1, devices=None) -> Mesh:
    """Build a ("data", "block") mesh over the given devices (default: every
    visible card, ``cuda:0 … cuda:k-1``; without a card that raises — the
    mesh never takes the CPU unless the caller names it)."""
    if devices is None:
        ensure_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if data is None:
        data = n // block
    if data * block != n:
        raise ValueError(f"mesh {data}x{block} != {n} devices")
    return Mesh([devices[i * block:(i + 1) * block] for i in range(data)])


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int) -> None:
    """Multi-process entry: a gloo process group over TCP (``host:port``).

    The cross-process leg exchanges host results only, so gloo serves the
    CPU and the card alike; each process drives its own local mesh.
    """
    import torch.distributed as dist

    dist.init_process_group(
        backend="gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
