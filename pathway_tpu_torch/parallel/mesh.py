"""Device mesh management (counterpart of pathway_tpu/parallel/mesh.py).

The JAX package lays computation over a `jax.sharding.Mesh` held by one
process, and XLA runs each shard's work. The port keeps that
single-controller model: a `Mesh` is a grid of `torch.device`s with named
axes, one process drives every position, and a sharded computation is a
function over the list of per-position shards (parallel/collectives.py
holds the collectives between them). Data-parallel batch work goes on the
`dp` axis, tensor parallelism on `tp`, sequence parallelism on `sp`.

A grid may name one device more than once (`["cuda:0"] * 4` on one card,
`["cpu"] * 8` in the tests); a tensor moved to the device it is on is the
same tensor, so positions that share a device share their replicated
tensors. Nothing repeats a device unless the caller passes it so.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch


class PartitionSpec(tuple):
    """How a tensor's dims lie over a mesh's axes: one entry per dim, an
    axis name or None (replicated), as `jax.sharding.PartitionSpec`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _indexed(device: torch.device) -> torch.device:
    """A bare `cuda` as the device a tensor sent there reports (`cuda:N`)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a, b) -> bool:
    """Whether two device names mean one device (`cuda` is `cuda:N` for
    the current N)."""
    return _indexed(torch.device(a)) == _indexed(torch.device(b))


class Mesh:
    """An n-d grid of `torch.device`s with one name per axis.
    `mesh.shape[name]` is the axis size and `mesh.devices` the grid, as in
    JAX."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = _indexed(torch.device(dev))
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"mesh of shape {grid.shape} needs {grid.ndim} axis names, got {tuple(axis_names)}"
            )
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, **position) -> torch.device:
        """The device at a position given by axis name, e.g.
        ``mesh.device(dp=1, tp=0)``; an axis not named is at 0."""
        unknown = set(position) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh has no axis {sorted(unknown)}; its axes are {self.axis_names}")
        return self.devices[tuple(position.get(name, 0) for name in self.axis_names)]

    def axis_devices(self, axis_name: str) -> list:
        """The devices along `axis_name`, the other axes at 0."""
        return [self.device(**{axis_name: i}) for i in range(self.shape[axis_name])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def dp_axis(mesh: Mesh) -> str:
    """The mesh's data-parallel axis: `dp`, else its first axis (which may
    be `tp` too, as the JAX package's mesh backend takes it)."""
    return "dp" if "dp" in mesh.axis_names else mesh.axis_names[0]


class NamedSharding:
    """A PartitionSpec over a mesh, as `jax.sharding.NamedSharding`: at
    most one dim is sharded, over one axis."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        dims = [i for i, axis in enumerate(spec) if axis is not None]
        if len(dims) > 1:
            raise ValueError(f"{spec}: at most one dim may be sharded")
        self.mesh, self.spec = mesh, spec

    def shard(self, x) -> list:
        """`x` (a tensor or an array) cut along its sharded dim into the
        axis's equal blocks, block i on the device at position i of that
        axis (the other axes at 0), as `jax.device_put` lays it out. A
        replicated spec gives one block, on the mesh's first device."""
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        dims = [i for i, axis in enumerate(self.spec) if axis is not None]
        if not dims:
            return [x.to(self.mesh.devices.flat[0])]
        devices = self.mesh.axis_devices(self.spec[dims[0]])
        if x.shape[dims[0]] % len(devices):
            raise ValueError(
                f"dim {dims[0]} of size {x.shape[dims[0]]} does not split over the "
                f"{self.spec[dims[0]]!r} axis of size {len(devices)}"
            )
        return [b.to(dev) for b, dev in zip(x.chunk(len(devices), dims[0]), devices)]

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def local_device_count() -> int:
    """The CUDA devices this process sees."""
    return torch.cuda.device_count()


_active_mesh = None


def get_mesh(
    axis_shapes: Sequence[int] | None = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A Mesh over `devices` (default: every CUDA device; without one this
    raises, pass e.g. ``devices=["cpu"] * 8``). With no shapes, all devices
    land on the first axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "get_mesh: no CUDA device is available; pass devices= (e.g. "
                "devices=['cpu'] * 8) to lay a mesh over other devices"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    if axis_shapes is None:
        axis_shapes = [len(grid)] + [1] * (len(axis_names) - 1)
    return Mesh(grid.reshape(tuple(axis_shapes)), tuple(axis_names))


def held_mesh() -> Optional[Mesh]:
    """The mesh `with_mesh` holds, or None (unlike `default_mesh`, this
    builds none)."""
    return _active_mesh


def default_mesh() -> Mesh:
    global _active_mesh
    if _active_mesh is None:
        _active_mesh = get_mesh()
    return _active_mesh


@contextlib.contextmanager
def with_mesh(mesh: Mesh):
    global _active_mesh
    prev = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = prev
