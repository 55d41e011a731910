"""Collectives over a mesh axis, for the port's single-controller mesh.

The JAX package's sharded bodies run inside `shard_map`, and their
collectives are XLA's (`lax.psum`, `all_gather`, `ppermute`,
`all_to_all`, `axis_index`). Here a body runs over the list of its
shards, one tensor per position along the axis, each on its position's
device, and these functions take and return such lists. They are built
from `.to(device)`, `torch.cat` and sums, so autograd differentiates
through them: a gradient reaching a gathered or summed shard flows back to
every shard it came from.

Where positions share a device (a grid that repeats one), the value every
position receives alike (`psum`, `all_gather`) is computed once for that
device and the positions get the same tensor.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _once_per_device(devices: Sequence[torch.device], make: Callable) -> list:
    made: dict = {}
    for dev in devices:
        if dev not in made:
            made[dev] = make(dev)
    return [made[dev] for dev in devices]


def axis_index(xs: Sequence[torch.Tensor]) -> list:
    """Each position's index along the axis."""
    return list(range(len(xs)))


def psum(xs: Sequence[torch.Tensor]) -> list:
    """The sum of every position's tensor, on each position's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return _once_per_device([x.device for x in xs], total.to)


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0) -> list:
    """Every position's tensor concatenated along `axis` in position order
    (JAX's `all_gather(..., tiled=True)`), on each position's device."""
    return _once_per_device(
        [x.device for x in xs], lambda dev: torch.cat([x.to(dev) for x in xs], dim=axis)
    )


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple]) -> list:
    """Position `dst` receives position `src`'s tensor for each (src, dst)
    pair of `perm`; a position that receives nothing gets zeros."""
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if y is None else y for x, y in zip(xs, out)]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> list:
    """Each position splits its tensor into len(xs) equal blocks along
    `split_axis` and sends block j to position j, which concatenates what
    it receives along `concat_axis` in position order (JAX's
    `all_to_all(..., tiled=True)`)."""
    n = len(xs)
    if xs[0].shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dim {split_axis} of size {xs[0].shape[split_axis]} does not split "
            f"into {n} blocks"
        )
    blocks = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [
        torch.cat([blocks[i][j].to(xs[j].device) for i in range(n)], dim=concat_axis)
        for j in range(n)
    ]
