"""Device mesh + sharding helpers (counterpart of pathway_tpu/parallel):
a single-controller mesh over `torch.device`s, collectives over lists of
shards, and ring / Ulysses sequence parallelism."""

from pathway_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    default_mesh,
    get_mesh,
    held_mesh,
    local_device_count,
    with_mesh,
)
from pathway_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "default_mesh",
    "get_mesh",
    "held_mesh",
    "local_device_count",
    "with_mesh",
    "ring_attention",
    "ulysses_attention",
]
