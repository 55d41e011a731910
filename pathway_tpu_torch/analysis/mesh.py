"""Mesh specification for the PWT4xx mesh-compatibility lints.

A mesh spec names the device axes a run intends to shard over — the same
("dp", "tp") vocabulary as `models/minilm.SentenceEncoder(mesh=...)` and
the pjit/NamedSharding recipes.  The analyzer does not need real devices:
the PWT402-405 lints are shape/topology arguments over the recorded
graph, so `pathway-tpu analyze --mesh dp=4,tp=2` works on a laptop and
`pw.run(mesh=...)` fails fast before any worker starts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple


@dataclass(frozen=True)
class MeshSpec:
    """Ordered (axis name, device count) pairs, e.g. dp=4,tp=2."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def parse(cls, spec: Any) -> "MeshSpec":
        """Accept a MeshSpec, a "dp=4,tp=2" string, or a name->count
        mapping.  Raises ValueError on anything else — pw.run(mesh=...)
        must reject a bad spec before building anything."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, Mapping):
            items = list(spec.items())
        elif isinstance(spec, str):
            items = []
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                name, eq, count = part.partition("=")
                if not eq:
                    raise ValueError(
                        f"mesh axis {part!r} is not name=count "
                        "(expected e.g. 'dp=4,tp=2')"
                    )
                items.append((name.strip(), count.strip()))
        else:
            raise ValueError(
                f"mesh spec must be a MeshSpec, 'dp=4,tp=2' string or "
                f"mapping, got {type(spec).__name__}"
            )
        axes = []
        for name, count in items:
            try:
                n = int(count)
            except (TypeError, ValueError):
                raise ValueError(
                    f"mesh axis {name!r} has non-integer device count "
                    f"{count!r}"
                ) from None
            if not name or n < 1:
                raise ValueError(
                    f"mesh axis {name!r}={n} must have a name and a "
                    "positive device count"
                )
            axes.append((name, n))
        if not axes:
            raise ValueError("mesh spec names no axes")
        return cls(axes=tuple(axes))

    @property
    def dp(self) -> int:
        return self.axis("dp")

    @property
    def tp(self) -> int:
        return self.axis("tp")

    def axis(self, name: str) -> int:
        for axis, count in self.axes:
            if axis == name:
                return count
        return 1

    def devices(self) -> int:
        n = 1
        for _axis, count in self.axes:
            n *= count
        return n

    def describe(self) -> str:
        return ",".join(f"{name}={count}" for name, count in self.axes)

    def to_dict(self) -> Dict[str, int]:
        return dict(self.axes)
