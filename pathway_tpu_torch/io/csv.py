"""pw.io.csv — sugar over fs with csv format (reference: io/csv)."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path: str, *, schema=None, mode: str = "streaming", **kwargs):
    return fs.read(path, format="csv", schema=schema, mode=mode, **kwargs)


def write(table, filename: str, **kwargs) -> None:
    fs.write(table, filename, format="csv", **kwargs)
