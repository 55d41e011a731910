"""pw.io.jsonlines — sugar over fs with jsonlines format (reference:
io/jsonlines)."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path: str, *, schema=None, mode: str = "streaming", **kwargs):
    return fs.read(path, format="json", schema=schema, mode=mode, **kwargs)


def write(table, filename: str, **kwargs) -> None:
    fs.write(table, filename, format="json", **kwargs)
