"""pw.io.plaintext — lines of text files (reference: io/plaintext)."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path: str, *, mode: str = "streaming", **kwargs):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)


def write(table, filename: str, **kwargs) -> None:
    fs.write(table, filename, format="plaintext", **kwargs)
