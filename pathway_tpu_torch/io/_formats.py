"""Shared object-payload parsing for file-like connectors (fs, s3, minio,
gdrive-adjacent). One implementation of the reference's parser dispatch
(src/connectors/data_format.rs: DsvParser:522, JsonLinesParser:1630,
IdentityParser:894) over whole-object byte payloads.
"""

from __future__ import annotations

import csv as csv_mod
import io as io_mod
import json
from typing import Any, Dict, Iterator

from pathway_tpu_torch.internals import dtype as dt


def parse_csv_value(text, dtype: dt.DType):
    if text is None:
        return None
    core = dt.unoptionalize(dtype)
    try:
        if core is dt.INT:
            return int(text)
        if core is dt.FLOAT:
            return float(text)
        if core is dt.BOOL:
            return text.strip().lower() in ("true", "1", "yes", "on")
    except ValueError:
        return None
    return text


def coerce_json_value(v, dtype: dt.DType):
    core = dt.unoptionalize(dtype)
    if core is dt.JSON:
        from pathway_tpu_torch.engine.value import Json

        return Json(v)
    if core is dt.FLOAT and isinstance(v, int):
        return float(v)
    if isinstance(v, (dict, list)):
        from pathway_tpu_torch.engine.value import Json

        return Json(v)
    return v



def _comment_filter(lines, cs):
    """Drop comment lines, but never inside an open quoted field: quote
    parity tracks whether a record spans lines (doubled quotes cancel,
    keeping parity correct for the doublequote escape style)."""
    in_quote = False
    for ln in lines:
        if (
            not in_quote
            and cs.comment_character
            and ln.startswith(cs.comment_character)
        ):
            continue
        if cs.enable_quoting and cs.quote:
            if ln.count(cs.quote) % 2 == 1:
                in_quote = not in_quote
        yield ln


def build_csv_reader(lines, csv_settings):
    """DictReader honoring CsvParserSettings; plain reader when None.
    Shared by the fs and object-store connectors so the settings mean the
    same thing everywhere (reference: io/_utils.py CsvParserSettings)."""
    if csv_settings is None:
        return csv_mod.DictReader(lines)
    cs = csv_settings
    return csv_mod.DictReader(
        _comment_filter(lines, cs),
        delimiter=cs.delimiter,
        quotechar=cs.quote if cs.enable_quoting else None,
        escapechar=cs.escape,
        doublequote=cs.enable_double_quote_escapes,
        quoting=(
            csv_mod.QUOTE_MINIMAL if cs.enable_quoting else csv_mod.QUOTE_NONE
        ),
    )


def schema_defaults(schema) -> Dict[str, Any]:
    """{column: default_value} for columns declaring one — computed ONCE
    per parse, not per row (reference: test_io.py test_csv_default_values
    / test_json_default_values)."""
    return {
        name: schema[name].default_value
        for name in schema.keys()
        if getattr(schema[name], "has_default_value", False)
    }


def json_row(
    obj: dict, schema, names, field_paths, defaults
) -> Dict[str, Any]:
    """One parsed JSON document -> one row: schema projection, field-path
    extraction, then default filling. The SINGLE implementation shared by
    the fs and s3 connectors. A field path that resolves to nothing
    leaves the column ABSENT so its schema default (if any) applies."""
    row = {
        k: coerce_json_value(v, schema[k].dtype)
        for k, v in obj.items()
        if k in names
    }
    if field_paths:
        for col, path in field_paths.items():
            if col not in names:
                continue
            val = _json_pointer(obj, path)
            if val is None:
                row.pop(col, None)
            else:
                row[col] = coerce_json_value(val, schema[col].dtype)
    for k, dflt in defaults.items():
        if k not in row:
            row[k] = dflt
    return row


def _json_pointer(obj, path: str):
    """Minimal JSON-pointer resolution for json_field_paths ("/a/b")."""
    cur = obj
    for part in path.strip("/").split("/"):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
        if cur is None:
            return None
    return cur


def parse_object(
    payload: bytes, format: str, schema, csv_settings=None,
    json_field_paths=None,
) -> Iterator[Dict[str, Any]]:
    """Parse one object's bytes into rows.

    formats: binary (one row, raw bytes), plaintext (row per line),
    plaintext_by_object (one row, whole text), json/jsonlines (row per JSON
    line; ``json_field_paths`` maps columns to JSON pointers inside each
    document), csv (header row + DictReader).
    """
    if format == "binary":
        yield {"data": payload}
        return
    if format in ("plaintext", "plaintext_by_object", "plaintext_by_file"):
        text = payload.decode(errors="replace")
        if format == "plaintext":
            for line in text.splitlines():
                yield {"data": line}
        else:
            yield {"data": text}
        return
    if format in ("json", "jsonlines"):
        names = set(schema.keys())
        defaults = schema_defaults(schema)
        for line in payload.decode(errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            yield json_row(
                json.loads(line), schema, names, json_field_paths, defaults
            )
        return
    if format == "csv":
        names = set(schema.keys())
        defaults = schema_defaults(schema)
        reader = build_csv_reader(
            io_mod.StringIO(payload.decode(errors="replace")), csv_settings
        )
        for rec in reader:
            row = {
                k: parse_csv_value(v, schema[k].dtype)
                for k, v in rec.items()
                if k in names
            }
            for k, dflt in defaults.items():
                if k not in row:
                    row[k] = dflt
            yield row
        return
    raise ValueError(f"unknown format {format!r}")
