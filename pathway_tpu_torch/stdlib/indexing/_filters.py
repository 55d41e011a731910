"""Metadata filtering for index queries.

The reference filters candidates with JMESPath expressions
(src/external_integration/mod.rs IndexDerivedImpl — jmespath crate). We use
the python `jmespath` package when available and otherwise fall back to a
small evaluator covering the subset the LLM xpack emits
(`field == 'value'`, `contains(path, 'x')`, &&/||, globmatch)."""

from __future__ import annotations

import fnmatch
import re
from typing import Any

try:
    import jmespath as _jmespath
except ImportError:  # pragma: no cover
    _jmespath = None


def evaluate_filter(filter_expr: str, metadata: Any) -> bool:
    from pathway_tpu_torch.engine.value import Json

    if filter_expr is None:
        return True
    if isinstance(metadata, Json):
        metadata = metadata.value
    if metadata is None:
        metadata = {}
    if _jmespath is not None:
        try:
            return bool(_jmespath.search(filter_expr, metadata))
        except Exception:  # noqa: BLE001
            return False
    return bool(_mini_eval(filter_expr, metadata))


_TOKEN = re.compile(
    r"\s*(&&|\|\||==|!=|>=|<=|>|<|\(|\)|`[^`]*`|'[^']*'|\"[^\"]*\""
    r"|[A-Za-z_][A-Za-z0-9_.]*\([^()]*\)|[A-Za-z_][A-Za-z0-9_.]*|-?\d+\.?\d*)"
)


def _mini_eval(expr: str, metadata: dict) -> Any:
    tokens = _TOKEN.findall(expr)
    pos = [0]

    def parse_or():
        left = parse_and()
        while pos[0] < len(tokens) and tokens[pos[0]] == "||":
            pos[0] += 1
            right = parse_and()
            left = bool(left) or bool(right)
        return left

    def parse_and():
        left = parse_cmp()
        while pos[0] < len(tokens) and tokens[pos[0]] == "&&":
            pos[0] += 1
            right = parse_cmp()
            left = bool(left) and bool(right)
        return left

    def parse_cmp():
        left = parse_atom()
        if pos[0] < len(tokens) and tokens[pos[0]] in (
            "==",
            "!=",
            ">",
            "<",
            ">=",
            "<=",
        ):
            op = tokens[pos[0]]
            pos[0] += 1
            right = parse_atom()
            try:
                if op == "==":
                    return left == right
                if op == "!=":
                    return left != right
                if op == ">":
                    return left > right
                if op == "<":
                    return left < right
                if op == ">=":
                    return left >= right
                if op == "<=":
                    return left <= right
            except TypeError:
                return False
        return left

    def parse_atom():
        tok = tokens[pos[0]]
        pos[0] += 1
        if tok == "(":
            v = parse_or()
            if pos[0] < len(tokens) and tokens[pos[0]] == ")":
                pos[0] += 1
            return v
        if tok.startswith(("`", "'", '"')):
            inner = tok[1:-1]
            try:
                import json

                return json.loads(inner)
            except Exception:  # noqa: BLE001
                return inner
        if re.fullmatch(r"-?\d+", tok):
            return int(tok)
        if re.fullmatch(r"-?\d+\.\d*", tok):
            return float(tok)
        call = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_.]*)\((.*)\)", tok)
        if call:
            fname, argstr = call.group(1), call.group(2)
            args = [a.strip() for a in argstr.split(",")] if argstr else []
            vals = [_atom_value(a, metadata) for a in args]
            if fname == "contains" and len(vals) == 2:
                try:
                    return vals[1] in vals[0]
                except TypeError:
                    return False
            if fname == "globmatch" and len(vals) == 2:
                return fnmatch.fnmatch(str(vals[1]), str(vals[0]))
            if fname == "to_string" and len(vals) == 1:
                return str(vals[0])
            return False
        return _lookup_path(tok, metadata)

    try:
        return parse_or()
    except (IndexError, ValueError):
        return False


def _atom_value(text: str, metadata: dict):
    text = text.strip()
    if text.startswith(("`", "'", '"')) and len(text) >= 2:
        inner = text[1:-1]
        try:
            import json

            return json.loads(inner)
        except Exception:  # noqa: BLE001
            return inner
    if re.fullmatch(r"-?\d+", text):
        return int(text)
    if re.fullmatch(r"-?\d+\.\d*", text):
        return float(text)
    return _lookup_path(text, metadata)


def _lookup_path(path: str, metadata: Any):
    cur = metadata
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur
