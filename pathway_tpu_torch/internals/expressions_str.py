"""`.str` string expression namespace (reference:
python/pathway/internals/expressions/string.py).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... s
... Hello
... ''')
>>> r = t.select(up=pw.this.s.str.upper(), n=pw.this.s.str.len())
>>> pw.debug.compute_and_print(r, include_id=False)
up    | n
HELLO | 5

Parsing helpers return typed columns:

>>> t2 = pw.debug.table_from_markdown('''
... s
... 12
... ''')
>>> r2 = t2.select(v=t2.s.str.parse_int() + 1)
>>> pw.debug.compute_and_print(r2, include_id=False)
v
13
"""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import MethodCallExpression, smart_wrap


class StringNamespace:
    def __init__(self, expr):
        self._expr = smart_wrap(expr)

    def _call(self, name, fun, *args, return_type=None):
        return MethodCallExpression(
            f"str.{name}",
            self._expr,
            *(smart_wrap(a) for a in args),
            fun=fun,
            return_type=return_type,
        )

    def lower(self):
        return self._call("lower", lambda v: v.lower(), return_type=dt.STR)

    def upper(self):
        return self._call("upper", lambda v: v.upper(), return_type=dt.STR)

    def reversed(self):
        return self._call("reversed", lambda v: v[::-1], return_type=dt.STR)

    def len(self):
        return self._call("len", lambda v: len(v), return_type=dt.INT)

    def strip(self, chars=None):
        return self._call(
            "strip", lambda v, c: v.strip(c), chars, return_type=dt.STR
        )

    def lstrip(self, chars=None):
        return self._call(
            "lstrip", lambda v, c: v.lstrip(c), chars, return_type=dt.STR
        )

    def rstrip(self, chars=None):
        return self._call(
            "rstrip", lambda v, c: v.rstrip(c), chars, return_type=dt.STR
        )

    def count(self, sub, start=None, end=None):
        return self._call(
            "count",
            lambda v, s, b, e: v.count(s, b, e),
            sub,
            start,
            end,
            return_type=dt.INT,
        )

    def find(self, sub, start=None, end=None):
        return self._call(
            "find",
            lambda v, s, b, e: v.find(s, b, e),
            sub,
            start,
            end,
            return_type=dt.INT,
        )

    def rfind(self, sub, start=None, end=None):
        return self._call(
            "rfind",
            lambda v, s, b, e: v.rfind(s, b, e),
            sub,
            start,
            end,
            return_type=dt.INT,
        )

    def startswith(self, prefix):
        return self._call(
            "startswith", lambda v, p: v.startswith(p), prefix, return_type=dt.BOOL
        )

    def endswith(self, suffix):
        return self._call(
            "endswith", lambda v, s: v.endswith(s), suffix, return_type=dt.BOOL
        )

    def swapcase(self):
        return self._call("swapcase", lambda v: v.swapcase(), return_type=dt.STR)

    def title(self):
        return self._call("title", lambda v: v.title(), return_type=dt.STR)

    def replace(self, old, new, count=-1):
        return self._call(
            "replace",
            lambda v, o, n, c: v.replace(o, n, c),
            old,
            new,
            count,
            return_type=dt.STR,
        )

    def split(self, sep=None, maxsplit=-1):
        return self._call(
            "split",
            lambda v, s, m: tuple(v.split(s, m)),
            sep,
            maxsplit,
            return_type=dt.ListDType(dt.STR),
        )

    def slice(self, start, end):
        return self._call(
            "slice", lambda v, s, e: v[s:e], start, end, return_type=dt.STR
        )

    def parse_int(self, optional: bool = False):
        def fun(v):
            try:
                return int(v)
            except (TypeError, ValueError):
                if optional:
                    return None
                raise

        return self._call(
            "parse_int",
            fun,
            return_type=dt.Optionalize(dt.INT) if optional else dt.INT,
        )

    def parse_float(self, optional: bool = False):
        def fun(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                if optional:
                    return None
                raise

        return self._call(
            "parse_float",
            fun,
            return_type=dt.Optionalize(dt.FLOAT) if optional else dt.FLOAT,
        )

    def parse_bool(
        self,
        true_values=("on", "true", "yes", "1"),
        false_values=("off", "false", "no", "0"),
        optional: bool = False,
    ):
        true_set = {s.lower() for s in true_values}
        false_set = {s.lower() for s in false_values}

        def fun(v):
            lv = v.lower()
            if lv in true_set:
                return True
            if lv in false_set:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {v!r} as bool")

        return self._call(
            "parse_bool",
            fun,
            return_type=dt.Optionalize(dt.BOOL) if optional else dt.BOOL,
        )