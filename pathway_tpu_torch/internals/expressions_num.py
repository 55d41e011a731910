"""`.num` numerical expression namespace (reference:
python/pathway/internals/expressions/numerical.py).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... x
... -2.5
... ''')
>>> r = t.select(a=pw.this.x.num.abs(), c=pw.this.x.num.ceil())
>>> pw.debug.compute_and_print(r, include_id=False)
a   | c
2.5 | -2
"""

from __future__ import annotations

import math

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import MethodCallExpression, smart_wrap


class NumericalNamespace:
    def __init__(self, expr):
        self._expr = smart_wrap(expr)

    def _call(self, name, fun, *args, return_type=None, propagate_none=True):
        return MethodCallExpression(
            f"num.{name}",
            self._expr,
            *(smart_wrap(a) for a in args),
            fun=fun,
            return_type=return_type,
            propagate_none=propagate_none,
        )

    def abs(self):
        # preserves the input's numeric dtype (reference:
        # expressions/test_numerical.py test_abs_int/test_abs_float)
        def same_numeric(d):
            core = dt.unoptionalize(d)
            return core if core in (dt.INT, dt.FLOAT) else dt.FLOAT

        return self._call("abs", abs, return_type=same_numeric)

    def round(self, decimals=0):
        return self._call(
            "round", lambda v, d: round(v, d), decimals, return_type=dt.FLOAT
        )

    def fill_na(self, default_value):
        def fun(v, d):
            if v is None:
                return d
            if isinstance(v, float) and math.isnan(v):
                return d
            return v

        return self._call("fill_na", fun, default_value, propagate_none=False)

    def isnan(self):
        return self._call(
            "isnan",
            lambda v: isinstance(v, float) and math.isnan(v),
            return_type=dt.BOOL,
        )

    def isinf(self):
        return self._call(
            "isinf",
            lambda v: isinstance(v, float) and math.isinf(v),
            return_type=dt.BOOL,
        )

    def sqrt(self):
        return self._call("sqrt", math.sqrt, return_type=dt.FLOAT)

    def log(self, base=math.e):
        return self._call(
            "log", lambda v, b: math.log(v, b), base, return_type=dt.FLOAT
        )

    def exp(self):
        return self._call("exp", math.exp, return_type=dt.FLOAT)

    def sin(self):
        return self._call("sin", math.sin, return_type=dt.FLOAT)

    def cos(self):
        return self._call("cos", math.cos, return_type=dt.FLOAT)

    def tan(self):
        return self._call("tan", math.tan, return_type=dt.FLOAT)

    def floor(self):
        return self._call("floor", math.floor, return_type=dt.INT)

    def ceil(self):
        return self._call("ceil", math.ceil, return_type=dt.INT)

    def trunc(self):
        return self._call("trunc", math.trunc, return_type=dt.INT)