"""`pw.this`, `pw.left`, `pw.right` deferred references (reference:
python/pathway/internals/thisclass.py). They are placeholders resolved to a
concrete table during desugaring (see desugaring.py).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... a | b
... 1 | 2
... ''')
>>> pw.debug.compute_and_print(
...     t.select(s=pw.this.a + pw.this.b), include_id=False
... )
s
3
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import PointerExpression, ThisColumnReference

KEY_ID = "id"


class ThisMetaclass(type):
    def __getattr__(cls, name: str):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return ThisColumnReference(cls, name)

    def __getitem__(cls, name):
        if isinstance(name, str):
            return ThisColumnReference(cls, name)
        if isinstance(name, ThisColumnReference):
            return name
        if isinstance(name, (list, tuple)):
            return _ThisSlice(cls, [cls[n] for n in name])
        raise TypeError(f"cannot index this with {name!r}")

    def pointer_from(cls, *args, optional: bool = False, instance=None):
        return PointerExpression(cls, *args, optional=optional, instance=instance)

    def without(cls, *columns):
        return _ThisWithout(cls, columns)

    def __iter__(cls):
        # `select(*pw.this)` — expands to every context column at
        # desugar time (reference: test_common.py test_wildcard_basic)
        yield _ThisAll(cls)

    def __repr__(cls):
        return f"<{cls.__name__}>"


class this(metaclass=ThisMetaclass):
    """`pw.this` — the table a method is invoked on."""


class left(metaclass=ThisMetaclass):
    """`pw.left` — the left side of a join."""


class right(metaclass=ThisMetaclass):
    """`pw.right` — the right side of a join."""


class _ThisAll:
    """`*pw.this` used as a select argument — all context columns."""

    def __init__(self, this_cls):
        self.this_cls = this_cls


class _ThisWithout:
    """`pw.this.without(col, ...)` used as a select argument."""

    def __init__(self, this_cls, columns):
        self.this_cls = this_cls
        self.columns = [c if isinstance(c, str) else c.name for c in columns]

    def __iter__(self):
        # `select(*pw.this.without(...))` — the marker itself expands
        yield self

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self.columns:
            raise KeyError(
                f"column {name!r} was removed by without()"
            )
        return ThisColumnReference(self.this_cls, name)


class _ThisSlice:
    def __init__(self, this_cls, refs):
        self.this_cls = this_cls
        self.refs = refs

    def __iter__(self):
        yield self

    def without(self, *columns):
        drop = {c if isinstance(c, str) else c.name for c in columns}
        return _ThisSlice(
            self.this_cls,
            [r for r in self.refs if r._name not in drop],
        )


def is_this_ref(expr: Any) -> bool:
    return isinstance(expr, ThisColumnReference)
