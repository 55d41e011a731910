"""Pretty-printing of expression trees for error messages (reference:
python/pathway/internals/expression_printer.py:19)."""

from __future__ import annotations


def print_expression(expr) -> str:
    from pathway_tpu_torch.internals import expression as ex

    if isinstance(expr, ex.ColumnConstExpression):
        return repr(expr._value)
    if isinstance(expr, ex.IdReference):
        return f"<table>.id"
    if isinstance(expr, ex.ColumnReference):
        return f"<table>.{expr._name}"
    if isinstance(expr, ex.ThisColumnReference):
        return f"{expr._this.__name__}.{expr._name}"
    if isinstance(expr, ex.BinaryOpExpression):
        return (
            f"({print_expression(expr._left)} {expr._op} "
            f"{print_expression(expr._right)})"
        )
    if isinstance(expr, ex.UnaryOpExpression):
        return f"{expr._op}({print_expression(expr._arg)})"
    if isinstance(expr, ex.IfElseExpression):
        return (
            f"if_else({print_expression(expr._if)}, "
            f"{print_expression(expr._then)}, {print_expression(expr._else)})"
        )
    if isinstance(expr, ex.ApplyExpression):
        args = ", ".join(print_expression(a) for a in expr._args)
        return f"apply({getattr(expr._fun, '__name__', 'fun')}, {args})"
    if isinstance(expr, ex.ReducerExpression):
        args = ", ".join(print_expression(a) for a in expr._args)
        return f"{expr._reducer.name}({args})"
    if isinstance(expr, ex.MethodCallExpression):
        args = ", ".join(print_expression(a) for a in expr._args)
        return f"{expr._method}({args})"
    if isinstance(expr, ex.CastExpression):
        return f"cast({expr._target}, {print_expression(expr._expr)})"
    if isinstance(expr, ex.ConvertExpression):
        return f"convert({expr._target}, {print_expression(expr._expr)})"
    if isinstance(expr, ex.CoalesceExpression):
        args = ", ".join(print_expression(a) for a in expr._args)
        return f"coalesce({args})"
    if isinstance(expr, ex.IsNoneExpression):
        return f"is_none({print_expression(expr._arg)})"
    if isinstance(expr, ex.UnwrapExpression):
        return f"unwrap({print_expression(expr._expr)})"
    if isinstance(expr, ex.MakeTupleExpression):
        args = ", ".join(print_expression(a) for a in expr._args)
        return f"make_tuple({args})"
    if isinstance(expr, ex.GetExpression):
        return (
            f"{print_expression(expr._obj)}"
            f"[{print_expression(expr._index)}]"
        )
    return f"<{type(expr).__name__}>"
