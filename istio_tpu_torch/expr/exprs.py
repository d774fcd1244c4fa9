"""Expression AST — the simplified Const/Var/Fn tree.

Role of the reference's mixer/pkg/expr Expression (expr.go:78-118): all
operators are normalized to named functions (== -> EQ, && -> LAND, | -> OR,
[] -> INDEX, unary ! -> NOT ...), selector chains like ``a.b.c`` flatten to
single attribute names, and instance-method syntax ``s.startsWith("x")``
becomes a Function with a Target.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Union

from istio_tpu_torch.attribute.types import ValueType, format_go_duration

ConstValue = Union[str, int, float, bool, datetime.timedelta]


@dataclasses.dataclass
class Constant:
    str_value: str          # source text, for round-tripping
    vtype: ValueType
    value: ConstValue

    def __str__(self) -> str:
        return self.str_value


@dataclasses.dataclass
class Variable:
    name: str

    def __str__(self) -> str:
        return "$" + self.name


@dataclasses.dataclass
class FunctionCall:
    name: str
    args: list["Expression"]
    target: Optional["Expression"] = None   # instance-method receiver

    def __str__(self) -> str:
        inner = ", ".join(str(a) for a in self.args)
        prefix = f"{self.target}:" if self.target is not None else ""
        return f"{prefix}{self.name}({inner})"


@dataclasses.dataclass
class Expression:
    """Exactly one of const_/var/fn is set."""
    const_: Optional[Constant] = None
    var: Optional[Variable] = None
    fn: Optional[FunctionCall] = None

    def __str__(self) -> str:
        if self.const_ is not None:
            return str(self.const_)
        if self.var is not None:
            return str(self.var)
        if self.fn is not None:
            return str(self.fn)
        return "<nil>"


def const_expr(value: ConstValue, vtype: ValueType, text: str | None = None) -> Expression:
    if text is None:
        if isinstance(value, datetime.timedelta):
            text = f'"{format_go_duration(value)}"'
        elif isinstance(value, str):
            text = f'"{value}"'
        elif isinstance(value, bool):
            text = "true" if value else "false"
        else:
            text = str(value)
    return Expression(const_=Constant(str_value=text, vtype=vtype, value=value))


def var_expr(name: str) -> Expression:
    return Expression(var=Variable(name=name))


def fn_expr(name: str, *args: Expression, target: Expression | None = None) -> Expression:
    return Expression(fn=FunctionCall(name=name, args=list(args), target=target))
