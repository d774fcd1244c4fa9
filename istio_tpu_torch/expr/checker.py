"""Static type checking of expressions against an attribute manifest.

Role of the reference's EvalType walk (mixer/pkg/expr/expr.go:93-268) and
FuncMap (func.go:39-85): intrinsics EQ/NEQ/OR/LOR/LAND/INDEX plus extern
metadata; any other function name — including parsed-but-undefined
operators like QUO or NOT — is an "unknown function" error.
"""
from __future__ import annotations

import dataclasses

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.expr.exprs import Expression, FunctionCall


class TypeError_(ValueError):
    """Expression type-check failure (named to avoid shadowing builtins)."""


@dataclasses.dataclass(frozen=True)
class FunctionMetadata:
    name: str
    return_type: ValueType
    argument_types: tuple[ValueType, ...]
    instance: bool = False
    target_type: ValueType = ValueType.UNSPECIFIED


INTRINSICS = [
    FunctionMetadata("EQ", ValueType.BOOL,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    FunctionMetadata("NEQ", ValueType.BOOL,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    # ordered comparisons (reference expr/func.go LT/LEQ/GT/GEQ): both
    # operands the same type; ordering defined for numeric/string/
    # time-like values (oracle enforces at eval time)
    FunctionMetadata("LSS", ValueType.BOOL,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    FunctionMetadata("LEQ", ValueType.BOOL,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    FunctionMetadata("GTR", ValueType.BOOL,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    FunctionMetadata("GEQ", ValueType.BOOL,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    FunctionMetadata("OR", ValueType.UNSPECIFIED,
                     (ValueType.UNSPECIFIED, ValueType.UNSPECIFIED)),
    FunctionMetadata("LOR", ValueType.BOOL, (ValueType.BOOL, ValueType.BOOL)),
    FunctionMetadata("LAND", ValueType.BOOL, (ValueType.BOOL, ValueType.BOOL)),
    FunctionMetadata("INDEX", ValueType.STRING,
                     (ValueType.STRING_MAP, ValueType.STRING)),
]

# Extern type metadata (reference: mixer/pkg/il/runtime/externs.go:42-79).
EXTERN_METADATA = [
    FunctionMetadata("ip", ValueType.IP_ADDRESS, (ValueType.STRING,)),
    FunctionMetadata("timestamp", ValueType.TIMESTAMP, (ValueType.STRING,)),
    FunctionMetadata("match", ValueType.BOOL,
                     (ValueType.STRING, ValueType.STRING)),
    FunctionMetadata("matches", ValueType.BOOL, (ValueType.STRING,),
                     instance=True, target_type=ValueType.STRING),
    FunctionMetadata("startsWith", ValueType.BOOL, (ValueType.STRING,),
                     instance=True, target_type=ValueType.STRING),
    FunctionMetadata("endsWith", ValueType.BOOL, (ValueType.STRING,),
                     instance=True, target_type=ValueType.STRING),
]


def func_map(extra: list[FunctionMetadata] | None = None) -> dict[str, FunctionMetadata]:
    m = {f.name: f for f in INTRINSICS}
    for f in EXTERN_METADATA:
        m[f.name] = f
    for f in extra or []:
        m[f.name] = f
    return m


DEFAULT_FUNCS = func_map()


class AttributeDescriptorFinder:
    """Attribute vocabulary: name → declared ValueType
    (role of reference expr/finder.go NewFinder)."""

    def __init__(self, manifest: dict[str, ValueType]):
        self._manifest = dict(manifest)

    def get_attribute(self, name: str) -> ValueType | None:
        return self._manifest.get(name)

    def names(self) -> list[str]:
        return list(self._manifest)

    def merged_with(self, other: "AttributeDescriptorFinder") -> "AttributeDescriptorFinder":
        merged = dict(self._manifest)
        merged.update(other._manifest)
        return AttributeDescriptorFinder(merged)


def eval_type(e: Expression, attrs: AttributeDescriptorFinder,
              funcs: dict[str, FunctionMetadata] | None = None) -> ValueType:
    """Infer the expression's static type; raises TypeError_ on unknown
    attributes/functions or argument type mismatches (reference:
    Expression.EvalType expr.go:93, Function.EvalType :202-268)."""
    fmap = DEFAULT_FUNCS if funcs is None else funcs
    if e.const_ is not None:
        return e.const_.vtype
    if e.var is not None:
        vt = attrs.get_attribute(e.var.name)
        if vt is None:
            raise TypeError_(f"unknown attribute {e.var.name}")
        return vt
    assert e.fn is not None
    return _fn_eval_type(e.fn, attrs, fmap)


def _fn_eval_type(f: FunctionCall, attrs: AttributeDescriptorFinder,
                  fmap: dict[str, FunctionMetadata]) -> ValueType:
    meta = fmap.get(f.name)
    if meta is None:
        raise TypeError_(f"unknown function: {f.name}")

    tmpl_type = ValueType.UNSPECIFIED

    if f.target is not None:
        if not meta.instance:
            raise TypeError_(
                f"invoking regular function on instance method: {f.name}")
        target_type = eval_type(f.target, attrs, fmap)
        if meta.target_type == ValueType.UNSPECIFIED:
            tmpl_type = target_type
        elif target_type != meta.target_type:
            raise TypeError_(
                f"{f} target typeError got {target_type}, "
                f"expected {meta.target_type}")
    elif meta.instance:
        raise TypeError_(f"invoking instance method without an instance: {f.name}")

    # The reference only rejects too-few args (expr.go:234, excess-arg
    # check is a TODO at :259 and crashes later in extern reflection);
    # rejecting excess here keeps the error typed instead of crashing.
    if len(f.args) != len(meta.argument_types):
        raise TypeError_(
            f"{f} arity mismatch. Got {len(f.args)} arg(s), "
            f"expected {len(meta.argument_types)} arg(s)")

    for idx in range(min(len(f.args), len(meta.argument_types))):
        arg_type = eval_type(f.args[idx], attrs, fmap)
        expected = meta.argument_types[idx]
        if expected == ValueType.UNSPECIFIED:
            if tmpl_type == ValueType.UNSPECIFIED:
                tmpl_type = arg_type
                continue
            expected = tmpl_type
        if arg_type != expected:
            raise TypeError_(
                f"{f} arg {idx + 1} ({f.args[idx]}) typeError got "
                f"{arg_type}, expected {expected}")

    if meta.return_type == ValueType.UNSPECIFIED:
        return tmpl_type
    return meta.return_type
