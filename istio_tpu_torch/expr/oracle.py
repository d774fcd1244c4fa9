"""Oracle interpreter — the host-side semantics reference.

This is the behavioral twin of the reference's IL compiler + stack-VM
interpreter (mixer/pkg/il/compiler/compiler.go + interpreter/
interpreterRun.go), implemented as a direct AST walk. It is the contract
the tensor compiler is conformance-tested against, and the fallback
engine for expressions the tensor compiler cannot lower.

Semantics reproduced exactly (see compiler.go codegen):
  * attribute resolution failure is a runtime error
    "lookup failed: '<name>'" (interpreterRun.got:396-463);
  * map-key miss is "member lookup failed: '<key>'" (:760-785);
  * `a | b` (OR) evaluates its left side in "soft" mode: attribute
    absence or map-key miss falls through to the right side
    (nilMode nmJmpOnValue, compiler.go:102-117, generateOr :459+);
    soft mode reaches only Var / INDEX / nested-OR positions — any other
    function produces a definite value or a hard error;
  * `&&` / `||` short-circuit (generateLand :373, generateLor :354) — a
    suppressed right side is never evaluated, so its errors never fire;
  * EQ on IP_ADDRESS uses net.IP-style equality and on TIMESTAMP uses
    instant equality (generateEq compiler.go:334-341 Interface case);
  * NEQ is !EQ (:347).
"""
from __future__ import annotations

import datetime
from typing import Any, Mapping

from istio_tpu_torch.attribute.bag import Bag, DictBag, TrackingBag
from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder, DEFAULT_FUNCS,
                                    FunctionMetadata, eval_type)
from istio_tpu_torch.expr.exprs import Expression, FunctionCall
from istio_tpu_torch.expr.externs import (EXTERNS, ExternError, extern_ip_equal,
                                    extern_timestamp_equal)
from istio_tpu_torch.expr.parser import parse


class EvalError(ValueError):
    """Runtime evaluation error (lookup failure, extern failure)."""


class _Absent(Exception):
    """Internal signal: soft-mode resolution produced no value."""


class OracleProgram:
    """A parsed + type-checked expression bound to a manifest — the
    oracle analog of a compiled IL program."""

    def __init__(self, text: str, finder: AttributeDescriptorFinder,
                 funcs: dict[str, FunctionMetadata] | None = None):
        self.text = text
        self.finder = finder
        self.funcs = DEFAULT_FUNCS if funcs is None else funcs
        self.ast = parse(text)
        self.result_type = eval_type(self.ast, finder, self.funcs)

    @classmethod
    def from_ast(cls, ast, finder: AttributeDescriptorFinder
                 ) -> "OracleProgram":
        """Bind an already-parsed expression (e.g. a compiled ruleset's
        retained atom AST — the disassembler/stepper path)."""
        prog = cls.__new__(cls)
        prog.text = str(ast)
        prog.finder = finder
        prog.funcs = DEFAULT_FUNCS
        prog.ast = ast
        prog.result_type = eval_type(ast, finder, DEFAULT_FUNCS)
        return prog

    # --- public API (role of il/interpreter Interpreter.Eval) ---

    def evaluate(self, bag: Bag) -> Any:
        return self._eval(self.ast, bag)

    def evaluate_with_tracking(self, bag: Bag) -> tuple[Any, TrackingBag]:
        tb = TrackingBag(bag)
        return self._eval(self.ast, tb), tb

    # --- evaluation ---

    def _eval(self, e: Expression, bag: Bag) -> Any:
        if e.const_ is not None:
            return e.const_.value
        if e.var is not None:
            v, ok = bag.get(e.var.name)
            if not ok:
                raise EvalError(f"lookup failed: '{e.var.name}'")
            return v
        assert e.fn is not None
        return self._eval_fn(e.fn, bag)

    def _eval_soft(self, e: Expression, bag: Bag) -> Any:
        """nmJmpOnValue evaluation: raises _Absent instead of a lookup
        error, but only for Var / INDEX / OR shapes; everything else is
        evaluated hard (mirrors which codegen paths honor nilMode)."""
        if e.var is not None:
            v, ok = bag.get(e.var.name)
            if not ok:
                raise _Absent()
            return v
        if e.fn is not None and e.fn.name == "INDEX":
            return self._eval_index(e.fn, bag, soft=True)
        if e.fn is not None and e.fn.name == "OR":
            return self._eval_or(e.fn, bag, soft=True)
        return self._eval(e, bag)

    def _eval_fn(self, f: FunctionCall, bag: Bag) -> Any:
        name = f.name
        if name == "EQ":
            return self._equals(f, bag)
        if name == "NEQ":
            return not self._equals(f, bag)
        if name == "LAND":
            for arg in f.args:
                if not self._eval(arg, bag):
                    return False
            return True
        if name == "LOR":
            for arg in f.args:
                if self._eval(arg, bag):
                    return True
            return False
        if name == "OR":
            return self._eval_or(f, bag, soft=False)
        if name == "INDEX":
            return self._eval_index(f, bag, soft=False)
        if name == "NOT":
            return not self._eval(f.args[0], bag)
        if name in ("LSS", "LEQ", "GTR", "GEQ"):
            return self._ordered(name, f, bag)
        return self._eval_extern(f, bag)

    def _ordered(self, name: str, f: FunctionCall, bag: Bag) -> bool:
        a = self._eval(f.args[0], bag)
        b = self._eval(f.args[1], bag)
        for v in (a, b):
            if not isinstance(v, (int, float, str, datetime.datetime,
                                  datetime.timedelta)) or \
                    isinstance(v, bool):
                raise EvalError(
                    f"unordered operand for {name}: {type(v).__name__}")
        try:
            if name == "LSS":
                return a < b
            if name == "LEQ":
                return a <= b
            if name == "GTR":
                return a > b
            return a >= b
        except TypeError as exc:   # mixed runtime types (bags are untyped)
            raise EvalError(f"unordered operands for {name}: "
                            f"{type(a).__name__} vs {type(b).__name__}"
                            ) from exc

    def _eval_or(self, f: FunctionCall, bag: Bag, soft: bool) -> Any:
        try:
            return self._eval_soft(f.args[0], bag)
        except _Absent:
            pass
        if soft:
            return self._eval_soft(f.args[1], bag)
        return self._eval(f.args[1], bag)

    def _eval_index(self, f: FunctionCall, bag: Bag, soft: bool) -> Any:
        if soft:
            target = self._eval_soft(f.args[0], bag)  # _Absent propagates
            key = self._eval_soft(f.args[1], bag)
        else:
            target = self._eval(f.args[0], bag)
            key = self._eval(f.args[1], bag)
        if not isinstance(key, str):
            raise EvalError(f"error converting value to string: '{key}'")
        found = isinstance(target, Mapping) and key in target
        if isinstance(bag, TrackingBag) and f.args[0].var is not None:
            bag.track_map_key(f.args[0].var.name, key, found)
        if not found:
            if soft:
                raise _Absent()
            raise EvalError(f"member lookup failed: '{key}'")
        return target[key]

    def _equals(self, f: FunctionCall, bag: Bag) -> bool:
        a = self._eval(f.args[0], bag)
        b = self._eval(f.args[1], bag)
        if isinstance(a, bytes) and isinstance(b, bytes):
            return extern_ip_equal(a, b)
        if isinstance(a, datetime.datetime) and isinstance(b, datetime.datetime):
            return extern_timestamp_equal(a, b)
        return a == b

    def _eval_extern(self, f: FunctionCall, bag: Bag) -> Any:
        fn = EXTERNS.get(f.name)
        if fn is None:
            raise EvalError(f"unknown function: {f.name}")
        args: list[Any] = []
        if f.target is not None:
            args.append(self._eval(f.target, bag))
        for arg in f.args:
            args.append(self._eval(arg, bag))
        try:
            return fn(*args)
        except ExternError as exc:
            raise EvalError(str(exc)) from exc


class OracleEvaluator:
    """Caching expression evaluator — role of the reference's IL
    evaluator (mixer/pkg/il/evaluator/evaluator.go:53-185): an LRU of
    compiled programs keyed by expression text, invalidated when the
    attribute vocabulary changes."""

    def __init__(self, finder: AttributeDescriptorFinder, cache_size: int = 4096):
        from istio_tpu_torch.utils.cache import LRUCache
        self._finder = finder
        self._cache = LRUCache(cache_size)

    def change_vocabulary(self, finder: AttributeDescriptorFinder) -> None:
        self._finder = finder
        self._cache.clear()

    def _program(self, text: str) -> OracleProgram:
        prog = self._cache.get(text)
        if prog is None:
            prog = OracleProgram(text, self._finder)
            self._cache.set(text, prog)
        return prog

    def eval(self, text: str, bag: Bag) -> Any:
        return self._program(text).evaluate(bag)

    def eval_string(self, text: str, bag: Bag) -> str:
        v = self.eval(text, bag)
        if not isinstance(v, str):
            raise EvalError(f"expression '{text}' evaluated to {type(v).__name__}, "
                            "expected string")
        return v

    def eval_predicate(self, text: str, bag: Bag) -> bool:
        v = self.eval(text, bag)
        if not isinstance(v, bool):
            raise EvalError(f"expression '{text}' evaluated to {type(v).__name__}, "
                            "expected boolean")
        return v


def evaluate(text: str, values: Mapping[str, Any],
             manifest: dict[str, ValueType]) -> Any:
    """One-shot convenience: parse, check, evaluate over a dict."""
    prog = OracleProgram(text, AttributeDescriptorFinder(manifest))
    return prog.evaluate(DictBag(values))
