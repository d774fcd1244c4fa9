"""A Rego-subset evaluator for the opa adapter.

Reference: mixer/adapter/opa embeds the full OPA engine
(opa.go:84-142: compile policy modules, evaluate `checkMethod` over an
`input` document). Embedding OPA is out of scope here; this module
implements the Rego subset the reference's own policy corpus
(opa_test.go:180-340) exercises, natively:

  * `package` / `import data.<pkg>` (import alias binding)
  * complete rules `name = value { body }`, `name { body }` (value
    true), `default name = value`, constants `name = literal`
  * bodies: conjunctions of expressions, `;` or newline separated,
    `#` comments
  * unification `a = b` with variable binding, element-wise over
    arrays/objects
  * references `input.a.b`, `data.pkg.rule`, `obj[key]`,
    `arr[_]` (existential iteration), `arr[i]`/`obj[var]` (binding
    iteration), chained `policy[_].rule`
  * negation-as-failure `not expr`
  * builtins: trim(s, cutset, out), split(s, sep, out),
    concat(sep, arr, out), lower/upper(s, out), startswith/endswith/
    contains(s, x), count(x, out), plus `=` itself

Evaluation is top-down with backtracking over generator-yielded
binding environments; rule dependencies memoize per query with a
cycle guard, and complete-rule definitions that succeed with
disagreeing values raise eval_conflict_error (OPA semantics — the
opa adapter turns that into a fail-closed deny). Enough to run the
reference's service-graph/org-chart/bucket-admin policies
byte-for-byte.

Port of istio_tpu/adapters/rego.py: host code (standard library only),
the reference's own.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterator, Mapping

__all__ = ["RegoError", "RegoEngine", "parse_module"]


class RegoError(ValueError):
    pass


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Var:
    name: str


@dataclasses.dataclass(frozen=True)
class Wildcard:
    pass


@dataclasses.dataclass(frozen=True)
class Ref:
    """base.path[0].path[1]... — each element a str key, int index,
    Var, Wildcard, or Scalar from a bracket."""
    base: str
    path: tuple


@dataclasses.dataclass(frozen=True)
class ArrayT:
    items: tuple


@dataclasses.dataclass(frozen=True)
class ObjectT:
    items: tuple          # ((key_term, value_term), ...)


@dataclasses.dataclass(frozen=True)
class SetT:
    items: tuple


@dataclasses.dataclass(frozen=True)
class Call:
    name: str
    args: tuple


@dataclasses.dataclass(frozen=True)
class Unify:
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class NotExpr:
    expr: Any


@dataclasses.dataclass(frozen=True)
class RuleDef:
    name: str
    value: Any            # head value term (True for `name { body }`)
    body: tuple           # expressions; () for constants
    default: bool = False


@dataclasses.dataclass
class Module:
    package: str
    imports: dict         # alias → data path ("service_graph" → pkg)
    rules: dict           # name → [RuleDef]


# ---------------------------------------------------------------------------
# tokenizer / parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>\{|\}|\[|\]|\(|\)|,|;|:=|:|=|\.)
""", re.VERBOSE)


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            raise RegoError(f"rego_parse_error: no match found at "
                            f"{src[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> None:
        kind, v = self.next()
        if v != value:
            raise RegoError(f"rego_parse_error: expected {value!r}, "
                            f"got {v!r}")

    def at(self, value: str) -> bool:
        return self.peek()[1] == value

    # -- module --

    def module(self) -> Module:
        self.expect("package")
        package = self._dotted_name()
        imports: dict[str, str] = {}
        rules: dict[str, list[RuleDef]] = {}
        while not self.at(""):
            if self.at("import"):
                self.next()
                path = self._dotted_name()
                parts = path.split(".")
                if parts[0] != "data":
                    raise RegoError("only `import data.<pkg>` supported")
                imports[parts[-1]] = ".".join(parts[1:])
                continue
            rule = self._rule()
            rules.setdefault(rule.name, []).append(rule)
        return Module(package=package, imports=imports, rules=rules)

    def _dotted_name(self) -> str:
        kind, v = self.next()
        if kind != "ident":
            raise RegoError(f"rego_parse_error: expected name, got {v!r}")
        parts = [v]
        while self.at("."):
            self.next()
            kind, v = self.next()
            if kind != "ident":
                raise RegoError("rego_parse_error: bad dotted name")
            parts.append(v)
        return ".".join(parts)

    def _rule(self) -> RuleDef:
        default = False
        if self.at("default"):
            self.next()
            default = True
        kind, name = self.next()
        if kind != "ident":
            raise RegoError(f"rego_parse_error: expected rule name, "
                            f"got {name!r}")
        value: Any = True
        body: tuple = ()
        if self.at("=") or self.at(":="):
            self.next()
            value = self._term()
        if self.at("{"):
            self.next()
            body = tuple(self._body())
            self.expect("}")
        if default and body:
            raise RegoError("default rules cannot have bodies")
        return RuleDef(name=name, value=value, body=body, default=default)

    def _body(self) -> list:
        exprs = []
        while not self.at("}"):
            exprs.append(self._expr())
            if self.at(";"):
                self.next()
        return exprs

    def _expr(self) -> Any:
        if self.at("not"):
            self.next()
            return NotExpr(self._expr())
        left = self._term()
        if self.at("=") or self.at(":="):
            self.next()
            right = self._term()
            return Unify(left, right)
        return left

    def _term(self) -> Any:
        kind, v = self.peek()
        if kind == "string":
            self.next()
            return _unquote(v)
        if kind == "number":
            self.next()
            return float(v) if "." in v else int(v)
        if v == "[":
            self.next()
            items = []
            while not self.at("]"):
                items.append(self._term())
                if self.at(","):
                    self.next()     # trailing comma allowed
            self.expect("]")
            return ArrayT(tuple(items))
        if v == "{":
            return self._object_or_set()
        if kind == "ident":
            return self._ref_or_call()
        raise RegoError(f"rego_parse_error: unexpected {v!r}")

    def _object_or_set(self) -> Any:
        self.expect("{")
        if self.at("}"):
            self.next()
            return ObjectT(())
        first = self._term()
        if self.at(":"):
            self.next()
            items = [(first, self._term())]
            while self.at(","):
                self.next()
                if self.at("}"):
                    break           # trailing comma
                k = self._term()
                self.expect(":")
                items.append((k, self._term()))
            self.expect("}")
            return ObjectT(tuple(items))
        items = [first]
        while self.at(","):
            self.next()
            if self.at("}"):
                break               # trailing comma
            items.append(self._term())
        self.expect("}")
        return SetT(tuple(items))

    def _ref_or_call(self) -> Any:
        kind, name = self.next()
        if name == "true":
            return True
        if name == "false":
            return False
        if name == "null":
            return None
        if self.at("("):
            self.next()
            args = []
            while not self.at(")"):
                args.append(self._term())
                if self.at(","):
                    self.next()
            self.expect(")")
            return Call(name, tuple(args))
        path: list = []
        while True:
            if self.at("."):
                self.next()
                kind, key = self.next()
                if kind != "ident":
                    raise RegoError("rego_parse_error: bad ref key")
                path.append(key)
            elif self.at("["):
                self.next()
                if self.peek() == ("ident", "_"):
                    self.next()
                    path.append(Wildcard())
                else:
                    inner = self._term()
                    path.append(inner if isinstance(
                        inner, (Var, Ref, str, int, float)) else inner)
                self.expect("]")
            else:
                break
        if not path and name not in ("input", "data"):
            return Var(name)
        return Ref(base=name, path=tuple(path))


def _unquote(s: str) -> str:
    return s[1:-1].replace('\\"', '"').replace("\\\\", "\\").replace(
        "\\n", "\n").replace("\\t", "\t")


def parse_module(src: str) -> Module:
    p = _Parser(_tokenize(src))
    mod = p.module()
    if not p.at(""):
        raise RegoError("rego_parse_error: trailing tokens")
    return mod


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

_BUILTINS_OUT = {
    "trim": lambda s, cutset: s.strip(cutset),
    "split": lambda s, sep: list(s.split(sep)),
    "concat": lambda sep, arr: sep.join(arr),
    "lower": lambda s: s.lower(),
    "upper": lambda s: s.upper(),
    "count": lambda x: len(x),
}
_BUILTINS_BOOL = {
    "startswith": lambda s, p: s.startswith(p),
    "endswith": lambda s, p: s.endswith(p),
    "contains": lambda s, x: x in s,
}


class _Env(dict):
    """Binding environment; child() shares nothing (cheap copies —
    bodies are short)."""

    def child(self) -> "_Env":
        e = _Env(self)
        return e


class _QueryState:
    """Per-query evaluation state threaded through the evaluator in
    place of the bare `seen` frozenset: the cycle-guard set (immutable,
    grows down the call tree) plus the rule-value memo (shared across
    the whole query, never across queries/threads)."""

    __slots__ = ("seen", "memo")

    def __init__(self, seen: frozenset = frozenset(),
                 memo: dict | None = None):
        self.seen = seen
        self.memo: dict = {} if memo is None else memo

    def __contains__(self, key) -> bool:
        return key in self.seen

    def __or__(self, keys) -> "_QueryState":
        return _QueryState(self.seen | keys, self.memo)


class RegoEngine:
    """Compiled policy set: modules indexed by package path."""

    def __init__(self, sources: list[str]):
        self.modules: dict[str, Module] = {}
        for src in sources:
            if not src.strip():
                raise RegoError("empty policy module")
            mod = parse_module(src)
            if mod.package in self.modules:
                # merge rules of same package
                existing = self.modules[mod.package]
                for name, defs in mod.rules.items():
                    existing.rules.setdefault(name, []).extend(defs)
                existing.imports.update(mod.imports)
            else:
                self.modules[mod.package] = mod

    # -- public query --

    def query(self, method: str, input_doc: Mapping[str, Any]) -> Any:
        """Evaluate e.g. "data.mixerauthz.allow" against `input`.
        Returns the rule value (False from a default if no body
        succeeds; None if the rule is undefined)."""
        parts = method.split(".")
        if parts[0] != "data" or len(parts) < 3:
            raise RegoError(f"check method must be data.<pkg>.<rule>, "
                            f"got {method!r}")
        pkg, rule = ".".join(parts[1:-1]), parts[-1]
        # the memo is per-query local state carried on the threaded
        # `seen` object: the engine is shared across server threads, so
        # storing it on self would leak one request's memoized
        # decisions into another's
        return self._rule_value(pkg, rule, input_doc, _QueryState())

    # -- rule resolution --

    def _rule_value(self, pkg: str, name: str, input_doc, seen) -> Any:
        key = (pkg, name)
        if key in seen:
            raise RegoError(f"rego_recursion_error: {pkg}.{name}")
        memo = seen.memo if isinstance(seen, _QueryState) else None
        if memo is not None and key in memo:
            return memo[key]
        mod = self.modules.get(pkg)
        if mod is None:
            raise RegoError(f"unknown package {pkg!r}")
        defs = mod.rules.get(name)
        if defs is None:
            return None
        seen = seen | {key}
        default_value = None
        for d in defs:
            if d.default:
                default_value = self._ground(d.value)
        # OPA complete-rule semantics: EVERY successful evaluation —
        # across definitions AND across bindings within one body — must
        # agree on the value; disagreement is eval_conflict_error
        # (which the opa adapter fails closed on), never a silent
        # first-wins (ADVICE r2)
        result: Any = None
        have_result = False

        def absorb(value: Any) -> None:
            nonlocal result, have_result
            if have_result and value != result:
                raise RegoError(
                    f"eval_conflict_error: complete rule {pkg}.{name} "
                    f"defined with conflicting values")
            result, have_result = value, True

        for d in defs:
            if d.default:
                continue
            if not d.body:
                # constant: name = literal
                for env, value in self._eval_term(
                        d.value, _Env(), mod, input_doc, seen):
                    absorb(value)
                continue
            for env in self._eval_body(list(d.body), _Env(), mod,
                                       input_doc, seen):
                for env2, value in self._eval_term(d.value, env, mod,
                                                   input_doc, seen):
                    absorb(value)
        out = result if have_result else default_value
        if memo is not None:
            memo[key] = out
        return out

    @staticmethod
    def _ground(term: Any) -> Any:
        if isinstance(term, (bool, int, float, str)) or term is None:
            return term
        if isinstance(term, ArrayT):
            return [RegoEngine._ground(t) for t in term.items]
        raise RegoError("default value must be a literal")

    # -- body evaluation: generator of environments --

    def _eval_body(self, exprs: list, env: _Env, mod: Module,
                   input_doc, seen) -> Iterator[_Env]:
        if not exprs:
            yield env
            return
        head, rest = exprs[0], exprs[1:]
        for env2 in self._eval_expr(head, env, mod, input_doc, seen):
            yield from self._eval_body(rest, env2, mod, input_doc, seen)

    def _eval_expr(self, expr: Any, env: _Env, mod: Module,
                   input_doc, seen) -> Iterator[_Env]:
        if isinstance(expr, NotExpr):
            # negation as failure over the current bindings
            for _ in self._eval_expr(expr.expr, env, mod, input_doc,
                                     seen):
                return
            yield env
            return
        if isinstance(expr, Unify):
            for env2, lv in self._eval_term(expr.left, env, mod,
                                            input_doc, seen,
                                            allow_unbound=True):
                for env3, rv in self._eval_term(expr.right, env2, mod,
                                                input_doc, seen,
                                                allow_unbound=True):
                    env4 = self._unify(lv, rv, env3)
                    if env4 is not None:
                        yield env4
            return
        if isinstance(expr, Call):
            yield from self._eval_call(expr, env, mod, input_doc, seen)
            return
        # bare term: truthy check (e.g. `service_graph.allow`,
        # `is_hr`)
        for env2, value in self._eval_term(expr, env, mod, input_doc,
                                           seen):
            if value is not None and value is not False:
                yield env2
        return

    def _eval_call(self, call: Call, env: _Env, mod: Module,
                   input_doc, seen) -> Iterator[_Env]:
        if call.name in _BUILTINS_BOOL:
            fn = _BUILTINS_BOOL[call.name]
            args = []
            for t in call.args:
                got = next(self._eval_term(t, env, mod, input_doc,
                                           seen), None)
                if got is None:
                    return
                env, v = got
                args.append(v)
            try:
                if fn(*args):
                    yield env
            except TypeError as exc:
                raise RegoError(f"{call.name}: {exc}") from exc
            return
        if call.name in _BUILTINS_OUT:
            fn = _BUILTINS_OUT[call.name]
            *ins, out = call.args
            args = []
            for t in ins:
                got = next(self._eval_term(t, env, mod, input_doc,
                                           seen), None)
                if got is None:
                    return
                env, v = got
                args.append(v)
            try:
                result = fn(*args)
            except TypeError as exc:
                raise RegoError(f"{call.name}: {exc}") from exc
            env2 = self._unify_out(out, result, env)
            if env2 is not None:
                yield env2
            return
        raise RegoError(f"unknown builtin {call.name!r}")

    def _unify_out(self, term: Any, value: Any, env: _Env) -> _Env | None:
        if isinstance(term, Var):
            if term.name in env:
                return env if env[term.name] == value else None
            env2 = env.child()
            env2[term.name] = value
            return env2
        got = term
        return env if got == value else None

    # -- term evaluation: generator of (env, value) --

    def _eval_term(self, term: Any, env: _Env, mod: Module, input_doc,
                   seen, allow_unbound: bool = False
                   ) -> Iterator[tuple[_Env, Any]]:
        if isinstance(term, (bool, int, float, str)) or term is None:
            yield env, term
            return
        if isinstance(term, Var):
            if term.name in env:
                yield env, env[term.name]
            elif term.name in mod.rules or term.name in mod.imports:
                # a bare ident can only be disambiguated here: an
                # unbound name that names a rule (or package alias) is
                # a rule reference, not a variable
                yield from self._eval_ref(Ref(base=term.name, path=()),
                                          env, mod, input_doc, seen)
            elif allow_unbound:
                yield env, term        # unbound var flows to unify
            return
        if isinstance(term, ArrayT):
            yield from self._eval_seq(list(term.items), [], env, mod,
                                      input_doc, seen, allow_unbound)
            return
        if isinstance(term, ObjectT):
            yield from self._eval_obj(list(term.items), {}, env, mod,
                                      input_doc, seen)
            return
        if isinstance(term, SetT):
            for e, items in self._eval_seq(list(term.items), [], env,
                                           mod, input_doc, seen, False):
                yield e, list(items)
            return
        if isinstance(term, Ref):
            yield from self._eval_ref(term, env, mod, input_doc, seen)
            return
        if isinstance(term, Call):
            raise RegoError("call terms only valid as expressions")
        raise RegoError(f"cannot evaluate {term!r}")

    def _eval_seq(self, items: list, acc: list, env: _Env, mod, input_doc,
                  seen, allow_unbound) -> Iterator[tuple[_Env, list]]:
        if not items:
            yield env, list(acc)
            return
        head, rest = items[0], items[1:]
        for env2, v in self._eval_term(head, env, mod, input_doc, seen,
                                       allow_unbound):
            yield from self._eval_seq(rest, acc + [v], env2, mod,
                                      input_doc, seen, allow_unbound)

    def _eval_obj(self, items: list, acc: dict, env: _Env, mod,
                  input_doc, seen) -> Iterator[tuple[_Env, dict]]:
        if not items:
            yield env, dict(acc)
            return
        (kt, vt), rest = items[0], items[1:]
        for env2, k in self._eval_term(kt, env, mod, input_doc, seen):
            for env3, v in self._eval_term(vt, env2, mod, input_doc,
                                           seen):
                yield from self._eval_obj(rest, {**acc, k: v}, env3,
                                          mod, input_doc, seen)

    def _eval_ref(self, ref: Ref, env: _Env, mod: Module, input_doc,
                  seen) -> Iterator[tuple[_Env, Any]]:
        # resolve the base document
        if ref.base == "input":
            roots: list[tuple[_Env, Any]] = [(env, input_doc)]
            path = list(ref.path)
        elif ref.base == "data":
            # data.<pkg...>.<rule>[...]: the longest string prefix
            # whose tail names a rule of the prefix package wins
            path = list(ref.path)
            str_prefix = []
            for el in path:
                if isinstance(el, str):
                    str_prefix.append(el)
                else:
                    break
            value = None
            for cut in range(len(str_prefix), 0, -1):
                pkg = ".".join(str_prefix[:cut - 1])
                m = self.modules.get(pkg)
                if m is not None and str_prefix[cut - 1] in m.rules:
                    value = self._rule_value(pkg, str_prefix[cut - 1],
                                             input_doc, seen)
                    path = path[cut:]
                    break
            else:
                return
            roots = [(env, value)]
        elif ref.base in mod.imports:
            # imported package alias: alias.rule[...]
            pkg = mod.imports[ref.base]
            if not ref.path or not isinstance(ref.path[0], str):
                return
            value = self._rule_value(pkg, ref.path[0], input_doc, seen)
            roots = [(env, value)]
            path = list(ref.path[1:])
        elif ref.base in env:
            roots = [(env, env[ref.base])]
            path = list(ref.path)
        elif ref.base in mod.rules:
            value = self._rule_value(mod.package, ref.base, input_doc,
                                     seen)
            roots = [(env, value)]
            path = list(ref.path)
        else:
            return

        def walk(env_in: _Env, doc: Any, remaining: list
                 ) -> Iterator[tuple[_Env, Any]]:
            if doc is None:
                return
            if not remaining:
                yield env_in, doc
                return
            el, rest = remaining[0], remaining[1:]
            if isinstance(el, Wildcard):
                for item in _iterate(doc):
                    yield from walk(env_in, item, rest)
                return
            if isinstance(el, Var):
                if el.name in env_in:
                    yield from walk(env_in, _index(doc, env_in[el.name]),
                                    rest)
                    return
                for key, item in _enumerate(doc):
                    env2 = env_in.child()
                    env2[el.name] = key
                    yield from walk(env2, item, rest)
                return
            if isinstance(el, Ref):
                for env2, key in self._eval_ref(el, env_in, mod,
                                                input_doc, seen):
                    yield from walk(env2, _index(doc, key), rest)
                return
            yield from walk(env_in, _index(doc, el), rest)

        for env_in, doc in roots:
            yield from walk(env_in, doc, path)

    # -- unification --

    def _unify(self, a: Any, b: Any, env: _Env) -> _Env | None:
        if isinstance(a, Var):
            if isinstance(b, Var):
                return None if a.name != b.name else env
            env2 = env.child()
            env2[a.name] = b
            return env2
        if isinstance(b, Var):
            env2 = env.child()
            env2[b.name] = a
            return env2
        if isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                return None
            for x, y in zip(a, b):
                env = self._unify(x, y, env)   # type: ignore[assignment]
                if env is None:
                    return None
            return env
        # scalar / dict equality (bool vs int: Rego types differ)
        if isinstance(a, bool) != isinstance(b, bool):
            return None
        return env if a == b else None


def _iterate(doc: Any) -> Iterator[Any]:
    if isinstance(doc, list):
        yield from doc
    elif isinstance(doc, Mapping):
        yield from doc.values()


def _enumerate(doc: Any) -> Iterator[tuple[Any, Any]]:
    if isinstance(doc, list):
        yield from enumerate(doc)
    elif isinstance(doc, Mapping):
        yield from doc.items()


def _index(doc: Any, key: Any) -> Any:
    try:
        if isinstance(doc, list):
            if isinstance(key, bool) or not isinstance(key, int):
                return None
            return doc[key] if 0 <= key < len(doc) else None
        if isinstance(doc, Mapping):
            return doc.get(key)
    except (TypeError, KeyError, IndexError):
        return None
    return None
