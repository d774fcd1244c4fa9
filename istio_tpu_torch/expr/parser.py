"""Expression-language parser: Go-expression surface syntax → AST.

The reference reuses go/parser and post-processes its tree
(mixer/pkg/expr/expr.go:287-436). We have no Go parser to lean on, so this
is a small hand-rolled tokenizer + precedence-climbing parser for the same
grammar:

  expr    = or_expr
  binary operators, loosest to tightest (Go precedence levels):
      ||                      (LOR)
      &&                      (LAND)
      == != < <= > >=         (EQ NEQ LSS LEQ GTR GEQ)
      + - | ^                 (ADD SUB OR XOR)
      * / % << >> &           (MUL QUO REM SHL SHR AND)
  unary   = [!|-] postfix
  postfix = primary { "[" expr "]" | "." IDENT "(" args ")" }
  primary = literal | dotted-name [ "(" args ")" ] | "(" expr ")"

Notes preserved from the reference semantics:
  * a dotted name (``a.b.c``) is ONE flat attribute, not member access
    (generateVarName, expr.go:270-285);
  * in ``a.b.startsWith("x")`` the final component is the method name and
    the rest is the receiver attribute (flattenSelectors, expr.go:384);
  * ``true``/``false`` are constants, all other identifiers are attributes;
  * every string literal is first tried as a Go duration ("20ms" parses to
    a DURATION constant — newConstant, expr.go:143-146);
  * all operators become named functions; whether a function EXISTS is a
    type-check question, not a parse question (so ``x/y`` parses fine and
    later fails with "unknown function: QUO").
"""
from __future__ import annotations

import re

from istio_tpu_torch.attribute.types import ValueType, parse_go_duration
from istio_tpu_torch.expr.exprs import (Constant, Expression, FunctionCall,
                                  Variable)


class ParseError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>0[xX][0-9a-fA-F]+|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)
  | (?P<str>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*'|`[^`]*`)
  | (?P<op>\|\||&&|==|!=|<=|>=|<<|>>|&\^|[-+*/%<>!|^&()\[\],.])
""", re.VERBOSE)

# operator token -> (function name, precedence); Go spec precedence levels
_BINARY = {
    "||": ("LOR", 1),
    "&&": ("LAND", 2),
    "==": ("EQ", 3), "!=": ("NEQ", 3), "<": ("LSS", 3), "<=": ("LEQ", 3),
    ">": ("GTR", 3), ">=": ("GEQ", 3),
    "+": ("ADD", 4), "-": ("SUB", 4), "|": ("OR", 4), "^": ("XOR", 4),
    "*": ("MUL", 5), "/": ("QUO", 5), "%": ("REM", 5),
    "<<": ("SHL", 5), ">>": ("SHR", 5), "&": ("AND", 5), "&^": ("ANDNOT", 5),
}
_UNARY = {"!": "NOT", "-": "SUB", "+": "ADD"}

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"',
            "'": "'", "a": "\a", "b": "\b", "f": "\f", "v": "\v", "0": "\0"}


def _unquote(text: str) -> str:
    if text.startswith("`"):
        return text[1:-1]
    body = text[1:-1]
    out: list[str] = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt == "x" and i + 3 < len(body):
                out.append(chr(int(body[i + 2:i + 4], 16)))
                i += 4
                continue
            if nxt == "u" and i + 5 < len(body):
                out.append(chr(int(body[i + 2:i + 6], 16)))
                i += 6
                continue
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Token:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self) -> str:
        return f"{self.kind}:{self.text}"


def _tokenize(src: str) -> list[_Token]:
    tokens: list[_Token] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise ParseError(f"unable to parse expression '{src}': "
                             f"bad character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append(_Token(kind, m.group()))
    tokens.append(_Token("eof", ""))
    return tokens


def _string_constant(raw: str) -> Constant:
    """String literal → DURATION if it parses as a Go duration, else
    STRING (reference: newConstant, expr.go:136-150)."""
    unq = _unquote(raw)
    # cheap prefilter before the full duration grammar: every Go
    # duration starts with a digit/sign/dot and ends with a unit
    # letter — the full parse on every literal was ~20% of a 10k-rule
    # snapshot compile
    # unit-less zeros ("0", "+0", "-0") are the only valid durations
    # not ending in a unit letter (time.ParseDuration)
    if unq in ("0", "+0", "-0") or (unq and unq[0] in "0123456789+-."
                                    and unq[-1] in "smh"):
        try:
            td = parse_go_duration(unq)
            return Constant(str_value=raw, vtype=ValueType.DURATION,
                            value=td)
        except ValueError:
            pass
    return Constant(str_value=raw, vtype=ValueType.STRING, value=unq)


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks = _tokenize(src)
        self.i = 0

    def peek(self) -> _Token:
        return self.toks[self.i]

    def next(self) -> _Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        t = self.next()
        if t.text != text:
            raise ParseError(f"unable to parse expression '{self.src}': "
                             f"expected {text!r}, found {t.text!r}")

    # --- grammar ---

    def parse(self) -> Expression:
        e = self.binary(1)
        if self.peek().kind != "eof":
            raise ParseError(f"unable to parse expression '{self.src}': "
                             f"trailing tokens at {self.peek().text!r}")
        return e

    def binary(self, min_prec: int) -> Expression:
        left = self.unary()
        while True:
            t = self.peek()
            info = _BINARY.get(t.text) if t.kind == "op" else None
            if info is None or info[1] < min_prec:
                return left
            self.next()
            right = self.binary(info[1] + 1)  # left-associative
            left = Expression(fn=FunctionCall(name=info[0], args=[left, right]))

    def unary(self) -> Expression:
        t = self.peek()
        if t.kind == "op" and t.text in _UNARY:
            self.next()
            operand = self.unary()
            return Expression(fn=FunctionCall(name=_UNARY[t.text], args=[operand]))
        return self.postfix()

    def postfix(self) -> Expression:
        e = self.primary()
        while True:
            t = self.peek()
            if t.text == "[":
                self.next()
                idx = self.binary(1)
                self.expect("]")
                e = Expression(fn=FunctionCall(name="INDEX", args=[e, idx]))
            elif t.text == ".":
                # method call anchored on a non-identifier primary:
                # ("lit").startsWith(...), f(x).matches(...)
                self.next()
                name_tok = self.next()
                if name_tok.kind != "ident" or "." in name_tok.text:
                    raise ParseError(
                        f"unable to parse expression '{self.src}': "
                        f"expected method name after '.'")
                self.expect("(")
                args = self.call_args()
                e = Expression(fn=FunctionCall(name=name_tok.text, args=args,
                                               target=e))
            else:
                return e

    def call_args(self) -> list[Expression]:
        args: list[Expression] = []
        if self.peek().text == ")":
            self.next()
            return args
        while True:
            args.append(self.binary(1))
            t = self.next()
            if t.text == ")":
                return args
            if t.text != ",":
                raise ParseError(f"unable to parse expression '{self.src}': "
                                 f"expected ',' or ')', found {t.text!r}")

    def primary(self) -> Expression:
        t = self.next()
        if t.text == "(":
            e = self.binary(1)
            self.expect(")")
            return e
        if t.kind == "int":
            return Expression(const_=Constant(
                str_value=t.text, vtype=ValueType.INT64, value=int(t.text, 0)))
        if t.kind == "float":
            return Expression(const_=Constant(
                str_value=t.text, vtype=ValueType.DOUBLE, value=float(t.text)))
        if t.kind == "str":
            return Expression(const_=_string_constant(t.text))
        if t.kind == "ident":
            # case-insensitive like the reference: expr.go:344 lowercases
            # the identifier before comparing against true/false
            low = t.text.lower()
            if low in ("true", "false"):
                return Expression(const_=Constant(
                    str_value=low, vtype=ValueType.BOOL, value=(low == "true")))
            if self.peek().text == "(":
                # call: last dotted component is the function name,
                # the rest (if any) is the receiver attribute
                # (reference: flattenSelectors + process CallExpr branch)
                self.next()
                args = self.call_args()
                if "." in t.text:
                    recv, meth = t.text.rsplit(".", 1)
                    return Expression(fn=FunctionCall(
                        name=meth, args=args,
                        target=Expression(var=Variable(name=recv))))
                return Expression(fn=FunctionCall(name=t.text, args=args))
            return Expression(var=Variable(name=t.text))
        raise ParseError(f"unable to parse expression '{self.src}': "
                         f"unexpected token {t.text!r}")


def parse(src: str) -> Expression:
    """Parse expression source into the simplified AST
    (role of reference Parse, expr.go:424-436)."""
    return _Parser(src).parse()


def extract_eq_matches(src: str) -> dict[str, object]:
    """Hoistable `attr == literal` conjuncts of a match expression — used
    to index rules by destination/protocol (reference: ExtractEQMatches,
    expr.go:446-490: only recurses through LAND)."""
    ex = parse(src)
    out: dict[str, object] = {}

    def record(fn: FunctionCall) -> None:
        if fn.name != "EQ" or len(fn.args) != 2:
            return
        a, b = fn.args
        if a.var is not None and b.const_ is not None:
            out[a.var.name] = b.const_.value
        elif a.const_ is not None and b.var is not None:
            out[b.var.name] = a.const_.value

    def walk(e: Expression) -> None:
        if e.fn is None:
            return
        record(e.fn)
        if e.fn.name != "LAND":
            return
        for arg in e.fn.args:
            walk(arg)

    walk(ex)
    return out
