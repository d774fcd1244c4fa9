"""Tensor expression compiler: AST → batched masked evaluation in torch.

Port of istio_tpu/compiler/tensor_expr.py. It replaces the reference's
IL compiler + stack-VM interpreter hot loop (mixer/pkg/il/compiler +
interpreter/interpreterRun.go:70 — O(rules) sequential per request)
with data-parallel evaluation: one closure evaluates an expression for
a whole batch of requests at once.

Short-circuit + 3-valued-presence semantics are compiled into masked
boolean algebra ("no short-circuit — evaluate everything, mask errors,
reduce"). Every node lowers to a triple

    (val, ok, err)   each [B]

where `ok` means "produced a value" and `err` means "hard runtime error".
Absence (fallback-able) is `~ok & ~err`. The exact masking rules mirror
the oracle (istio_tpu_torch/expr/oracle.py), which mirrors the IL codegen:

  eff_err(x)  = x.err | ~x.ok          # hard context turns absence → error
  LAND(a,b):   err = ea | (~ea & a.val & eb)        ; val = a.val & b.val
  LOR(a,b):    err = ea | (~ea & ~a.val & eb)       ; val = a.val | b.val
  OR(a,b):     val = a.ok ? a.val : b.val
               ok  = a.ok | (~a.err & b.ok)
               err = a.err | (~a.ok & ~a.err & b.err)
  EQ/NEQ, externs: err = OR of eff_err(operand)

Non-boolean values are interned int32 ids (layout.py) and EQ is id
comparison. Constant byte predicates (startsWith / endsWith / match())
lower to the byte_pred kernel and constant `matches` regexes to the
dfa_scan kernel (ops/bytes_ops.py; the ruleset's subject groups write
their literal pairs through the byte_lits / dfa_lits entry points,
LitGroup); runtime-pattern predicates and ordered comparisons stay
torch code.

Expressions the device path cannot lower — dynamic-key INDEX, non-constant
match/regex patterns, ip()/timestamp() over runtime strings, unsupported
regex constructs — raise HostFallback at compile time and are routed to
the oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.layout import (AttributeBatch, BatchLayout,
                                             ID_TRUE, InternTable,
                                             ORDER_KEY_TYPES, order_key_bytes)
from istio_tpu_torch.device import resolve_device
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder,
                                          DEFAULT_FUNCS, eval_type)
from istio_tpu_torch.expr.exprs import Expression, FunctionCall
from istio_tpu_torch.expr.externs import (ExternError, extern_ip,
                                          extern_timestamp)
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.ops import bytes_ops
from istio_tpu_torch.ops.regex_dfa import UnsupportedRegex, compile_regex

V = ValueType
_BYTE_PREDS = ("match", "matches", "startsWith", "endsWith")
_CMP_FUNCS = ("LSS", "LEQ", "GTR", "GEQ")
_BOOL = torch.bool
_I32 = torch.int32


class HostFallback(Exception):
    """Expression cannot run on device; evaluate with the oracle."""


@dataclasses.dataclass
class TVal:
    val: Any   # bool[B] for BOOL nodes, int32[B] ids otherwise
    ok: Any    # bool[B]
    err: Any   # bool[B]


@dataclasses.dataclass
class BVal:
    """Byte-string view of a subtree (subject of a byte predicate)."""
    data: Any  # uint8[B, L]
    lens: Any  # int32[B]
    ok: Any
    err: Any


def _eff_err(t: TVal) -> Any:
    return t.err | ~t.ok


# ---------------------------------------------------------------------------
# Requirement collection (pre-pass)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Requirements:
    """What the layout must provide for a set of expressions."""
    derived_keys: set[tuple[str, str]] = dataclasses.field(default_factory=set)
    byte_sources: set[Any] = dataclasses.field(default_factory=set)
    # (extern name, operand key) → operand AST: runtime ip()/
    # timestamp() conversions the tensorizer runs at ingest
    extern_sources: dict[tuple[str, str], Any] = \
        dataclasses.field(default_factory=dict)

    def merge(self, other: "Requirements") -> None:
        self.derived_keys |= other.derived_keys
        self.byte_sources |= other.byte_sources
        self.extern_sources.update(other.extern_sources)


def _extern_operand_ok(e: Expression) -> bool:
    """Shapes the tensorizer's ingest oracle may evaluate: constants,
    variables, constant-key INDEX, and `|` fallbacks over those."""
    if e.const_ is not None or e.var is not None:
        return True
    f = e.fn
    if f is None:
        return False
    if f.name == "INDEX":
        return (f.args[0].var is not None
                and f.args[1].const_ is not None)
    if f.name == "OR":
        return all(_extern_operand_ok(a) for a in f.args)
    return False


def collect_requirements(ast: Expression, finder: AttributeDescriptorFinder,
                         reqs: Requirements | None = None) -> Requirements:
    """Walk the AST collecting derived-slot and byte-slot needs; raises
    HostFallback for shapes the device path cannot express."""
    if reqs is None:
        reqs = Requirements()
    _collect(ast, finder, reqs, as_bytes=False)
    return reqs


def _collect(e: Expression, finder: AttributeDescriptorFinder,
             reqs: Requirements, as_bytes: bool) -> None:
    if e.const_ is not None:
        return
    if e.var is not None:
        vt = finder.get_attribute(e.var.name)
        if vt is None:
            raise HostFallback(f"unknown attribute {e.var.name}")
        if as_bytes:
            reqs.byte_sources.add(e.var.name)
        return
    f = e.fn
    assert f is not None
    if f.name == "INDEX":
        tgt = f.args[0]
        if tgt.var is not None:
            map_vars = [tgt.var.name]
        elif (tgt.fn is not None and tgt.fn.name == "OR"
              and all(a.var is not None for a in tgt.fn.args)
              and not as_bytes):
            # (mapA | mapB)[key]: both maps' derived slots + presence
            map_vars = [a.var.name for a in tgt.fn.args]
        else:
            raise HostFallback("INDEX over non-variable map")
        if f.args[1].const_ is None:
            raise HostFallback("dynamic string-map key")
        key = f.args[1].const_.value
        if not isinstance(key, str):
            raise HostFallback("non-string map key")
        for m in map_vars:
            if finder.get_attribute(m) != ValueType.STRING_MAP:
                raise HostFallback(f"INDEX over non-map {m}")
            reqs.derived_keys.add((m, key))
        if as_bytes:
            reqs.byte_sources.add((map_vars[0], key))
        return
    if f.name == "OR":
        _collect(f.args[0], finder, reqs, as_bytes)
        _collect(f.args[1], finder, reqs, as_bytes)
        return
    if f.name in _BYTE_PREDS:
        if f.name == "match":
            subject, pattern = f.args[0], f.args[1]
        elif f.name == "matches":
            subject, pattern = f.args[0], f.target
        else:  # startsWith / endsWith
            subject, pattern = f.target, f.args[0]
        if pattern is None or pattern.const_ is None or \
                not isinstance(pattern.const_.value, str):
            if f.name == "matches":
                # runtime regex compilation has no device analog
                raise HostFallback("non-constant pattern for matches")
            # dynamic prefix/suffix/glob: BOTH sides ride byte planes
            # (bytes_ops.dyn_*_match)
            _collect(pattern, finder, reqs, as_bytes=True)
            _collect(subject, finder, reqs, as_bytes=True)
            return
        if f.name == "matches":
            try:
                compile_regex(pattern.const_.value)
            except UnsupportedRegex as exc:
                import re as _re
                try:
                    _re.compile(pattern.const_.value)
                except _re.error:
                    # invalid pattern: the oracle errors on EVERY
                    # evaluation → lowers to a constant-error atom,
                    # no requirements needed
                    return
                raise HostFallback(str(exc))
        _collect(subject, finder, reqs, as_bytes=True)
        return
    if f.name in ("ip", "timestamp"):
        arg = f.args[0]
        if arg.const_ is None:
            # runtime conversion: the TENSORIZER runs it at ingest into
            # an extern column (layout.extern_slots) — string parsing
            # has no device form, so it happens at the edge, once per
            # request, not per rule
            if not _extern_operand_ok(arg):
                raise HostFallback(
                    f"{f.name}() over an un-ingestable operand")
            _collect(arg, finder, reqs, as_bytes=False)
            reqs.extern_sources[(f.name, str(arg))] = arg
        return
    if f.name in _CMP_FUNCS:
        # ordered comparisons ride the byte planes: strings as utf-8,
        # numerics as 8-byte order keys (layout.order_key_bytes) —
        # keys of DIFFERENT types are not mutually comparable, so only
        # same-type pairs lower. INT64-vs-DOUBLE is a real comparison
        # on the oracle (python int<float) → host fallback; every
        # other mixed/unorderable pair makes the oracle raise on EVERY
        # evaluation → a constant-error atom, no requirements needed.
        ta, tb = (eval_type(a, finder, DEFAULT_FUNCS) for a in f.args)
        if ta != tb:
            if {ta, tb} <= {V.INT64, V.DOUBLE}:
                raise HostFallback("mixed numeric comparison")
            return   # oracle type error every row
        if ta != V.STRING and ta not in ORDER_KEY_TYPES:
            return   # unorderable (BOOL/IP/BYTES): oracle error
        for a in f.args:
            _collect(a, finder, reqs, as_bytes=True)
        return
    if f.name in ("EQ", "NEQ", "LAND", "LOR"):
        for a in f.args:
            _collect(a, finder, reqs, as_bytes=False)
        return
    raise HostFallback(f"unsupported function on device: {f.name}")


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

class _Ctx:
    def __init__(self, layout: BatchLayout, interner: InternTable,
                 finder: AttributeDescriptorFinder):
        self.layout = layout
        self.interner = interner
        self.finder = finder

    def type_of(self, e: Expression) -> ValueType:
        return eval_type(e, self.finder, DEFAULT_FUNCS)


NodeFn = Callable[[AttributeBatch], TVal]
ByteFn = Callable[[AttributeBatch], BVal]


def _ones(batch: AttributeBatch) -> torch.Tensor:
    return torch.ones(batch.ids.shape[0], dtype=_BOOL,
                      device=batch.ids.device)


def _zeros(batch: AttributeBatch) -> torch.Tensor:
    return torch.zeros(batch.ids.shape[0], dtype=_BOOL,
                       device=batch.ids.device)


def _const_tval(value: Any, vtype: ValueType, ctx: _Ctx) -> NodeFn:
    if vtype == V.BOOL:
        v = bool(value)

        def fn(batch: AttributeBatch) -> TVal:
            return TVal(_ones(batch) if v else _zeros(batch), _ones(batch),
                        _zeros(batch))
        return fn
    cid = ctx.interner.intern(value)

    def fn(batch: AttributeBatch) -> TVal:
        val = torch.full((batch.ids.shape[0],), cid, dtype=_I32,
                         device=batch.ids.device)
        return TVal(val, _ones(batch), _zeros(batch))
    return fn


def _error_tval() -> NodeFn:
    def fn(batch: AttributeBatch) -> TVal:
        val = torch.zeros(batch.ids.shape[0], dtype=_I32,
                          device=batch.ids.device)
        return TVal(val, _zeros(batch), _ones(batch))
    return fn


def _compile_node(e: Expression, ctx: _Ctx) -> NodeFn:
    if e.const_ is not None:
        return _const_tval(e.const_.value, e.const_.vtype, ctx)

    if e.var is not None:
        vt = ctx.finder.get_attribute(e.var.name)
        if vt is None:
            raise HostFallback(f"unknown attribute {e.var.name}")
        if vt == V.STRING_MAP:
            raise HostFallback("bare string-map variable on device")
        col = ctx.layout.slot_of(e.var.name)
        is_bool = vt == V.BOOL

        def fn(batch: AttributeBatch) -> TVal:
            ids = batch.ids[:, col]
            ok = batch.present[:, col]
            val = (ids == ID_TRUE) if is_bool else ids
            return TVal(val, ok, torch.zeros_like(ok))
        return fn

    f = e.fn
    assert f is not None
    name = f.name

    if name == "INDEX":
        key = f.args[1].const_.value
        tgt = f.args[0]
        if tgt.var is not None:
            col = ctx.layout.derived_slot_of(tgt.var.name, key)

            def fn(batch: AttributeBatch) -> TVal:
                ok = batch.present[:, col]
                return TVal(batch.ids[:, col], ok, torch.zeros_like(ok))
            return fn
        # (mapA | mapB)[key] — _collect validated the OR-of-vars shape:
        # soft map fallback selects by MAP presence, then the chosen
        # map's derived slot supplies value/presence
        m1 = tgt.fn.args[0].var.name
        m2 = tgt.fn.args[1].var.name
        c1 = ctx.layout.derived_slot_of(m1, key)
        c2 = ctx.layout.derived_slot_of(m2, key)
        mp1 = ctx.layout.map_slots[m1]
        mp2 = ctx.layout.map_slots[m2]

        def fn(batch: AttributeBatch) -> TVal:
            sel = batch.map_present[:, mp1]
            val = torch.where(sel, batch.ids[:, c1], batch.ids[:, c2])
            ok = torch.where(sel, batch.present[:, c1],
                             batch.map_present[:, mp2]
                             & batch.present[:, c2])
            return TVal(val, ok, torch.zeros_like(ok))
        return fn

    if name == "OR":
        fa = _compile_node(f.args[0], ctx)
        fb = _compile_node(f.args[1], ctx)

        def fn(batch: AttributeBatch) -> TVal:
            a, b = fa(batch), fb(batch)
            val = torch.where(a.ok, a.val, b.val)
            ok = a.ok | (~a.err & b.ok)
            err = a.err | (~a.ok & ~a.err & b.err)
            return TVal(val, ok, err)
        return fn

    if name in ("EQ", "NEQ"):
        fa = _compile_node(f.args[0], ctx)
        fb = _compile_node(f.args[1], ctx)
        negate = name == "NEQ"

        def fn(batch: AttributeBatch) -> TVal:
            a, b = fa(batch), fb(batch)
            cmp = a.val == b.val
            if negate:
                cmp = ~cmp
            ee = _eff_err(a) | _eff_err(b)
            return TVal(cmp, ~ee, ee)
        return fn

    if name == "LAND":
        fa = _compile_node(f.args[0], ctx)
        fb = _compile_node(f.args[1], ctx)

        def fn(batch: AttributeBatch) -> TVal:
            a, b = fa(batch), fb(batch)
            ea, eb = _eff_err(a), _eff_err(b)
            err = ea | (~ea & a.val & eb)
            val = a.val & b.val & ~err
            return TVal(val, ~err, err)
        return fn

    if name == "LOR":
        fa = _compile_node(f.args[0], ctx)
        fb = _compile_node(f.args[1], ctx)

        def fn(batch: AttributeBatch) -> TVal:
            a, b = fa(batch), fb(batch)
            ea, eb = _eff_err(a), _eff_err(b)
            err = ea | (~ea & ~a.val & eb)
            val = ((a.val & ~ea) | (b.val & ~eb)) & ~err
            return TVal(val, ~err, err)
        return fn

    if name in _BYTE_PREDS:
        return _compile_byte_pred(f, ctx)

    if name in _CMP_FUNCS:
        return _compile_cmp(f, ctx)

    if name in ("ip", "timestamp"):
        arg = f.args[0]
        if arg.const_ is None:
            # ingest-converted extern column (layout.extern_slots):
            # ID_INVALID marks a conversion/lookup error
            col = ctx.layout.extern_slots.get((name, str(arg)))
            if col is None:
                raise HostFallback(
                    f"{name}() operand missing an extern slot")

            def fn(batch: AttributeBatch) -> TVal:
                ids = batch.ids[:, col]
                pres = batch.present[:, col]
                err = pres & (ids == 0)
                ok = pres & ~err
                return TVal(ids, ok, err)
            return fn
        raw = arg.const_.value
        try:
            value = (extern_ip(raw) if name == "ip"
                     else extern_timestamp(raw))
        except ExternError:
            return _error_tval()  # runtime-error constant, oracle parity
        return _const_tval(value, V.IP_ADDRESS if name == "ip"
                           else V.TIMESTAMP, ctx)

    raise HostFallback(f"unsupported function on device: {name}")


def _compile_cmp(f: FunctionCall, ctx: _Ctx) -> NodeFn:
    """Ordered comparison (expr LSS/LEQ/GTR/GEQ) over the byte planes.

    Strings compare as raw utf-8 (Go string order); numerics compare by
    their 8-byte order keys (layout.order_key_bytes) — both reduce to
    one lex_cmp. NaN operands arrive as present-but-EMPTY numeric rows
    and read False under every comparison. String rows at the byte-slot
    cap may be truncated, making the comparison undecidable → err."""
    name = f.name
    ta = ctx.type_of(f.args[0])
    tb = ctx.type_of(f.args[1])
    if ta != tb:
        if {ta, tb} <= {V.INT64, V.DOUBLE}:
            raise HostFallback("mixed numeric comparison")
        return _error_tval()   # oracle type error on every row
    if ta != V.STRING and ta not in ORDER_KEY_TYPES:
        # the oracle raises "unordered operand" on every evaluation
        return _error_tval()
    numeric = ta in ORDER_KEY_TYPES
    fa = _compile_bytes(f.args[0], ctx)
    fb = _compile_bytes(f.args[1], ctx)
    max_len = ctx.layout.max_str_len

    def fn(batch: AttributeBatch) -> TVal:
        a, b = fa(batch), fb(batch)
        ee = (a.err | ~a.ok) | (b.err | ~b.ok)
        c = bytes_ops.lex_cmp(a.data, a.lens, b.data, b.lens)
        if name == "LSS":
            val = c < 0
        elif name == "LEQ":
            val = c <= 0
        elif name == "GTR":
            val = c > 0
        else:
            val = c >= 0
        if numeric:
            # NaN marker (empty key): all four comparisons read False,
            # never err. Malformed-payload marker (1-byte key,
            # layout.ORDER_KEY_ERROR): the oracle raises per row → err
            nan = (a.ok & (a.lens == 0)) | (b.ok & (b.lens == 0))
            bad = (a.ok & (a.lens == 1)) | (b.ok & (b.lens == 1))
            ee = ee | bad
            val = val & ~nan
        else:
            # either side possibly truncated → order undecidable
            ee = ee | (a.ok & (a.lens >= max_len)) \
                    | (b.ok & (b.lens >= max_len))
        val = val & ~ee
        return TVal(val, ~ee, ee)
    return fn


def _byte_pred_spec(f: FunctionCall, max_len: int
                    ) -> tuple[Expression, tuple[int, bytes], str]:
    """A constant startsWith / endsWith / match() call → (subject AST,
    (byte_pred kind, pattern bytes), truncation mode). The mode is
    "safe" where the stored prefix decides the row even when the value
    was truncated at max_len, and "all" where every possibly-truncated
    row is undecidable. Patterns longer than the cap → HostFallback."""
    if f.name == "match":
        subject_ast, pattern = f.args[0], f.args[1].const_.value
        if len(pattern.encode("utf-8")) > max_len:
            raise HostFallback("glob pattern exceeds byte-slot width")
        if pattern.endswith("*"):
            trunc = "safe"                      # prefix glob
        elif pattern.startswith("*"):
            trunc = "all"                       # suffix glob
        else:
            # exact: safe unless the stored prefix could equal the
            # pattern while the real string continues past the cap
            trunc = "safe" if len(pattern.encode()) < max_len else "all"
        return subject_ast, bytes_ops.glob_kind(pattern), trunc
    if f.name == "startsWith":
        pattern = f.args[0].const_.value
        if len(pattern.encode("utf-8")) > max_len:
            raise HostFallback("prefix exceeds byte-slot width")
        return f.target, (bytes_ops.PREFIX, pattern.encode()), "safe"
    pattern = f.args[0].const_.value        # endsWith
    return f.target, (bytes_ops.SUFFIX, pattern.encode()), "all"


def is_const_byte_pred(e: Expression) -> bool:
    """startsWith / endsWith / match() with a constant string pattern —
    the atoms the ruleset batches into one byte_pred launch per
    subject (compile_byte_group)."""
    f = e.fn
    if f is None or f.name not in ("match", "startsWith", "endsWith"):
        return False
    pat = f.args[1] if f.name == "match" else f.args[0]
    return pat.const_ is not None and isinstance(pat.const_.value, str)


def _compile_byte_pred(f: FunctionCall, ctx: _Ctx) -> NodeFn:
    """Byte predicates with truncation safety.

    Strings longer than max_str_len land truncated in the byte plane
    (layout.py). Per predicate:
      * prefix checks (startsWith, `x*` globs, exact globs shorter
        than the cap) only read the head — always decidable;
      * suffix/tail checks (endsWith, `*x` globs, cap-length exact
        globs) are undecidable on a possibly-truncated row → err;
      * unanchored regex: a hit inside the stored prefix proves a hit
        in the full string, so only a MISS on a truncated row is
        undecidable; a `$`-anchored regex could falsely anchor at the
        truncation point, so every truncated row is undecidable.
    A pattern longer than the cap → HostFallback at compile time.
    """
    max_len = ctx.layout.max_str_len
    if f.name == "match":
        pattern_ast = f.args[1]
    elif f.name == "matches":
        pattern_ast = f.target
    else:
        pattern_ast = f.args[0]
    if pattern_ast.const_ is None and f.name != "matches":
        return _compile_dyn_byte_pred(f, ctx)
    if f.name == "matches":
        subject_ast, pattern = f.args[0], f.target.const_.value
        try:
            dfa = compile_regex(pattern)
        except UnsupportedRegex:
            import re as _re
            try:
                _re.compile(pattern)
            except _re.error:
                return _error_tval()   # invalid pattern: always errors
            raise
        group = compile_dfa_group(subject_ast, [pattern], [dfa], ctx)

        def fn(batch: AttributeBatch) -> TVal:
            val, ee = group(batch)
            return TVal(val[:, 0], ~ee[:, 0], ee[:, 0])
        return fn
    group = compile_byte_group(_byte_pred_spec(f, max_len)[0], [f], ctx)

    def fn(batch: AttributeBatch) -> TVal:
        val, ee = group(batch)
        return TVal(val[:, 0], ~ee[:, 0], ee[:, 0])
    return fn


def _byte_group_spec(calls: list[FunctionCall], max_len: int
                     ) -> tuple[bytes_ops.BytePatterns, np.ndarray]:
    """The patterns of a byte group and which of its columns have the
    truncation mode "all"."""
    specs = [_byte_pred_spec(c, max_len) for c in calls]
    return (bytes_ops.BytePatterns.of([s[1] for s in specs]),
            np.array([s[2] == "all" for s in specs]))


def compile_byte_group(subject_ast: Expression, calls: list[FunctionCall],
                       ctx: _Ctx) -> Callable:
    """ALL constant startsWith / endsWith / match() atoms over ONE
    subject, answered by one byte_pred launch. Returns fn(batch) →
    (val [B, k], ee [B, k]) with exactly _compile_byte_pred's semantics
    per column: subject absence/error masks the row, and columns whose
    truncation mode is "all" are undecidable on possibly-truncated
    rows. (The ruleset writes its groups' literal pairs instead:
    compile_byte_lits.)"""
    max_len = ctx.layout.max_str_len
    patterns, trunc_all = _byte_group_spec(calls, max_len)
    fsub = _compile_bytes(subject_ast, ctx)
    dev_trunc: dict[torch.device, torch.Tensor] = {}

    def fn(batch: AttributeBatch):
        s = fsub(batch)
        hit = bytes_ops.byte_pred(s.data, s.lens, patterns)      # [B, k]
        t_all = dev_trunc.get(hit.device)
        if t_all is None:
            t_all = dev_trunc[hit.device] = \
                torch.from_numpy(trunc_all).to(hit.device)
        maybe = (s.ok & (s.lens >= max_len))[:, None]
        ee = (s.err | ~s.ok)[:, None] | (maybe & t_all[None, :])
        return hit & ~ee, ee
    return fn


def compile_dfa_group(subject_ast: Expression, patterns: list[str],
                      dfas: list, ctx: "_Ctx") -> Callable:
    """ALL constant-pattern `matches` atoms over ONE subject, evaluated
    by one dfa_scan launch.

    Returns fn(batch) → (val [B, k], ee [B, k]) with exactly
    _compile_byte_pred's semantics per column: subject absence/error
    masks the row; truncated rows are fully undecidable for $-anchored
    patterns and miss-undecidable otherwise (the truncation contract,
    applied here around the kernel). (The ruleset writes its groups'
    literal pairs instead: compile_dfa_lits.)"""
    max_len = ctx.layout.max_str_len
    fsub = _compile_bytes(subject_ast, ctx)
    bank = _dfa_bank(dfas)
    trunc_all = np.array(["$" in p for p in patterns])
    dev_trunc: dict[torch.device, torch.Tensor] = {}

    def fn(batch: AttributeBatch):
        s = fsub(batch)
        m = bytes_ops.dfa_scan(s.data, s.lens, bank)             # [B, k]
        t_all = dev_trunc.get(m.device)
        if t_all is None:
            t_all = dev_trunc[m.device] = \
                torch.from_numpy(trunc_all).to(m.device)
        ee = (s.err | ~s.ok)[:, None].expand_as(m)
        val = m & ~ee
        maybe = (s.ok & (s.lens >= max_len))[:, None]
        undecidable = torch.where(t_all[None, :], maybe, maybe & ~val)
        ee = ee | undecidable
        val = val & ~ee
        return val, ee
    return fn


def _dfa_bank(dfas: list) -> bytes_ops.DfaBank:
    from istio_tpu_torch.ops.regex_dfa import pack_dfas_tiered

    # the reference's tier selection, kept so the host geometry matches;
    # the dfa_scan kernel walks the class-compressed table of every tier
    return bytes_ops.DfaBank.of(pack_dfas_tiered(dfas)["classes"])


@dataclasses.dataclass(eq=False)
class LitGroup:
    """One subject group of the ruleset's ext columns: every constant
    byte predicate (table: BytePatterns, one byte_lits launch) or every
    constant-pattern regex (table: DfaBank, one dfa_lits launch) over
    one subject, each pattern's literal pair (m, n) written into its
    column of the ext planes with _compile_byte_pred's absence, error
    and truncation rules. `view(batch)` is the subject (no device op
    for an attribute subject); `write(view, em, en)` is the launch."""
    fsub: Callable
    table: Any
    lits: bytes_ops.LitColumns
    max_len: int

    def view(self, batch: AttributeBatch) -> BVal:
        return self.fsub(batch)

    def write(self, s: BVal, em: torch.Tensor, en: torch.Tensor) -> None:
        op = bytes_ops.dfa_lits if isinstance(self.table, bytes_ops.DfaBank) \
            else bytes_ops.byte_lits
        op(s.data, s.lens, s.ok, s.err, self.table, self.lits, self.max_len,
           em, en)


def compile_byte_lits(subject_ast: Expression, calls: list[FunctionCall],
                      cols, ctx: _Ctx) -> LitGroup:
    """compile_byte_group's atoms as a LitGroup writing column cols[i]
    for calls[i] (modes: "all" → TRUNC_ALL, "safe" → TRUNC_SAFE)."""
    max_len = ctx.layout.max_str_len
    patterns, trunc_all = _byte_group_spec(calls, max_len)
    modes = np.where(trunc_all, bytes_ops.TRUNC_ALL, bytes_ops.TRUNC_SAFE)
    return LitGroup(_compile_bytes(subject_ast, ctx, lean=True), patterns,
                    bytes_ops.LitColumns.of(modes, cols), max_len)


def compile_dfa_lits(subject_ast: Expression, patterns: list[str],
                     dfas: list, cols, ctx: _Ctx) -> LitGroup:
    """compile_dfa_group's atoms as a LitGroup writing column cols[i]
    for patterns[i] (`$`-anchored → TRUNC_ALL, else TRUNC_MISS)."""
    modes = [bytes_ops.TRUNC_ALL if "$" in p else bytes_ops.TRUNC_MISS
             for p in patterns]
    return LitGroup(_compile_bytes(subject_ast, ctx, lean=True),
                    _dfa_bank(dfas), bytes_ops.LitColumns.of(modes, cols),
                    ctx.layout.max_str_len)


def _compile_dyn_byte_pred(f: FunctionCall, ctx: _Ctx) -> NodeFn:
    """Byte predicates whose PATTERN is itself a runtime string
    (`as.startsWith(as2)`, `match(as, as2)`): both operands ride byte
    planes and bytes_ops.dyn_*_match compares them row-wise.

    Truncation: the subject's stored prefix decides a prefix check iff
    the pattern fits under the cap; suffix/exact/glob verdicts on a
    possibly-truncated subject, and any possibly-truncated pattern,
    are undecidable → err."""
    max_len = ctx.layout.max_str_len
    if f.name == "match":
        subject_ast, pattern_ast = f.args[0], f.args[1]
        op, trunc_subject = bytes_ops.dyn_glob_match, "all"
    elif f.name == "startsWith":
        subject_ast, pattern_ast = f.target, f.args[0]
        op, trunc_subject = bytes_ops.dyn_prefix_match, "safe"
    else:   # endsWith
        subject_ast, pattern_ast = f.target, f.args[0]
        op, trunc_subject = bytes_ops.dyn_suffix_match, "all"
    fsub = _compile_bytes(subject_ast, ctx)
    fpat = _compile_bytes(pattern_ast, ctx)

    def fn(batch: AttributeBatch) -> TVal:
        s, p = fsub(batch), fpat(batch)
        ee = (s.err | ~s.ok) | (p.err | ~p.ok)
        val = op(s.data, s.lens, p.data, p.lens)
        undecidable = p.ok & (p.lens >= max_len)
        if trunc_subject == "all":
            undecidable = undecidable | (s.ok & (s.lens >= max_len))
        ee = ee | undecidable
        val = val & ~ee
        return TVal(val, ~ee, ee)
    return fn


def _compile_bytes(e: Expression, ctx: _Ctx, lean: bool = False) -> ByteFn:
    """Compile a STRING-typed subtree to its byte-tensor view. `lean`
    (the LitGroup subjects): an attribute view's err is None (it never
    errs) and a constant's ok and err are None (present on every row),
    so the view makes no mask tensor the kernels do not need."""
    lay = ctx.layout
    if e.const_ is not None:
        if e.const_.vtype in ORDER_KEY_TYPES:
            raw = order_key_bytes(e.const_.value, e.const_.vtype)
        else:
            raw = str(e.const_.value).encode("utf-8")[:lay.max_str_len]
        row = np.zeros(lay.max_str_len, dtype=np.uint8)
        if raw:
            row[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        n = len(raw)
        ctx.interner.note_byte_const(n)
        dev_rows: dict[torch.device, torch.Tensor] = {}

        def fn(batch: AttributeBatch) -> BVal:
            b = batch.ids.shape[0]
            w = batch.str_bytes.shape[2]
            dev = batch.ids.device
            r = dev_rows.get(dev)
            if r is None:
                r = dev_rows[dev] = torch.from_numpy(row).to(dev)
            lens = torch.full((b,), n, dtype=_I32, device=dev)
            if lean:
                return BVal(r[:w][None, :].expand(b, w), lens, None, None)
            return BVal(r[:w][None, :].expand(b, w), lens, _ones(batch),
                        _zeros(batch))
        return fn

    if e.var is not None:
        bcol = lay.byte_slots[e.var.name]
        col = lay.slot_of(e.var.name)

        def fn(batch: AttributeBatch) -> BVal:
            ok = batch.present[:, col]
            return BVal(batch.str_bytes[:, bcol, :], batch.str_lens[:, bcol],
                        ok, None if lean else torch.zeros_like(ok))
        return fn

    f = e.fn
    assert f is not None
    if f.name == "INDEX":
        pair = (f.args[0].var.name, f.args[1].const_.value)
        bcol = lay.byte_slots[pair]
        col = lay.derived_slot_of(*pair)

        def fn(batch: AttributeBatch) -> BVal:
            ok = batch.present[:, col]
            return BVal(batch.str_bytes[:, bcol, :], batch.str_lens[:, bcol],
                        ok, None if lean else torch.zeros_like(ok))
        return fn

    if f.name == "OR":
        fa = _compile_bytes(f.args[0], ctx)
        fb = _compile_bytes(f.args[1], ctx)

        def fn(batch: AttributeBatch) -> BVal:
            a, b = fa(batch), fb(batch)
            data = torch.where(a.ok[:, None], a.data, b.data)
            lens = torch.where(a.ok, a.lens, b.lens)
            ok = a.ok | (~a.err & b.ok)
            err = a.err | (~a.ok & ~a.err & b.err)
            return BVal(data, lens, ok, err)
        return fn

    raise HostFallback(f"cannot view {f.name}(...) as bytes on device")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TensorProgram:
    """A compiled expression: fn(batch) → (val [B], valid [B]).

    For BOOL expressions val is bool; otherwise val holds intern ids that
    `decode_value` maps back to Python values. `valid` is False exactly
    where the oracle would raise an evaluation error. A call moves the
    batch to the program's device first.
    """
    text: str
    result_type: ValueType
    fn: Callable[[AttributeBatch], tuple[Any, Any]]
    layout: BatchLayout
    interner: InternTable
    device: torch.device = torch.device("cpu")

    def __call__(self, batch: AttributeBatch) -> tuple[Any, Any]:
        return self.fn(batch.to(self.device))

    def decode_value(self, raw: Any, batch: AttributeBatch | None = None
                     ) -> Any:
        if self.result_type == V.BOOL:
            return bool(raw)
        vid = int(raw)
        if batch is not None:
            return batch.value_of(vid, self.interner)
        return self.interner.value_of(vid)


def compile_expression(text: str, finder: AttributeDescriptorFinder,
                       layout: BatchLayout, interner: InternTable,
                       device: str | torch.device = "cuda") -> TensorProgram:
    """Parse + type check + lower to a batched evaluator on `device`.

    Raises HostFallback when the expression needs the oracle, and
    TypeError_/ParseError exactly like the oracle path."""
    dev = resolve_device(device)
    ast = parse(text)
    rtype = eval_type(ast, finder, DEFAULT_FUNCS)
    ctx = _Ctx(layout, interner, finder)
    node = _compile_node(ast, ctx)

    def run(batch: AttributeBatch) -> tuple[Any, Any]:
        t = node(batch)
        return t.val, t.ok & ~t.err

    return TensorProgram(text=text, result_type=rtype, fn=run,
                         layout=layout, interner=interner, device=dev)


def compile_field(ast: Expression, finder: AttributeDescriptorFinder,
                  layout: BatchLayout, interner: InternTable
                  ) -> tuple[NodeFn, ValueType]:
    """Lower ONE already-parsed instance-field expression to a batched
    node (REPORT instance construction, runtime/report_lower.py) and its
    result type. The node follows the same masked algebra as
    compile_expression (`ok & ~err` marks rows where the oracle would
    NOT raise) and runs on whatever device the batch lies on; raises
    HostFallback exactly like compile_expression."""
    rtype = eval_type(ast, finder, DEFAULT_FUNCS)
    ctx = _Ctx(layout, interner, finder)
    return _compile_node(ast, ctx), rtype

