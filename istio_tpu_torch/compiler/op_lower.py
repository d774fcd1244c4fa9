"""Lower expressions to op programs (ops/field_ops.py).

One postfix op program per expression, node for node as
tensor_expr._compile_node lowers it to closures: every node kind it
takes has an op, including the byte views (_compile_bytes), constant
and runtime-pattern byte predicates, `matches` regexes and ordered
compares, so a program never calls a closure. The two compile the same
expression against the same layout and interner, and raise
HostFallback at the same nodes; a node the op set cannot take raises
NotLowerable, a compiler error rather than a fallback.

Operand order follows Sethi–Ullman: of a two-operand node, the operand
that needs more stack is emitted first, and the op row's operand-order
bit records the swap (OR, LAND and LOR are not symmetric in their error
rules, CMP and DPRED not at all). A tree of n nodes then needs at most
floor(log2(n + 1)) stack slots; programs that would need more than
field_ops.MAX_STACK raise.
"""
from __future__ import annotations

import re

import numpy as np

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.layout import ORDER_KEY_TYPES, order_key_bytes
from istio_tpu_torch.compiler.tensor_expr import (HostFallback, _Ctx,
                                                  _BYTE_PREDS, _CMP_FUNCS,
                                                  _byte_pred_spec)
from istio_tpu_torch.expr.exprs import Expression
from istio_tpu_torch.expr.externs import (ExternError, extern_ip,
                                          extern_timestamp)
from istio_tpu_torch.ops import bytes_ops
from istio_tpu_torch.ops import field_ops as fo
from istio_tpu_torch.ops.regex_dfa import (UnsupportedRegex, compile_regex,
                                           pack_dfas_classes)

V = ValueType


class NotLowerable(Exception):
    """A node _compile_node takes that the op set does not: a compiler
    bug, never a fallback."""


class ProgramBuilder:
    """Accumulates op programs over one layout: add() one expression per
    program, finish() → field_ops.OpProgram."""

    def __init__(self, layout, interner, finder) -> None:
        self.ctx = _Ctx(layout, interner, finder)
        self.rows: list[tuple] = []
        self.starts = [0]
        self.need = 0
        self._consts: dict[bytes, int] = {}
        self._dfas: list = []
        self._dfa_of: dict[str, int] = {}

    def add(self, ast: Expression) -> None:
        rows, need = self._node(ast)
        if need > fo.MAX_STACK:
            raise NotLowerable(f"program needs {need} stack slots > "
                               f"{fo.MAX_STACK}")
        self.rows.extend(rows)
        self.starts.append(len(self.rows))
        self.need = max(self.need, need)

    def finish(self) -> fo.OpProgram:
        lay = self.ctx.layout
        table = np.zeros((len(self.rows), fo.OP_WIDTH), np.int32)
        for i, r in enumerate(self.rows):
            table[i, :len(r)] = r
        width = max([lay.max_str_len, 1] + [len(c) for c in self._consts])
        consts = np.zeros((max(len(self._consts), 1), width), np.uint8)
        for raw, k in self._consts.items():
            consts[k, :len(raw)] = np.frombuffer(raw, np.uint8)
        dfa = (bytes_ops.DfaBank.of(pack_dfas_classes(self._dfas))
               if self._dfas else None)
        return fo.OpProgram(ops=table,
                            starts=np.asarray(self.starts, np.int32),
                            consts=consts, dfa=dfa,
                            max_len=int(lay.max_str_len), need=self.need)

    # -- rows ---------------------------------------------------------

    def _const_row(self, raw: bytes) -> int:
        k = self._consts.get(raw)
        if k is None:
            k = self._consts[raw] = len(self._consts)
        return k

    @staticmethod
    def _two(op: int, a: tuple, b: tuple, *operands: int
             ) -> tuple[list, int]:
        """Both operands' rows, the one needing more stack first, then
        the op row with its operand-order bit last."""
        (ra, na), (rb, nb) = a, b
        row = [op, *operands, 0, 0, 0][:fo.OP_WIDTH - 1]
        if nb > na:
            return rb + ra + [tuple(row) + (1,)], nb
        return ra + rb + [tuple(row) + (0,)], max(na, nb + 1)

    def _node(self, e: Expression) -> tuple[list, int]:
        ctx = self.ctx
        if e.const_ is not None:
            c = e.const_
            if c.vtype == V.BOOL:
                return [(fo.OP_CONST, int(bool(c.value)))], 1
            return [(fo.OP_CONST, ctx.interner.intern(c.value))], 1
        lay = ctx.layout
        if e.var is not None:
            vt = ctx.finder.get_attribute(e.var.name)
            if vt is None:
                raise HostFallback(f"unknown attribute {e.var.name}")
            if vt == V.STRING_MAP:
                raise HostFallback("bare string-map variable on device")
            return [(fo.OP_VAR, lay.slot_of(e.var.name),
                     int(vt == V.BOOL))], 1
        f = e.fn
        name = f.name
        if name == "INDEX":
            key, tgt = f.args[1].const_.value, f.args[0]
            if tgt.var is not None:
                return [(fo.OP_DSLOT,
                         lay.derived_slot_of(tgt.var.name, key))], 1
            m1, m2 = tgt.fn.args[0].var.name, tgt.fn.args[1].var.name
            return [(fo.OP_MAPSEL, lay.derived_slot_of(m1, key),
                     lay.derived_slot_of(m2, key), lay.map_slots[m1],
                     lay.map_slots[m2])], 1
        if name in fo.BINARY_OPS:
            return self._two(fo.BINARY_OPS[name], self._node(f.args[0]),
                             self._node(f.args[1]))
        if name in _BYTE_PREDS:
            return self._byte_pred(f)
        if name in _CMP_FUNCS:
            return self._cmp(f)
        if name in ("ip", "timestamp"):
            arg = f.args[0]
            if arg.const_ is None:
                col = lay.extern_slots.get((name, str(arg)))
                if col is None:
                    raise HostFallback(
                        f"{name}() operand missing an extern slot")
                return [(fo.OP_EXTERN, col)], 1
            try:
                value = (extern_ip(arg.const_.value) if name == "ip"
                         else extern_timestamp(arg.const_.value))
            except ExternError:
                return [(fo.OP_ERR,)], 1
            return [(fo.OP_CONST, ctx.interner.intern(value))], 1
        raise HostFallback(f"unsupported function on device: {name}")

    def _cmp(self, f) -> tuple[list, int]:
        """tensor_expr._compile_cmp: a type mismatch or an unorderable
        type is an error on every row (ERR)."""
        ta, tb = (self.ctx.type_of(a) for a in f.args)
        if ta != tb:
            if {ta, tb} <= {V.INT64, V.DOUBLE}:
                raise HostFallback("mixed numeric comparison")
            return [(fo.OP_ERR,)], 1
        if ta != V.STRING and ta not in ORDER_KEY_TYPES:
            return [(fo.OP_ERR,)], 1
        return self._two(fo.OP_CMP, self._bytes(f.args[0]),
                         self._bytes(f.args[1]),
                         fo.CMP_KINDS.index(f.name),
                         int(ta in ORDER_KEY_TYPES))

    def _byte_pred(self, f) -> tuple[list, int]:
        """tensor_expr._compile_byte_pred: a `matches` regex walks its
        DFA (DFA), a constant pattern is byte_pred's (BPRED), a runtime
        one the dyn_* predicates' (DPRED)."""
        max_len = self.ctx.layout.max_str_len
        if f.name == "matches":
            pattern = f.target.const_.value
            try:
                dfa = compile_regex(pattern)
            except UnsupportedRegex:
                try:
                    re.compile(pattern)
                except re.error:
                    return [(fo.OP_ERR,)], 1   # invalid: always errors
                raise
            k = self._dfa_of.get(pattern)
            if k is None:
                k = self._dfa_of[pattern] = len(self._dfas)
                self._dfas.append(dfa)
            rows, need = self._bytes(f.args[0])
            return rows + [(fo.OP_DFA, k, int("$" in pattern))], need
        pattern_ast = f.args[1] if f.name == "match" else f.args[0]
        if pattern_ast.const_ is None:
            if f.name == "match":
                subject, kind = f.args[0], fo.GLOB
            else:
                subject = f.target
                kind = (bytes_ops.PREFIX if f.name == "startsWith"
                        else bytes_ops.SUFFIX)
            return self._two(fo.OP_DPRED, self._bytes(subject),
                             self._bytes(pattern_ast), kind)
        subject, (kind, raw), trunc = _byte_pred_spec(f, max_len)
        rows, need = self._bytes(subject)
        return rows + [(fo.OP_BPRED, kind, self._const_row(raw), len(raw),
                        int(trunc == "all"))], need

    def _bytes(self, e: Expression) -> tuple[list, int]:
        """tensor_expr._compile_bytes: a STRING-typed subtree as a view."""
        lay = self.ctx.layout
        if e.const_ is not None:
            if e.const_.vtype in ORDER_KEY_TYPES:
                raw = order_key_bytes(e.const_.value, e.const_.vtype)
            else:
                raw = str(e.const_.value).encode("utf-8")[:lay.max_str_len]
            self.ctx.interner.note_byte_const(len(raw))
            return [(fo.OP_BCONST, self._const_row(raw), len(raw))], 1
        if e.var is not None:
            return [(fo.OP_BSLOT, lay.byte_slots[e.var.name],
                     lay.slot_of(e.var.name))], 1
        f = e.fn
        if f.name == "INDEX":
            pair = (f.args[0].var.name, f.args[1].const_.value)
            return [(fo.OP_BSLOT, lay.byte_slots[pair],
                     lay.derived_slot_of(*pair))], 1
        if f.name == "OR":
            return self._two(fo.OP_OR, self._bytes(f.args[0]),
                             self._bytes(f.args[1]))
        raise HostFallback(f"cannot view {f.name}(...) as bytes on device")


def lower_programs(asts, layout, interner, finder) -> fo.OpProgram:
    """One op program per expression, in order."""
    b = ProgramBuilder(layout, interner, finder)
    for ast in asts:
        b.add(ast)
    return b.finish()
