"""Device lowering for REPORT instance construction.

Port of istio_tpu/runtime/report_lower.py. The reference's host path
builds report instances per record, per field, through one expression
evaluation each (InstanceBuilder.build). Here every lowerable field
expression compiles into the same batched masked algebra as Check
predicates (compiler/tensor_expr.compile_field) and rides the report
path's single packed device trip (FusedPlan.packed_report): the device
evaluates all fields for all records at once, the host decodes intern
ids back to Python values with one unique-id pass per chunk, and
adapters receive finished instances — only adapter I/O stays host-side.

One addition to the reference: each field's AST is also lowered to an
op program (compiler/op_lower.py, ops/field_ops.py), the postfix op
table that the field_eval kernel interprets for every field of a batch
in one launch. The closures stay as the kernel's plain version and
nothing else: every node kind has an op, so no closure runs beside the
kernel.

Fallback contract: an instance with ANY unlowerable field keeps
InstanceBuilder.build (host oracle) — mixed configs serve with fused
and host instances side by side. A device-invalid field (the rows where
the oracle would raise EvalError) aborts that row's instance exactly
like the host error path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.op_lower import lower_programs
from istio_tpu_torch.compiler.tensor_expr import HostFallback, compile_field
from istio_tpu_torch.ops import field_ops as fo
from istio_tpu_torch.templates import Variety
from istio_tpu_torch.utils.log import scope

log = scope("runtime.report_lower")


@dataclasses.dataclass(frozen=True)
class FieldSlot:
    """One compiled field expression: where its value/valid rows live
    in the stacked planes and how to decode the raw int32."""
    path: tuple           # ("value",) / ("dimensions", "k") / nested
    row: int              # row index in the [F, B] field planes
    is_bool: bool         # True → raw 0/1, not an intern id


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """Recipe to materialize one instance from decoded field planes."""
    name: str
    fields: tuple[FieldSlot, ...]
    consts: tuple[tuple[tuple, Any], ...]     # (path, constant value)
    # (path,) of every map/submessage container, in creation order —
    # created empty first so zero-entry maps still appear ({} like the
    # host build) and nested const/field paths have a parent
    containers: tuple[tuple, ...]


@dataclasses.dataclass
class ReportLowering:
    """Per-snapshot compiled report-field programs + specs."""
    specs: dict[str, InstanceSpec]        # instance qname → recipe
    host_instances: frozenset             # qnames kept on the host build
    # per plane row: the closure (field_eval's plain version, the
    # reference's field_fns) and the op table field_eval interprets
    program: fo.FieldProgram

    @property
    def n_fields(self) -> int:
        return self.program.n_fields

    @property
    def n_valid_words(self) -> int:
        return self.program.n_words

    def decode_planes(self, raw: np.ndarray, valid: np.ndarray,
                      batch, interner) -> np.ndarray:
        """Pulled id planes → object array of Python values, via ONE
        unique-id decode per chunk (per-record dict lookups replace
        per-record expression evaluation). Invalid cells decode from a
        masked 0 id (never read — materialize() aborts first)."""
        if raw.size == 0:
            return np.empty(raw.shape, object)
        safe = np.where(valid, raw, 0)
        uniq, inv = np.unique(safe, return_inverse=True)
        table = np.empty(len(uniq), object)
        for j, u in enumerate(uniq):
            table[j] = batch.value_of(int(u), interner)
        return table[inv].reshape(raw.shape)

    def materialize(self, iname: str, b: int, decoded: np.ndarray,
                    raw: np.ndarray, valid: np.ndarray) -> dict | None:
        """Instance dict for record `b`, or None when any field row is
        device-invalid (the host path's EvalError abort)."""
        spec = self.specs[iname]
        out: dict[str, Any] = {"name": iname}
        for path in spec.containers:
            _set_path(out, path, {})
        for path, v in spec.consts:
            _set_path(out, path, v)
        for fs in spec.fields:
            if not valid[fs.row, b]:
                return None
            v = bool(raw[fs.row, b]) if fs.is_bool else decoded[fs.row, b]
            _set_path(out, fs.path, v)
        return out


class ReportFieldCtx:
    """Decoded field planes for ONE dispatcher.report() call.

    The report path chunks oversize batches through the prewarmed
    serving buckets (dispatcher._report_active_fused); each chunk adds
    its real-row slice here, and `seal()` concatenates along the record
    axis so `materialize(iname, b)` addresses records by their global
    position in the call's bag list."""

    def __init__(self, lowering: ReportLowering, interner) -> None:
        self.rl = lowering
        self.interner = interner
        self._raw: list[np.ndarray] = []
        self._valid: list[np.ndarray] = []
        self._dec: list[np.ndarray] = []
        self.raw = self.valid = self.dec = None

    def add_chunk(self, packed: np.ndarray, base: int, n_real: int,
                  batch, decode: bool = True) -> None:
        """Slice this chunk's field rows out of the packed pull
        (rows base..base+F are int32 values, then ceil(F/32) bitpacked
        valid words) and decode ids once. `decode=False` skips the
        unique-id decode for chunks the caller already knows carry no
        active report rule (their cells are never materialized)."""
        from istio_tpu_torch.runtime.fused import unpack_word_rows

        f, fw = self.rl.n_fields, self.rl.n_valid_words
        raw = packed[base:base + f, :n_real]
        if fw:
            valid = unpack_word_rows(
                packed[base + f:base + f + fw, :n_real], f).T
        else:
            valid = np.zeros((0, n_real), bool)
        self._raw.append(raw)
        self._valid.append(valid)
        self._dec.append(
            self.rl.decode_planes(raw, valid, batch, self.interner)
            if decode else np.full(raw.shape, None, object))

    def seal(self) -> None:
        self.raw = np.concatenate(self._raw, axis=1) if self._raw \
            else np.zeros((self.rl.n_fields, 0), np.int32)
        self.valid = np.concatenate(self._valid, axis=1) if self._valid \
            else np.zeros((self.rl.n_fields, 0), bool)
        self.dec = np.concatenate(self._dec, axis=1) if self._dec \
            else np.empty((self.rl.n_fields, 0), object)

    def materialize(self, iname: str, b: int) -> dict | None:
        return self.rl.materialize(iname, b, self.dec, self.raw,
                                   self.valid)


def _set_path(d: dict, path: tuple, value: Any) -> None:
    for p in path[:-1]:
        d = d[p]
    d[path[-1]] = value


def _lower_instance(ib, finder, layout, interner, next_row: int
                    ) -> tuple[InstanceSpec, list, list]:
    """Compile every field of one instance (all-or-nothing: raises
    HostFallback if any field cannot lower) → (spec, closures, field
    ASTs)."""
    fields: list[FieldSlot] = []
    consts: list[tuple[tuple, Any]] = []
    containers: list[tuple] = []
    fns: list = []
    asts: list = []

    def lower(ast, path: tuple) -> None:
        node, rtype = compile_field(ast, finder, layout, interner)
        fields.append(FieldSlot(path=path, row=next_row + len(fns),
                                is_bool=rtype is ValueType.BOOL))
        fns.append(node)
        asts.append(ast)

    def walk(plan: list[tuple], prefix: tuple) -> None:
        for fname, kind, payload in plan:
            path = prefix + (fname,)
            if kind == "const":
                consts.append((path, payload))
            elif kind == "sub":
                containers.append(path)
                walk(payload, path)
            elif kind == "map":
                containers.append(path)
                for k in sorted(payload):
                    lower(payload[k].ast, path + (k,))
            else:
                lower(payload.ast, path)

    walk(ib.compiled_plan(), ())
    return InstanceSpec(name=ib.name, fields=tuple(fields),
                        consts=tuple(consts),
                        containers=tuple(containers)), fns, asts


def build_report_lowering(snapshot) -> ReportLowering | None:
    """Compile every REPORT instance referenced by a rule action.

    Returns None when nothing lowered (the dispatcher keeps the pure
    host build). Per-instance failures (HostFallback, or a layout slot
    the requirements pre-pass could not provide) demote just that
    instance to `host_instances`."""
    rs = snapshot.ruleset
    layout, interner, finder = rs.layout, rs.interner, snapshot.finder
    specs: dict[str, InstanceSpec] = {}
    host: set[str] = set()
    field_fns: list = []
    field_asts: list = []
    for ridx in range(len(snapshot.rules)):
        for hc, template, inst_names in snapshot.actions_for(
                ridx, Variety.REPORT):
            for iname in inst_names:
                if iname in specs or iname in host:
                    continue
                ib = snapshot.instances[iname]
                try:
                    spec, fns, asts = _lower_instance(
                        ib, finder, layout, interner, len(field_fns))
                except (HostFallback, KeyError) as exc:
                    host.add(iname)
                    log.info("report instance %s keeps the host build: "
                             "%s", iname, exc)
                    continue
                specs[iname] = spec
                field_fns.extend(fns)
                field_asts.extend(asts)
    if not specs:
        return None
    program = fo.FieldProgram(
        fns=field_fns,
        prog=lower_programs(field_asts, layout, interner, finder))
    log.info("report lowering: %d instances / %d field programs on "
             "device (%d op rows, stack %d), %d instances host-built",
             len(specs), len(field_fns), len(program.prog.ops),
             program.prog.need, len(host))
    return ReportLowering(specs=specs, host_instances=frozenset(host),
                          program=program)
