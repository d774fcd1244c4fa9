"""Fused serving plan — wire the PolicyEngine into the check path.

Port of istio_tpu/runtime/fused.py. Given a validated Snapshot, extract
every CHECK action the fused device step can absorb (denier →
DenySpec, static STRINGS / REGEX / IP_ADDRESSES lists → ListEntrySpec,
lowered rbac policies → RbacSpec) and build one
PolicyEngine per snapshot, reusing the snapshot's compiled
RuleSetProgram. Everything that cannot lower (handlers without a device
lowering, case-insensitive or provider-refreshed lists, rules whose
predicate fell back to the host oracle) is collected into
`host_actions` for the dispatcher to overlay per request. The plan is
the reference's field for field; `packed_check` makes one device trip
(PolicyEngine step, the rule-telemetry fold, the packer) and one pull.

The packer is the check_pack kernel (csrc/check_pack.cu, K5; the
reference's `_base_packer.<locals>.pack` with the bit-lane codec B4
inside). `packed_report` serves report traffic on the same trip: the
check rows, then the report field rows the field_eval kernel
(csrc/field_eval.cu, K8) writes into the same buffer, and one pull.
`packed_check_instep` carries an in-step quota allocation on the check
trip: the quota_alloc kernel (csrc/quota_alloc.cu, K9, B8) writes its
granted and gate rows after check_pack's, and one pull. Under a mesh
(`build_fused_plan(mesh=...)`) the engine's step is the dp × mp sharded
one (parallel/mesh.shard_engine_check): all three entries go through
`engine.check`, so they run sharded, and the packer, the rule-telemetry
fold and the quota gate read the verdict's matched / err planes
gathered onto the engine's device; a trip still ends in one pull. Not
carried: the C++ wire tensorizer (`native` stays None).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

import numpy as np
import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.compiler.layout import AttributeBatch
from istio_tpu_torch.models.policy_engine import (DenySpec, INTERNAL,
                                                  ListEntrySpec, PolicyEngine,
                                                  PERMISSION_DENIED, RbacSpec,
                                                  vis_rows, vis_rows_of)
from istio_tpu_torch.ops.bytes_ops import (pack_bits, pack_bool_rows,
                                           unpack_bits)
from istio_tpu_torch.ops.field_ops import field_eval
from istio_tpu_torch.runtime.config import Snapshot, _qualify
from istio_tpu_torch.runtime.report_lower import build_report_lowering
from istio_tpu_torch.templates import Variety
from istio_tpu_torch.utils.log import scope

log = scope("runtime.fused")

_FUSABLE_LIST_TYPES = ("STRINGS", "REGEX", "IP_ADDRESSES")

# latency-tier byte-plane width: batches whose every string fits this
# many bytes serve through a str_bytes plane sliced to it (see
# FusedPlan.narrow_batch)
STR_TIER_MIN = 32


def str_tiers(layout, interner=None) -> tuple[int, ...]:
    """Byte-plane length tiers for a snapshot: (STR_TIER_MIN, L) when
    the layout carries real byte slots wider than the small tier, else
    the single full width. A tier below the longest compiled byte
    CONSTANT is unsound (narrowing would slice constant rows), so the
    small tier only exists when every constant fits it; `interner` is
    consulted after every program compiled."""
    L = layout.max_str_len
    min_safe = STR_TIER_MIN
    if interner is not None:
        min_safe = max(min_safe,
                       int(getattr(interner, "max_byte_const_len", 0)))
    if layout.n_byte_slots and L > min_safe:
        return (min_safe, L)
    return (L,)


def unpack_word_rows(rows: np.ndarray, n_bits: int) -> np.ndarray:
    """Host inverse of pack_bool_rows: int32 word rows [W, B] (a slice
    of the packed pull) → bool [B, n_bits]."""
    return np.unpackbits(
        np.ascontiguousarray(rows.T).view(np.uint8), axis=1,
        bitorder="little")[:, :n_bits].astype(bool)


# ---------------------------------------------------------------------------
# K5: check_pack (csrc/check_pack.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackTables:
    """The snapshot-resident inputs of the packer, on the engine's
    device: rule namespaces, the instance and predicate-map masks as
    uint32 lanes in pack_bits layout (held as int32), the overlay
    columns, and the kernel's word tables: the verdict fold's namespace
    rows (models/policy_engine.fold_word_tables: vis_ns, vis_words), the
    rules that carry any instance bit, and each namespace row's
    predicate-map words (the reference's ns_ok ⊗ pred_map)."""
    rule_ns: torch.Tensor      # int32 [R]
    inst_bits: torch.Tensor    # int32 [R, ceil(n_items/32)]
    pred_bits: torch.Tensor    # int32 [R, ceil(n_maps/32)]
    cols: torch.Tensor         # int32 [C]
    default_ns: int
    n_cols: int                # layout columns (predicate item bits)
    n_items: int               # n_cols + n_maps
    n_maps: int
    vis_ns: torch.Tensor       # int32 [V]
    vis_words: torch.Tensor    # int32 [V + 1, ceil(R/32)]
    inst_any: torch.Tensor     # int32 [ceil(R/32)]
    pred_ns: torch.Tensor      # int32 [V + 1, ceil(n_maps/32)]

    @staticmethod
    def of(rule_ns: np.ndarray, default_ns: int, inst_mask: np.ndarray,
           pred_map_mask: np.ndarray, cols: np.ndarray, n_cols: int,
           n_items: int, device) -> "PackTables":
        """The tables of a plan's masks (int8 / bool [R, n_items] and
        [R, n_maps]) on `device`."""
        vis_ns, vis = vis_rows_of(rule_ns, default_ns)
        pred_ns = (vis.astype(np.int32) @ np.asarray(pred_map_mask,
                                                     np.int32)) > 0

        def lanes(mask: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(
                pack_bits(mask).view(np.int32))).to(device)
        return PackTables(
            rule_ns=torch.from_numpy(
                np.ascontiguousarray(rule_ns, np.int32)).to(device),
            inst_bits=lanes(inst_mask), pred_bits=lanes(pred_map_mask),
            cols=torch.from_numpy(np.asarray(cols, np.int32)).to(device),
            default_ns=default_ns, n_cols=n_cols, n_items=n_items,
            n_maps=int(pred_map_mask.shape[1]),
            vis_ns=torch.from_numpy(vis_ns).to(device),
            vis_words=lanes(vis),
            inst_any=lanes(np.asarray(inst_mask).any(axis=1)),
            pred_ns=lanes(pred_ns))

    @property
    def n_words(self) -> int:
        return (self.n_items + 31) // 32

    @property
    def n_rows_out(self) -> int:
        return 5 + self.n_words + (int(self.cols.numel()) + 31) // 32


def check_pack_plain(status: torch.Tensor, dur: torch.Tensor,
                     uses: torch.Tensor, deny_rule: torch.Tensor,
                     err_count: torch.Tensor, referenced: torch.Tensor,
                     matched: torch.Tensor, req_ns: torch.Tensor,
                     t: PackTables) -> torch.Tensor:
    """Plain version of the check_pack kernel: the reference's
    `FusedPlan._base_packer.<locals>.pack` (istio_tpu/runtime/
    fused.py:315-360), with the item ORs as 0/1 float32 matmuls (exact:
    every sum is an integer below 2^24) followed by > 0."""
    b = status.shape[0]
    dev = status.device
    head = torch.stack([status, dur.view(torch.int32), uses, deny_rule,
                        err_count.to(torch.int32).expand(b)])
    parts = [head]
    if t.n_items:
        ns_ok = (t.rule_ns[None, :] == t.default_ns) | \
            (t.rule_ns[None, :] == req_ns[:, None])
        active = matched & ns_ok
        items = torch.zeros((b, t.n_words * 32), dtype=torch.bool,
                            device=dev)
        items[:, :t.n_cols] = referenced[:, :t.n_cols]
        if t.n_maps:
            pred = unpack_bits(t.pred_bits, t.n_maps).to(torch.float32)
            items[:, t.n_cols:t.n_cols + t.n_maps] |= \
                (ns_ok.to(torch.float32) @ pred) > 0
        inst = unpack_bits(t.inst_bits, t.n_items).to(torch.float32)
        items[:, :t.n_items] |= (active.to(torch.float32) @ inst) > 0
        parts.append(pack_bool_rows(items, t.n_words))
    n_ov = int(t.cols.numel())
    if n_ov:
        n_ov_words = (n_ov + 31) // 32
        ov = torch.zeros((b, n_ov_words * 32), dtype=torch.bool, device=dev)
        ov[:, :n_ov] = matched[:, t.cols.long()]
        parts.append(pack_bool_rows(ov, n_ov_words))
    return torch.cat(parts, dim=0) if len(parts) > 1 else head


def check_pack_words_plain(status: torch.Tensor, dur: torch.Tensor,
                           uses: torch.Tensor, deny_rule: torch.Tensor,
                           err_count: torch.Tensor, referenced: torch.Tensor,
                           matched: torch.Tensor, req_ns: torch.Tensor,
                           t: PackTables) -> torch.Tensor:
    """Plain version of the check_pack kernel in its own formulation:
    each request's namespace row (vis_rows) gives its visible rules from
    vis_words and its predicate-map words from pred_ns (no walk of the
    rules); the instance OR runs over the rules that are matched,
    visible and carry an instance bit (inst_any), as a 0/1 float32
    matmul (exact: every sum is an integer below 2^24) then > 0."""
    b, n_rules = matched.shape
    dev = status.device
    head = torch.stack([status, dur.view(torch.int32), uses, deny_rule,
                        err_count.to(torch.int32).expand(b)])
    parts = [head]
    if t.n_items:
        row = vis_rows(req_ns, t.vis_ns)
        vis = unpack_bits(t.vis_words, n_rules)[row]
        act = matched & vis & unpack_bits(t.inst_any, n_rules)[None, :]
        items = torch.zeros((b, t.n_words * 32), dtype=torch.bool,
                            device=dev)
        items[:, :t.n_cols] = referenced[:, :t.n_cols]
        if t.n_maps:
            items[:, t.n_cols:t.n_cols + t.n_maps] |= \
                unpack_bits(t.pred_ns, t.n_maps)[row]
        inst = unpack_bits(t.inst_bits, t.n_items).to(torch.float32)
        items[:, :t.n_items] |= (act.to(torch.float32) @ inst) > 0
        parts.append(pack_bool_rows(items, t.n_words))
    n_ov = int(t.cols.numel())
    if n_ov:
        n_ov_words = (n_ov + 31) // 32
        ov = torch.zeros((b, n_ov_words * 32), dtype=torch.bool, device=dev)
        ov[:, :n_ov] = matched[:, t.cols.long()] != 0
        parts.append(pack_bool_rows(ov, n_ov_words))
    return torch.cat(parts, dim=0) if len(parts) > 1 else head


_K = kernels
_PACK_ARGS = ([_K.VP] * 6 + [_K.I32, _K.I32]          # verdict, referenced
              + [_K.VP, _K.I32, _K.I32]                 # matched
              + [_K.VP, _K.VP, _K.I32, _K.VP]           # namespace rows
              + [_K.VP, _K.VP, _K.I32, _K.VP, _K.I32, _K.I32]  # masks, W
              + [_K.VP, _K.I32, _K.VP, _K.VP])          # cols, out, stream


def check_pack(status: torch.Tensor, dur: torch.Tensor, uses: torch.Tensor,
               deny_rule: torch.Tensor, err_count: torch.Tensor,
               referenced: torch.Tensor, matched: torch.Tensor,
               req_ns: torch.Tensor, t: PackTables,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The packed int32 rows [5 + W + Cw, B] of one check batch (rows:
    status, TTL f32 bits, uses, deny_rule, err_count, W item words, Cw
    overlay words), written into `out` when given (the leading rows of
    the packed report buffer). CPU tensors run check_pack_plain."""
    dev = status.device
    b, n_rules = matched.shape
    if out is not None and (tuple(out.shape) != (t.n_rows_out, b) or
                            out.dtype != torch.int32 or out.device != dev or
                            not out.is_contiguous()):
        raise ValueError(f"check_pack: out must be a contiguous int32 "
                         f"[{t.n_rows_out}, {b}] tensor on {dev}")
    if dev.type == "cpu":
        got = check_pack_plain(status, dur, uses, deny_rule, err_count,
                               referenced, matched, req_ns, t)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"check_pack: unsupported device {dev}")
    want = {"status": (status, torch.int32, (b,)),
            "dur": (dur, torch.float32, (b,)),
            "uses": (uses, torch.int32, (b,)),
            "deny_rule": (deny_rule, torch.int32, (b,)),
            "err_count": (err_count, torch.int32, ()),
            "referenced": (referenced, torch.bool, None),
            "matched": (matched, torch.bool, None),
            "req_ns": (req_ns, torch.int32, (b,)),
            "vis_ns": (t.vis_ns, torch.int32, None),
            "vis_words": (t.vis_words, torch.int32,
                          (int(t.vis_ns.shape[0]) + 1, (n_rules + 31) // 32)),
            "inst_any": (t.inst_any, torch.int32, ((n_rules + 31) // 32,)),
            "inst_bits": (t.inst_bits, torch.int32, None),
            "pred_ns": (t.pred_ns, torch.int32,
                        (int(t.vis_ns.shape[0]) + 1, (t.n_maps + 31) // 32)),
            "cols": (t.cols, torch.int32, None)}
    for k, (x, dt, shape) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous() or \
                (shape is not None and tuple(x.shape) != shape):
            raise ValueError(f"check_pack: {k} must be a contiguous {dt} "
                             f"{shape or ''} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    iw, pw = int(t.inst_bits.shape[1]), int(t.pred_ns.shape[1])
    if referenced.shape[0] != b or referenced.shape[1] < t.n_cols or \
            tuple(t.inst_bits.shape) != (n_rules, t.n_words):
        raise ValueError("check_pack: mask or referenced shapes do not "
                         "match the plan")
    if out is None:
        out = torch.empty((t.n_rows_out, b), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    p = kernels.ptr
    fn = kernels.function("check_pack", "check_pack", _PACK_ARGS)
    rc = fn(p(status), p(dur), p(uses), p(deny_rule), p(err_count),
            p(referenced), int(referenced.shape[1]), t.n_cols,
            p(matched), b, n_rules, p(req_ns), p(t.vis_ns),
            int(t.vis_ns.shape[0]), p(t.vis_words), p(t.inst_any),
            p(t.inst_bits), iw, p(t.pred_ns), pw, t.n_words,
            p(t.cols), int(t.cols.numel()), p(out),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("check_pack", kernels.check(rc, "check_pack"),
                     status, dur, uses, deny_rule, err_count, referenced,
                     matched, req_ns, t)
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedPlan:
    """Per-snapshot serving plan: device engine + host overlay map."""
    engine: PolicyEngine
    # rule idx → CHECK actions the device cannot absorb (same tuples as
    # Snapshot.actions_for); host-fallback rules carry ALL their actions
    host_actions: dict[int, list]
    host_rule_idx: np.ndarray          # sorted keys of host_actions
    # per rule: attrs referenced by its CHECK instances
    instance_attrs: list[frozenset]
    deny_info: dict[int, tuple[int, str]]   # rule → (code, message)
    list_rules: frozenset
    rbac_rules: frozenset = frozenset()
    # why list actions stayed host-side, e.g. "CASE_INSENSITIVE_STRINGS"
    unfused_list_kinds: tuple = ()
    # rules carrying REPORT-variety actions (their activity bits ride
    # overlay_cols, as in the reference)
    report_rules: frozenset = frozenset()
    # QUOTA-variety wiring: [(rule idx, handler qname, instance qname,
    # accepted quota names)] in rule order
    quota_actions: tuple = ()
    # the C++ wire tensorizer is not ported: always None
    native: Any = None
    # rules whose FIRST check action is fused — device status wins ties
    # against host-overlay actions of the same rule
    fused_first_rules: frozenset = frozenset()
    # the only rule columns the host ever inspects per request
    overlay_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    fused_deny: int = 0
    fused_lists: int = 0
    # referenced-attribute items: item j < n_columns is the column's
    # slot/derived attr, item n_columns + m is map slot m's attr name
    item_names: list = dataclasses.field(default_factory=list)
    inst_mask: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.int8))
    pred_map_mask: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.int8))
    # rule → instance attrs with no layout item; such rules stay in
    # overlay_cols and their names merge host-side
    unmapped_instance_attrs: dict = dataclasses.field(default_factory=dict)
    _ns_pred_cache: dict = dataclasses.field(default_factory=dict)
    # the packer's device-resident tables (PackTables), built on first
    # use like the reference's jitted packer
    _packer: Any = None
    # compiled REPORT instance-field programs (runtime/report_lower.py);
    # None when no report instance lowered (the dispatcher then keeps
    # the host build)
    report_lowering: Any = None
    # on-device per-rule accumulators (runtime/rulestats.RuleTelemetry);
    # None when rule telemetry is disabled
    telemetry: Any = None
    # byte-plane length tiers (str_tiers(layout))
    str_tiers: tuple = ()
    # (bucket rows, byte width) pairs that have run once
    _warmed_shapes: set = dataclasses.field(default_factory=set)
    # (buckets, counter-plane shape) pairs prewarm_instep completed
    _instep_warmed: set = dataclasses.field(default_factory=set)

    @property
    def n_ref_words(self) -> int:
        return (len(self.item_names) + 31) // 32

    @property
    def n_overlay_words(self) -> int:
        return (len(self.overlay_cols) + 31) // 32

    def narrow_batch(self, batch: AttributeBatch) -> AttributeBatch:
        """Latency-tier byte-plane specialisation: when every string in
        the batch fits the small tier, slice str_bytes to it.
        Verdict-identical by construction (sliced lanes are zero padding
        past every row's length; the truncation contract compares
        str_lens against layout.max_str_len, which narrowing never
        changes). Host tensors only."""
        w = self._serve_width(batch)
        if batch.str_bytes.device.type != "cpu" \
                or w >= int(batch.str_bytes.shape[2]):
            return batch
        return dataclasses.replace(
            batch, str_bytes=batch.str_bytes[:, :, :w].contiguous())

    def pack_tables(self) -> PackTables:
        if self._packer is None:
            rs = self.engine.ruleset
            self._packer = PackTables.of(
                rs.rule_ns, rs.ns_ids[""], self.inst_mask,
                self.pred_map_mask, self.overlay_cols, rs.layout.n_columns,
                len(self.item_names), self.engine.device)
        return self._packer

    def packed_check(self, batch: AttributeBatch, ns_ids,
                     observe: bool = True,
                     n_real: int | None = None) -> np.ndarray:
        """engine step + rule-telemetry fold + packer on the device, then
        ONE pull of the int32 array [5 + W + Cw, B] (W = n_ref_words,
        Cw = n_overlay_words).

        Rows: 0 status, 1 valid_duration_s (f32 bits), 2
        valid_use_count, 3 deny_rule, 4 err_count (broadcast), 5..5+W
        referenced-item bits (little-endian within each int32), then
        matched[:, overlay_cols] bitpacked the same way (raw,
        ns-unmasked).

        `n_real`: count of non-padding rows (the leading prefix); rows
        past it are bucket padding the rule-telemetry fold ignores.
        None = every row is real."""
        from istio_tpu_torch.runtime import monitor

        batch = self.narrow_batch(batch)   # latency-tier byte plane
        tables = self.pack_tables()
        w = int(batch.str_bytes.shape[2])
        if observe:
            # fault-injection seam at the device boundary; gated on
            # observe so prewarm trips never trip it
            from istio_tpu_torch.runtime.resilience import CHAOS
            CHAOS.device_step()
        # h2d = staging + dispatch of the device work; device_step = the
        # blocking pull (execution + D2H)
        t0 = time.perf_counter()
        dev = self.engine.device
        ns_arr = np.asarray(ns_ids, np.int32)
        req = torch.from_numpy(ns_arr).to(dev, non_blocking=True)
        verdict = self.engine.check(batch, req)
        if observe and self.telemetry is not None:
            b = ns_arr.shape[0]
            real = np.arange(b) < (b if n_real is None else n_real)
            self.telemetry.observe(verdict, req, real)
        packed = check_pack(verdict.status, verdict.valid_duration_s,
                            verdict.valid_use_count, verdict.deny_rule,
                            verdict.err_count, verdict.referenced,
                            verdict.matched, req, tables)
        t1 = time.perf_counter()
        out = packed.cpu().numpy()          # the single device→host pull
        self._warmed_shapes.add((int(batch.ids.shape[0]), w))
        if observe:
            monitor.observe_stage("h2d", t1 - t0)
            monitor.observe_stage("device_step", time.perf_counter() - t1)
        return out

    def packed_report(self, batch: AttributeBatch, ns_ids) -> np.ndarray:
        """packed_check's rows PLUS the report instance-field rows in the
        SAME single device pull: after the overlay words come F int32
        value rows (intern ids; 0/1 for BOOL fields) and ceil(F/32)
        bitpacked field-valid words, F = report_lowering.n_fields. The
        engine step runs without the rule-telemetry fold (report traffic
        folds none, as in the reference); check_pack and field_eval write
        their rows into one preallocated buffer. With no field program
        the check rows alone serve."""
        rl = self.report_lowering
        if rl is None or rl.n_fields == 0:
            return self.packed_check(batch, ns_ids, observe=False)
        batch = self.narrow_batch(batch)   # latency-tier byte plane
        tables = self.pack_tables()
        dev = self.engine.device
        b, w = int(batch.ids.shape[0]), int(batch.str_bytes.shape[2])
        req = torch.from_numpy(np.asarray(ns_ids, np.int32)).to(
            dev, non_blocking=True)
        dbatch = batch.to(dev)
        verdict = self.engine.check(dbatch, req)
        head = tables.n_rows_out
        buf = torch.empty((head + rl.n_fields + rl.n_valid_words, b),
                          dtype=torch.int32, device=dev)
        check_pack(verdict.status, verdict.valid_duration_s,
                   verdict.valid_use_count, verdict.deny_rule,
                   verdict.err_count, verdict.referenced, verdict.matched,
                   req, tables, out=buf[:head])
        field_eval(dbatch, rl.program, out=buf[head:])
        out = buf.cpu().numpy()             # the single device→host pull
        self._warmed_shapes.add((b, w))
        return out

    def packed_check_instep(self, batch: AttributeBatch, ns_ids,
                            q: Mapping[str, Any], counts: torch.Tensor,
                            n_real: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """packed_check's rows PLUS an in-step quota allocation on the
        SAME trip: the quota-carrying batch pays one trip instead of a
        check trip and a pool-flush trip.

        `q` carries the staged per-row alloc arrays of an
        InlineQuotaSession (buckets / amounts / be / mx / active / ticks
        / lasts / rolling, plus rule_idx: the ruleset row whose matched
        bit gates the row). `counts` is the pool's counter plane; the
        alloc runs the quota_alloc kernel's seg mode, gated inside the
        kernel on the device's own verdict (active & rule_idx >= 0 &
        ns-visible rule & status OK & matched[row, rule]), into a clone
        of it. Returns DEVICE tensors (packed, new_counts): packed's
        last two rows are granted and gate once pulled; the caller moves
        the pool onto new_counts and then pulls."""
        from istio_tpu_torch.models.quota_alloc import QuotaGate, quota_alloc
        from istio_tpu_torch.runtime.device_quota import ROW_FIELDS

        batch = self.narrow_batch(batch)   # latency-tier byte plane
        tables = self.pack_tables()
        dev = self.engine.device
        b, w = int(batch.ids.shape[0]), int(batch.str_bytes.shape[2])
        ns_arr = np.asarray(ns_ids, np.int32)
        req = torch.from_numpy(ns_arr).to(dev, non_blocking=True)
        verdict = self.engine.check(batch, req)
        if self.telemetry is not None:
            # in-step quota batches ARE check traffic — the same per-rule
            # fold as packed_check (prewarm passes n_real=0: its dummy
            # trips count nothing)
            real = np.arange(b) < (b if n_real is None else n_real)
            self.telemetry.observe(verdict, req, real)
        head = tables.n_rows_out
        buf = torch.empty((head + 2, b), dtype=torch.int32, device=dev)
        check_pack(verdict.status, verdict.valid_duration_s,
                   verdict.valid_use_count, verdict.deny_rule,
                   verdict.err_count, verdict.referenced, verdict.matched,
                   req, tables, out=buf[:head])
        # one host→device copy of the staged rows and the rule column
        staged = np.stack([np.asarray(q[k], np.int32)
                           for k in (*ROW_FIELDS, "rule_idx")])
        rows = torch.from_numpy(staged).to(dev)
        gate = QuotaGate(status=verdict.status, matched=verdict.matched,
                         rule_idx=rows[len(ROW_FIELDS)],
                         rule_ns=tables.rule_ns, req_ns=req,
                         default_ns=tables.default_ns)
        new_counts = counts.clone()
        quota_alloc("seg", new_counts, *rows[:len(ROW_FIELDS)], gate=gate,
                    granted=buf[head], gate_out=buf[head + 1])
        self._warmed_shapes.add((b, w))
        return buf, new_counts

    def prewarm_instep(self, buckets, counts: torch.Tensor,
                       should_stop=None) -> None:
        """Run the in-step trip once for every serving shape (bucket ×
        byte tier) before traffic selects it. `counts` supplies only the
        plane's shape: the dummy trips run on a zero plane, all rows
        inactive, and never touch the pool. Completed (buckets, shape)
        pairs are memoized. `should_stop` is polled between shapes."""
        key = (tuple(sorted(set(buckets))), tuple(counts.shape))
        if key in self._instep_warmed:
            return
        zero_counts = torch.zeros_like(counts)
        for b, tier in self.all_warm_shapes(buckets):
            if should_stop is not None and should_stop():
                return
            q = {k: np.zeros(b, np.int32) for k in (
                "buckets", "amounts", "be", "mx", "active", "ticks",
                "lasts", "rolling")}
            q["rule_idx"] = np.full(b, -1, np.int32)
            packed, _ = self.packed_check_instep(
                self._dummy_batch(b, tier), np.zeros(b, np.int32), q,
                zero_counts, n_real=0)   # dummies feed no rule telemetry
            packed.cpu()
        self._instep_warmed.add(key)

    def pred_attrs_for_ns(self, ns_id: int) -> frozenset:
        """Union of predicate attr uses over rules visible to ns_id."""
        cached = self._ns_pred_cache.get(ns_id)
        if cached is not None:
            return cached
        rs = self.engine.ruleset
        default = rs.ns_ids[""]
        out: set = set()
        for ridx in range(rs.n_rules):
            if rs.rule_ns[ridx] == default or rs.rule_ns[ridx] == ns_id:
                out |= rs.attr_names[ridx]
        frozen = frozenset(out)
        self._ns_pred_cache[ns_id] = frozen
        return frozen

    def prewarm(self, buckets) -> None:
        """Run the serving entry once for every serving batch shape
        (bucket × byte tier) before the plan serves, the report entry
        too when report instances lowered. There is no trace to compile
        on the card: the kernels build once per process, at first use,
        so a warm trip only launches each shape once and records it in
        _warmed_shapes."""
        for b, tier in self.all_warm_shapes(buckets):
            batch, zeros = self._dummy_batch(b, tier), np.zeros(b, np.int32)
            self.packed_check(batch, zeros, observe=False)
            if self.report_lowering is not None and self.report_rules:
                self.packed_report(batch, zeros)

    def all_warm_shapes(self, buckets) -> list:
        """Every (bucket rows, byte tier) pair narrow_batch can route a
        served batch to."""
        lay = self.engine.ruleset.layout
        tiers = sorted(set(self.str_tiers or (lay.max_str_len,)))
        return [(b, t) for b in sorted(set(buckets)) for t in tiers]

    def _serve_width(self, batch) -> int:
        """The byte-plane width this batch serves at — THE tier-routing
        decision narrow_batch slices to. Host tensors only."""
        w = int(batch.str_bytes.shape[2])
        tiers = self.str_tiers
        if len(tiers) < 2 or batch.str_bytes.device.type != "cpu" \
                or batch.str_lens.device.type != "cpu":
            return w
        t = tiers[0]
        if w <= t or not batch.str_lens.numel():
            return w
        m = int(batch.str_lens.max())
        return t if m <= t else w

    def _dummy_batch(self, b: int, tier: int) -> AttributeBatch:
        """Dummy batch routed to exactly one byte-plane tier of bucket
        size `b` (lens pinned AT the tier)."""
        lay = self.engine.ruleset.layout
        tiers = sorted(set(self.str_tiers or (lay.max_str_len,)))
        lens = 0 if tier == min(tiers) else tier
        nb = max(lay.n_byte_slots, 1)
        return AttributeBatch(
            ids=torch.zeros((b, lay.n_columns), dtype=torch.int32),
            present=torch.zeros((b, lay.n_columns), dtype=torch.bool),
            map_present=torch.zeros((b, max(lay.n_maps, 1)),
                                    dtype=torch.bool),
            str_bytes=torch.zeros((b, nb, lay.max_str_len),
                                  dtype=torch.uint8),
            str_lens=torch.full((b, nb), lens, dtype=torch.int32),
            hash_ids=torch.zeros((b, lay.n_columns), dtype=torch.int32))

    def message_for(self, rule_idx: int, status: int) -> str:
        """Best-effort status message for a device-produced denial."""
        info = self.deny_info.get(rule_idx)
        if info is not None and info[0] == status:
            return info[1]
        if rule_idx in self.rbac_rules:
            if status == PERMISSION_DENIED:
                return "RBAC: permission denied"
            if status == INTERNAL:
                return "authorization instance evaluation failed"
        if rule_idx in self.list_rules:
            if status == INTERNAL:
                return "list instance evaluation failed"
            name = self.engine.ruleset.rules[rule_idx].name
            return f"rejected by list check (rule {name})"
        return "denied by policy"


def build_fused_plan(snapshot: Snapshot,
                     mesh=None,
                     rule_telemetry: bool = True) -> FusedPlan | None:
    """Extract fusable CHECK actions and build the snapshot's engine on
    the ruleset's device. `rule_telemetry` wires per-rule hit/deny/err
    accumulators (runtime/rulestats.RuleTelemetry) into packed_check.
    `mesh` (parallel/mesh.Mesh, dp × mp) makes the engine's step the
    sharded one (parallel/mesh.shard_engine_check)."""
    rs = snapshot.ruleset
    if rs.n_rules == 0:
        return None
    layout = rs.layout

    deny_by_rule: dict[int, DenySpec] = {}
    deny_info: dict[int, tuple[int, str]] = {}
    lists: list[ListEntrySpec] = []
    list_rules: set[int] = set()
    unfused_kinds: set[str] = set()
    rbacs: list[RbacSpec] = []
    rbac_rules: set[int] = set()
    host_actions: dict[int, list] = {}
    instance_attrs: list[frozenset] = []
    # ruleset rows beyond the config rules are rbac pseudo-rules — they
    # carry no actions and never appear in overlays or host fallbacks
    n_real = len(snapshot.rules)

    def add_host(ridx: int, action) -> None:
        host_actions.setdefault(ridx, []).append(action)

    fused_first: set[int] = set()
    for ridx in range(n_real):
        attrs: set = set()
        for pos, action in enumerate(
                snapshot.actions_for(ridx, Variety.CHECK)):
            hc, template, inst_names = action
            for iname in inst_names:
                attrs |= snapshot.instances[iname].referenced_attrs
            if ridx in rs.host_fallback:
                # device matched==False for fallback rules; their fused
                # contributions would be inert — run everything on host
                add_host(ridx, action)
                continue
            if hc.adapter == "rbac" and template == "authorization":
                handler_ref = _qualify(hc.name, hc.namespace)
                fused_insts, host_insts = [], []
                for iname in inst_names:
                    g = snapshot.rbac_groups.get((handler_ref, iname))
                    if g is not None and g.lowered:
                        fused_insts.append((iname, g))
                    else:
                        host_insts.append(iname)
                if fused_insts and pos == 0 and not host_insts:
                    fused_first.add(ridx)
                for iname, g in fused_insts:
                    rbacs.append(RbacSpec(
                        rule=ridx, allow_rows=g.allow_rows,
                        guard_row=g.guard_row,
                        valid_duration_s=float(
                            hc.params.get("caching_ttl_s", 60.0))))
                    rbac_rules.add(ridx)
                if host_insts:
                    add_host(ridx, (hc, template, host_insts))
                continue
            if hc.adapter == "denier":
                if pos == 0:
                    fused_first.add(ridx)
                code = int(hc.params.get("status_code", PERMISSION_DENIED))
                msg = str(hc.params.get("status_message", "denied"))
                dur = float(hc.params.get("valid_duration_s", 5.0))
                uses = int(hc.params.get("valid_use_count", 10_000))
                prev = deny_by_rule.get(ridx)
                if prev is None:
                    deny_by_rule[ridx] = DenySpec(
                        rule=ridx, status=code, valid_duration_s=dur,
                        valid_use_count=uses)
                    deny_info[ridx] = (code, msg)
                else:   # merged denier actions: first status, min TTLs
                    deny_by_rule[ridx] = DenySpec(
                        rule=ridx, status=prev.status,
                        valid_duration_s=min(prev.valid_duration_s, dur),
                        valid_use_count=min(prev.valid_use_count, uses))
                continue
            if hc.adapter == "list" and template == "listentry":
                fused, host = _split_list_instances(
                    snapshot, hc, inst_names, layout, unfused_kinds)
                if pos == 0 and fused and not host:
                    fused_first.add(ridx)
                for iname, value_attr in fused:
                    lists.append(ListEntrySpec(
                        rule=ridx, value_attr=value_attr,
                        entries=list(hc.params.get("overrides", ())),
                        blacklist=bool(hc.params.get("blacklist", False)),
                        valid_duration_s=float(
                            hc.params.get("caching_ttl_s", 300.0)),
                        valid_use_count=int(
                            hc.params.get("caching_use_count", 10_000)),
                        entry_type=str(hc.params.get("entry_type",
                                                     "STRINGS"))))
                    list_rules.add(ridx)
                if host:
                    add_host(ridx, (hc, template, host))
                continue
            add_host(ridx, action)
        instance_attrs.append(frozenset(attrs))

    # QUOTA-variety actions, recorded in rule order
    quota_actions: list = []
    quota_rules: set[int] = set()
    for ridx in range(n_real):
        for hc, template, inst_names in snapshot.actions_for(
                ridx, Variety.QUOTA):
            for iname in inst_names:
                names = frozenset({iname, iname.split(".")[0]})
                quota_actions.append(
                    (ridx, _qualify(hc.name, hc.namespace), iname, names))
                quota_rules.add(ridx)

    engine = PolicyEngine(ruleset=rs, finder=snapshot.finder,
                          deny=list(deny_by_rule.values()), lists=lists,
                          quotas=(), rbacs=rbacs, count_rules=n_real,
                          device=rs.device)
    if mesh is not None:
        from istio_tpu_torch.parallel.mesh import shard_engine_check
        engine._step = shard_engine_check(mesh, engine)
    log.info("fused plan: %d deny rules, %d lists, %d rbac actions "
             "(%d pseudo-rules), %d host-overlay rules", len(deny_by_rule),
             len(lists), len(rbacs), rs.n_rules - n_real, len(host_actions))

    # referenced-attribute item space: every layout column (slot or
    # derived) plus every map slot
    n_cols, n_maps = layout.n_columns, layout.n_maps
    item_names: list = [None] * (n_cols + n_maps)
    item_of: dict = {}
    for name, col in layout.slots.items():
        item_names[col] = name
        item_of[name] = col
    for pair, col in layout.derived_slots.items():
        item_names[col] = pair
        item_of[pair] = col
    for name, mcol in layout.map_slots.items():
        item_names[n_cols + mcol] = name
        item_of[name] = n_cols + mcol
    n_items = len(item_names)
    n_rows = int(rs.rule_ns.shape[0])   # incl. rule-axis padding
    inst_mask = np.zeros((n_rows, n_items), np.int8)
    unmapped: dict[int, frozenset] = {}
    for ridx, attrs in enumerate(instance_attrs):
        if ridx in rs.host_fallback:
            # the device never knows whether a host-fallback rule
            # matched — its instance attrs merge host-side
            if attrs:
                unmapped[ridx] = attrs
            continue
        missing = []
        for item in attrs:
            idx = item_of.get(item)
            if idx is None:
                missing.append(item)
            else:
                inst_mask[ridx, idx] = 1
        if missing:
            unmapped[ridx] = frozenset(missing)
    # predicate MAP-name uses (e.g. `ar["k"]` references "ar" too)
    pred_map_mask = np.zeros((n_rows, max(n_maps, 1)), np.int8)
    for ridx in range(rs.n_rules):
        for item in rs.attr_names[ridx]:
            if isinstance(item, str) and item in layout.map_slots:
                pred_map_mask[ridx, layout.map_slots[item]] = 1

    report_rules = {ridx for ridx in range(n_real)
                    if snapshot.actions_for(ridx, Variety.REPORT)}
    # after the engine, as in the reference: report constants intern in
    # the same order, so the field rows of the pull are byte-equal
    report_lowering = build_report_lowering(snapshot) if report_rules \
        else None
    real_fallback = {r for r in rs.host_fallback if r < n_real}
    overlay = set(host_actions) | real_fallback | set(unmapped) \
        | quota_rules | report_rules
    telemetry = None
    if rule_telemetry:
        from istio_tpu_torch.runtime.rulestats import RuleTelemetry
        telemetry = RuleTelemetry(rs, n_real)
    return FusedPlan(engine=engine, telemetry=telemetry,
                     # AFTER every compile above (engine, report
                     # lowering): the interner's constant-length max is
                     # grow-only
                     str_tiers=str_tiers(layout, rs.interner),
                     host_actions=host_actions,
                     host_rule_idx=np.asarray(sorted(host_actions),
                                              np.int64),
                     instance_attrs=instance_attrs,
                     deny_info=deny_info,
                     list_rules=frozenset(list_rules),
                     rbac_rules=frozenset(rbac_rules),
                     quota_actions=tuple(quota_actions),
                     fused_first_rules=frozenset(fused_first),
                     overlay_cols=np.asarray(sorted(overlay), np.int64),
                     fused_deny=len(deny_by_rule), fused_lists=len(lists),
                     item_names=item_names,
                     inst_mask=inst_mask,
                     pred_map_mask=pred_map_mask[:, :n_maps]
                     if n_maps else np.zeros((n_rows, 0), np.int8),
                     unmapped_instance_attrs=unmapped,
                     unfused_list_kinds=tuple(sorted(unfused_kinds)),
                     report_rules=frozenset(report_rules),
                     report_lowering=report_lowering)


def _split_list_instances(snapshot: Snapshot, hc, inst_names, layout,
                          unfused_kinds: set | None = None
                          ) -> tuple[list, list]:
    """(fused [(iname, value_attr)], host [iname]) for a list action —
    the reference's decision, unchanged. Fusable entry types: STRINGS
    (static overrides, exact match), REGEX (every pattern DFA-
    compilable; value needs a byte slot) and IP_ADDRESSES (every entry a
    parseable CIDR; an IP_ADDRESS-typed value with a byte slot).
    CASE_INSENSITIVE_STRINGS and refreshable providers keep host
    semantics; `unfused_kinds` collects why an action stayed host-side."""
    p: Mapping[str, Any] = hc.params
    et = p.get("entry_type", "STRINGS")

    def reject(reason: str) -> tuple[list, list]:
        if unfused_kinds is not None:
            unfused_kinds.add(reason)
        return [], list(inst_names)

    if et not in _FUSABLE_LIST_TYPES:
        return reject(et)
    if p.get("provider") is not None or p.get("provider_url"):
        return reject("provider-refreshed")
    entries = p.get("overrides", ())
    if et == "STRINGS":
        if not all(isinstance(e, str) for e in entries):
            return reject("STRINGS:non-string-entries")
    elif et == "REGEX":
        from istio_tpu_torch.ops.regex_dfa import compile_regex
        try:
            for e in entries:
                compile_regex(str(e))
        except Exception:
            return reject("REGEX:unsupported-pattern")
    elif et == "IP_ADDRESSES":
        import ipaddress
        try:
            for e in entries:
                ipaddress.ip_network(str(e), strict=False)
        except ValueError:
            return reject("IP_ADDRESSES:bad-cidr")
    from istio_tpu_torch.attribute.types import ValueType
    fused, host = [], []
    for iname in inst_names:
        ref = snapshot.instances[iname].value_attr_ref()
        slot_ok = ref is not None and (
            ref in layout.derived_slots if isinstance(ref, tuple)
            else ref in layout.slots)
        if et in ("REGEX", "IP_ADDRESSES"):
            slot_ok = slot_ok and ref in layout.byte_slots
        if et == "IP_ADDRESSES":
            # only IP_ADDRESS-typed attrs carry raw IP bytes
            if isinstance(ref, tuple) or \
                    layout.manifest.get(ref) != ValueType.IP_ADDRESS:
                slot_ok = False
        elif not isinstance(ref, tuple) and \
                layout.manifest.get(ref) == ValueType.IP_ADDRESS:
            # STRINGS/REGEX over an IP-typed value: the host adapter
            # normalises the bytes to a textual IP before matching
            slot_ok = False
        if slot_ok:
            fused.append((iname, ref))
        else:
            host.append(iname)
            if unfused_kinds is not None:
                unfused_kinds.add(f"{et}:value-not-lowerable")
    return fused, host
