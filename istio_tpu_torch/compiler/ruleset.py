"""Ruleset compiler: N match predicates → one batched tensor program.

Port of istio_tpu/compiler/ruleset.py. The host compile is the
reference's, step for step, so the emitted index tensors (lit_idx,
conj_m_idx, conj_n_idx, eqc_*) are array_equal to the JAX package's.
The device program runs through the rule_match kernel
(csrc/rule_match.cu); constant regex atoms through dfa_scan and constant
byte predicates through byte_pred (ops/bytes_ops.py).

This is the batched replacement for the reference resolver's per-request
loop (mixer/pkg/runtime/resolver.go:202-238 filterActions — which calls
the IL interpreter once per rule per request, 100-600ns each per
bench.baseline). Here a whole config snapshot compiles ONCE into device
tensors and every request batch is matched against ALL rules in one
fused device program:

    atoms:   evaluate every unique primitive predicate once per request
             → m[B, A] "definitely true", n[B, A] "definitely false"
    conj:    lit = [m ‖ n ‖ TRUE];  sat[B, n_conj] = AND over each
             conjunction's padded literal indices (gather + all)
    rules:   matched = OR over each rule's M-conjunction indices;
             not_matched likewise over N; err = ~matched & ~not_matched

The conj/rule stages are padded index gathers + reductions rather than
one-hot [2A, n_conj] / [n_conj, R] matmuls: conjunctions average only a
few literals, so a dense matmul would burn ~1000× the useful operations.

Exactness: each predicate's AST is decomposed over its top-level
LAND/LOR skeleton into a pair of monotone DNFs over per-atom literals
{m_a, n_a}, where m_a = val∧¬err ("definitely true") and
n_a = ¬val∧¬err ("definitely false"):

    M(atom)      = {{m_a}}                 N(atom)      = {{n_a}}
    M(a && b)    = M(a)∧M(b)               N(a && b)    = N(a) ∨ (M(a)∧N(b))
    M(a || b)    = M(a) ∨ (N(a)∧M(b))      N(a || b)    = N(a)∧N(b)

These recurrences are provably equivalent to the short-circuit +
error-propagation semantics of the oracle (expr/oracle.py,
mirroring IL generateLand/generateLor compiler.go:373/:354): e.g. a
short-circuited `false && err` is N(a)∧anything ⇒ not-matched, while
`true && err` is neither M nor N ⇒ error. The conformance tests
(tests/test_ruleset.py, tests/test_torch_ruleset.py) check every corpus predicate against the oracle.

Atoms are deduplicated ACROSS rules (10k istio rules share a few hundred
distinct predicates in practice) and evaluated in three tiers:
  1. a vectorized gather-compare for EQ/NEQ(slot, const) — covers the
     overwhelming majority of real istio match clauses;
  2. a vectorized slot-vs-slot compare;
  3. per-atom compiled closures from tensor_expr for everything else
     (byte predicates, `|` fallback chains, nested EQ of booleans).

Rules whose predicate cannot lower (dynamic patterns, DNF blowup past
`dnf_cap`) are marked host-fallback and carry an OracleProgram; the
runtime dispatcher overlays their verdicts on the device result.

ReferencedAttributes (protoBag.go:117 semantics) become compile-time
per-rule attribute bitmaps (SURVEY.md §2.2 translation note).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.layout import (AttributeBatch, BatchLayout,
                                             ID_FALSE, ID_TRUE, InternTable,
                                             build_layout)
from istio_tpu_torch.compiler import tensor_expr
from istio_tpu_torch.compiler.tensor_expr import (HostFallback, Requirements,
                                                  collect_requirements)
from istio_tpu_torch.device import NotPorted, resolve_device
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder,
                                          DEFAULT_FUNCS, TypeError_,
                                          eval_type)
from istio_tpu_torch.expr.exprs import Expression
from istio_tpu_torch.expr.externs import (ExternError, extern_ip,
                                          extern_timestamp)
from istio_tpu_torch.expr.oracle import OracleProgram
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.ops.regex_dfa import compile_regex

V = ValueType

# A literal is (atom_index, kind): kind 'm' = definitely-true,
# 'n' = definitely-false. A conjunction is a frozenset of literals; a DNF
# a set of conjunctions.
Literal = tuple[int, str]
Conj = frozenset
Dnf = set

DEFAULT_DNF_CAP = 128


class DnfBlowup(HostFallback):
    """Predicate's DNF exceeded dnf_cap conjunctions."""


def _contradicts(c: Conj) -> bool:
    idxs = {}
    for idx, kind in c:
        prev = idxs.get(idx)
        if prev is not None and prev != kind:
            return True
        idxs[idx] = kind
    return False


def _dnf_and(a: Dnf, b: Dnf, cap: int) -> Dnf:
    out: Dnf = set()
    for x in a:
        for y in b:
            c = x | y
            if not _contradicts(c):
                out.add(c)
    if len(out) > cap:
        raise DnfBlowup(f"DNF exceeded {cap} conjunctions")
    return _prune(out)


def _prune(d: Dnf) -> Dnf:
    """Drop subsumed conjunctions (c2 ⊇ c1 is redundant)."""
    by_size = sorted(d, key=len)
    kept: list[Conj] = []
    for c in by_size:
        if not any(k <= c for k in kept):
            kept.append(c)
    return set(kept)


@dataclasses.dataclass
class Rule:
    """A policy rule's match clause (reference: the `match:` field of a
    mixer rule, config.proto; resolver.go:34 Rule)."""
    name: str
    match: str = ""          # empty = always matches (resolver.go:219)
    namespace: str = ""
    # pre-built predicate AST (synthesized pseudo-rules, e.g. the rbac
    # lowering compiler/rbac_lower.py) — used instead of parsing `match`
    ast: Expression | None = None


def _rule_ast(rule: Rule) -> Expression:
    if rule.ast is not None:
        return rule.ast
    return parse(rule.match.strip() or "true")


def _rule_oracle(rule: Rule,
                 finder: AttributeDescriptorFinder) -> OracleProgram:
    if rule.ast is not None:
        return OracleProgram.from_ast(rule.ast, finder)
    return OracleProgram(rule.match.strip() or "true", finder)


@dataclasses.dataclass
class _AtomTable:
    """Deduplicated primitive predicates across all rules. Append-only
    with O(added) rollback: mark() before a speculative decompose,
    revert(mark) drops only the atoms added since — copying the whole
    table per rule made snapshot compile quadratic in rule count."""
    asts: list[Expression] = dataclasses.field(default_factory=list)
    by_key: dict[str, int] = dataclasses.field(default_factory=dict)
    _keys: list[str] = dataclasses.field(default_factory=list)

    def index_of(self, e: Expression) -> int:
        key = str(e)
        idx = self.by_key.get(key)
        if idx is None:
            idx = len(self.asts)
            self.by_key[key] = idx
            self.asts.append(e)
            self._keys.append(key)
        return idx

    def mark(self) -> int:
        return len(self.asts)

    def revert(self, mark: int) -> None:
        for key in self._keys[mark:]:
            del self.by_key[key]
        del self._keys[mark:]
        del self.asts[mark:]


def _decompose(e: Expression, atoms: _AtomTable, cap: int) -> tuple[Dnf, Dnf]:
    """→ (M, N): DNFs for definitely-matched / definitely-not-matched."""
    if e.const_ is not None and e.const_.vtype == V.BOOL:
        if e.const_.value:
            return ({frozenset()}, set())
        return (set(), {frozenset()})
    if e.fn is not None and e.fn.name in ("LAND", "LOR"):
        name = e.fn.name
        args = e.fn.args
        m, n = _decompose(args[0], atoms, cap)
        for arg in args[1:]:
            ma, na = _decompose(arg, atoms, cap)
            if name == "LAND":
                m, n = _dnf_and(m, ma, cap), _prune(n | _dnf_and(m, na, cap))
            else:
                m, n = _prune(m | _dnf_and(n, ma, cap)), _dnf_and(n, na, cap)
        return m, n
    idx = atoms.index_of(e)
    return ({frozenset([(idx, "m")])}, {frozenset([(idx, "n")])})


def _fold_time_const(e: Expression) -> Any | None:
    """Fold ip("c")/timestamp("c") over a constant into a value;
    None if not that shape. ExternError propagates (oracle parity: the
    atom then always errors — handled by the general path)."""
    f = e.fn
    if f is None or f.name not in ("ip", "timestamp"):
        return None
    if not f.args or f.args[0].const_ is None:
        return None
    raw = f.args[0].const_.value
    return extern_ip(raw) if f.name == "ip" else extern_timestamp(raw)


@dataclasses.dataclass
class _SlotRef:
    col: int


def _slot_ref(e: Expression, layout: BatchLayout,
              finder: AttributeDescriptorFinder) -> _SlotRef | None:
    """Variable or INDEX(map, const-key) → its scalar/derived column."""
    if e.var is not None:
        vt = finder.get_attribute(e.var.name)
        if vt is None or vt == V.STRING_MAP:
            return None
        return _SlotRef(layout.slot_of(e.var.name))
    f = e.fn
    if (f is not None and f.name == "INDEX" and f.args[0].var is not None
            and f.args[1].const_ is not None
            and isinstance(f.args[1].const_.value, str)):
        pair = (f.args[0].var.name, f.args[1].const_.value)
        if pair in layout.derived_slots:
            return _SlotRef(layout.derived_slots[pair])
    return None


def _const_id(e: Expression, interner: InternTable) -> int | None:
    """Constant operand (or foldable ip()/timestamp()) → intern id."""
    if e.const_ is not None:
        v = e.const_.value
        if isinstance(v, bool):
            return ID_TRUE if v else ID_FALSE
        return interner.intern(v)
    try:
        folded = _fold_time_const(e)
    except ExternError:
        return None
    if folded is None:
        return None
    return interner.intern(folded)


@dataclasses.dataclass
class RuleSetProgram:
    """The compiled snapshot. `fn(batch)` → (matched, not_matched, err)
    each bool[B, n_rows], where n_rows = n_rules rounded up to
    `rule_pad` (mp-sharding padding; pad rows read False/True/False and
    belong to an unmatchable namespace — size consumers off
    rule_ns.shape[0], NOT n_rules). Host-fallback rules read
    False/False/True on device; overlay with `host_eval`."""
    rules: list[Rule]
    layout: BatchLayout
    interner: InternTable
    fn: Callable[..., tuple[Any, Any, Any]]   # fn(params, batch)
    params: Mapping[str, Any]   # device index tensors (lit_idx/conj_*_idx)
    n_atoms: int
    n_conjs: int
    host_fallback: dict[int, OracleProgram]   # rule idx → oracle
    fallback_reason: dict[int, str]
    attr_mask: np.ndarray                     # bool [n_rows, n_columns]
    attr_names: list[set]                     # per REAL rule (n_rules)
    rule_ns: np.ndarray                       # int32 [n_rows]
    ns_ids: dict[str, int]
    # ---- evaluation tier of each atom ("id-eq", "slot-eq", "dfa-pack",
    #      "tensor")
    atom_tier: dict[int, str] = dataclasses.field(default_factory=dict)
    # ---- compiled-shape geometry (atom tier counts, conjunction split,
    #      padded index widths)
    geometry: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    @property
    def n_rules(self) -> int:
        return len(self.rules)

    def __call__(self, batch: AttributeBatch) -> tuple[Any, Any, Any]:
        return self.fn(self.params, batch.to(self.device))

    def namespace_id(self, ns: str) -> int:
        """Id for a request namespace; unknown namespaces match only
        default-namespace ('') rules."""
        return self.ns_ids.get(ns, -1)

    def namespace_mask(self, req_ns_ids: Any) -> Any:
        """bool[B, n_rules]: rule visible to the request's namespace —
        default-namespace rules apply to everyone (resolver.go:110
        default + destination-namespace rule lists)."""
        rns = torch.from_numpy(self.rule_ns)
        req = torch.as_tensor(np.asarray(req_ns_ids, np.int32))
        return (rns[None, :] == self.ns_ids[""]) | (rns[None, :] == req[:, None])

    def host_eval(self, rule_idx: int, bag) -> tuple[bool, bool, bool]:
        """(matched, not_matched, err) for one host-fallback rule."""
        prog = self.host_fallback[rule_idx]
        try:
            v = bool(prog.evaluate(bag))
            return v, not v, False
        except Exception:
            return False, False, True


# ---------------------------------------------------------------------------
# K1: rule match (csrc/rule_match.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RuleMatchConsts:
    """The compile-time structure of one snapshot's rule-match program
    that rides beside its params: legacy EQ / slot-EQ literal columns
    (closure constants in the reference too) and the block widths."""
    n_fused: int          # fused all-EQ conjunctions (sat columns first)
    use_legacy: bool      # the literal-plane stage exists
    n_live: int           # width of each m / n literal block
    n_sat: int            # = CONJ_FALSE = max(n_conjs, 1)
    eq_cols: torch.Tensor  # int32 [E]
    eq_cids: torch.Tensor  # int32 [E]
    eq_neg: torch.Tensor   # bool [E]
    ss_a: torch.Tensor     # int32 [S]
    ss_b: torch.Tensor     # int32 [S]
    ss_neg: torch.Tensor   # bool [S]

    @classmethod
    def of(cls, *, device: torch.device, **kw) -> "RuleMatchConsts":
        for k in ("eq_cols", "eq_cids", "eq_neg", "ss_a", "ss_b", "ss_neg"):
            kw[k] = torch.from_numpy(np.ascontiguousarray(kw[k])).to(device)
        return cls(**kw)


def rule_match_plain(ids: torch.Tensor, present: torch.Tensor,
                     ext_m: torch.Tensor, ext_n: torch.Tensor,
                     params: Mapping[str, torch.Tensor],
                     c: RuleMatchConsts) -> tuple[Any, Any, Any]:
    """Plain version of the rule_match kernel: the reference's
    `compile_ruleset.<locals>.run` (istio_tpu/compiler/ruleset.py:798).
    ext_m / ext_n bool [B, X] are the DFA-group and generic-atom literal
    columns in the reference's order (eq-live, slot-EQ, DFA, gen)."""
    b = ids.shape[0]
    dev = ids.device
    sat_parts = []
    if c.n_fused:
        col = params["eqc_col"].long()
        iv = ids[:, col]                                  # [B, F, Lf]
        pv = present[:, col]
        hit = ((iv == params["eqc_cid"][None]) ^ params["eqc_xor"][None]) \
            & pv
        sat_parts.append((hit | params["eqc_pad"][None]).all(dim=2))
    if c.use_legacy:
        parts_m, parts_n = [], []
        if c.eq_cols.numel():
            cols = c.eq_cols.long()
            cmp = (ids[:, cols] == c.eq_cids[None, :]) ^ c.eq_neg[None, :]
            pres = present[:, cols]
            parts_m.append(cmp & pres)
            parts_n.append(~cmp & pres)
        if c.ss_a.numel():
            sa, sb = c.ss_a.long(), c.ss_b.long()
            pres = present[:, sa] & present[:, sb]
            cmp = (ids[:, sa] == ids[:, sb]) ^ c.ss_neg[None, :]
            parts_m.append(cmp & pres)
            parts_n.append(~cmp & pres)
        parts_m.append(ext_m)
        parts_n.append(ext_n)
        m_all = torch.cat(parts_m, dim=1)
        n_all = torch.cat(parts_n, dim=1)
        if m_all.shape[1] == 0:
            m_all = n_all = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        # lit[:, LIT_TRUE] is the AND-identity sentinel
        lit = torch.cat([m_all, n_all,
                         torch.ones((b, 1), dtype=torch.bool, device=dev)],
                        dim=1)
        sat_parts.append(lit[:, params["lit_idx"].long()].all(dim=2))
    sat = torch.cat(sat_parts, dim=1)                     # [B, n_sat]
    # sat[:, CONJ_FALSE] is the OR-identity sentinel, sat[:, CONJ_TRUE]
    # the always-true column rule-axis padding points its N gather at
    sat_ext = torch.cat([sat, torch.zeros((b, 1), dtype=torch.bool,
                                          device=dev),
                         torch.ones((b, 1), dtype=torch.bool, device=dev)],
                        dim=1)
    matched = sat_ext[:, params["conj_m_idx"].long()].any(dim=2)
    not_matched = sat_ext[:, params["conj_n_idx"].long()].any(dim=2)
    err = ~matched & ~not_matched
    return matched, not_matched, err


_K = kernels
_RULE_MATCH_ARGS = ([_K.VP, _K.VP, _K.I32, _K.I32]              # ids..C
                    + [_K.I32, _K.I32] + [_K.VP] * 4             # fused
                    + [_K.I32, _K.I32] + [_K.VP] * 3             # legacy EQ
                    + [_K.I32] + [_K.VP] * 3                     # slot-EQ
                    + [_K.I32, _K.VP, _K.VP, _K.I32]             # ext, n_live
                    + [_K.I32, _K.I32, _K.VP, _K.VP]             # lit_idx, lit
                    + [_K.I32, _K.VP]                            # n_sat, sat
                    + [_K.I32, _K.I32, _K.VP, _K.VP]             # conj idx
                    + [_K.VP] * 3 + [_K.VP])                     # outs, stream


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple | None = None) -> torch.Tensor:
    if t.dtype != dtype:
        raise ValueError(f"rule_match: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"rule_match: {name} shape {tuple(t.shape)} != "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"rule_match: {name} must be contiguous")
    return t


def rule_match(ids: torch.Tensor, present: torch.Tensor,
               ext_m: torch.Tensor, ext_n: torch.Tensor,
               params: Mapping[str, torch.Tensor],
               c: RuleMatchConsts) -> tuple[Any, Any, Any]:
    """matched / not_matched / err, each bool [B, R], of every rule for
    every request: the fused all-EQ gather-compare, the legacy literal
    plane (EQ, slot-EQ, then ext columns), the literal AND over lit_idx
    and the rule OR over conj_m_idx / conj_n_idx, in one chain of
    launches. CPU tensors run rule_match_plain."""
    if ids.device.type == "cpu":
        return rule_match_plain(ids, present, ext_m, ext_n, params, c)
    if ids.device.type != "cuda":
        raise ValueError(f"rule_match: unsupported device {ids.device}")
    b, n_cols = ids.shape
    _check(ids, "ids", torch.int32)
    _check(present, "present", torch.bool, (b, n_cols))
    x = int(ext_m.shape[1])
    ext_m = _check(ext_m.contiguous(), "ext_m", torch.bool, (b, x))
    ext_n = _check(ext_n.contiguous(), "ext_n", torch.bool, (b, x))
    eqc = [_check(params[k], k, dt) for k, dt in (
        ("eqc_col", torch.int32), ("eqc_cid", torch.int32),
        ("eqc_xor", torch.bool), ("eqc_pad", torch.bool))]
    lit_idx = _check(params["lit_idx"], "lit_idx", torch.int32)
    cm = _check(params["conj_m_idx"], "conj_m_idx", torch.int32)
    cn = _check(params["conj_n_idx"], "conj_n_idx", torch.int32,
                tuple(cm.shape))
    for t in (*eqc, lit_idx, cm, cn, ext_m, present):
        if t.device != ids.device:
            raise ValueError("rule_match: tensors on different devices")
    n_rows, k_max = cm.shape
    n_eq = int(c.eq_cols.numel())
    n_ss = int(c.ss_a.numel())
    if c.use_legacy and max(n_eq + n_ss + x, 1) != c.n_live:
        raise ValueError("rule_match: literal columns do not add up to "
                         "n_live")
    dev = ids.device
    lit_w = 2 * c.n_live + 1
    lit = torch.empty((b, lit_w if c.use_legacy else 0), dtype=torch.bool,
                      device=dev)
    sat = torch.empty((b, c.n_sat + 2), dtype=torch.bool, device=dev)
    matched = torch.empty((b, n_rows), dtype=torch.bool, device=dev)
    not_matched = torch.empty_like(matched)
    err = torch.empty_like(matched)
    if b == 0:
        return matched, not_matched, err
    p = kernels.ptr
    fn = kernels.function("rule_match", "rule_match", _RULE_MATCH_ARGS)
    rc = fn(p(ids), p(present), b, n_cols,
            c.n_fused, int(eqc[0].shape[1]), *(p(t) for t in eqc),
            int(c.use_legacy), n_eq, p(c.eq_cols), p(c.eq_cids),
            p(c.eq_neg),
            n_ss, p(c.ss_a), p(c.ss_b), p(c.ss_neg),
            x, p(ext_m), p(ext_n), c.n_live,
            int(lit_idx.shape[0]), int(lit_idx.shape[1]), p(lit_idx), p(lit),
            c.n_sat, p(sat),
            n_rows, k_max, p(cm), p(cn),
            p(matched), p(not_matched), p(err),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("rule_match", kernels.check(rc, "rule_match"), ids,
                     present, ext_m, ext_n, params, c)
    return matched, not_matched, err


class SnapshotOracle:
    """Whole-snapshot CPU oracle executor — the graceful-degradation
    resolve path the device circuit breaker falls back to
    (the reference's runtime/resilience.py).

    Per-rule OracleProgram evaluation with the same namespace-targeting
    semantics as the device RuleSetProgram (default-namespace rules
    apply to everyone; rules in other namespaces only to requests
    addressed there). Correctness over speed by design: every rule runs
    interpreted python per request, which is exactly the conformance
    oracle the compiler tests pin the device programs against — so a
    tripped breaker degrades latency, never answers.

    Oracle programs compile lazily per rule (a breaker trip must not
    pay a whole-snapshot compile before answering its first batch) and
    are seeded with the ruleset's existing host-fallback programs.
    Thread-safe: fallback batches run concurrently on the batcher's
    worker pool."""

    def __init__(self, rules: Sequence[Rule],
                 finder: AttributeDescriptorFinder,
                 seed: Mapping[int, OracleProgram] | None = None):
        self.rules = list(rules)
        self.finder = finder
        self._progs: dict[int, OracleProgram] = dict(seed or {})
        self._lock = threading.Lock()

    def _prog(self, ridx: int) -> OracleProgram:
        prog = self._progs.get(ridx)
        if prog is None:
            prog = _rule_oracle(self.rules[ridx], self.finder)
            with self._lock:
                self._progs.setdefault(ridx, prog)
        return prog

    def resolve(self, bag, request_ns: str
                ) -> tuple[list[int], list[int], int]:
        """→ (active rule idxs, namespace-visible rule idxs, n_errors)
        for one request — the per-bag shape Dispatcher._check_one
        consumes. A predicate that raises counts as not-matched plus
        one resolve error (host_eval parity)."""
        active: list[int] = []
        visible: list[int] = []
        errs = 0
        for ridx, rule in enumerate(self.rules):
            if rule.namespace and rule.namespace != request_ns:
                continue
            visible.append(ridx)
            try:
                matched = bool(self._prog(ridx).evaluate(bag))
            except Exception:
                errs += 1
                continue
            if matched:
                active.append(ridx)
        return active, visible, errs


def compile_ruleset(rules: Sequence[Rule], finder: AttributeDescriptorFinder,
                    *, interner: InternTable | None = None,
                    max_str_len: int | None = None,
                    dnf_cap: int = DEFAULT_DNF_CAP,
                    extra_derived_keys: Sequence[tuple[str, str]] = (),
                    extra_byte_sources: Sequence[Any] = (),
                    extra_extern_sources: Sequence[tuple[str, str, Any]] = (),
                    rule_pad: int = 1,
                    device: str | torch.device = "cuda"
                    ) -> RuleSetProgram:
    """Compile a rule snapshot. Never raises for individual bad rules —
    un-lowerable predicates fall back to the oracle; predicates that do
    not even type-check to BOOL raise TypeError_ (config validation's
    job, store/validator.go analog).

    `extra_derived_keys` adds (map, key) columns consumers outside the
    predicates need — e.g. listentry instances the fused engine turns
    into id-membership scans (runtime/fused.py). `extra_byte_sources`
    likewise adds byte slots (attr name or (map, key)) for consumers
    that match VALUE BYTES rather than interned ids — REGEX/CIDR list
    entries lowered to device DFA/prefix scans. `extra_extern_sources`
    adds ip()/timestamp() ingest columns the same way (REPORT instance
    field expressions lowered by runtime/report_lower.py).

    `rule_pad` rounds the RULE-AXIS arrays (conj index matrices,
    rule_ns, attr_mask — and therefore the matched/err planes) up to a
    multiple, so the axis can shard evenly over an mp mesh dimension
    (parallel/mesh.py). Pad rows are definitely-not-matched, never
    error, and belong to an unmatchable namespace; `n_rules` still
    counts real rules only.

    `rule_pad` > 1 (rule-axis padding for an mp mesh) is not ported
    yet and raises NotPorted; the reference's `decomp_cache` is not
    carried. The program's tensors live on `device`."""
    if rule_pad != 1:
        raise NotPorted("rule_pad > 1 (mp-sharded rule axis)")
    dev = resolve_device(device)
    interner = interner or InternTable()
    atoms = _AtomTable()
    per_rule: list[tuple[Dnf, Dnf] | None] = []   # None = host fallback
    host_fallback: dict[int, OracleProgram] = {}
    fallback_reason: dict[int, str] = {}
    parsed: list[Expression] = []

    for ridx, rule in enumerate(rules):
        ast = _rule_ast(rule)
        rtype = eval_type(ast, finder, DEFAULT_FUNCS)
        if rtype != V.BOOL:
            raise TypeError_(
                f"rule {rule.name}: match must be BOOL, got {rtype.name}")
        parsed.append(ast)
        try:
            mark = atoms.mark()
            mn = _decompose(ast, atoms, dnf_cap)
            per_rule.append(mn)
        except HostFallback as exc:
            atoms.revert(mark)              # undo partial atom adds
            per_rule.append(None)
            oracle = _rule_oracle(rule, finder)
            host_fallback[ridx] = oracle
            fallback_reason[ridx] = str(exc)

    # Requirements for every device atom; atoms that cannot lower demote
    # every rule that references them to host fallback.
    reqs = Requirements()
    bad_atoms: set[int] = set()
    for aidx, ast in enumerate(atoms.asts):
        try:
            r = Requirements()
            collect_requirements(ast, finder, r)
        except HostFallback as exc:
            bad_atoms.add(aidx)
            continue
        reqs.merge(r)
    if bad_atoms:
        for ridx, mn in enumerate(per_rule):
            if mn is None:
                continue
            used = {i for conj in (mn[0] | mn[1]) for i, _ in conj}
            if used & bad_atoms:
                per_rule[ridx] = None
                host_fallback[ridx] = _rule_oracle(rules[ridx], finder)
                fallback_reason[ridx] = "atom not lowerable"

    manifest = {n: finder.get_attribute(n) for n in finder.names()}
    kwargs = {} if max_str_len is None else {"max_str_len": max_str_len}
    ext = dict(reqs.extern_sources)
    for n, k, east in extra_extern_sources:
        ext.setdefault((n, k), east)
    layout = build_layout(
        manifest,
        sorted(set(reqs.derived_keys) | set(extra_derived_keys)),
        sorted(set(reqs.byte_sources) | set(extra_byte_sources), key=str),
        extern_sources=[(n, k, ast) for (n, k), ast
                        in ext.items()], **kwargs)

    # ---- classify atoms into vectorizable tiers ----
    # An atom can still refuse to lower here (e.g. STRING_MAP equality
    # has no device view even though its requirements collected fine);
    # demote every rule using it to host fallback and reclassify.
    ctx = tensor_expr._Ctx(layout, interner, finder)
    while True:
        live_atoms = sorted({i for mn in per_rule if mn
                             for conj in (mn[0] | mn[1]) for i, _ in conj})
        eq_cols: list[int] = []; eq_cids: list[int] = []
        eq_neg: list[bool] = []
        eq_atom_idx: list[int] = []
        ss_a: list[int] = []; ss_b: list[int] = []; ss_neg: list[bool] = []
        ss_atom_idx: list[int] = []
        # constant-pattern regex atoms grouped by subject: one packed
        # multi-DFA scan per subject instead of one scan per atom
        # (tensor_expr.compile_dfa_group)
        dfa_groups: dict[str, dict] = {}
        gen_fns: list[Callable] = []
        gen_atom_idx: list[int] = []
        unlowerable: set[int] = set()

        for aidx in live_atoms:
            ast = atoms.asts[aidx]
            done = False
            f = ast.fn
            if ast.var is not None \
                    and finder.get_attribute(ast.var.name) == V.BOOL:
                eq_cols.append(layout.slot_of(ast.var.name))
                eq_cids.append(ID_TRUE); eq_neg.append(False)
                eq_atom_idx.append(aidx); done = True
            elif f is not None and f.name in ("EQ", "NEQ") \
                    and len(f.args) == 2:
                neg = f.name == "NEQ"
                for x, y in ((f.args[0], f.args[1]),
                             (f.args[1], f.args[0])):
                    sref = _slot_ref(x, layout, finder)
                    if sref is None:
                        continue
                    cid = _const_id(y, interner)
                    if cid is not None:
                        eq_cols.append(sref.col); eq_cids.append(cid)
                        eq_neg.append(neg); eq_atom_idx.append(aidx)
                        done = True
                        break
                if not done:
                    ra = _slot_ref(f.args[0], layout, finder)
                    rb = _slot_ref(f.args[1], layout, finder)
                    if ra is not None and rb is not None:
                        ss_a.append(ra.col); ss_b.append(rb.col)
                        ss_neg.append(neg); ss_atom_idx.append(aidx)
                        done = True
            if not done and f is not None and f.name == "matches" \
                    and f.target is not None \
                    and f.target.const_ is not None:
                try:
                    pattern = f.target.const_.value
                    dfa = compile_regex(pattern)
                    # probe the subject NOW so an un-viewable subject
                    # falls through to the generic path's fallback
                    tensor_expr._compile_bytes(f.args[0], ctx)
                except Exception:
                    dfa = None
                if dfa is not None:
                    g = dfa_groups.setdefault(
                        str(f.args[0]),
                        {"subject": f.args[0], "atoms": [],
                         "patterns": [], "dfas": []})
                    g["atoms"].append(aidx)
                    g["patterns"].append(pattern)
                    g["dfas"].append(dfa)
                    done = True
            if not done:
                try:
                    gen_fns.append(tensor_expr._compile_node(ast, ctx))
                except HostFallback:
                    unlowerable.add(aidx)   # keep scanning: one pass
                    continue                # collects every bad atom
                gen_atom_idx.append(aidx)

        if not unlowerable:
            break
        for ridx, mn in enumerate(per_rule):
            if mn is None:
                continue
            used = {i for conj in (mn[0] | mn[1]) for i, _ in conj}
            if used & unlowerable:
                per_rule[ridx] = None
                host_fallback[ridx] = _rule_oracle(rules[ridx], finder)
                fallback_reason[ridx] = "atom not lowerable"

    dfa_group_fns = [tensor_expr.compile_dfa_group(
        g["subject"], g["patterns"], g["dfas"], ctx)
        for g in dfa_groups.values()]
    dfa_atom_idx = [a for g in dfa_groups.values() for a in g["atoms"]]

    n_atoms = len(atoms.asts)
    ss_a_a = np.asarray(ss_a, np.int32)
    ss_b_a = np.asarray(ss_b, np.int32)
    ss_neg_a = np.asarray(ss_neg, bool)

    # ---- conjunction + rule matrices ----
    conj_list: list[Conj] = []
    conj_key: dict[Conj, int] = {}
    rule_m_cols: list[list[int]] = []
    rule_n_cols: list[list[int]] = []
    for mn in per_rule:
        if mn is None:
            rule_m_cols.append([]); rule_n_cols.append([])
            continue
        cols_mn = []
        for dnf in mn:
            cols = []
            for conj in dnf:
                j = conj_key.get(conj)
                if j is None:
                    j = len(conj_list)
                    conj_key[conj] = j
                    conj_list.append(conj)
                cols.append(j)
            cols_mn.append(cols)
        rule_m_cols.append(cols_mn[0]); rule_n_cols.append(cols_mn[1])

    n_conjs = len(conj_list)
    n_rules = len(rules)
    # rule-axis padding for even mp sharding (see docstring)
    n_rows = max(-(-max(n_rules, 1) // rule_pad) * rule_pad, 1)

    # ---- fused gather–compare fast path ----
    # Conjunctions whose EVERY literal is a tier-1 EQ/NEQ(slot, const)
    # atom skip the two-stage evaluation (atom planes → literal
    # gather): their sat column gathers the slot ids/present bits
    # DIRECTLY and compares against the interned constants in the same
    # pass — one fused gather-compare over the slot tensor instead of
    # materializing the m/n literal planes and re-gathering them.
    # Literal truth for an EQ atom: m = cmp∧present, n = ¬cmp∧present,
    # so a (atom, kind) literal is ((ids==cid) ^ neg ^ (kind=='n')) ∧
    # present, and padding lanes read True (AND identity). EQ atoms
    # dominate real istio configs, so most snapshots evaluate entirely
    # here and the legacy literal-gather stage compiles away.
    # Conjunction columns permute fused-first; the rule-stage index
    # matrices are remapped through the permutation.
    eq_info = {aidx: (eq_cols[i], eq_cids[i], eq_neg[i])
               for i, aidx in enumerate(eq_atom_idx)}
    fused_j = [j for j, conj in enumerate(conj_list)
               if all(aidx in eq_info for aidx, _ in conj)]
    fused_set = set(fused_j)
    legacy_j = [j for j in range(n_conjs) if j not in fused_set]
    n_fused = len(fused_j)
    n_legacy = n_conjs - n_fused
    new_of_old = np.zeros(max(n_conjs, 1), np.int32)
    for newj, oldj in enumerate(fused_j + legacy_j):
        new_of_old[oldj] = newj
    conj_list = [conj_list[j] for j in fused_j + legacy_j]
    rule_m_cols = [[int(new_of_old[j]) for j in cols]
                   for cols in rule_m_cols]
    rule_n_cols = [[int(new_of_old[j]) for j in cols]
                   for cols in rule_n_cols]
    # the legacy block only exists for conjunctions it still owns (or
    # as the placeholder column of an empty ruleset)
    use_legacy = n_legacy > 0 or n_fused == 0

    l_max_f = max((len(conj_list[j]) for j in range(n_fused)),
                  default=1) or 1
    l_max = max((len(conj_list[j]) for j in range(n_fused, n_conjs)),
                default=1) or 1
    k_max = max((max(len(m), len(n)) for m, n in
                 ((rule_m_cols[r], rule_n_cols[r]) for r in range(n_rules))),
                default=1) or 1

    eqc_col = np.zeros((max(n_fused, 1), l_max_f), np.int32)
    eqc_cid = np.zeros((max(n_fused, 1), l_max_f), np.int32)
    eqc_xor = np.zeros((max(n_fused, 1), l_max_f), bool)
    eqc_pad = np.ones((max(n_fused, 1), l_max_f), bool)
    for j in range(n_fused):
        for s, (aidx, kind) in enumerate(sorted(conj_list[j])):
            col, cid, neg = eq_info[aidx]
            eqc_col[j, s] = col
            eqc_cid[j, s] = cid
            eqc_xor[j, s] = bool(neg) ^ (kind == "n")
            eqc_pad[j, s] = False

    # The legacy m/n planes carry ONLY the EQ atoms some legacy
    # conjunction still references — an EQ atom every referencing
    # conjunction of which went fused would be gathered/compared into
    # lanes no lit_idx row ever reads (lit_idx is a param, not a
    # constant, so nothing prunes them later). ss/dfa/gen atoms are legacy by
    # construction (any conjunction holding one is non-fusable).
    legacy_atom_set = {aidx for conj in conj_list[n_fused:]
                       for aidx, _ in conj}
    eq_keep = [i for i, aidx in enumerate(eq_atom_idx)
               if aidx in legacy_atom_set]
    eq_live_idx = [eq_atom_idx[i] for i in eq_keep]
    order = eq_live_idx + ss_atom_idx + dfa_atom_idx + gen_atom_idx
    n_live = max(len(order), 1)   # width of the m/n literal blocks
    # inverse permutation: position of atom i in the concatenated output
    pos_of = np.full(max(n_atoms, 1), 0, dtype=np.int32)
    for pos, aidx in enumerate(order):
        pos_of[aidx] = pos
    eq_cols_a = np.asarray([eq_cols[i] for i in eq_keep], np.int32)
    eq_cids_a = np.asarray([eq_cids[i] for i in eq_keep], np.int32)
    eq_neg_a = np.asarray([eq_neg[i] for i in eq_keep], bool)

    # Sparse (gather) formulation. Conjunctions average only a few
    # literals and rules a few conjunctions, so dense [2A, n_conj] /
    # [n_conj, R] one-hot matmuls waste ~1000× the operations; padded
    # index gathers + AND/OR reductions move only bytes. Sentinel columns:
    # literal index 2·n_live is always-TRUE (AND identity), conjunction
    # index n_conjs is always-FALSE (OR identity).
    LIT_TRUE = 2 * n_live
    CONJ_FALSE = max(n_conjs, 1)   # sat has max(n_conjs,1) real columns
    CONJ_TRUE = CONJ_FALSE + 1     # pad rows: definitely-not-matched
    # legacy literal gather rows: only the conjunctions the fused
    # gather-compare path above did NOT absorb (an all-EQ snapshot
    # compiles no literal gather at all)
    lit_idx = np.full((max(n_legacy, 1), l_max), LIT_TRUE, np.int32)
    for jj, conj in enumerate(conj_list[n_fused:]):
        for s, (aidx, kind) in enumerate(sorted(conj)):
            lit_idx[jj, s] = pos_of[aidx] + (0 if kind == "m" else n_live)
    conj_m_idx = np.full((n_rows, k_max), CONJ_FALSE, np.int32)
    conj_n_idx = np.full((n_rows, k_max), CONJ_FALSE, np.int32)
    # padding rows read not_matched=True (never "err"): their N gather
    # points at the always-TRUE sentinel column
    conj_n_idx[n_rules:, 0] = CONJ_TRUE
    for ridx in range(n_rules):
        for s, j in enumerate(rule_m_cols[ridx]):
            conj_m_idx[ridx, s] = j
        for s, j in enumerate(rule_n_cols[ridx]):
            conj_n_idx[ridx, s] = j

    # Index tensors are ARGUMENTS (params), not closure constants, as in
    # the reference: interop.params_from_reference can swap in the JAX
    # package's own compiled tensors.
    params = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("lit_idx", lit_idx), ("conj_m_idx", conj_m_idx),
        ("conj_n_idx", conj_n_idx), ("eqc_col", eqc_col),
        ("eqc_cid", eqc_cid), ("eqc_xor", eqc_xor), ("eqc_pad", eqc_pad))}
    consts = RuleMatchConsts.of(
        n_fused=n_fused, use_legacy=use_legacy, n_live=n_live,
        n_sat=CONJ_FALSE, eq_cols=eq_cols_a, eq_cids=eq_cids_a,
        eq_neg=eq_neg_a, ss_a=ss_a_a, ss_b=ss_b_a, ss_neg=ss_neg_a,
        device=dev)

    # Constant startsWith / endsWith / match() atoms of the generic tier
    # are batched per subject into one byte_pred launch; their columns
    # are scattered back into the reference's gen-atom order below.
    byte_groups: dict[str, dict] = {}
    other_gen: list[tuple[int, Callable]] = []
    for gpos, (aidx, gfn) in enumerate(zip(gen_atom_idx, gen_fns)):
        ast = atoms.asts[aidx]
        if tensor_expr.is_const_byte_pred(ast):
            subj = tensor_expr._byte_pred_spec(ast.fn, layout.max_str_len)[0]
            g = byte_groups.setdefault(str(subj), {"subject": subj,
                                                   "calls": [], "pos": []})
            g["calls"].append(ast.fn)
            g["pos"].append(gpos)
        else:
            other_gen.append((gpos, gfn))
    byte_group_fns = [tensor_expr.compile_byte_group(
        g["subject"], g["calls"], ctx) for g in byte_groups.values()]
    # gen_perm[gen position] = its column in the concatenation (byte
    # groups in order, then the remaining closures)
    cat_pos = [p for g in byte_groups.values() for p in g["pos"]] + \
        [p for p, _ in other_gen]
    gen_perm_np = np.zeros(len(cat_pos), np.int64)
    gen_perm_np[cat_pos] = np.arange(len(cat_pos))
    gen_perm = torch.from_numpy(gen_perm_np).to(dev)
    n_ext = len(dfa_atom_idx) + len(gen_atom_idx)

    def run(params: Mapping[str, Any],
            batch: AttributeBatch) -> tuple[Any, Any, Any]:
        b = batch.ids.shape[0]
        ext_m: list[torch.Tensor] = []
        ext_n: list[torch.Tensor] = []
        if use_legacy:
            for gfn in dfa_group_fns:
                gval, gee = gfn(batch)
                ext_m.append(gval)             # already masked by ~ee
                ext_n.append(~gval & ~gee)
            gm: list[torch.Tensor] = []
            gn: list[torch.Tensor] = []
            for gfn in byte_group_fns:
                gval, gee = gfn(batch)
                gm.append(gval)
                gn.append(~gval & ~gee)
            for _, fn in other_gen:
                t = fn(batch)
                ee = t.err | ~t.ok
                gm.append((t.val & ~ee)[:, None])
                gn.append((~t.val & ~ee)[:, None])
            if gm:
                ext_m.append(torch.cat(gm, dim=1)[:, gen_perm])
                ext_n.append(torch.cat(gn, dim=1)[:, gen_perm])
        if ext_m:
            em = torch.cat(ext_m, dim=1)
            en = torch.cat(ext_n, dim=1)
        else:
            em = en = torch.zeros((b, n_ext if use_legacy else 0),
                                  dtype=torch.bool, device=batch.ids.device)
        return rule_match(batch.ids, batch.present, em, en, params, consts)

    # ---- per-rule attribute bitmaps (compile-time ReferencedAttributes) ----
    attr_mask = np.zeros((n_rows, max(layout.n_columns, 1)), bool)
    attr_names: list[set] = []
    for ridx in range(n_rules):
        names: set = set()
        _collect_attr_names(parsed[ridx], finder, names)
        attr_names.append(names)
        for item in names:
            if isinstance(item, tuple):
                if item in layout.derived_slots:
                    attr_mask[ridx, layout.derived_slots[item]] = True
            elif item in layout.slots:
                attr_mask[ridx, layout.slots[item]] = True

    ns_ids: dict[str, int] = {"": 0}
    # pad rows carry an unmatchable namespace (ids are ≥ 0, unknown
    # request namespaces are -1) so they are invisible everywhere
    rule_ns = np.full(n_rows, -7, np.int32)
    if n_rules == 0:
        rule_ns[:] = 0   # placeholder row of an empty ruleset
    for ridx, rule in enumerate(rules):
        ns = rule.namespace
        if ns not in ns_ids:
            ns_ids[ns] = len(ns_ids)
        rule_ns[ridx] = ns_ids[ns]

    atom_tier = {aidx: "id-eq" for aidx in eq_atom_idx}
    atom_tier.update({aidx: "slot-eq" for aidx in ss_atom_idx})
    atom_tier.update({aidx: "dfa-pack" for aidx in dfa_atom_idx})
    atom_tier.update({aidx: "tensor" for aidx in gen_atom_idx})

    geometry = {
        # EQ atoms the LEGACY stage materializes planes for (fused-only
        # EQ atoms are excluded above) — the roofline model sizes the
        # legacy stage from this; the total is n_eq_atoms_total
        "n_eq_atoms": len(eq_keep),
        "n_eq_atoms_total": len(eq_atom_idx),
        "n_ss_atoms": len(ss_atom_idx),
        "n_dfa_atoms": len(dfa_atom_idx),
        "n_gen_atoms": len(gen_atom_idx),
        "n_dfa_groups": len(dfa_group_fns),
        "n_byte_groups": len(byte_group_fns),
        "n_live": n_live,
        "n_conjs": n_conjs,
        "n_fused_conjs": n_fused,
        "n_legacy_conjs": n_legacy,
        "use_legacy": use_legacy,
        "l_max_fused": int(eqc_col.shape[1]) if n_fused else 0,
        "l_max_legacy": int(lit_idx.shape[1]) if use_legacy else 0,
        "k_max": k_max,
        "n_rows": n_rows,
    }

    return RuleSetProgram(
        rules=list(rules), layout=layout, interner=interner,
        fn=run, params=params,
        n_atoms=n_atoms, n_conjs=n_conjs,
        host_fallback=host_fallback, fallback_reason=fallback_reason,
        attr_mask=attr_mask, attr_names=attr_names,
        rule_ns=rule_ns, ns_ids=ns_ids,
        atom_tier=atom_tier, geometry=geometry, device=dev)


def _collect_attr_names(e: Expression, finder: AttributeDescriptorFinder,
                        out: set) -> None:
    if e.var is not None:
        out.add(e.var.name)
        return
    f = e.fn
    if f is None:
        return
    if (f.name == "INDEX" and f.args[0].var is not None
            and f.args[1].const_ is not None):
        out.add(f.args[0].var.name)
        out.add((f.args[0].var.name, f.args[1].const_.value))
        return
    if f.target is not None:
        _collect_attr_names(f.target, finder, out)
    for a in f.args:
        _collect_attr_names(a, finder, out)
