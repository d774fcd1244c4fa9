"""Shared route automaton: route-rule matches → the policy ruleset
tensors (BASELINE.json: "Pilot's route compiler emits the same NFA for
VirtualService/RouteRule header+URI match so L7 routing and policy
share one compiled automaton").

Port of istio_tpu/pilot/route_nfa.py. Every (service, route-rule) pair
lowers its match block to ONE predicate in the SAME expression language
the policy engine compiles (exact → EQ, prefix → startsWith, regex →
matches, header presence → `|` fallback probe), then the whole mesh's
route table becomes a RuleSetProgram on `device`. Batched route
selection is one device trip:

    matched [B, R]  →  choice[b] = highest-precedence matched rule

The match runs through K1 (rule_match), K2 (dfa_scan) and K3
(byte_pred), the choice through K10's route_winner (ops/route_ops.py);
the compact select re-densifies the ragged byte plane with K10's
route_densify first. `select()` returns per-request route indices;
index n_rules means "no rule matched → default route". The host-side
`select_host()` applies identical semantics sequentially and is the
conformance oracle. `select_wire` and `native` need the wire decoder and
the C++ shim, which the port does not carry (ROADMAP.md): they raise
NotPorted.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from istio_tpu_torch.attribute.bag import Bag, bag_from_mapping
from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.cache import stable_digest
from istio_tpu_torch.compiler.layout import AttributeBatch, Tensorizer
from istio_tpu_torch.compiler.ruleset import Rule, compile_ruleset
from istio_tpu_torch.device import NotPorted, resolve_device
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.ops.route_ops import route_densify, route_winner
from istio_tpu_torch.pilot.model import Config, Service

V = ValueType

# vocabulary of the route-match automaton
ROUTE_MANIFEST: dict[str, ValueType] = {
    "destination.service": V.STRING,
    "request.path": V.STRING,
    "request.method": V.STRING,
    "request.scheme": V.STRING,
    "request.host": V.STRING,
    "request.headers": V.STRING_MAP,
    "source.service": V.STRING,
}
ROUTE_FINDER = AttributeDescriptorFinder(ROUTE_MANIFEST)

_ABSENT = "\x00absent\x00"


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _header_ref(name: str) -> str:
    """Pseudo-headers map to first-class attributes (header.go:27
    translates :path/:method the same way)."""
    specials = {"uri": "request.path", ":path": "request.path",
                ":method": "request.method", "method": "request.method",
                ":authority": "request.host", "authority": "request.host",
                "scheme": "request.scheme", ":scheme": "request.scheme"}
    if name in specials:
        return specials[name]
    return f"request.headers[{_quote(name)}]"


def match_to_predicate(hostname: str, match: Mapping[str, Any] | None,
                       source: str | None = None) -> str:
    """Route-rule match block → one boolean expression."""
    parts = [f"destination.service == {_quote(hostname)}"]
    if source:
        parts.append(f"source.service == {_quote(source)}")
    headers = {}
    if match:
        headers = match.get("request", {}).get("headers", {}) \
            if "request" in match else match.get("headers", {}) or {}
    for name, cond in sorted(headers.items()):
        ref = _header_ref(name)
        is_map = ref.startswith("request.headers[")
        probe = f"({ref} | {_quote(_ABSENT)})" if is_map else ref
        if not cond or cond == {"presence": True}:
            parts.append(f"{probe} != {_quote(_ABSENT)}")
        elif "exact" in cond:
            parts.append(f"{probe} == {_quote(cond['exact'])}")
        elif "prefix" in cond:
            parts.append(f"{probe}.startsWith({_quote(cond['prefix'])})")
        elif "regex" in cond:
            # Envoy route regexes are FULL match; `matches` is an
            # unanchored search (Go regexp.MatchString parity), so
            # _anchor forces full-match semantics — wrapping `^(pat)$`
            # for unanchored/alternation patterns, passing
            # already-anchored pipe-free patterns through bare so they
            # keep lowering to the device DFA (which rejects nested
            # inner anchors). NOTE: the RECEIVER of .matches() is the
            # PATTERN (see testing/corpus.py).
            parts.append(f"{_quote(_anchor(cond['regex']))}"
                         f".matches({probe})")
    return " && ".join(parts)


def _anchor(pattern: str) -> str:
    """Force full-match semantics. A pattern that is already anchored
    on both ends AND safe to use bare (no top-level alternation that
    the anchors wouldn't distribute over) stays as-is — wrapping it
    would nest anchors inside the group, which the device DFA compiler
    rejects (regex_dfa: no inner anchors) and needlessly sends the
    rule to the host oracle."""
    if (pattern.startswith("^") and pattern.endswith("$")
            and not pattern.endswith("\\$") and "|" not in pattern):
        return pattern
    return f"^({pattern})$"


@dataclasses.dataclass
class RouteEntry:
    rule: Config
    service: Service
    predicate: str
    precedence: int


class RouteTable:
    """The whole mesh's route rules as one device program."""

    def __init__(self, services: Sequence[Service],
                 rules_by_host: Mapping[str, Sequence[Config]],
                 max_str_len: int = 256,
                 device: str | torch.device = "cuda"):
        self.entries: list[RouteEntry] = []
        host_of = {s.hostname: s for s in services}
        for hostname in sorted(rules_by_host):
            service = host_of.get(hostname)
            if service is None:
                continue
            for rule in rules_by_host[hostname]:
                src = rule.spec.get("match", {}).get("source")
                pred = match_to_predicate(hostname,
                                          rule.spec.get("match"), src)
                self.entries.append(RouteEntry(
                    rule=rule, service=service, predicate=pred,
                    precedence=int(rule.spec.get("precedence", 0))))
        rules = [Rule(name=f"route{i}", match=e.predicate)
                 for i, e in enumerate(self.entries)]
        self.program = compile_ruleset(rules, ROUTE_FINDER,
                                       max_str_len=max_str_len,
                                       device=device)
        self.device = self.program.device
        self.tensorizer = Tensorizer(self.program.layout,
                                     self.program.interner)
        # selection weights: precedence first, then config order
        # (route_rules sorting, route.go) — higher weight wins
        n = len(self.entries)
        order = sorted(range(n),
                       key=lambda i: (-self.entries[i].precedence, i))
        self._weight = np.zeros(max(n, 1), np.int64)
        for rank, idx in enumerate(order):
            self._weight[idx] = n - rank          # best rank → largest
        # int32 on the device, as in the reference's jit (no x64): the
        # weights are at most n
        self._weight_dev = torch.from_numpy(
            self._weight.astype(np.int32)).to(self.device)
        self.default_index = n

    # -- device path --

    def select(self, requests: Sequence[Mapping[str, Any] | Bag]
               ) -> np.ndarray:
        """One device step: per-request winning route index
        (default_index when nothing matches)."""
        bags = [r if isinstance(r, Bag) else bag_from_mapping(dict(r))
                for r in requests]
        if not self.entries:
            return np.full(len(bags), self.default_index, np.int64)
        batch = self.tensorizer.tensorize(bags)
        if not self.program.host_fallback:
            # argmax on device: pulling the [B, R] matched plane costs
            # R/64 times the bytes of the [B] winner indices (megabytes
            # per batch at 10k routes behind a high-RTT transport)
            return self._select_on_device(batch).cpu().numpy().astype(
                np.int64)
        matched = self.program(batch, ("matched",))[0]
        matched = matched.cpu().numpy().copy()
        for ridx in self.program.host_fallback:
            for b, bag in enumerate(bags):
                matched[b, ridx] = self.program.host_eval(ridx, bag)[0]
        scores = matched * self._weight[None, :]
        best = scores.argmax(axis=1)
        hit = scores.max(axis=1) > 0
        return np.where(hit, best, self.default_index)

    @property
    def native(self):
        """The C++ wire→tensor decoder of the reference: not carried."""
        raise NotPorted("RouteTable.native: the C++ tensorizer shim is "
                        "not carried (ROADMAP.md queue A, wire fronts "
                        "and the native shim)")

    def select_wire(self, wires: Sequence[bytes], block: bool = True):
        """The wire-record fast path of the reference: needs api/wire and
        the C++ shim, which the port does not carry."""
        raise NotPorted("RouteTable.select_wire: api/wire and the C++ "
                        "tensorizer shim are not carried (ROADMAP.md "
                        "queue A, wire fronts and the native shim)")

    def _compact_planes(self, batch: AttributeBatch):
        """select_wire's host compaction of a tensorized batch → (flat
        uint8 [cap], presence uint8 [B, ceil(C/8)] little-endian, lens
        int16 [B, nbyte]) as numpy, or None when the dense byte plane is
        the smaller (cap > its size). COMPACT byte-plane transfer:
        str_bytes is [B, nbyte, L] but real subjects (paths, hosts) are
        ~20 bytes, so the ragged bytes, bitpacked presence and int16
        lens are shipped and re-densified on the device."""
        sb = np.asarray(batch.str_bytes)
        lens = np.asarray(batch.str_lens)
        L = sb.shape[2]
        mask = np.arange(L)[None, None, :] < lens[:, :, None]
        flat = sb[mask]
        total = flat.shape[0]
        cap = max(1024, 1 << int(total).bit_length())  # stable shapes
        if cap > sb.size:     # pathological: dense is smaller
            return None
        flat_p = np.zeros(cap, np.uint8)
        flat_p[:total] = flat
        pres_p = np.packbits(np.asarray(batch.present), axis=1,
                             bitorder="little")
        return flat_p, pres_p, lens.astype(np.int16)

    def _select_on_device(self, batch: AttributeBatch) -> torch.Tensor:
        """rule_match over the batch, then route_winner → int32 [B] on
        the device."""
        matched = self.program(batch, ("matched",))[0]
        return route_winner(matched, self._weight_dev, self.default_index)

    def _select_on_device_compact(self, ids, pres_packed, map_present,
                                  flat, lens16) -> torch.Tensor:
        """select with the byte plane shipped RAGGED (flat bytes + int16
        lens + bitpacked presence) and re-densified on the device by
        route_densify → int32 [B] on the device. Arguments are numpy
        arrays or tensors; they are moved to the program's device."""
        def on(x):
            return torch.as_tensor(x).to(self.device)

        ids = on(ids)
        str_bytes, str_lens, present = route_densify(
            on(flat), on(lens16), on(pres_packed),
            self.program.layout.n_columns, self.program.layout.max_str_len)
        batch = AttributeBatch(
            ids=ids, present=present, map_present=on(map_present),
            str_bytes=str_bytes, str_lens=str_lens,
            hash_ids=torch.zeros_like(ids))   # routes never hash
        matched = self.program(batch, ("matched",))[0]
        return route_winner(matched, self._weight_dev, self.default_index)

    # -- host oracle --

    def select_host(self, request: Mapping[str, Any]) -> int:
        best, best_w = self.default_index, 0
        for i, entry in enumerate(self.entries):
            if self._matches_host(entry, request) and \
                    self._weight[i] > best_w:
                best, best_w = i, int(self._weight[i])
        return best

    @staticmethod
    def _matches_host(entry: RouteEntry,
                      request: Mapping[str, Any]) -> bool:
        if request.get("destination.service") != entry.service.hostname:
            return False
        spec = entry.rule.spec
        src = spec.get("match", {}).get("source")
        if src and request.get("source.service") != src:
            return False
        headers = {}
        if spec.get("match"):
            m = spec["match"]
            headers = m.get("request", {}).get("headers", {}) \
                if "request" in m else m.get("headers", {}) or {}
        for name, cond in headers.items():
            ref = _header_ref(name)
            if ref.startswith("request.headers["):
                value = (request.get("request.headers") or {}).get(name)
            else:
                value = request.get(ref)
            if not cond or cond == {"presence": True}:
                if value is None:
                    return False
            elif "exact" in cond:
                if value != cond["exact"]:
                    return False
            elif "prefix" in cond:
                if value is None or not str(value).startswith(
                        cond["prefix"]):
                    return False
            elif "regex" in cond:
                # mirror the device predicate EXACTLY: unanchored
                # search of the ^(pat)$ wrapper (same engine semantics
                # incl. the $-before-trailing-newline subtlety)
                if value is None or re.search(_anchor(cond["regex"]),
                                              str(value)) is None:
                    return False
        return True

    def route_for(self, index: int) -> RouteEntry | None:
        if 0 <= index < len(self.entries):
            return self.entries[index]
        return None


class RouteScopeProgram:
    """Source-admission half of the mesh's route-rule match blocks as
    ONE compiled program — the per-node part of config generation.

    Per-sidecar RDS generation filters each destination's route rules
    by the polling node's source identity (`match.source`,
    route.go buildVirtualHost / model._match_source). The reference
    re-evaluates that filter per node per rule on the host; here every
    source-constrained (host, rule) pair lowers its constraint to one
    `source.service == "..."` predicate in the SAME expression
    language / ruleset tensors the route NFA and policy engine compile
    (BASELINE's shared-automaton doctrine), so admission for ALL
    pending node groups is one batched device step:

        admits [B, C]  →  row b: does node-group b's source satisfy
                          constrained pair c?

    Unconstrained rules admit every source by construction and never
    enter the program; a node with no source identity admits
    everything (the `_match_source` None-source semantics) and skips
    the device plane entirely. Header/URI match halves are NOT
    evaluated here — they become envoy match JSON in the generated
    config (the data plane evaluates them per request; RouteTable
    evaluates them per request on-device for the policy tie-in).

    `digest` content-addresses the constraint set (host, rule index,
    source) so snapshots carry the compiled program across
    generations whenever no source constraint moved (PR 10 doctrine).
    Compilation is lazy — building a snapshot whose digest matches the
    previous generation never compiles.
    """

    def __init__(self, rules_by_host: Mapping[str, Sequence[Any]],
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._constrained: list[tuple[str, int]] = []
        self._sources: list[str] = []
        for host in sorted(rules_by_host):
            for i, rule in enumerate(rules_by_host[host]):
                src = (rule.spec.get("match") or {}).get("source")
                if src:
                    self._constrained.append((host, i))
                    self._sources.append(str(src))
        self._slot = {pair: j for j, pair in
                      enumerate(self._constrained)}
        self.n_constrained = len(self._constrained)
        self.digest = stable_digest(
            [(h, i, s) for (h, i), s in zip(self._constrained,
                                            self._sources)])

    @functools.cached_property
    def _program(self):
        """Lazy compile: (program, tensorizer) over the constraint
        predicates; None when nothing in the mesh is
        source-constrained."""
        if not self._constrained:
            return None
        rules = [Rule(name=f"scope{j}",
                      match=f"source.service == {_quote(src)}")
                 for j, src in enumerate(self._sources)]
        program = compile_ruleset(rules, ROUTE_FINDER, max_str_len=256,
                                  device=self.device)
        return program, Tensorizer(program.layout, program.interner)

    def admit_rows(self, sources: Sequence[str | None]) -> list:
        """One device step for a batch of node-group source
        identities → per-row admission maps. Row value None means
        'admit everything' (no identity, or no constrained rules).
        The batch pads to a power of two so churn storms reuse a few
        compiled shapes instead of one per pending-set size."""
        if self._program is None or not sources:
            return [None] * len(sources)
        program, tensorizer = self._program
        n = len(sources)
        cap = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
        padded = [s or "" for s in sources] + [""] * (cap - n)
        bags = [bag_from_mapping({"source.service": s}) for s in padded]
        batch = tensorizer.tensorize(bags)
        matched = program(batch, ("matched",))[0]
        m = matched.cpu().numpy().copy()   # the one admission-plane pull per batched generation
        for ridx in program.host_fallback:   # defensive: EQ never falls back
            for b in range(n):
                m[b, ridx] = program.host_eval(ridx, bags[b])[0]
        rows = []
        for b, s in enumerate(sources):
            if s is None:
                rows.append(None)
            else:
                rows.append({pair: bool(m[b, j]) for j, pair in
                             enumerate(self._constrained)})
        return rows

    def admits(self, row, host: str, rule_index: int) -> bool:
        """Does the admission row (one admit_rows element) include
        `rules_by_host[host][rule_index]`? Unconstrained rules and
        identity-less rows always admit."""
        if row is None:
            return True
        pair = (host, rule_index)
        if pair not in self._slot:
            return True
        return row[pair]
