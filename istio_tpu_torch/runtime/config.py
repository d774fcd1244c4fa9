"""Config kinds + validated Snapshot building.

Maps the reference's runtime2 config model (mixer/pkg/runtime2/config/
ephemeral.go → snapshot.go) with the same kinds the reference's store
carries: `attributemanifest`, `handler`, `instance`, `rule`, plus the
rbac adapter's `servicerole`/`servicerolebinding` (mixer/adapter/rbac
watches those kinds itself in the reference; here the snapshot feeds
them to the handler).

A Snapshot is immutable: attribute finder, handler configs (built
handlers live in the controller's HandlerTable so they survive snapshot
swaps when unchanged — handlerTable.go diffing), instance builders, and
rules with their ACTION wiring. The rule match predicates are compiled
to the device RuleSetProgram here; action wiring that matches the fused
fast path (denier/list/quota over id-exact entries) is extracted for
PolicyEngine construction by the controller.

Port of istio_tpu/runtime/config.py: the snapshot build is the
reference's, step for step, so layouts, rulesets and plans come out
equal, rbac pseudo-rule rows included (`_lower_rbac_groups` with
compiler/rbac_lower.py); the reference's DecompCache is a host memo and
is left out (`decomp_cache` stays None). The ruleset compiles onto
`device`.
"""
from __future__ import annotations

import dataclasses
import json

import torch
from typing import Any, Mapping

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.ruleset import Rule as RulePred
from istio_tpu_torch.compiler.ruleset import RuleSetProgram, compile_ruleset
from istio_tpu_torch.compiler.layout import InternTable, Tensorizer
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.templates import (InstanceBuilder, TemplateError, Variety,
                                       registry as template_registry)
from istio_tpu_torch.device import resolve_device
from istio_tpu_torch.utils.log import scope
from istio_tpu_torch.runtime.store import Store

KIND_MANIFEST = "attributemanifest"
KIND_HANDLER = "handler"
KIND_INSTANCE = "instance"
KIND_RULE = "rule"
KIND_SERVICE_ROLE = "servicerole"
KIND_SERVICE_ROLE_BINDING = "servicerolebinding"


@dataclasses.dataclass(frozen=True)
class HandlerConfig:
    name: str
    namespace: str
    adapter: str
    params: Mapping[str, Any]

    @property
    def signature(self) -> str:
        """Identity for handler reuse across snapshots
        (handlerTable.go signature diffing)."""
        return json.dumps([self.adapter, self.params], sort_keys=True,
                          default=str)


@dataclasses.dataclass(frozen=True)
class Action:
    """One rule action: a handler plus instances (config.proto Action)."""
    handler: str                 # fully-qualified handler name
    instances: tuple[str, ...]   # instance names


@dataclasses.dataclass(frozen=True)
class RuleConfig:
    name: str
    namespace: str
    match: str
    actions: tuple[Action, ...]


@dataclasses.dataclass
class RbacGroup:
    """Device-lowered rbac policy for one (handler, authorization
    instance) pair: pseudo-rule rows appended to the ruleset
    (compiler/rbac_lower.py). `lowered` is False when any row fell back
    to the host oracle — the action then stays on the host adapter."""
    handler: str
    instance: str
    allow_rows: tuple[int, ...]        # OR of these rows = allowed
    guard_row: int = -1                # -1: instance can never error
    n_triples: int = 0
    lowered: bool = True
    reason: str = ""


@dataclasses.dataclass
class Snapshot:
    """Validated, compiled config generation (runtime2 Snapshot)."""
    revision: int
    finder: AttributeDescriptorFinder
    handlers: dict[str, HandlerConfig]
    instances: dict[str, InstanceBuilder]
    instance_templates: dict[str, str]
    rules: list[RuleConfig]
    ruleset: RuleSetProgram            # one predicate row per rule,
    #                                    then rbac pseudo-rule rows
    tensorizer: Tensorizer
    roles: list[Mapping[str, Any]]
    bindings: list[Mapping[str, Any]]
    errors: list[str]                  # per-resource soft errors
    # ruleset rows [n_config_rules:] are synthesized pseudo-rules (no
    # config rule / actions behind them — only the fused engine and the
    # RbacGroups below may reference them)
    n_config_rules: int = 0
    rbac_groups: dict[tuple[str, str], RbacGroup] = \
        dataclasses.field(default_factory=dict)
    # the exact compile_ruleset kwargs this snapshot's ruleset was
    # built with (extra derived/byte/extern sources, max_str_len,
    # rule_pad) — the sharding plane recompiles rule SUBSETS
    # (istio_tpu/sharding/banks.py) and must reproduce the layout
    # inputs, or a bank would miss a column its instances read
    compile_kwargs: dict = dataclasses.field(default_factory=dict)
    # per-instance content digest (template + raw store params,
    # compiler/cache.stable_digest): bank_content_key folds in the
    # digests of every instance a bank's rules reference, so an
    # instance edit invalidates exactly the banks that serve it
    instance_digests: dict = dataclasses.field(default_factory=dict)
    # the builder's cross-build DecompCache (compiler/cache.py) rides
    # along so shard sub-compiles hit the decomposition memo the
    # parent build just filled; NEVER part of the snapshot's content
    # identity (excluded from every digest)
    decomp_cache: Any = dataclasses.field(default=None, repr=False)

    def rule_index(self, name: str, namespace: str) -> int:
        for i, r in enumerate(self.rules):
            if r.name == name and r.namespace == namespace:
                return i
        raise KeyError((namespace, name))

    def qualified_rule_names(self) -> list[str]:
        """Positional rule index → "ns/name" (bare name for the
        default namespace) — THE rule naming convention every
        index-keyed surface renders through (rulestats aggregation,
        canary diff attribution, waiver matching). Memoized: the
        snapshot is immutable."""
        names = getattr(self, "_qnames", None)
        if names is None:
            names = [f"{r.namespace}/{r.name}" if r.namespace
                     else r.name for r in self.rules]
            self._qnames = names
        return names

    def actions_for(self, rule_idx: int,
                    variety: Variety) -> list[tuple[HandlerConfig, str, list[str]]]:
        """[(handler cfg, template, instance names)] of one variety —
        one tuple PER TEMPLATE so a mixed action (e.g. stdio handling
        both logentry and metric instances) dispatches each instance
        under its own template."""
        out = []
        for action in self.rules[rule_idx].actions:
            h = self.handlers.get(action.handler)
            if h is None:
                continue
            by_template: dict[str, list[str]] = {}
            for n in action.instances:
                if n not in self.instances:
                    continue
                tmpl = self.instance_templates[n]
                if template_registry.get(tmpl).variety == variety:
                    by_template.setdefault(tmpl, []).append(n)
            for tmpl, insts in by_template.items():
                out.append((h, tmpl, insts))
        return out


def _qualify(name: str, ns: str) -> str:
    """namespace-qualified resource name (reference uses
    name.kind.namespace; kind is implicit in our typed dicts)."""
    return f"{name}.{ns}" if ns else name


class SnapshotBuilder:
    """Ephemeral → Snapshot validation (runtime2/config/ephemeral.go):
    reads the whole store, type-checks everything, collects soft errors
    per resource (a bad rule/instance is dropped, not fatal — matching
    the reference controller's tolerance), and compiles the ruleset."""

    # the reference's configDefaultNamespace: rules here apply mesh-wide
    DEFAULT_CONFIG_NAMESPACE = "istio-system"

    def __init__(self, default_manifest: Mapping[str, ValueType]
                 | None = None,
                 interner: InternTable | None = None,
                 max_str_len: int | None = None,
                 config_namespace: str = DEFAULT_CONFIG_NAMESPACE,
                 lower_rbac: bool = True,
                 device: str | torch.device = "cuda"):
        self.default_manifest = dict(default_manifest or {})
        self.interner = interner or InternTable()
        self.max_str_len = max_str_len
        self.config_namespace = config_namespace
        self.device = resolve_device(device)
        # the reference's per-rule parse/DNF memo (DecompCache) is a
        # host-side cache only; not carried (ROADMAP.md)
        self.decomp_cache = None
        # False for non-fused servers: only the fused engine reads the
        # synthesized pseudo-rule rows — compiling them into a snapshot
        # the generic dispatcher serves would be pure compile/step waste
        self.lower_rbac = lower_rbac
        self._revision = 0

    def build(self, store: Store) -> Snapshot:
        self._revision += 1
        errors: list[str] = []

        # 1. attribute vocabulary (processAttributeManifests
        #    controller.go:273)
        manifest: dict[str, ValueType] = dict(self.default_manifest)
        for key, spec in store.list(KIND_MANIFEST).items():
            for attr, desc in (spec.get("attributes") or {}).items():
                vt_name = str((desc or {}).get("value_type",
                                               "STRING")).upper()
                try:
                    manifest[attr] = ValueType[vt_name]
                except KeyError:
                    errors.append(f"{key}: bad value_type {vt_name}"
                                  f" for {attr}")
        finder = AttributeDescriptorFinder(manifest)

        # 2. handlers
        handlers: dict[str, HandlerConfig] = {}
        for (kind, ns, name), spec in store.list(KIND_HANDLER).items():
            adapter = spec.get("adapter") or spec.get("compiledAdapter")
            if not adapter:
                errors.append(f"handler {name}.{ns}: missing adapter")
                continue
            hc = HandlerConfig(name=name, namespace=ns,
                               adapter=str(adapter),
                               params=dict(spec.get("params") or {}))
            handlers[_qualify(name, ns)] = hc

        # 3. instances
        from istio_tpu_torch.compiler.cache import stable_digest
        instances: dict[str, InstanceBuilder] = {}
        instance_templates: dict[str, str] = {}
        instance_digests: dict[str, str] = {}
        for (kind, ns, name), spec in store.list(KIND_INSTANCE).items():
            tmpl_name = spec.get("template") or spec.get("compiledTemplate")
            if not tmpl_name:
                errors.append(f"instance {name}.{ns}: missing template")
                continue
            qname = _qualify(name, ns)
            # content identity BEFORE any param mutation below — the
            # bank cache keys on what the store said, not on builder
            # internals
            instance_digests[qname] = stable_digest(
                [str(tmpl_name), dict(spec.get("params") or {})])
            try:
                info = template_registry.get(str(tmpl_name))
                params = dict(spec.get("params") or {})
                bindings = params.pop("attribute_bindings", None)
                ib = InstanceBuilder(info, qname, params, finder)
                if bindings:
                    ib.attribute_bindings = dict(bindings)
                instances[qname] = ib
                instance_templates[qname] = info.name
            except TemplateError as exc:
                errors.append(f"instance {qname}: {exc}")

        # 4. rules (+ predicate compilation)
        rules: list[RuleConfig] = []
        preds: list[RulePred] = []
        for (kind, ns, name), spec in store.list(KIND_RULE).items():
            actions = []
            for a in (spec.get("actions") or ()):
                handler = str(a.get("handler", ""))
                if "." not in handler:
                    handler = _qualify(handler, ns)
                inst_names = []
                for inst in (a.get("instances") or ()):
                    inst = str(inst)
                    if "." not in inst:
                        inst = _qualify(inst, ns)
                    inst_names.append(inst)
                missing = [h for h in [handler] if h not in handlers]
                missing += [i for i in inst_names if i not in instances]
                if missing:
                    errors.append(f"rule {name}.{ns}: unknown refs "
                                  f"{missing}")
                    continue
                actions.append(Action(handler=handler,
                                      instances=tuple(inst_names)))
            rc = RuleConfig(name=name, namespace=ns,
                            match=str(spec.get("match", "") or ""),
                            actions=tuple(actions))
            rules.append(rc)
            # rules in the config (default) namespace are global: the
            # ruleset's "" namespace applies to every request
            pred_ns = "" if ns in ("", self.config_namespace) else ns
            preds.append(RulePred(name=_qualify(name, ns), match=rc.match,
                                  namespace=pred_ns))

        kwargs = {} if self.max_str_len is None \
            else {"max_str_len": self.max_str_len}
        # listentry instances whose value is a bare (map, key) read get
        # a derived layout column so the fused engine can absorb them
        # (runtime/fused.py id-membership scan)
        derived = set()
        for qname, ib in instances.items():
            if instance_templates[qname] != "listentry":
                continue
            ref = ib.value_attr_ref()
            if isinstance(ref, tuple):
                derived.add(ref)
        kwargs["extra_derived_keys"] = sorted(derived)
        # listentry instances feeding REGEX/IP_ADDRESSES list handlers
        # additionally get a BYTE slot: their device lowering matches
        # value bytes (DFA scan / CIDR prefix compare, runtime/fused.py)
        # rather than interned ids
        byte_srcs = set()
        for rc in rules:
            for a in rc.actions:
                hc = handlers.get(a.handler)
                if hc is None or hc.adapter != "list":
                    continue
                if hc.params.get("entry_type", "STRINGS") not in \
                        ("REGEX", "IP_ADDRESSES"):
                    continue
                for iname in a.instances:
                    if instance_templates.get(iname) != "listentry":
                        continue
                    ref = instances[iname].value_attr_ref()
                    if ref is not None:
                        byte_srcs.add(ref)
        kwargs["extra_byte_sources"] = sorted(byte_srcs, key=str)
        # REPORT instance field expressions lower onto the device
        # (runtime/report_lower.py — the reference runs them through
        # the same IL loop as predicates, template.gen.go
        # ProcessReport): collect their layout needs (derived map-key
        # columns, byte slots for match()/startsWith subjects, extern
        # ingest columns) in the same pre-pass the predicates use. An
        # instance whose requirements cannot collect keeps the host
        # build — never a config error.
        from istio_tpu_torch.compiler.tensor_expr import (HostFallback,
                                                          Requirements,
                                                          collect_requirements)

        def _field_asts(tree):
            for v in tree.values():
                if isinstance(v, dict):
                    yield from _field_asts(v)
                else:
                    yield v

        rep_reqs = Requirements()
        seen_report: set[str] = set()
        for rc in rules:
            for a in rc.actions:
                for iname in a.instances:
                    ib = instances.get(iname)
                    tmpl = instance_templates.get(iname)
                    if ib is None or tmpl is None or iname in seen_report:
                        continue
                    if template_registry.get(tmpl).variety is not \
                            Variety.REPORT:
                        continue
                    seen_report.add(iname)
                    try:
                        r = Requirements()
                        for ast in _field_asts(ib.expr_tree()):
                            collect_requirements(ast, finder, r)
                        rep_reqs.merge(r)
                    except HostFallback:
                        pass    # instance keeps InstanceBuilder.build
        if rep_reqs.derived_keys:
            kwargs["extra_derived_keys"] = sorted(
                set(kwargs["extra_derived_keys"]) | rep_reqs.derived_keys)
        if rep_reqs.byte_sources:
            kwargs["extra_byte_sources"] = sorted(
                set(kwargs["extra_byte_sources"])
                | rep_reqs.byte_sources, key=str)
        if rep_reqs.extern_sources:
            kwargs["extra_extern_sources"] = [
                (n, k, east)
                for (n, k), east in sorted(rep_reqs.extern_sources.items(),
                                           key=lambda kv: kv[0])]
        # rule-axis padded to 8 so the matched/err planes shard evenly
        # over any mp ∈ {1,2,4,8} serving mesh (parallel/mesh.py)
        kwargs["rule_pad"] = 8

        roles = [dict(spec, name=k[2], namespace=k[1])
                 for k, spec in store.list(KIND_SERVICE_ROLE).items()]
        bindings = [dict(spec, name=k[2], namespace=k[1])
                    for k, spec in store.list(
                        KIND_SERVICE_ROLE_BINDING).items()]

        # rbac device lowering: synthesize pseudo-rule rows per
        # (handler, authorization instance) pair so the fused engine
        # can compute allow/deny on device (compiler/rbac_lower.py;
        # reference host loop: mixer/adapter/rbac/rbac.go:181)
        n_config_rules = len(preds)
        rbac_groups = self._lower_rbac_groups(
            rules, handlers, instances, instance_templates,
            roles, bindings, finder, preds) if self.lower_rbac else {}

        try:
            ruleset = compile_ruleset(preds, finder,
                                      interner=self.interner,
                                      decomp_cache=self.decomp_cache,
                                      device=self.device, **kwargs)
        except Exception as exc:
            # a predicate that doesn't type-check is a config error for
            # that rule; retry with offenders replaced by 'false'
            safe_preds, bad = [], []
            for p in preds:
                try:
                    compile_ruleset([p], finder, interner=self.interner,
                                    decomp_cache=self.decomp_cache,
                                    device=self.device, **kwargs)
                    safe_preds.append(p)
                except Exception as e2:
                    errors.append(f"rule {p.name}: {e2}")
                    safe_preds.append(RulePred(name=p.name, match="false",
                                               namespace=p.namespace))
            ruleset = compile_ruleset(safe_preds, finder,
                                      interner=self.interner,
                                      decomp_cache=self.decomp_cache,
                                      device=self.device, **kwargs)

        # pseudo-rules are implementation detail, not policy: their
        # predicate attrs must not leak into ReferencedAttributes (the
        # host path only evaluates rbac instance exprs when the parent
        # rule matched — instance_attrs cover that, runtime/fused.py)
        if len(preds) > n_config_rules:
            ruleset.attr_mask[n_config_rules:, :] = False
            for i in range(n_config_rules, len(preds)):
                ruleset.attr_names[i] = set()
            for g in rbac_groups.values():
                if not g.lowered:
                    continue
                rows = set(g.allow_rows)
                if g.guard_row >= 0:
                    rows.add(g.guard_row)
                bad_rows = rows & set(ruleset.host_fallback)
                if bad_rows:
                    g.lowered = False
                    g.reason = "; ".join(sorted(
                        ruleset.fallback_reason.get(r, "host fallback")
                        for r in bad_rows))

        return Snapshot(revision=self._revision, finder=finder,
                        handlers=handlers, instances=instances,
                        instance_templates=instance_templates,
                        rules=rules, ruleset=ruleset,
                        # no hash_slots: the serving engine runs
                        # quotas=() (host adapters own quota state), so
                        # nothing reads the hash plane. A quota-bearing
                        # PolicyEngine must tensorize via its own
                        # .tensorizer, which hashes its key slots.
                        tensorizer=Tensorizer(ruleset.layout,
                                              self.interner),
                        roles=roles, bindings=bindings, errors=errors,
                        n_config_rules=n_config_rules,
                        rbac_groups=rbac_groups,
                        compile_kwargs=dict(kwargs),
                        instance_digests=instance_digests,
                        decomp_cache=self.decomp_cache)

    @staticmethod
    def _lower_rbac_groups(rules, handlers, instances,
                           instance_templates, roles, bindings, finder,
                           preds):
        """Synthesize rbac pseudo-rule predicates, appending to `preds`.

        Every synthesized AST is pre-validated (eval_type == BOOL) so
        the whole-ruleset compile can never fail because of a pseudo
        rule — an unfusable policy shape keeps its action on the host
        adapter (group.lowered=False, logged), never changes
        semantics."""
        from istio_tpu_torch.compiler.rbac_lower import (RbacLowerError,
                                                         lower_rbac)
        from istio_tpu_torch.expr.checker import DEFAULT_FUNCS, eval_type
        from istio_tpu_torch.attribute.types import ValueType

        log = scope("runtime.config")

        groups: dict[tuple[str, str], RbacGroup] = {}
        for rc in rules:
            for action in rc.actions:
                hc = handlers.get(action.handler)
                if hc is None or hc.adapter != "rbac":
                    continue
                for inst in action.instances:
                    if instance_templates.get(inst) != "authorization" \
                            or (action.handler, inst) in groups:
                        continue
                    key = (action.handler, inst)
                    # handler params override store kinds, matching the
                    # host build (runtime/handler_table.py setdefault —
                    # an explicit empty list in params stays empty)
                    eff_roles = hc.params["roles"] \
                        if "roles" in hc.params else roles
                    eff_bindings = hc.params["bindings"] \
                        if "bindings" in hc.params else bindings
                    try:
                        low = lower_rbac(eff_roles, eff_bindings,
                                         instances[inst].expr_tree(),
                                         finder)
                        for ast in low.allow_asts + (
                                [low.guard_ast] if low.guard_ast
                                is not None else []):
                            t = eval_type(ast, finder, DEFAULT_FUNCS)
                            if t != ValueType.BOOL:
                                raise RbacLowerError(
                                    f"pseudo-rule type {t.name}")
                    except Exception as exc:
                        reason = f"{type(exc).__name__}: {exc}"
                        log.info("rbac policy for %s not device-"
                                 "lowerable, serving via host adapter:"
                                 " %s", inst, reason)
                        groups[key] = RbacGroup(
                            handler=action.handler, instance=inst,
                            allow_rows=(), lowered=False, reason=reason)
                        continue
                    base = len(preds)
                    for i, ast in enumerate(low.allow_asts):
                        preds.append(RulePred(
                            name=f"~rbac/{inst}/{i}", ast=ast))
                    guard_row = -1
                    if low.guard_ast is not None:
                        guard_row = len(preds)
                        preds.append(RulePred(
                            name=f"~rbac/{inst}/guard",
                            ast=low.guard_ast))
                    groups[key] = RbacGroup(
                        handler=action.handler, instance=inst,
                        allow_rows=tuple(
                            range(base, base + len(low.allow_asts))),
                        guard_row=guard_row, n_triples=low.n_triples)
        return groups
