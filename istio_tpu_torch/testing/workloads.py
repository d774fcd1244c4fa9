"""Synthetic mesh workloads (port of istio_tpu/testing/workloads.py).

The Check() world of the reference: Bookinfo-style denier + listchecker
rules, authz predicates over source/destination attributes, and
header/URI match clauses (exact, prefix, glob, regex), the OPA overlay
world and the shared-quota store of the adapter-executor plane, the
fleet world of the sharded serving plane (make_fleet_rules /
make_fleet_store / make_fleet_traffic), and Pilot's route world and
discovery fleet. These copies produce the same rules,
bags, services and configs as the reference's for the same arguments;
`make_engine` builds the port's PolicyEngine on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from istio_tpu_torch.attribute.bag import Bag, bag_from_mapping
from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.ruleset import Rule
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.models.policy_engine import (DenySpec, ListEntrySpec,
                                                  PolicyEngine, QuotaSpec)

V = ValueType

# the attribute vocabulary the synthetic workloads use (types as in the
# reference's global attribute manifest)
MESH_MANIFEST: dict[str, ValueType] = {
    "source.name": V.STRING,
    "source.namespace": V.STRING,
    "source.ip": V.IP_ADDRESS,
    "source.labels": V.STRING_MAP,
    "source.user": V.STRING,
    "source.service": V.STRING,
    "destination.name": V.STRING,
    "destination.namespace": V.STRING,
    "destination.service": V.STRING,
    "destination.labels": V.STRING_MAP,
    "request.headers": V.STRING_MAP,
    "request.host": V.STRING,
    "request.method": V.STRING,
    "request.path": V.STRING,
    "request.scheme": V.STRING,
    "request.size": V.INT64,
    "request.time": V.TIMESTAMP,
    "request.useragent": V.STRING,
    "request.api_key": V.STRING,
    "response.code": V.INT64,
    "response.size": V.INT64,
    "response.duration": V.DURATION,
    "connection.mtls": V.BOOL,
    "context.protocol": V.STRING,
    "context.reporter.kind": V.STRING,
    "api.service": V.STRING,
    "api.operation": V.STRING,
    "api.version": V.STRING,
}

MESH_FINDER = AttributeDescriptorFinder(MESH_MANIFEST)


def make_rules(n_rules: int, n_services: int | None = None,
               with_regex: bool = True,
               seed: int | None = None) -> list[Rule]:
    """Bookinfo/authz-flavored rule mix: mostly EQ/NEQ conjunctions
    (the vectorized tier), a sprinkling of header glob/regex and path
    prefix predicates (the byte-DFA tier).

    `seed` (explicit, end-to-end reproducible): varies the per-branch
    CONSTANTS (locked namespaces, methods, session ids, path/regex
    versions) from a named rng so analyzer and chaos corpora differ
    across seeds but replay identically for one seed. The svc/ns/
    branch STRUCTURE stays i-based under any seed — consumers key on
    it (every-3rd-rule deny wiring, chaos_smoke's deny bags). None =
    the legacy fixed constants, byte-identical to pre-seed output."""
    n_services = n_services or max(n_rules // 2, 1)
    rng = np.random.default_rng(seed) if seed is not None else None

    def draw(legacy, hi):
        return legacy if rng is None else int(rng.integers(hi))

    rules = []
    for i in range(n_rules):
        svc = f"svc{i % n_services}.ns{i % 23}.svc.cluster.local"
        parts = [f'destination.service == "{svc}"']
        k = i % 10
        if k < 4:
            parts.append(f'source.namespace != "locked{draw(i % 5, 5)}"')
        elif k == 4:
            parts.append(f'request.method == '
                         f'"{"GET" if draw(i % 2, 2) else "POST"}"')
        elif k == 5:
            parts.append(f'request.headers["cookie"] == '
                         f'"session={draw(i % 97, 97)}"')
        elif k == 6:
            parts.append('connection.mtls')
        elif k == 7 and with_regex:
            parts.append(f'request.path.startsWith('
                         f'"/api/v{draw(i % 3, 3)}/")')
        elif k == 8 and with_regex:
            parts.append(f'match(request.host, "*.ns{i % 23}.cluster.local")')
        elif k == 9 and with_regex:
            parts.append(
                f'"/(products|reviews)/[0-9]+/v{draw(i % 4, 4)}"'
                '.matches(request.path)')
        rules.append(Rule(name=f"rule{i}", match=" && ".join(parts),
                          namespace=f"ns{i % 23}"))
    return rules


def make_engine(n_rules: int = 1024, with_quota: bool = True,
                device: str | torch.device = "cuda",
                quota_max: int = 1 << 20) -> PolicyEngine:
    rules = make_rules(n_rules)
    deny = [DenySpec(rule=i) for i in range(0, n_rules, 3)]
    lists = [ListEntrySpec(rule=i, value_attr="source.namespace",
                           entries=[f"ns{j}" for j in range(0, 23, 2)])
             for i in range(1, n_rules, 97)]
    quotas = ([QuotaSpec(rule=i, key_attr="source.user", max_amount=quota_max)
               for i in range(2, n_rules, 301)] if with_quota else [])
    return PolicyEngine(rules, MESH_FINDER, deny=deny, lists=lists,
                        quotas=quotas, device=device)


def _overlay_list_provider() -> list[str]:
    """Provider seam for the overlay workload's refreshed list (the
    reference's URL-fetch role; module-level named function so stores
    built in child processes resolve it by reference)."""
    return [f"ns{j}" for j in range(0, 23, 2)]


def make_store(n_rules: int, n_services: int | None = None,
               with_regex: bool = True,
               host_overlay_every: int | None = None,
               seed: int | None = None):
    """A MemStore carrying the make_rules() workload as REAL config
    kinds (handlers/instances/rules), for serving-path benches and the
    perf rig: every 3rd rule deny + every 97th a whitelist, mirroring
    make_engine()'s fused-action mix. Rules live in their own
    namespaces (namespace targeting identical to make_rules).

    `host_overlay_every`: every Nth rule additionally carries work the
    device GENUINELY cannot absorb — the host-overlay-heavy shape
    (VERDICT r2 weak #4) whose per-request python cost the overlay
    bench measures. r4's device lowering learned REGEX-entry lists and
    silently emptied the old overlay workload (`overlay_rules: 0`);
    the three shapes now cycle through the reference's genuinely
    host-bound list semantics (mixer/adapter/list/list.go:115-247):
    case-insensitive membership, provider-refreshed entries (the TTL
    refresh loop — entries change between requests, so no compiled
    bank can be current), and a dynamic `match(x, attr)` predicate
    whose pattern is an attribute (no constant DFA exists).

    `seed` forwards to make_rules (explicit, reproducible constant
    variation; None = legacy fixed constants). Action wiring stays
    i-based under any seed."""
    from istio_tpu_torch.runtime.store import MemStore

    s = MemStore()
    s.set(("handler", "istio-system", "denyall"), {
        "adapter": "denier", "params": {"status_code": 7}})
    s.set(("handler", "istio-system", "nswhitelist"), {
        "adapter": "list",
        "params": {"overrides": [f"ns{j}" for j in range(0, 23, 2)],
                   "blacklist": False}})
    # served quota traffic (grpcServer.go:188-230 loop → device pools,
    # runtime/device_quota.py): per-user rate limit, requested by the
    # perf rig on a fraction of payloads
    s.set(("handler", "istio-system", "mq"), {
        "adapter": "memquota",
        "params": {"quotas": [{"name": "rq.istio-system",
                               "max_amount": 1 << 30}]}})
    s.set(("instance", "istio-system", "rq"), {
        "template": "quota",
        "params": {"dimensions": {"user": 'source.user | "anon"'}}})
    s.set(("rule", "istio-system", "quota-rule"), {
        "match": "",
        "actions": [{"handler": "mq", "instances": ["rq"]}]})
    s.set(("instance", "istio-system", "nothing"), {
        "template": "checknothing", "params": {}})
    s.set(("instance", "istio-system", "srcns"), {
        "template": "listentry", "params": {"value": "source.namespace"}})
    # REPORT-path traffic (grpcServer.go:262 → dispatcher.Report →
    # metric adapter): a request-count metric into prometheus — the
    # served report bench drives this through the real gRPC surface
    s.set(("handler", "istio-system", "prom"), {
        "adapter": "prometheus",
        "params": {"metrics": [{
            "name": "reqcount.istio-system", "kind": "COUNTER",
            "label_names": ["destination"]}]}})
    s.set(("instance", "istio-system", "reqcount"), {
        "template": "metric",
        "params": {"value": "1",
                   "dimensions": {"destination":
                                  'destination.service | "unknown"'}}})
    s.set(("rule", "istio-system", "report-all"), {
        "match": "",
        "actions": [{"handler": "prom", "instances": ["reqcount"]}]})
    if host_overlay_every:
        # shape 1: CASE_INSENSITIVE_STRINGS membership — list.go's
        # ToLower path; the device's one-hot banks are case-exact, so
        # the fused plan must overlay these rules per request
        # (runtime/fused._split_list_instances keeps them host-side)
        s.set(("handler", "istio-system", "cilist"), {
            "adapter": "list",
            "params": {"overrides": [f"NS{j}" for j in range(0, 23, 2)],
                       "entry_type": "CASE_INSENSITIVE_STRINGS",
                       "blacklist": False}})
        # shape 2: provider-refreshed entries (the reference's URL-
        # fetch + TTL refresh loop, list.go:115-247) — entries can
        # change between requests, so membership stays a host call
        s.set(("handler", "istio-system", "provlist"), {
            "adapter": "list",
            "params": {"overrides": [],
                       "provider": _overlay_list_provider,
                       "refresh_interval_s": 3600.0,
                       "blacklist": False}})
        s.set(("instance", "istio-system", "nsinst"), {
            "template": "listentry",
            "params": {"value": "source.namespace"}})
        # shape 3: REGEX entries OUTSIDE the DFA-compilable subset
        # (a backreference — the dynamic per-entry match semantics
        # list.go applies that no compiled bank can express); the
        # plain dynamic match(x, attr) predicate form now lowers on
        # device (tensor_expr._compile_dyn_byte_pred), so this is the
        # remaining genuinely-dynamic pattern shape
        s.set(("handler", "istio-system", "dynpat"), {
            "adapter": "list",
            "params": {"overrides": [r"^/api/(v[0-9])/\1/"],
                       "entry_type": "REGEX", "blacklist": True}})
        s.set(("instance", "istio-system", "pathinst"), {
            "template": "listentry",
            "params": {"value": "request.path"}})
    for i, rule in enumerate(make_rules(n_rules, n_services, with_regex,
                                        seed=seed)):
        actions = []
        if i % 3 == 0:
            actions.append({"handler": "denyall.istio-system",
                            "instances": ["nothing.istio-system"]})
        if i % 97 == 1:
            actions.append({"handler": "nswhitelist.istio-system",
                            "instances": ["srcns.istio-system"]})
        if host_overlay_every and i % host_overlay_every == 2:
            k = (i // host_overlay_every) % 3
            if k == 0:
                actions.append({"handler": "cilist.istio-system",
                                "instances": ["nsinst.istio-system"]})
            elif k == 1:
                actions.append({"handler": "provlist.istio-system",
                                "instances": ["nsinst.istio-system"]})
            else:
                actions.append({"handler": "dynpat.istio-system",
                                "instances": ["pathinst.istio-system"]})
        if not actions:   # every rule carries at least a no-op check
            actions.append({"handler": "denyall.istio-system",
                            "instances": []})
        s.set(("rule", rule.namespace, rule.name),
              {"match": rule.match, "actions": actions})
    return s


OPA_POLICY = """package mixerauthz

    policy = [
      {
        "rule": {
          "verbs": [
            "GET"
          ],
          "users": [
            "reader",
            "admin"
          ]
        }
      },
      {
        "rule": {
          "verbs": [
            "GET",
            "POST",
            "DELETE"
          ],
          "users": [
            "admin"
          ]
        }
      }
    ]

    default allow = false

    allow = true {
      rule = policy[_].rule
      input.subject.user = rule.users[_]
      input.action.method = rule.verbs[_]
    }"""
"""Rego module for the OPA overlay scenario (the reference adapter's
bucket-admins policy shape, opa_test.go:180): readers may GET, admins
may do anything, everyone else is denied — evaluated per request by
the native Rego-subset engine (adapters/rego.py) on the adapter
executor's opa lane."""


def make_opa_store(n_rules: int, n_services: int | None = None,
                   opa_every: int = 7, fail_close: bool = True,
                   seed: int | None = None):
    """make_store's world with every `opa_every`-th rule additionally
    carrying an OPA authorization action: the 776-line Rego engine
    runs per matching request as a genuine external policy check —
    the authorization template has no device lowering for the opa
    adapter, so these are first-class host-overlay actions on the
    executor's opa lane. Requests crafted by make_opa_requests carry
    subject users the policy allows AND denies, so oracle-parity
    gates see real PERMISSION_DENIED flips."""
    s = make_store(n_rules, n_services, seed=seed)
    s.set(("handler", "istio-system", "opah"), {
        "adapter": "opa",
        "params": {"policies": [OPA_POLICY],
                   "check_method": "data.mixerauthz.allow",
                   "fail_close": fail_close}})
    s.set(("instance", "istio-system", "authzi"), {
        "template": "authorization",
        "params": {
            "subject": {"user": 'source.user | ""'},
            "action": {"service": 'destination.service | ""',
                       "method": 'request.method | ""',
                       "path": 'request.path | ""'}}})
    for i in range(0, n_rules, opa_every):
        key = ("rule", f"ns{i % 23}", f"rule{i}")
        spec = dict(s.get(key))
        spec["actions"] = list(spec["actions"]) + [
            {"handler": "opah.istio-system",
             "instances": ["authzi.istio-system"]}]
        s.set(key, spec)
    return s


def make_opa_requests(batch: int, n_rules: int,
                      n_services: int | None = None,
                      opa_every: int = 7, seed: int = 5) -> list[dict]:
    """Traffic targeting make_opa_store's OPA-carrying rules: each
    request addresses rule i (i % opa_every == 0) by its exact
    service, with the user cycling allowed (admin/reader-GET) and
    denied (reader-POST / intern) shapes — so every request fires the
    Rego check and the corpus carries both verdicts."""
    n_services = n_services or max(n_rules // 2, 1)
    rng = np.random.default_rng(seed)
    out = []
    opa_rules = list(range(0, n_rules, opa_every))
    for j in range(batch):
        i = opa_rules[int(rng.integers(len(opa_rules)))]
        kind = j % 4
        user, method = (("admin", "POST"), ("reader", "GET"),
                        ("reader", "DELETE"), ("intern", "GET"))[kind]
        out.append({
            "destination.service":
                f"svc{i % n_services}.ns{i % 23}.svc.cluster.local",
            "source.user": user,
            "source.namespace": f"ns{2 * int(rng.integers(12)) % 23}",
            "request.method": method,
            "request.path": f"/api/v{i % 3}/items",
        })
    return out


def make_shared_quota_store(backend=None, max_amount: int = 64,
                            duration_s: float = 0.0,
                            min_dedup_s: float = 5.0):
    """One global memquota rule over a SHARED QuotaBackend (adapters/
    memquota.QuotaBackend) — the cross-replica shared-quota dedup
    scenario: N stores built over the same `backend` give N replicas
    whose handlers allocate against one set of cells and one dedup
    cache, through the adapter executor's mq lane. A dedup_id retried
    on ANY replica replays the original grant; the window max is
    enforced globally."""
    from istio_tpu_torch.runtime.store import MemStore

    s = MemStore()
    params: dict = {"quotas": [{"name": "rq.istio-system",
                                "max_amount": max_amount,
                                "valid_duration_s": duration_s}],
                    "min_deduplication_duration_s": min_dedup_s}
    if backend is not None:
        params["backend"] = backend
    s.set(("handler", "istio-system", "mq"), {
        "adapter": "memquota", "params": params})
    s.set(("instance", "istio-system", "rq"), {
        "template": "quota",
        "params": {"dimensions": {"user": 'source.user | "anon"'}}})
    s.set(("rule", "istio-system", "quota-rule"), {
        "match": "",
        "actions": [{"handler": "mq", "instances": ["rq"]}]})
    return s


def make_request_dicts(batch: int, seed: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    dicts = []
    for _ in range(batch):
        i = int(rng.integers(0, 4096))
        dicts.append({
            "destination.service":
                f"svc{rng.integers(0, 512)}.ns{i % 23}.svc.cluster.local",
            "source.namespace": f"ns{rng.integers(0, 25)}",
            "source.user": f"cluster.local/ns/ns{i % 23}/sa/sa{i % 61}",
            "request.method": "GET" if rng.random() < 0.7 else "POST",
            "request.path": f"/api/v{rng.integers(0, 4)}/products/{i}",
            "request.host": f"svc{i % 31}.ns{i % 23}.cluster.local",
            "request.size": i,
            "connection.mtls": bool(rng.random() < 0.5),
            "request.headers": {"cookie": f"session={rng.integers(0, 120)}",
                                ":authority": "productpage"},
        })
    return dicts


def make_bags(batch: int, seed: int = 1) -> list[Bag]:
    return [bag_from_mapping(d) for d in make_request_dicts(batch, seed)]


def make_request_ns(engine: PolicyEngine, batch: int,
                    seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = [engine.ruleset.namespace_id(f"ns{rng.integers(0, 25)}")
           for _ in range(batch)]
    return np.asarray(ids, np.int32)


def make_hit_requests(n_rules: int, batch: int, seed: int = 3
                      ) -> tuple[list[dict], list[str]]:
    """Requests aimed at the rules of make_rules(n_rules) (port-only
    helper): each picks a rule — a third of them a quota rule, a third
    a list rule — and fills the attributes its clauses read, each
    sometimes absent, from few distinct users, with the rule's own
    namespace or an unknown one; a few paths run past the 128-byte slot.
    Denials, list verdicts, quota contention and predicate errors all
    occur. → (request dicts, request namespace names)."""
    rng = np.random.default_rng(seed)
    n_services = max(n_rules // 2, 1)
    quota_rules = list(range(2, n_rules, 301))
    list_rules = list(range(1, n_rules, 97))
    dicts, ns = [], []
    for _ in range(batch):
        u = rng.random()
        if u < 1 / 3 and quota_rules:
            i = int(rng.choice(quota_rules))
        elif u < 2 / 3 and list_rules:
            i = int(rng.choice(list_rules))
        else:
            i = int(rng.integers(n_rules))
        d: dict = {"destination.service":
                   f"svc{i % n_services}.ns{i % 23}.svc.cluster.local"}
        if rng.random() < 0.9:
            d["source.namespace"] = (f"locked{i % 5}" if rng.random() < 0.2
                                     else f"ns{rng.integers(0, 25)}")
        if rng.random() < 0.9:
            d["source.user"] = f"cluster.local/ns/ns{i % 23}/sa/" \
                f"sa{rng.integers(0, 4)}"
        if rng.random() < 0.9:
            d["request.method"] = "GET" if rng.random() < 0.5 else "POST"
        if rng.random() < 0.8:
            d["request.headers"] = {
                "cookie": f"session={i % 97 if rng.random() < 0.5 else 98}"}
        if rng.random() < 0.9:
            d["connection.mtls"] = bool(rng.random() < 0.5)
        if rng.random() < 0.9:
            v = int(rng.integers(0, 4))
            d["request.path"] = (
                f"/api/v{i % 3}/products/{i}" if rng.random() < 0.5 else
                f"/reviews/{i}/v{v}")
            if rng.random() < 0.03:
                d["request.path"] += "/x" * 80
        if rng.random() < 0.9:
            d["request.host"] = (f"svc{i % 31}.ns{i % 23}.cluster.local"
                                 if rng.random() < 0.7 else "other.host")
        dicts.append(d)
        ns.append(f"ns{i % 23}" if rng.random() < 0.9 else "ns24")
    return dicts, ns


def make_rbac_store(n_role_rules: int, n_users: int = 200,
                    n_services: int = 128):
    """BASELINE config 2: a 1k-role-rule RBAC world as real config
    kinds. One ServiceRole per role rule (services/methods/paths mixing
    exact, prefix `p*` and suffix `*s` stringMatch forms, every 5th
    with a constraint), one binding per role (user or group subjects,
    every 7th with a subject property) — all in namespace "default" —
    plus one authorization instance + rule. The whole policy lowers to
    device pseudo-rules (compiler/rbac_lower.py); reference semantics:
    mixer/adapter/rbac/rbac.go:181 HandleAuthorization."""
    from istio_tpu_torch.runtime.store import MemStore

    s = MemStore()
    s.set(("handler", "istio-system", "authzh"), {
        "adapter": "rbac", "params": {"caching_ttl_s": 60.0}})
    s.set(("instance", "istio-system", "authz"), {
        "template": "authorization",
        "params": {
            "subject": {"user": 'source.user | ""',
                        "groups": 'source.labels["group"] | ""',
                        "properties": {
                            "version": 'source.labels["version"] | ""'}},
            "action": {"namespace": 'destination.namespace | ""',
                       "service": 'destination.service | ""',
                       "method": 'request.method | ""',
                       "path": 'request.path | ""',
                       "properties": {
                           "version":
                               'request.headers["version"] | ""'}}}})
    s.set(("rule", "istio-system", "authz-rule"), {
        "match": "", "actions": [{"handler": "authzh",
                                  "instances": ["authz"]}]})
    for i in range(n_role_rules):
        k = i % 4
        if k == 0:
            services = [f"svc{i % n_services}.default.svc.cluster.local"]
        elif k == 1:
            services = ["*.default.svc.cluster.local"]
        else:
            services = [f"svc{i % n_services}.*"]
        rule: dict = {"services": services,
                      "methods": (["GET"], ["GET", "POST"], ["*"],
                                  ["DELETE"])[i % 4],
                      "paths": ([f"/api/v{i % 9}/*"], ["*"],
                                [f"*/{i % 31}.html"],
                                [f"/data/{i % 100}"])[i % 4]}
        if i % 5 == 0:
            rule["constraints"] = [{"key": "version",
                                    "values": ["v1", f"v{i % 7}"]}]
        s.set(("servicerole", "default", f"role{i}"), {"rules": [rule]})
        subj: dict
        if i % 3 == 0:
            subj = {"user": f"user{i % n_users}"}
        elif i % 3 == 1:
            subj = {"group": f"group{i % 29}"}
        else:   # combined user AND group constraint
            subj = {"user": f"user{i % n_users}",
                    "group": f"group{i % 29}"}
        if i % 7 == 0:
            subj["properties"] = {"version": f"v{i % 7}"}
        s.set(("servicerolebinding", "default", f"bind{i}"), {
            "roleRef": {"kind": "ServiceRole", "name": f"role{i}"},
            "subjects": [subj]})
    return s


def make_rbac_request_dicts(batch: int, n_users: int = 200,
                            n_services: int = 128,
                            seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(batch):
        out.append({
            "source.user": f"user{int(rng.integers(n_users))}",
            "source.labels": {"group": f"group{int(rng.integers(32))}",
                              "version": f"v{int(rng.integers(8))}"},
            "destination.namespace": "default",
            "destination.service":
                f"svc{int(rng.integers(n_services))}"
                ".default.svc.cluster.local",
            "request.method": ("GET", "POST", "DELETE",
                               "PUT")[int(rng.integers(4))],
            "request.path": (f"/api/v{int(rng.integers(10))}/items",
                             f"/data/{int(rng.integers(120))}",
                             f"/static/{int(rng.integers(40))}.html"
                             )[i % 3],
            "request.headers": {"version": f"v{int(rng.integers(8))}"},
        })
    return out


# ---------------------------------------------------------------------------
# Pilot: the route world and the discovery fleet
# ---------------------------------------------------------------------------

def _fleet_ns_assignment(n_rules: int, n_namespaces: int,
                         seed: int) -> np.ndarray:
    """Item → namespace index for the fleet workloads, Zipf-skewed so
    namespace SIZES are realistic (a few big app namespaces, a long
    tail of small ones): item i lands in namespace
    `(zipf(a=1.1) - 1) mod n_namespaces`. The same (n, n_namespaces,
    seed) gives the reference's assignment, bit for bit."""
    rng = np.random.default_rng(seed)
    return ((rng.zipf(1.1, n_rules) - 1) % n_namespaces).astype(
        np.int64)


def make_fleet_rules(n_rules: int, n_namespaces: int,
                     seed: int = 0) -> list[Rule]:
    """Fleet-scale rule set for the sharded serving plane
    (istio_tpu_torch/sharding): n_rules EQ-dominated predicates
    partitioned over n_namespaces namespaces (sizes Zipf-skewed via
    _fleet_ns_assignment — the shard planner has to balance REAL
    namespace skew, not uniform confetti). Rule i guards its own
    unique service `svc{i}.ns{k}.svc.cluster.local`, so a request is
    attributable to exactly the rules crafted for it, plus one extra
    conjunct cycling through the vectorized-tier shapes. Every
    predicate stays inside the fused gather-compare envelope by
    design: fleet scale is the point, and a 100k-rule snapshot must
    compile in host seconds."""
    ns_of = _fleet_ns_assignment(n_rules, n_namespaces, seed)
    rules = []
    for i in range(n_rules):
        ns = f"ns{int(ns_of[i])}"
        svc = f"svc{i}.{ns}.svc.cluster.local"
        parts = [f'destination.service == "{svc}"']
        k = i % 4
        if k < 2:
            parts.append(f'source.namespace != "locked{i % 5}"')
        elif k == 2:
            parts.append('request.method == "GET"')
        else:
            parts.append('connection.mtls')
        rules.append(Rule(name=f"fleet{i}", match=" && ".join(parts),
                          namespace=ns))
    return rules


def make_fleet_store(n_rules: int, n_namespaces: int, seed: int = 0,
                     with_quota: bool = False):
    """MemStore carrying make_fleet_rules as real config kinds: every
    3rd rule denies (status 7), every 97th runs a source-namespace
    whitelist, the rest a bare denier action with no instances (the
    no-op check) — make_store's action mix at fleet scale, WITHOUT the
    mesh-wide report rule (a 100k-rule parent snapshot must not lower
    a report plane the sharded path never serves). `with_quota` adds
    one GLOBAL per-user memquota rule — the shape the sharding tests
    pin: replicated into every bank, allocated once per request from
    the one controller-owned pool."""
    from istio_tpu_torch.runtime.store import MemStore

    s = MemStore()
    s.set(("handler", "istio-system", "denyall"), {
        "adapter": "denier", "params": {"status_code": 7}})
    s.set(("handler", "istio-system", "nswhitelist"), {
        "adapter": "list",
        "params": {"overrides": [f"team{j}" for j in range(0, 40, 2)],
                   "blacklist": False}})
    s.set(("instance", "istio-system", "nothing"), {
        "template": "checknothing", "params": {}})
    s.set(("instance", "istio-system", "srcns"), {
        "template": "listentry", "params": {"value": "source.namespace"}})
    if with_quota:
        s.set(("handler", "istio-system", "mq"), {
            "adapter": "memquota",
            "params": {"quotas": [{"name": "rq.istio-system",
                                   "max_amount": 1 << 30}]}})
        s.set(("instance", "istio-system", "rq"), {
            "template": "quota",
            "params": {"dimensions": {"user": 'source.user | "anon"'}}})
        s.set(("rule", "istio-system", "quota-rule"), {
            "match": "",
            "actions": [{"handler": "mq", "instances": ["rq"]}]})
    for i, rule in enumerate(make_fleet_rules(n_rules, n_namespaces,
                                              seed)):
        if i % 3 == 0:
            actions = [{"handler": "denyall.istio-system",
                        "instances": ["nothing.istio-system"]}]
        elif i % 97 == 1:
            actions = [{"handler": "nswhitelist.istio-system",
                        "instances": ["srcns.istio-system"]}]
        else:
            actions = [{"handler": "denyall.istio-system",
                        "instances": []}]
        s.set(("rule", rule.namespace, rule.name),
              {"match": rule.match, "actions": actions})
    return s


FLEET_ZIPF_A = 1.2
"""Zipf skew of fleet sidecar traffic (make_fleet_traffic): namespace
index drawn as `(zipf(a=1.2) - 1) mod n_namespaces`, i.e. P(ns k) ∝
the mass the Zipf tail folds onto k — ns0 is the hot head (P(rank 1)
= 1/ζ(1.2) ≈ 18% of draws, plus whatever tail mass the mod folds
back), with a long informative tail. Rule namespaces are sized with
a=1.1 (_fleet_ns_assignment); traffic skew deliberately does NOT
match rule skew — hot traffic landing on namespaces of every size is
what makes shard occupancy a real measurement."""


def make_fleet_traffic(n_requests: int, n_rules: int,
                       n_namespaces: int, seed: int = 0,
                       zipf_a: float = FLEET_ZIPF_A,
                       sidecar_ids: int = 20_000) -> list[dict]:
    """Zipf-skewed sidecar Check() traffic against a make_fleet_rules
    world: each request carries a sidecar identity drawn uniformly
    from a `sidecar_ids`-wide id space (`source.user` = sidecar{i}),
    and picks a namespace by Zipf rank (see FLEET_ZIPF_A), then a
    uniform rule within it, addressing that rule's own service — so
    predicates actually fire and deny/whitelist rules exercise their
    device lowerings. ~10% of rows carry a `locked{...}` source
    namespace (the k<2 rules' not-matched branch) and ~10% a
    namespace no rule knows (global rules only). Fully reproducible
    for one (n_rules, n_namespaces, seed, zipf_a, sidecar_ids)."""
    ns_of = _fleet_ns_assignment(n_rules, n_namespaces, seed)
    by_ns: dict[int, list[int]] = {}
    for i, k in enumerate(ns_of):
        by_ns.setdefault(int(k), []).append(i)
    rng = np.random.default_rng(seed + 1)
    out = []
    for j in range(n_requests):
        ns_rank = int((rng.zipf(zipf_a) - 1) % n_namespaces)
        roll = rng.random()
        if roll < 0.10 or ns_rank not in by_ns:
            # unknown-namespace traffic: only global rules can apply
            d = {"destination.service":
                 f"ghost{j % 251}.void{ns_rank}.svc.cluster.local"}
            ridx = None
        else:
            rules = by_ns[ns_rank]
            ridx = rules[int(rng.integers(len(rules)))]
            d = {"destination.service":
                 f"svc{ridx}.ns{ns_rank}.svc.cluster.local"}
        locked = rng.random() < 0.10
        d.update({
            "source.namespace":
                f"locked{(j if ridx is None else ridx) % 5}" if locked
                else f"team{int(rng.integers(40))}",
            "source.user": f"sidecar{int(rng.integers(sidecar_ids))}",
            "request.method": "GET" if rng.random() < 0.8 else "POST",
            "connection.mtls": bool(rng.random() < 0.8),
            "request.path": f"/api/v{j % 3}/items",
        })
        out.append(d)
    return out


def make_route_world(n_routes: int = 1000, n_services: int | None = None,
                     seed: int = 3):
    """Synthetic mesh routing world for the route-NFA bench: services
    with v1alpha1 route rules mixing URI prefix/regex, header exact
    matches, and source-label constraints (the VirtualService diet
    route.go compiles)."""
    from istio_tpu_torch.pilot.model import (Config, ConfigMeta, Port, Service)

    rng = np.random.default_rng(seed)
    n_services = n_services or max(8, n_routes // 10)
    services = [Service(hostname=f"svc{i}.default.svc.cluster.local",
                        address=f"10.2.{i // 250}.{i % 250}",
                        ports=(Port("http", 9080, "HTTP"),))
                for i in range(n_services)]
    rules_by_host: dict = {}
    for r in range(n_routes):
        svc = services[int(rng.integers(n_services))]
        kind = int(rng.integers(4))
        match: dict = {"request": {"headers": {}}}
        headers = match["request"]["headers"]
        if kind == 0:
            headers["uri"] = {"prefix": f"/api/v{r % 7}/"}
        elif kind == 1:
            headers["uri"] = {"regex": f"^/items/[0-9]+/r{r % 11}$"}
        elif kind == 2:
            headers["cookie"] = {"exact": f"user=group{r % 13}"}
        else:
            headers["uri"] = {"prefix": f"/svc/{r % 17}/"}
            match["source"] = (f"svc{int(rng.integers(n_services))}"
                               ".default.svc.cluster.local")
        cfg = Config(ConfigMeta(type="route-rule", name=f"rr{r}",
                                namespace="default"),
                     {"destination": {"name": svc.hostname.split(".")[0]},
                      "precedence": int(rng.integers(4)),
                      "match": match,
                      "route": [{"labels": {"version": "v1"}}]})
        rules_by_host.setdefault(svc.hostname, []).append(cfg)
    return services, rules_by_host


def make_discovery_world(n_services: int = 48, n_namespaces: int = 8,
                         replicas: int = 3,
                         n_routes: int | None = None,
                         source_ns: int = 2, seed: int = 0):
    """Discovery-plane fleet world (the PR 9 Zipf fleet harness applied
    to Pilot): `n_services` services Zipf-assigned over `n_namespaces`
    namespaces (_fleet_ns_assignment — real namespace skew, a few big
    app namespaces and a long tail), each namespace's services sharing
    a PER-NAMESPACE http port (8000+k — per-namespace apps on their own
    ports is what makes RDS genuinely namespace-scoped: one-namespace
    churn touches one port's route configs), each service running
    `replicas` sidecar-fronted instances at distinct IPs. Route rules
    mix URI prefix/regex, header exact and presence matchers (the
    VirtualService diet), and services in the first `source_ns`
    namespaces additionally carry source-constrained rules — the part
    of generation that is per-node and rides the batched
    RouteScopeProgram device step; every other namespace's sidecars
    collapse to ONE shared RDS config per port.

    → (registry, store, nodes, meta): `nodes` are sidecar node-id
    strings (`sidecar~ip~id~domain`), meta carries ns_ports /
    nodes_by_ns / rules_by_ns for churn targeting. Build the world
    BEFORE constructing the DiscoveryService — store/registry events
    fire per mutation."""
    from istio_tpu_torch.pilot.model import (Config, ConfigMeta,
                                       MemoryConfigStore, Port,
                                       Service)
    from istio_tpu_torch.pilot.registry import MemoryRegistry

    rng = np.random.default_rng(seed)
    ns_of = _fleet_ns_assignment(n_services, n_namespaces, seed)
    registry = MemoryRegistry()
    store = MemoryConfigStore()
    nodes: list[str] = []
    nodes_by_ns: dict[int, list[str]] = {}
    hosts_by_ns: dict[int, list[str]] = {}
    node_idx = 0
    for i in range(n_services):
        k = int(ns_of[i])
        ns = f"ns{k}"
        host = f"svc{i}.{ns}.svc.cluster.local"
        port = Port("http", 8000 + k, "HTTP")
        endpoints = []
        for r in range(replicas):
            ip = (f"10.{8 + (node_idx >> 14)}."
                  f"{(node_idx >> 7) & 127}.{node_idx & 127}")
            endpoints.append((ip, {"version": f"v{r}"}))
            node = f"sidecar~{ip}~svc{i}-{r}.{ns}~cluster.local"
            nodes.append(node)
            nodes_by_ns.setdefault(k, []).append(node)
            node_idx += 1
        registry.add_service(
            Service(hostname=host,
                    address=f"10.3.{i // 250}.{i % 250}",
                    ports=(port,)),
            endpoints)
        hosts_by_ns.setdefault(k, []).append(host)
    n_routes = n_routes if n_routes is not None else n_services
    rules_by_ns: dict[int, list[str]] = {}
    for j in range(n_routes):
        i = int(rng.integers(n_services))
        k = int(ns_of[i])
        ns = f"ns{k}"
        host = f"svc{i}.{ns}.svc.cluster.local"
        kind = j % 4
        headers: dict = {}
        if kind == 0:
            headers["uri"] = {"prefix": f"/api/v{j % 7}/"}
        elif kind == 1:
            headers["uri"] = {"regex": f"^/items/[0-9]+/r{j % 11}$"}
        elif kind == 2:
            headers["cookie"] = {"exact": f"user=group{j % 13}"}
        else:
            headers["uri"] = {"prefix": f"/svc/{j % 17}/"}
            headers["x-debug"] = {"presence": True}
        match: dict = {"request": {"headers": headers}}
        if k < source_ns and j % 2 == 0:
            peers = hosts_by_ns[k]
            match["source"] = peers[(j * 7) % len(peers)]
        name = f"dr{j}"
        store.create(Config(
            ConfigMeta(type="route-rule", name=name, namespace=ns),
            {"destination": {"service": host},
             "precedence": int(rng.integers(4)),
             "match": match,
             "route": [{"labels": {"version": f"v{j % replicas}"}}]}))
        rules_by_ns.setdefault(k, []).append(name)
    meta = {
        "n_sidecars": len(nodes),
        "ns_ports": {k: 8000 + k for k in range(n_namespaces)},
        "ns_of": [int(x) for x in ns_of],
        "nodes_by_ns": nodes_by_ns,
        "hosts_by_ns": hosts_by_ns,
        "rules_by_ns": rules_by_ns,
        "source_ns": source_ns,
        "n_routes": n_routes,
    }
    return registry, store, nodes, meta


def churn_discovery_rule(store, meta: dict, ns_index: int,
                         tick: int) -> str:
    """One-namespace churn unit: bump one existing route rule's
    timeout in namespace `ns_index` (store.update fires the change
    event → scoped publish). Returns the rule name."""
    from istio_tpu_torch.pilot.model import Config

    names = meta["rules_by_ns"].get(ns_index)
    if not names:
        raise ValueError(f"namespace ns{ns_index} has no route rules "
                         f"to churn")
    name = names[tick % len(names)]
    cfg = store.get("route-rule", name, f"ns{ns_index}")
    spec = dict(cfg.spec)
    spec["httpReqTimeout"] = {
        "simpleTimeout": {"timeout": f"{10 + tick}s"}}
    store.update(Config(cfg.meta, spec))
    return name


def make_route_requests(batch: int, n_services: int | None = None,
                        seed: int = 4) -> list[dict]:
    """Route-manifest-shaped requests (destination.service +
    request.path/headers + source.service)."""
    rng = np.random.default_rng(seed)
    n_services = n_services or 100
    out = []
    for i in range(batch):
        out.append({
            "destination.service": f"svc{int(rng.integers(n_services))}"
                                   ".default.svc.cluster.local",
            "request.path": f"/api/v{int(rng.integers(9))}/x{i}"
            if i % 2 == 0 else f"/items/{int(rng.integers(1e6))}/r3",
            "request.headers": {"cookie":
                                f"user=group{int(rng.integers(15))}"},
            "source.service": f"svc{int(rng.integers(n_services))}"
                              ".default.svc.cluster.local",
        })
    return out


# ---------------------------------------------------------------------------
# long subjects for sequence-parallel DFA matching (parallel/seq_match.py)
# ---------------------------------------------------------------------------

LONG_NEEDLE = b"needle-42"
# the patterns tests/test_parallel.py matches over long subjects: a needle
# anywhere, an anchored first byte, an anchored tail
LONG_PATTERNS = ("needle-[0-9]+", "^[a-z]", "xyzzy$")


def make_long_subjects(n_rows: int, n_chunks: int, chunk: int,
                       seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Long lowercase subjects for a chunked DFA match → (data uint8
    [n_rows, n_chunks * chunk], lens int32 [n_rows]); reshape data to
    [n_rows, n_chunks, chunk] for a sharded match. Rows cycle through
    the cases of tests/test_parallel.py:56-69: the needle inside one
    chunk, across a chunk seam, absent, at the very end, and at the end
    of a row whose length stops 40 bytes short (a short tail that cuts
    the needle off). Lengths are the full row except for the short
    tails."""
    rng = np.random.default_rng(seed)
    total = n_chunks * chunk
    n = len(LONG_NEEDLE)
    if total < n + 40:
        raise ValueError(f"rows of {total} bytes are too short")
    data = rng.integers(97, 123, (n_rows, total), dtype=np.uint8)
    lens = np.full(n_rows, total, np.int32)
    needle = np.frombuffer(LONG_NEEDLE, np.uint8)
    for i in range(n_rows):
        kind = i % 5
        if kind == 0:                         # inside one chunk
            c = int(rng.integers(n_chunks))
            at = c * chunk + int(rng.integers(max(chunk - n, 0) + 1))
            at = min(at, total - n)
        elif kind == 1 and n_chunks > 1:      # straddles a chunk seam
            at = int(rng.integers(1, n_chunks)) * chunk - n // 2
        elif kind in (3, 4):                  # at the very end
            at = total - n
        else:                                 # absent
            continue
        data[i, at:at + n] = needle
        if kind == 4:
            lens[i] = total - 40
    return data, lens
