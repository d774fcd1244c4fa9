"""Synthetic mesh workloads (port of istio_tpu/testing/workloads.py).

The Check() world of the reference: Bookinfo-style denier + listchecker
rules, authz predicates over source/destination attributes, and
header/URI match clauses (exact, prefix, glob, regex). These copies
produce the same rules and bags as the reference's for the same
arguments; `make_engine` builds the port's PolicyEngine on `device`.
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
