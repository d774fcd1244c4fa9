"""rbac — role-based access control over ServiceRole/ServiceRoleBinding.

Reference: mixer/adapter/rbac (1,337 LoC; startController rbac.go:113,
HandleAuthorization :181). Roles grant access rules {services, methods,
paths, constraints}; bindings attach subjects {user, groups,
properties} to roles, both scoped to a namespace. `*` wildcards and
prefix/suffix `*` forms are honored exactly like the reference's
stringMatch. Config kinds arrive via the runtime config store
(ServiceRole/ServiceRoleBinding kinds, see runtime/config.py) instead
of a private k8s watcher — the runtime controller feeds `set_policies`
on snapshot swaps.

This host adapter is the semantics oracle for the fused NFA authz
path: compiler/rbac_lower.py compiles the same roles/bindings into
device pseudo-rule predicates (one row per binding-subject-rolerule
triple, OR-reduced by models/policy_engine.RbacSpec), and
tests/test_rbac_lower.py holds the two paths to field-by-field
agreement. Policies outside the lowerable subset stay here, on the
host overlay (snapshot.rbac_groups[...].lowered == False).

Port of istio_tpu/adapters/rbac.py: host code, the reference's own.
"""
from __future__ import annotations

import threading
from typing import Any, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (Builder, CheckResult, Env, Handler,
                                          Info)
from istio_tpu_torch.models.policy_engine import OK, PERMISSION_DENIED


def _string_match(pattern: str, value: str) -> bool:
    """reference rbac stringMatch: exact, `*`, prefix* or *suffix."""
    if pattern == "*":
        return True
    if pattern.endswith("*"):
        return value.startswith(pattern[:-1])
    if pattern.startswith("*"):
        return value.endswith(pattern[1:])
    return pattern == value


def _any_match(patterns: Sequence[str], value: str) -> bool:
    return not patterns or any(_string_match(p, value) for p in patterns)


class RbacHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env):
        self._lock = threading.Lock()
        self._roles: dict[tuple[str, str], Mapping] = {}
        self._bindings: dict[tuple[str, str], Mapping] = {}
        self.set_policies(config.get("roles", ()),
                          config.get("bindings", ()))
        self.caching_ttl_s = float(config.get("caching_ttl_s", 60.0))

    def set_policies(self, roles: Sequence[Mapping],
                     bindings: Sequence[Mapping]) -> None:
        """Atomic policy swap (controller feed, rbac.go:113 analog)."""
        new_roles = {(r.get("namespace", ""), r["name"]): r for r in roles}
        new_bindings = {(b.get("namespace", ""), b["name"]): b
                        for b in bindings}
        with self._lock:
            self._roles = new_roles
            self._bindings = new_bindings

    def handle_check(self, template: str,
                     instance: Mapping[str, Any]) -> CheckResult:
        subject = instance.get("subject", {}) or {}
        action = instance.get("action", {}) or {}
        namespace = str(action.get("namespace", ""))
        with self._lock:
            roles = dict(self._roles)
            bindings = dict(self._bindings)
        for (ns, name), binding in bindings.items():
            if ns != namespace:
                continue
            if not self._subject_bound(binding, subject):
                continue
            role_name = (binding.get("roleRef", {}) or {}).get("name", "")
            role = roles.get((ns, role_name))
            if role is not None and self._action_allowed(role, action):
                return CheckResult(status_code=OK,
                                   valid_duration_s=self.caching_ttl_s)
        return CheckResult(status_code=PERMISSION_DENIED,
                           status_message="RBAC: permission denied",
                           valid_duration_s=self.caching_ttl_s)

    @staticmethod
    def _subject_bound(binding: Mapping, subject: Mapping) -> bool:
        for s in binding.get("subjects", ()):
            if "user" in s and s["user"] != "*" and \
                    s["user"] != subject.get("user", ""):
                continue
            if "group" in s and s["group"] != "*" and \
                    s["group"] != subject.get("groups", ""):
                continue
            props = s.get("properties", {})
            sprops = subject.get("properties", {}) or {}
            if any(str(sprops.get(k, "")) != str(v)
                   for k, v in props.items()):
                continue
            return True
        return False

    @staticmethod
    def _action_allowed(role: Mapping, action: Mapping) -> bool:
        for rule in role.get("rules", ()):
            if not _any_match(rule.get("services", ()),
                              str(action.get("service", ""))):
                continue
            if not _any_match(rule.get("methods", ()),
                              str(action.get("method", ""))):
                continue
            if not _any_match(rule.get("paths", ()),
                              str(action.get("path", ""))):
                continue
            props = action.get("properties", {}) or {}
            constraints_ok = all(
                str(props.get(c.get("key", ""), "")) in
                [str(v) for v in c.get("values", ())]
                for c in rule.get("constraints", ()))
            if constraints_ok:
                return True
        return False


class RbacBuilder(Builder):
    def validate(self) -> list[str]:
        errs = []
        for r in self.config.get("roles", ()):
            if "name" not in r:
                errs.append("ServiceRole missing name")
        for b in self.config.get("bindings", ()):
            if "name" not in b:
                errs.append("ServiceRoleBinding missing name")
            if not (b.get("roleRef", {}) or {}).get("name"):
                errs.append(f"binding {b.get('name')}: missing roleRef")
        return errs

    def build(self) -> Handler:
        return RbacHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="rbac",
    supported_templates=("authorization",),
    builder=RbacBuilder,
    description="RBAC authz over ServiceRole/ServiceRoleBinding"))
