"""opa — policy-engine authorization adapter.

Reference: mixer/adapter/opa (1,470 LoC) embeds the Open Policy Agent
Rego evaluator and asks it `checkMethod` over an `input` document of
the authorization instance (opa.go:217-256). Two policy dialects:

  * **Rego** (reference-compatible): policies containing a `package`
    declaration compile through the native Rego-subset evaluator
    (adapters/rego.py) — the reference's own test policy corpus
    (bucket-admins, service-graph + org-chart) runs unmodified. Config
    keys follow the reference: `policies` (modules), `check_method`
    ("data.<pkg>.<rule>"), `fail_close`.
  * **Expression language** (TPU-native reinterpretation): policies
    without a `package` declaration evaluate in the framework's own
    attribute-expression dialect over the flattened instance — these
    stay compilable to the device ruleset path. Any rule evaluating
    true allows (default-deny).

Instance fields are exposed to expression policies as attributes
(subject.user, action.method, action.properties[...], ...) and to
Rego as the reference's input document {subject: {...},
action: {...}}.

Port of istio_tpu/adapters/opa.py: host code, the reference's own.
"""
from __future__ import annotations

from typing import Any, Mapping

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (AdapterError, Builder,
                                          CheckResult, Env, Handler, Info)
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.attribute.types import ValueType as V
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder,
                                          TypeError_)
from istio_tpu_torch.expr.oracle import EvalError, OracleProgram
from istio_tpu_torch.expr.parser import ParseError
from istio_tpu_torch.models.policy_engine import OK, PERMISSION_DENIED

_POLICY_MANIFEST = {
    "subject.user": V.STRING, "subject.groups": V.STRING,
    "subject.properties": V.STRING_MAP,
    "action.namespace": V.STRING, "action.service": V.STRING,
    "action.method": V.STRING, "action.path": V.STRING,
    "action.properties": V.STRING_MAP,
}


def _flatten(instance: Mapping[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for part in ("subject", "action"):
        sub = instance.get(part, {}) or {}
        for k, v in sub.items():
            if k == "properties":
                out[f"{part}.properties"] = {
                    str(pk): str(pv) for pk, pv in (v or {}).items()}
            else:
                out[f"{part}.{k}"] = v
    return out


def _is_rego(policies) -> bool:
    """Rego modules carry a package declaration (possibly after
    comments); expression-language policies never contain one."""
    import re
    return any(re.search(r"^\s*package\s", p, re.M) for p in policies)


class OpaHandler(Handler):
    def __init__(self, config: Mapping[str, Any]):
        from istio_tpu_torch.adapters.rego import RegoEngine, RegoError
        self.fail_close = bool(config.get("fail_close", True))
        policies = list(config.get("policies", ()))
        self._rego = None
        self._rego_error: str | None = None
        self._rules: list[OracleProgram] = []
        if _is_rego(policies):
            self.check_method = str(config.get("check_method",
                                               "data.mixerauthz.allow"))
            try:
                self._rego = RegoEngine(policies)
            except RegoError as exc:
                # the reference keeps serving with hasConfigError set;
                # every request then routes through handleFailClose
                # (opa.go:205-221 — denied under fail_close, allowed
                # under explicit fail-open)
                self._rego_error = str(exc)
        else:
            finder = AttributeDescriptorFinder(_POLICY_MANIFEST)
            for text in policies:
                self._rules.append(OracleProgram(text, finder))

    def _fail(self, message: str) -> CheckResult:
        if self.fail_close:
            return CheckResult(status_code=PERMISSION_DENIED,
                               status_message=message)
        return CheckResult(status_code=OK, status_message="fail-open")

    def handle_check(self, template: str,
                     instance: Mapping[str, Any]) -> CheckResult:
        if self._rego is not None or self._rego_error is not None:
            return self._check_rego(instance)
        bag = bag_from_mapping(_flatten(instance))
        for prog in self._rules:
            try:
                if prog.evaluate(bag):
                    return CheckResult(status_code=OK)
            except EvalError:
                if self.fail_close:
                    continue   # treat errored rule as no-allow
                return CheckResult(status_code=OK,
                                   status_message="fail-open")
        return CheckResult(status_code=PERMISSION_DENIED,
                           status_message="opa: no policy allowed")

    def _check_rego(self, instance: Mapping[str, Any]) -> CheckResult:
        """opa.go HandleAuthorization: evaluate checkMethod over
        input={action, subject}; non-bool/undefined → fail-close."""
        from istio_tpu_torch.adapters.rego import RegoError
        if self._rego_error is not None:
            # config error → handleFailClose (opa.go:205-215): denied
            # under fail_close (the default), allowed when the
            # operator explicitly configured fail-open
            return self._fail("opa: request was rejected")
        input_doc = {
            "subject": dict(instance.get("subject") or {}),
            "action": dict(instance.get("action") or {}),
        }
        try:
            result = self._rego.query(self.check_method, input_doc)
        except RegoError as exc:
            return self._fail(f"opa: request was rejected. err: {exc}")
        if not isinstance(result, bool):
            return self._fail("opa: request was rejected")
        if not result:
            return CheckResult(status_code=PERMISSION_DENIED,
                               status_message="opa: request was rejected")
        return CheckResult(status_code=OK)


class OpaBuilder(Builder):
    def validate(self) -> list[str]:
        errs: list[str] = []
        policies = list(self.config.get("policies", ()))
        if _is_rego(policies):
            from istio_tpu_torch.adapters.rego import RegoEngine, RegoError
            engine = None
            try:
                engine = RegoEngine(policies)
            except RegoError as exc:
                errs.append(f"Policy: {exc}")
            method = str(self.config.get("check_method",
                                         "data.mixerauthz.allow"))
            parts = method.split(".")
            if parts[0] != "data" or len(parts) < 3:
                errs.append(f"check_method: {method!r} must be "
                            "data.<package>.<rule>")
            elif engine is not None:
                # a typo'd package/rule would otherwise only surface
                # as a runtime deny on every request
                pkg, rule = ".".join(parts[1:-1]), parts[-1]
                mod = engine.modules.get(pkg)
                if mod is None:
                    errs.append(f"check_method: unknown package "
                                f"{pkg!r}")
                elif rule not in mod.rules:
                    errs.append(f"check_method: package {pkg!r} has "
                                f"no rule {rule!r}")
            return errs
        finder = AttributeDescriptorFinder(_POLICY_MANIFEST)
        for text in policies:
            try:
                prog = OracleProgram(text, finder)
                if prog.result_type != V.BOOL:
                    errs.append(f"policy {text!r} is not boolean")
            except (ParseError, TypeError_) as exc:
                errs.append(f"policy {text!r}: {exc}")
        return errs

    def build(self) -> Handler:
        return OpaHandler(self.config)


INFO = adapter_registry.register(Info(
    name="opa",
    supported_templates=("authorization",),
    builder=OpaBuilder,
    description="policy authorization: native Rego-subset evaluator "
                "(reference corpus compatible) or expression-language "
                "policies"))
