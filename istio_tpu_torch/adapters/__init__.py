"""Adapter SDK + built-in adapter inventory.

Port of istio_tpu/adapters: an adapter declares `Info` (name, supported
templates, builder factory, default config), a `Builder` validated and
built once per distinct (adapter, config) signature, and a `Handler`
receiving template instances per request.

The reference's 14 adapters, all host code: denier, list, memquota,
rbac, noop, stdio, prometheus, statsd, fluentd, opa (with the Rego
evaluator in rego.py), kubernetesenv, circonus, stackdriver and
servicecontrol. The three SaaS-backed ones (circonus, stackdriver,
servicecontrol) keep their final network hop behind an injectable
`transport` seam.
"""
from istio_tpu_torch.adapters.sdk import (AdapterError, AdapterUnavailable,
                                          Builder, CheckResult, Handler,
                                          Info, QuotaArgs, QuotaResult)
from istio_tpu_torch.adapters.registry import adapter_registry

__all__ = ["Info", "Builder", "Handler", "CheckResult", "QuotaArgs",
           "QuotaResult", "AdapterError", "AdapterUnavailable",
           "adapter_registry"]
