"""Adapter SDK + the host adapters of the served Check() path.

Port of istio_tpu/adapters: an adapter declares `Info` (name, supported
templates, builder factory, default config), a `Builder` validated and
built once per distinct (adapter, config) signature, and a `Handler`
receiving template instances per request. This slice carries denier,
list, memquota, noop, prometheus and rbac; every other adapter of the
reference raises NotPorted when its handler is built (registry.py).
"""
from istio_tpu_torch.adapters.sdk import (AdapterError, AdapterUnavailable,
                                          Builder, CheckResult, Handler,
                                          Info, QuotaArgs, QuotaResult)
from istio_tpu_torch.adapters.registry import adapter_registry

__all__ = ["Info", "Builder", "Handler", "CheckResult", "QuotaArgs",
           "QuotaResult", "AdapterError", "AdapterUnavailable",
           "adapter_registry"]
