"""Adapter inventory registry (port of istio_tpu/adapters/registry.py;
reference: mixer/pkg/config/adapterInfoRegistry.go + generated
mixer/adapter/inventory.gen.go)."""
from __future__ import annotations

from istio_tpu_torch.adapters.sdk import AdapterError, Info


class AdapterRegistry:
    def __init__(self) -> None:
        self._by_name: dict[str, Info] = {}

    def register(self, info: Info) -> Info:
        if info.name in self._by_name:
            raise AdapterError(f"duplicate adapter: {info.name}")
        self._by_name[info.name] = info
        return info

    def get(self, name: str) -> Info:
        info = self._by_name.get(name)
        if info is None:
            raise AdapterError(f"unknown adapter: {name}")
        return info

    def names(self) -> list[str]:
        return sorted(self._by_name)


adapter_registry = AdapterRegistry()


def load_inventory() -> AdapterRegistry:
    """Import every built-in adapter module (each registers itself)."""
    from istio_tpu_torch.adapters import (circonus, denier,  # noqa
                                          fluentd, kubernetesenv,
                                          list_adapter, memquota, noop,
                                          opa, prometheus_adapter, rbac,
                                          servicecontrol, stackdriver,
                                          statsd, stdio)
    return adapter_registry
