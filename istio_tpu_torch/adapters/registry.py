"""Adapter inventory registry (port of istio_tpu/adapters/registry.py;
reference: mixer/pkg/config/adapterInfoRegistry.go + generated
mixer/adapter/inventory.gen.go).

This slice carries the host adapters the served worlds name (denier,
list, memquota, noop, prometheus, rbac). The reference's other adapters raise
NotPorted when a handler for them is built, never a config error."""
from __future__ import annotations

from istio_tpu_torch.adapters.sdk import AdapterError, Info
from istio_tpu_torch.device import NotPorted

# adapters of the reference's inventory this slice does not carry
NOT_PORTED = frozenset({"circonus", "fluentd", "kubernetesenv", "opa",
                        "servicecontrol", "stackdriver", "statsd",
                        "stdio"})


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
            if name in NOT_PORTED:
                raise NotPorted(f"adapter {name}")
            raise AdapterError(f"unknown adapter: {name}")
        return info

    def names(self) -> list[str]:
        return sorted(self._by_name)


adapter_registry = AdapterRegistry()


def load_inventory() -> AdapterRegistry:
    """Import every built-in adapter module (each registers itself)."""
    from istio_tpu_torch.adapters import (denier, list_adapter,  # noqa
                                          memquota, noop,
                                          prometheus_adapter, rbac)
    return adapter_registry
