"""Service registries — the ServiceDiscovery contract + backends.

Reference: pilot/pkg/model/service.go:220 ServiceDiscovery iface,
pilot/pkg/serviceregistry/{kube,consul,eureka,cloudfoundry,aggregate}.
This image has no k8s/consul/eureka endpoints, so the concrete
backends are: MemoryRegistry (programmatic; the mock/discovery.go test
backbone and the file-driven topology source) and AggregateRegistry
(fans out queries + change handlers exactly like aggregate/
controller.go). Platform adapters implement the same four queries and
plug into the aggregate — the contract, caching and event flow are the
load-bearing parts reproduced here.

The port's copy of istio_tpu/pilot/registry.py, unchanged but for its
imports: standard library only, nothing of the JAX package.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Mapping, Sequence

from istio_tpu_torch.pilot.model import (NetworkEndpoint, Port, Service,
                                   ServiceInstance)

Handler = Callable[[Service, str], None]


class ServiceDiscovery:
    """service.go:220: Services/GetService/Instances/HostInstances."""

    def services(self) -> list[Service]:
        raise NotImplementedError

    def get_service(self, hostname: str) -> Service | None:
        raise NotImplementedError

    def instances(self, hostname: str, ports: Sequence[str] = (),
                  labels: Mapping[str, str] | None = None
                  ) -> list[ServiceInstance]:
        raise NotImplementedError

    def host_instances(self, addrs: set[str]) -> list[ServiceInstance]:
        """Instances co-located with a proxy's addresses."""
        raise NotImplementedError

    def get_istio_service_accounts(self, hostname: str,
                                   ports: Sequence[str]) -> list[str]:
        return []


class MemoryRegistry(ServiceDiscovery):
    """Programmatic registry (reference mock/discovery.go role)."""

    def __init__(self) -> None:
        self._services: dict[str, Service] = {}
        self._instances: dict[str, list[ServiceInstance]] = {}
        self._lock = threading.Lock()
        self._svc_handlers: list[Handler] = []

    # -- mutation --

    def add_service(self, service: Service,
                    endpoints: Iterable[tuple] = ()) -> None:
        """Register a service; endpoints = (address, labels) pairs or
        (address, labels, availability_zone) triples, one instance per
        (endpoint, service port)."""
        with self._lock:
            self._services[service.hostname] = service
            insts = []
            for ep in endpoints:
                addr, labels = ep[0], ep[1]
                az = ep[2] if len(ep) > 2 else ""
                for port in service.ports:
                    insts.append(ServiceInstance(
                        endpoint=NetworkEndpoint(address=addr,
                                                 port=port.port,
                                                 service_port=port),
                        service=service, labels=dict(labels),
                        availability_zone=az,
                        service_account=service.service_account))
            self._instances[service.hostname] = insts
        for fn in list(self._svc_handlers):
            fn(service, "add")

    def remove_service(self, hostname: str) -> None:
        with self._lock:
            svc = self._services.pop(hostname, None)
            self._instances.pop(hostname, None)
        if svc is not None:
            for fn in list(self._svc_handlers):
                fn(svc, "delete")

    # -- ServiceDiscovery --

    def services(self) -> list[Service]:
        with self._lock:
            return sorted(self._services.values(),
                          key=lambda s: s.hostname)

    def get_service(self, hostname: str) -> Service | None:
        with self._lock:
            return self._services.get(hostname)

    def instances(self, hostname, ports=(), labels=None):
        with self._lock:
            out = []
            for inst in self._instances.get(hostname, []):
                if ports and inst.endpoint.service_port.name not in ports:
                    continue
                if labels and any(inst.labels.get(k) != v
                                  for k, v in labels.items()):
                    continue
                out.append(inst)
            return out

    def host_instances(self, addrs: set[str]) -> list[ServiceInstance]:
        with self._lock:
            return [i for insts in self._instances.values()
                    for i in insts if i.endpoint.address in addrs]

    # -- ConfigStoreCache-style handlers (kube controller.go role) --

    def append_service_handler(self, fn: Handler) -> None:
        self._svc_handlers.append(fn)


class AggregateRegistry(ServiceDiscovery):
    """serviceregistry/aggregate/controller.go: merge registries."""

    def __init__(self, registries: Sequence[ServiceDiscovery] = ()):
        self.registries = list(registries)

    def add_registry(self, registry: ServiceDiscovery) -> None:
        self.registries.append(registry)

    def services(self) -> list[Service]:
        seen: dict[str, Service] = {}
        for r in self.registries:
            for s in r.services():
                seen.setdefault(s.hostname, s)
        return sorted(seen.values(), key=lambda s: s.hostname)

    def get_service(self, hostname: str) -> Service | None:
        for r in self.registries:
            s = r.get_service(hostname)
            if s is not None:
                return s
        return None

    def instances(self, hostname, ports=(), labels=None):
        out = []
        for r in self.registries:
            out.extend(r.instances(hostname, ports, labels))
        return out

    def host_instances(self, addrs: set[str]) -> list[ServiceInstance]:
        out = []
        for r in self.registries:
            out.extend(r.host_instances(addrs))
        return out

    def append_service_handler(self, fn: Handler) -> None:
        for r in self.registries:
            if hasattr(r, "append_service_handler"):
                r.append_service_handler(fn)
