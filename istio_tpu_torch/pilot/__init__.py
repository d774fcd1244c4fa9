"""Pilot — the proxy-config control plane (port of istio_tpu/pilot/): the
abstract service/routing model, the registries, the route and Envoy v1
config builders, versioned discovery snapshots and the v1 REST discovery
service (SDS/CDS/RDS/LDS), and the route automaton (route_nfa.py) whose
header/URI matches compile into the same ruleset tensors the policy
engine runs, so L7 route selection for a batch is one device trip.

The platform registries (consul, eureka, cloudfoundry), the sidecar
agent, injection and mesh config are not carried (ROADMAP.md).
"""
from istio_tpu_torch.pilot.model import (Config, ConfigMeta, ConfigStore,
                                         IstioConfigStore, MemoryConfigStore,
                                         NetworkEndpoint, Port, Service,
                                         ServiceInstance, ValidationError)
from istio_tpu_torch.pilot.registry import (AggregateRegistry,
                                            MemoryRegistry,
                                            ServiceDiscovery)

__all__ = ["Config", "ConfigMeta", "ConfigStore", "IstioConfigStore",
           "MemoryConfigStore", "NetworkEndpoint", "Port", "Service",
           "ServiceInstance", "ValidationError", "AggregateRegistry",
           "MemoryRegistry", "ServiceDiscovery"]
