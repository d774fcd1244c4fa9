"""Carry the JAX package's compiled state across to the port.

The port imports nothing of `istio_tpu`; these functions take the
reference's objects as plain data (numpy arrays, enums with a `.name`,
dataclass fields) and rebuild the port's counterparts, so a test can
feed the reference's own compiled params, batches and quota state
through the port's step, serve the reference's config store, and
continue a reference run's rule telemetry on the port, and rebuild
Pilot's route world and discovery registry and store.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.layout import AttributeBatch
from istio_tpu_torch.device import resolve_device

_BATCH_DTYPES = {"ids": np.int32, "present": bool, "map_present": bool,
                 "str_bytes": np.uint8, "str_lens": np.int32,
                 "hash_ids": np.int32}


def manifest_from_reference(manifest: Mapping[str, Any]
                            ) -> dict[str, ValueType]:
    """attribute name → the port's ValueType of the same name."""
    return {k: ValueType[v.name] for k, v in manifest.items()}


def params_from_reference(params: Mapping[str, Any],
                          device: str | torch.device = "cuda"
                          ) -> dict[str, torch.Tensor]:
    """The reference engine's `params` dict (ruleset index tensors + the
    pe_* banks) → the port's: same keys, int32 / bool / float32 tensors
    on `device`, plus what the port keeps in another form — the
    verdict_fold kernel's per-namespace referenced table, derived from
    pe_attr_mask_bits and pe_rule_ns (models/policy_engine.ref_table),
    and its rule-word tables, derived from pe_rule_ns, pe_deny_mask and
    pe_err_rule_mask (fold_word_tables; the default namespace's id is 0
    in every compiled ruleset)."""
    from istio_tpu_torch.models.policy_engine import (fold_word_tables,
                                                      ref_table)

    dev = resolve_device(device)
    out: dict[str, torch.Tensor] = {}
    for k, v in params.items():
        a = np.array(v)
        if k == "pe_attr_mask_bits":
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        elif a.dtype == np.bool_:
            pass
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        else:
            a = a.astype(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if "pe_attr_mask_bits" in params:
        table = ref_table(np.asarray(params["pe_attr_mask_bits"], np.uint32),
                          np.asarray(params["pe_rule_ns"], np.int32))
        out["pe_ref_table"] = torch.from_numpy(table).to(dev)
    if "pe_deny_mask" in params:
        mask = params.get("pe_err_rule_mask")
        words = fold_word_tables(
            np.asarray(params["pe_rule_ns"], np.int32), 0,
            np.asarray(params["pe_deny_mask"], bool),
            None if mask is None else np.asarray(mask, bool))
        out.update({k: torch.from_numpy(v).to(dev) for k, v in words.items()})
    return out


def specs_from_reference(specs: Any) -> list:
    """The reference engine's action specs (DenySpec, ListEntrySpec of
    any entry_type, RbacSpec, QuotaSpec) → the port's dataclasses of the
    same name and fields. The reference keeps its REGEX and CIDR banks
    as closure constants of its step, not params, so a port engine built
    from these specs rebuilds them; `params_from_reference` carries the
    rest (the pe_rb_* tables among them)."""
    import dataclasses

    from istio_tpu_torch.models import policy_engine

    out = []
    for spec in specs:
        cls = getattr(policy_engine, type(spec).__name__)
        out.append(cls(**{f.name: getattr(spec, f.name)
                          for f in dataclasses.fields(spec)}))
    return out


def batch_from_reference(ab: Any, device: str | torch.device = "cuda"
                         ) -> AttributeBatch:
    """The reference's AttributeBatch (numpy or jax planes) → the
    port's, on `device`."""
    dev = resolve_device(device)
    planes = {f: torch.from_numpy(np.array(getattr(ab, f), dtype=dt))
              for f, dt in _BATCH_DTYPES.items()}
    return AttributeBatch(**planes,
                          ephemeral_values=ab.ephemeral_values).to(dev)


def quota_counts_from_reference(arr: Any,
                                device: str | torch.device = "cuda"
                                ) -> torch.Tensor:
    """The reference's quota counter state int32 [Q, NB] → a tensor."""
    dev = resolve_device(device)
    return torch.from_numpy(np.array(arr, dtype=np.int32)).to(dev)


def store_from_reference(ref_store: Any):
    """The reference's config store → a port MemStore holding the same
    (kind, namespace, name) → spec entries of every kind, the rbac
    adapter's servicerole / servicerolebinding among them (specs are
    plain dicts; a provider callable in a list handler's params is
    carried as is)."""
    from istio_tpu_torch.runtime.store import Event, MemStore

    out = MemStore()
    out.apply_events([Event(key, dict(spec))
                      for key, spec in ref_store.list().items()],
                     notify=False)
    return out


def telemetry_state_from_reference(ref_tel: Any,
                                   device: str | torch.device = "cuda"
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The reference RuleTelemetry's undrained counts → (hit int32
    [S, R], deny int32 [S, R], err int32 [R]) tensors on `device`, each
    its own buffer, so a test can continue a reference run on the port
    (copy them into RuleTelemetry.state()). The host-side planes of
    host-fallback rules are folded in, as the reference's drain does."""
    dev = resolve_device(device)
    ref_tel.wait()
    hit = np.array(ref_tel._acc_hit, np.int64) + ref_tel._host_hit
    deny = np.array(ref_tel._acc_deny, np.int64)
    err = np.array(ref_tel._acc_err, np.int64) + ref_tel._host_err
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (hit, deny, err))


def _service_from_reference(s: Any):
    from istio_tpu_torch.pilot.model import Port, Service
    return Service(hostname=s.hostname, address=s.address,
                   ports=tuple(Port(p.name, p.port, p.protocol)
                               for p in s.ports),
                   external_name=s.external_name,
                   service_account=s.service_account)


def _config_from_reference(c: Any):
    import copy

    from istio_tpu_torch.pilot.model import Config, ConfigMeta
    m = c.meta
    return Config(ConfigMeta(type=m.type, name=m.name,
                             namespace=m.namespace, domain=m.domain,
                             labels=dict(m.labels),
                             annotations=dict(m.annotations),
                             resource_version=m.resource_version),
                  copy.deepcopy(dict(c.spec)))


def pilot_world_from_reference(services: Any, rules_by_host: Any
                               ) -> tuple[list, dict]:
    """The reference's route world (pilot Service list, hostname → route
    rule Configs) → the port's pilot objects, in the same order. The
    route world is the state a RouteTable compiles."""
    return ([_service_from_reference(s) for s in services],
            {h: [_config_from_reference(c) for c in rules]
             for h, rules in rules_by_host.items()})


def discovery_world_from_reference(registry: Any, store: Any
                                   ) -> tuple[Any, Any]:
    """The reference's discovery world (a registry answering services() /
    instances(), a config store answering snapshot()) → a port
    MemoryRegistry and MemoryConfigStore holding the same services,
    instances (endpoint, labels, zone) and configs. Build it before any
    DiscoveryService attaches its handlers."""
    from istio_tpu_torch.pilot.model import MemoryConfigStore
    from istio_tpu_torch.pilot.registry import MemoryRegistry

    reg = MemoryRegistry()
    for s in registry.services():
        endpoints, seen = [], set()
        for inst in registry.instances(s.hostname):
            key = (inst.endpoint.address, inst.availability_zone,
                   tuple(sorted(inst.labels.items())))
            if key not in seen:
                seen.add(key)
                endpoints.append((inst.endpoint.address, dict(inst.labels),
                                  inst.availability_zone))
        reg.add_service(_service_from_reference(s), endpoints)
    out = MemoryConfigStore()
    for _, cfg in sorted(store.snapshot().items()):
        out.create(_config_from_reference(cfg))
    return reg, out
