"""Carry the JAX package's compiled state across to the port.

The port imports nothing of `istio_tpu`; these functions take the
reference's objects as plain data (numpy arrays, enums with a `.name`,
dataclass fields) and rebuild the port's counterparts, so a test can
feed the reference's own compiled params, batches and quota state
through the port's step.
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
    pe_attr_mask_bits and pe_rule_ns (models/policy_engine.ref_table)."""
    from istio_tpu_torch.models.policy_engine import ref_table

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
