"""Content digests of config (port of the host half of
istio_tpu/compiler/cache.py that the snapshot builder and the sharded
serving plane call).

`stable_digest` and `manifest_digest` are the reference's: the
deterministic hashes the sharding plane keys its content-addressed bank
cache on (sharding/banks.bank_content_key). The
reference's `DecompCache` (a host memo of parse + DNF decomposition
across compiles) and its XLA compile-cache setup are not carried:
`compile_ruleset` accepts a `decomp_cache` argument and ignores it
(ROADMAP.md).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any


def stable_digest(obj: Any) -> str:
    """sha256 of the canonical-JSON rendering of `obj` — deterministic
    across processes and PYTHONHASHSEED (sorted keys, no whitespace,
    default=str for the odd non-JSON leaf)."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()



def manifest_digest(finder) -> str:
    """Digest of an AttributeDescriptorFinder's vocabulary — the
    (name, value type) set every type-check and lowering decision
    depends on. Two finders with equal digests make identical
    eval_type / tier-classification decisions for any expression."""
    items = sorted((n, getattr(finder.get_attribute(n), "name",
                               str(finder.get_attribute(n))))
                   for n in finder.names())
    return stable_digest(items)
