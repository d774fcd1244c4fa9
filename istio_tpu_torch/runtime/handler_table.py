"""Built-handler lifecycle with signature-based reuse.

Reference: mixer/pkg/runtime/handlerTable.go — across config
generations, a handler whose (adapter, params) signature is unchanged
is REUSED (adapters hold sockets/caches); new signatures are built,
vanished ones closed after the old snapshot drains.

Port of istio_tpu/runtime/handler_table.py: host code, the reference's
own.
"""
from __future__ import annotations

import logging
import threading
from typing import Mapping

from istio_tpu_torch.adapters.registry import adapter_registry, load_inventory
from istio_tpu_torch.adapters.sdk import AdapterError, Env, Handler
from istio_tpu_torch.runtime.config import HandlerConfig, Snapshot

log = logging.getLogger("istio_tpu_torch.runtime.handlers")


class HandlerTable:
    def __init__(self) -> None:
        load_inventory()
        self._lock = threading.Lock()
        self._by_sig: dict[str, Handler] = {}

    def rebuild(self, snapshot: Snapshot
                ) -> tuple[dict[str, Handler], list[Handler]]:
        """Build/reuse handlers for a snapshot. Returns (handler-name →
        Handler, orphans). Orphans are NOT closed here — the caller
        closes them after the old dispatcher drains (the reference's
        cleanupResolver ordering, resolver.go:240-247): requests in
        flight on the previous snapshot may still be using them."""
        out: dict[str, Handler] = {}
        new_sigs: dict[str, Handler] = {}
        with self._lock:
            for qname, hc in snapshot.handlers.items():
                sig = hc.signature
                handler = self._by_sig.get(sig) or new_sigs.get(sig)
                if handler is None:
                    try:
                        handler = self._build(hc, snapshot)
                    except Exception as exc:
                        snapshot.errors.append(
                            f"handler {qname}: build failed: {exc}")
                        continue
                new_sigs[sig] = handler
                out[qname] = handler
            orphans = [h for sig, h in self._by_sig.items()
                       if sig not in new_sigs]
            self._by_sig = new_sigs
        return out, orphans

    @staticmethod
    def close_handlers(handlers: list[Handler]) -> None:
        for h in handlers:
            try:
                h.close()
            except Exception:
                log.exception("handler close failed")

    def _build(self, hc: HandlerConfig, snapshot: Snapshot) -> Handler:
        info = adapter_registry.get(hc.adapter)
        params = dict(hc.params)
        if hc.adapter == "rbac":
            # the reference's rbac adapter runs its own CRD controller
            # (rbac.go:113); here role/binding kinds ride the main store
            params.setdefault("roles", snapshot.roles)
            params.setdefault("bindings", snapshot.bindings)
        builder = info.builder(params, Env(hc.adapter))
        # inferred instance types for this handler's templates
        types: dict[str, Mapping] = {}
        for rule_idx in range(len(snapshot.rules)):
            for action in snapshot.rules[rule_idx].actions:
                if action.handler != f"{hc.name}.{hc.namespace}" \
                        and action.handler != hc.name:
                    continue
                for inst in action.instances:
                    ib = snapshot.instances.get(inst)
                    if ib is not None:
                        types[inst] = ib.inferred
        builder.set_types(types)
        errs = builder.validate()
        if errs:
            raise AdapterError("; ".join(errs))
        return builder.build()

    def close(self) -> None:
        with self._lock:
            handlers = list(self._by_sig.values())
            self._by_sig = {}
        for h in handlers:
            try:
                h.close()
            except Exception:
                log.exception("handler close failed")
