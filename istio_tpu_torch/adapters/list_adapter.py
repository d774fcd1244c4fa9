"""list — white/blacklist membership checks for listentry instances.

Reference: mixer/adapter/list/list.go (1,905 LoC; HandleListEntry :68,
list refresh :115-247). Entry types match the reference's
ListEntryType: STRINGS, CASE_INSENSITIVE_STRINGS, IP_ADDRESSES
(entries are CIDRs or addresses), REGEX. Lists come from `overrides`
config plus an optional refreshing provider; `provider_url` supports
file:// URLs and `provider` is a callable injection seam.

Port of istio_tpu/adapters/list_adapter.py: host code, the reference's
own. `refresh()` is the body of the provider's TTL loop
(list.go:115-247), run every `refresh_interval_s` by the adapter
executor's maintenance lane (runtime/executor.py). A refresh changes
only the entries this handler holds. It never reaches a device list
bank: the fused plan keeps every list with a provider on the host
(runtime/fused._split_list_instances), and the banks it builds from
provider-less lists come from the snapshot's config, never from a
refresh.
"""
from __future__ import annotations

import ipaddress
import re
import threading
import time
from typing import Any, Callable, Mapping
from urllib.parse import urlparse

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (AdapterError, Builder, CheckResult, Env,
                                          Handler, Info)
from istio_tpu_torch.models.policy_engine import NOT_FOUND, OK, PERMISSION_DENIED


class ListHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env):
        self.entry_type = config.get("entry_type", "STRINGS")
        self.blacklist = bool(config.get("blacklist", False))
        self.caching_ttl_s = float(config.get("caching_ttl_s", 300.0))
        self.caching_use_count = int(config.get("caching_use_count", 10_000))
        self._env = env
        self._lock = threading.Lock()
        self._provider: Callable[[], list[str]] | None = \
            config.get("provider")
        url = config.get("provider_url", "")
        if url and self._provider is None:
            parsed = urlparse(url)
            if parsed.scheme != "file":
                raise AdapterError(
                    "only file:// provider_url supported (no egress); "
                    "inject `provider` for other sources")
            path = parsed.path
            self._provider = lambda: [
                ln.strip() for ln in open(path, encoding="utf-8")
                if ln.strip()]
        self._base_overrides = tuple(config.get("overrides", ()))
        # a provider that starts failing keeps the LAST GOOD list
        # serving: these counts and the last refresh's age are the only
        # signal of it
        self.refresh_failures = 0
        self.last_refresh_wall: float | None = None
        self.last_refresh_error: str | None = None
        self._set_entries(list(self._base_overrides) +
                          (self._provider() if self._provider else []))
        if self._provider is not None:
            self.last_refresh_wall = time.time()
        self.refresh_interval_s = float(
            config.get("refresh_interval_s", 60.0))

    def refresh(self) -> None:
        """Pull the provider's list again. A failing provider never
        replaces the last good list: the pull comes before
        _set_entries, and the failure is counted and raised, so the
        maintenance lane's counters move."""
        if self._provider is None:
            return
        try:
            entries = self._provider()
        except Exception as exc:
            with self._lock:
                self.refresh_failures += 1
                self.last_refresh_error = f"{type(exc).__name__}: {exc}"
            raise
        self._set_entries(list(self._base_overrides) + list(entries))
        with self._lock:
            self.last_refresh_wall = time.time()
            self.last_refresh_error = None

    def refresh_stats(self) -> dict:
        """The provider's freshness."""
        with self._lock:
            last = self.last_refresh_wall
            return {
                "provider": self._provider is not None,
                "entries": len(self.config_overrides),
                "refresh_failures": self.refresh_failures,
                "last_refresh_age_s":
                    round(time.time() - last, 3) if last is not None
                    else None,
                "last_refresh_error": self.last_refresh_error,
            }

    def _set_entries(self, entries: list[str]) -> None:
        et = self.entry_type
        with self._lock:
            self.config_overrides = tuple(entries)
            if et == "STRINGS":
                self._strings = frozenset(entries)
            elif et == "CASE_INSENSITIVE_STRINGS":
                self._strings = frozenset(e.lower() for e in entries)
            elif et == "IP_ADDRESSES":
                self._nets = [ipaddress.ip_network(e, strict=False)
                              for e in entries]
            elif et == "REGEX":
                self._regexes = [re.compile(e) for e in entries]
            else:
                raise AdapterError(f"unknown entry_type {et}")

    def _member(self, value: str) -> bool:
        et = self.entry_type
        with self._lock:
            if et == "STRINGS":
                return value in self._strings
            if et == "CASE_INSENSITIVE_STRINGS":
                return value.lower() in self._strings
            if et == "IP_ADDRESSES":
                try:
                    addr = ipaddress.ip_address(value)
                except ValueError:
                    return False
                return any(addr in net for net in self._nets)
            return any(r.search(value) for r in self._regexes)

    def handle_check(self, template: str,
                     instance: Mapping[str, Any]) -> CheckResult:
        value = instance.get("value")
        if isinstance(value, bytes):
            value = str(ipaddress.ip_address(
                value[-4:] if len(value) == 16 and
                value[:12] == b"\x00" * 10 + b"\xff\xff" else value))
        member = self._member(str(value))
        ok = member != self.blacklist
        return CheckResult(
            status_code=OK if ok else (
                PERMISSION_DENIED if self.blacklist else NOT_FOUND),
            status_message="" if ok else f"{value} rejected",
            valid_duration_s=self.caching_ttl_s,
            valid_use_count=self.caching_use_count)


class ListBuilder(Builder):
    def validate(self) -> list[str]:
        errs = []
        et = self.config.get("entry_type", "STRINGS")
        if et not in ("STRINGS", "CASE_INSENSITIVE_STRINGS",
                      "IP_ADDRESSES", "REGEX"):
            errs.append(f"unknown entry_type {et}")
        if et == "REGEX":
            for e in self.config.get("overrides", ()):
                try:
                    re.compile(e)
                except re.error as exc:
                    errs.append(f"bad regex {e!r}: {exc}")
        if et == "IP_ADDRESSES":
            for e in self.config.get("overrides", ()):
                try:
                    ipaddress.ip_network(e, strict=False)
                except ValueError as exc:
                    errs.append(f"bad CIDR {e!r}: {exc}")
        return errs

    def build(self) -> Handler:
        return ListHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="list",
    supported_templates=("listentry",),
    builder=ListBuilder,
    description="white/blacklist over strings/IP-nets/regex with "
                "refreshable providers"))
