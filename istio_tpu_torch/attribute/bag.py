"""Attribute bags — the request-scoped key/value data model.

Role of the reference's mixer/pkg/attribute: `Bag` (bag.go:18) is read-only
lookup; `MutableBag` (mutableBag.go:37) is a parent-chained overlay used to
carry preprocessing output; reference tracking (protoBag.go:117-160) records
which attributes a request's evaluation actually touched so sidecars can
cache Check results keyed on them.
"""
from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping


class Bag:
    """Read-only attribute bag interface."""

    # keep subclasses' __slots__ effective (a slotless base silently
    # re-adds per-instance __dict__ to every wire bag)
    __slots__ = ()

    def get(self, name: str) -> tuple[Any, bool]:
        raise NotImplementedError

    def names(self) -> list[str]:
        raise NotImplementedError

    def done(self) -> None:  # release pooled resources; no-op by default
        pass

    def debug_string(self) -> str:
        parts = []
        for n in sorted(self.names()):
            v, _ = self.get(n)
            parts.append(f"{n:30s}: {v!r}")
        return "\n".join(parts)


class DictBag(Bag):
    """Bag over a plain dict — the FakeBag of the test stack
    (reference: mixer/pkg/il/testing/fakebag.go)."""

    def __init__(self, values: Mapping[str, Any] | None = None):
        self._values = dict(values or {})

    def get(self, name: str) -> tuple[Any, bool]:
        if name in self._values:
            return self._values[name], True
        return None, False

    def names(self) -> list[str]:
        return list(self._values)


class MutableBag(Bag):
    """Mutable overlay chained over an optional parent
    (reference: mutableBag.go:37-118)."""

    def __init__(self, parent: Bag | None = None):
        self.parent = parent if parent is not None else DictBag()
        self._values: dict[str, Any] = {}

    def get(self, name: str) -> tuple[Any, bool]:
        if name in self._values:
            return self._values[name], True
        return self.parent.get(name)

    def names(self) -> list[str]:
        seen = dict.fromkeys(self._values)
        for n in self.parent.names():
            seen.setdefault(n)
        return list(seen)

    def set(self, name: str, value: Any) -> None:
        self._values[name] = value

    def delete(self, name: str) -> None:
        self._values.pop(name, None)

    def reset(self) -> None:
        self._values.clear()

    def preserve_merge(self, *bags: Bag) -> None:
        """Merge without clobbering existing values (reference:
        mutableBag.go:180 PreserveMerge — used to fold preprocessing
        output under the request attributes)."""
        for bag in bags:
            for name in bag.names():
                _, exists = self.get(name)
                if not exists:
                    v, ok = bag.get(name)
                    if ok:
                        self._values[name] = v

    def child(self) -> "MutableBag":
        return MutableBag(parent=self)


# Reference-condition markers, mirroring mixerpb ReferencedAttributes
# Condition (ABSENCE / EXACT / REGEX) used in protoBag.go trackReference.
CONDITION_ABSENCE = "ABSENCE"
CONDITION_EXACT = "EXACT"
CONDITION_REGEX = "REGEX"


class TrackingBag(Bag):
    """Wraps a bag and records every attribute (and string-map key)
    resolution, with presence/absence condition.

    This reproduces ProtoBag's referenced-attribute tracking
    (protoBag.go:117 GetReferencedAttributes, :155 trackReference): the
    snapshot powers client-side Check caching, so exact semantics matter —
    a map-key lookup records "name[key]" and a failed lookup records the
    ABSENCE condition.
    """

    def __init__(self, inner: Bag):
        self.inner = inner
        self._refs: dict[tuple[str, str], str] = {}  # (attr, mapkey) -> condition
        self._lock = threading.Lock()

    def get(self, name: str) -> tuple[Any, bool]:
        v, ok = self.inner.get(name)
        with self._lock:
            self._refs[(name, "")] = CONDITION_EXACT if ok else CONDITION_ABSENCE
        return v, ok

    def track_map_key(self, name: str, key: str, found: bool) -> None:
        with self._lock:
            self._refs[(name, key)] = CONDITION_EXACT if found else CONDITION_ABSENCE

    def names(self) -> list[str]:
        return self.inner.names()

    def referenced(self) -> dict[tuple[str, str], str]:
        with self._lock:
            return dict(self._refs)

    def referenced_names(self) -> list[str]:
        """Flat snapshot in the conformance-corpus format: 'attr' and
        'attr[key]' entries, sorted."""
        with self._lock:
            out = []
            for (attr, key), _cond in self._refs.items():
                out.append(f"{attr}[{key}]" if key else attr)
            return sorted(out)

    def clear_referenced(self) -> None:
        with self._lock:
            self._refs.clear()


def bag_from_mapping(values: Mapping[str, Any]) -> DictBag:
    return DictBag(values)


def merged_names(bags: Iterable[Bag]) -> list[str]:
    seen: dict[str, None] = {}
    for b in bags:
        for n in b.names():
            seen.setdefault(n)
    return list(seen)
