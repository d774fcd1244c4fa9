"""Batch layout, value interning, and tensorization.

The data model for attribute bags (SURVEY.md §2.2 translation note):
the wire protocol already dictionary-codes attribute names and string
values as int32 indices, so a batch of requests tensorizes naturally into
dense int32 arrays.

Key design decision — IDENTITY SEMANTICS: the expression language has
no arithmetic over attribute values (intrinsics: EQ/NEQ/OR/LOR/LAND/
INDEX plus the ordered comparisons, reference func.go:39-72), so every
non-boolean scalar value is interned into one opaque int32 id space and
equality becomes id comparison. Byte tensors serve string slots
consumed by byte-level predicates (glob/regex/prefix/suffix) AND
ordered comparisons: numeric slots (INT64/DOUBLE/DURATION/TIMESTAMP)
store an 8-byte ORDER-PRESERVING key (sign-flipped big-endian; IEEE
bit-trick for doubles), so `<`/`>` lower to the same lexicographic
byte compare as strings (bytes_ops.lex_cmp). IP addresses are
normalized to 16-byte form before interning so `ip_equal` semantics
(v4 == v4-in-v6, externs.go:88) hold under id equality; timestamps and
durations normalize to epoch-/total-nanoseconds.

String-map indexing with CONSTANT keys becomes "derived slots": the
tensorizer extracts ``bag["request.header"]["host"]`` into its own id +
present column, so INDEX costs nothing on device.
"""
from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import Any, Hashable, Mapping, Sequence

import numpy as np
import torch

from istio_tpu_torch.attribute.bag import Bag
from istio_tpu_torch.attribute.types import ValueType

# Reserved intern ids.
ID_INVALID = 0
ID_FALSE = 1
ID_TRUE = 2

DEFAULT_MAX_STR_LEN = 128

# types whose byte slots carry order-preserving keys (BOOL is NOT
# orderable — the oracle raises on it, expr/oracle.py _ordered)
ORDER_KEY_TYPES = frozenset({ValueType.INT64, ValueType.DOUBLE,
                             ValueType.DURATION, ValueType.TIMESTAMP})

_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_I64_FLIP = 0x8000_0000_0000_0000
_U64_MASK = 0xFFFF_FFFF_FFFF_FFFF
# 1-byte marker for a numeric slot whose value could not be encoded
# (wrong wire type): real keys are 8 bytes, NaN is 0 bytes, this is 1
ORDER_KEY_ERROR = b"\x00"


def order_key_bytes(v: Any, vtype: ValueType) -> bytes:
    """8-byte big-endian key whose unsigned lexicographic order equals
    the value order — `<` on device is then bytes_ops.lex_cmp over the
    same planes string predicates use. Returns b"" (present-but-empty =
    undecidable marker) for values with no total-order embedding (NaN:
    every ordered comparison is False in the reference, which no key
    can encode)."""
    import struct

    if vtype == ValueType.INT64:
        if isinstance(v, (str, bytes)):
            raise ValueError("non-numeric INT64 payload")
        return struct.pack(">Q", (int(v) ^ _I64_FLIP) & _U64_MASK)
    if vtype == ValueType.DOUBLE:
        if isinstance(v, (str, bytes)):
            raise ValueError("non-numeric DOUBLE payload")
        d = float(v)
        if d != d:   # NaN
            return b""
        if d == 0.0:
            d = 0.0   # -0.0 == +0.0 must share one key (IEEE order)
        bits = struct.unpack(">Q", struct.pack(">d", d))[0]
        bits = (bits ^ _U64_MASK) if (bits >> 63) else (bits | _I64_FLIP)
        return struct.pack(">Q", bits)
    if vtype == ValueType.DURATION:
        if isinstance(v, (str, bytes)):
            raise ValueError("non-duration payload")
        ns = (v // datetime.timedelta(microseconds=1)) * 1000 \
            if isinstance(v, datetime.timedelta) else int(v)
        return struct.pack(">Q", (ns ^ _I64_FLIP) & _U64_MASK)
    if vtype == ValueType.TIMESTAMP:
        if isinstance(v, datetime.datetime):
            if v.tzinfo is None:
                v = v.replace(tzinfo=datetime.timezone.utc)
            ns = int((v - _EPOCH) // datetime.timedelta(microseconds=1)
                     ) * 1000
        elif isinstance(v, (str, bytes)):
            raise ValueError("non-timestamp payload")
        else:
            ns = int(v)
        return struct.pack(">Q", (ns ^ _I64_FLIP) & _U64_MASK)
    raise ValueError(f"no order key for {vtype}")


def _normalize(value: Any) -> tuple[str, Hashable]:
    """Map a runtime value to its (type_tag, canonical) intern key."""
    if isinstance(value, bool):
        return ("b", value)
    if isinstance(value, int):
        return ("i", value)
    if isinstance(value, float):
        return ("d", value)
    if isinstance(value, str):
        return ("s", value)
    if isinstance(value, bytes):
        if len(value) == 4:  # v4 → v4-in-v6 canonical form (net.IP.Equal)
            value = b"\x00" * 10 + b"\xff\xff" + value
        return ("p", value)
    if isinstance(value, datetime.timedelta):
        return ("D", round(value.total_seconds() * 1e9))
    if isinstance(value, datetime.datetime):
        return ("t", round(value.timestamp() * 1e9))
    raise TypeError(f"cannot intern value of type {type(value)}")


def canonical_bytes(norm: tuple[str, Hashable]) -> bytes:
    """_normalize key → canonical byte encoding (shared with the C++
    JAX package's native shim builds the identical bytes)."""
    import struct
    tag, v = norm
    t = tag.encode()
    if tag == "b":
        return t + (b"\x01" if v else b"\x00")
    if tag in ("i", "D", "t"):
        return t + struct.pack("<q", int(v))
    if tag == "d":
        return t + struct.pack("<d", float(v))
    if tag == "s":
        return t + str(v).encode("utf-8")
    if tag == "p":
        return t + bytes(v)
    raise ValueError(f"unknown intern tag {tag}")


def stable_hash31(value: Any) -> int:
    """Content-stable 31-bit hash of a value (FNV-1a over the canonical
    key bytes, as the reference's Tensorizer computes it). Used for
    quota bucketing: unlike intern/ephemeral ids it never depends on
    encounter order or snapshot, so a key maps to the same bucket for
    the life of the counter window."""
    h = 0x811C9DC5
    for b in canonical_bytes(_normalize(value)):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


class InternTable:
    """Grow-only value ↔ int32-id table for COMPILE-TIME constants
    (bounded by config size; shared across snapshots so constant ids
    stay stable). Runtime-observed values never enter this table — the
    tensorizer assigns them negative per-batch ephemeral ids
    (AttributeBatch.ephemeral_values), so a long-running server's
    memory does not grow with distinct request values. Thread-safe;
    ids are stable for the life of the table."""

    def __init__(self) -> None:
        self._by_key: dict[tuple[str, Hashable], int] = {
            ("b", False): ID_FALSE, ("b", True): ID_TRUE,
        }
        self._values: list[Any] = [None, False, True]
        self._lock = threading.Lock()
        # longest byte-plane CONSTANT any compile using this table has
        # materialized (tensor_expr._compile_bytes). The latency-tier
        # gate (fused.str_tiers) must not narrow batches below it: a
        # constant row sliced to the tier loses real tail bytes, which
        # flips suffix-window verdicts. Grow-only like the table, so
        # conservative across config swaps on a shared table.
        self.max_byte_const_len = 0

    def note_byte_const(self, n: int) -> None:
        with self._lock:
            if n > self.max_byte_const_len:
                self.max_byte_const_len = n

    def intern(self, value: Any) -> int:
        key = _normalize(value)
        with self._lock:
            idx = self._by_key.get(key)
            if idx is None:
                idx = len(self._values)
                self._by_key[key] = idx
                self._values.append(value)
            return idx

    def lookup(self, value: Any) -> int:
        """Id of a value WITHOUT interning; ID_INVALID if unseen."""
        key = _normalize(value)
        with self._lock:
            return self._by_key.get(key, ID_INVALID)

    def reader(self) -> Mapping[tuple[str, Hashable], int]:
        """Lock-free read view for hot loops. Sound because the table
        only ever GROWS (ids are never reassigned or removed) — a
        reader that misses an in-flight insert sees a strict subset,
        which callers must tolerate (the tensorizer does: a missed
        constant becomes a batch ephemeral). This method is the
        contract; do not reach into _by_key directly."""
        return self._by_key

    def value_of(self, idx: int) -> Any:
        if idx < 0:
            raise KeyError(
                f"id {idx} is a per-batch ephemeral id; resolve it via "
                "AttributeBatch.value_of(id, interner)")
        with self._lock:
            return self._values[idx]

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Static slot assignment for a config snapshot.

    scalar slots cover every non-map attribute in the manifest plus one
    derived slot per (map attribute, constant key) pair the compiled
    expressions need. Byte slots exist per string source consumed by a
    byte-level predicate.
    """
    manifest: Mapping[str, ValueType]
    slots: Mapping[str, int]                       # scalar attr → column
    derived_slots: Mapping[tuple[str, str], int]   # (map, key) → column
    map_slots: Mapping[str, int]                   # map attr → map column
    byte_slots: Mapping[Any, int]                  # attr | (map,key) → byte col
    max_str_len: int = DEFAULT_MAX_STR_LEN
    # extern-converted columns: ("ip"|"timestamp", operand-key) → id
    # column. The TENSORIZER runs the conversion at ingest (normalize
    # at the edge — string parsing has no device form) and interns
    # the result; id ID_INVALID with present=True marks a conversion/
    # lookup error (tensor_expr reads it back as err).
    extern_slots: Mapping[tuple[str, str], int] = \
        dataclasses.field(default_factory=dict)
    # operand ASTs per extern slot key (for the tensorizer's oracle)
    extern_defs: Mapping[tuple[str, str], Any] = \
        dataclasses.field(default_factory=dict)

    @property
    def n_columns(self) -> int:
        return (len(self.slots) + len(self.derived_slots)
                + len(self.extern_slots))

    @property
    def n_maps(self) -> int:
        return len(self.map_slots)

    @property
    def n_byte_slots(self) -> int:
        return len(self.byte_slots)

    def slot_of(self, name: str) -> int:
        return self.slots[name]

    def derived_slot_of(self, map_name: str, key: str) -> int:
        return self.derived_slots[(map_name, key)]


def build_layout(manifest: Mapping[str, ValueType],
                 derived_keys: Sequence[tuple[str, str]] = (),
                 byte_sources: Sequence[Any] = (),
                 max_str_len: int = DEFAULT_MAX_STR_LEN,
                 extern_sources: Sequence[tuple[str, str, Any]] = ()
                 ) -> BatchLayout:
    """Assign columns. `derived_keys`, `byte_sources` and
    `extern_sources` ((extern name, operand key, operand AST) triples)
    are collected by the expression/ruleset compilers (a compile →
    layout → recompile fixpoint is avoided by collecting requirements
    in a pre-pass)."""
    slots: dict[str, int] = {}
    map_slots: dict[str, int] = {}
    for name in sorted(manifest):
        if manifest[name] == ValueType.STRING_MAP:
            map_slots[name] = len(map_slots)
        else:
            slots[name] = len(slots)
    derived: dict[tuple[str, str], int] = {}
    col = len(slots)
    for mk in sorted(set(derived_keys)):
        if mk not in derived:
            derived[mk] = col
            col += 1
    externs: dict[tuple[str, str], int] = {}
    defs: dict[tuple[str, str], Any] = {}
    for name, key, ast in sorted(extern_sources,
                                 key=lambda t: (t[0], t[1])):
        k = (name, key)
        if k not in externs:
            externs[k] = col
            defs[k] = ast
            col += 1
    bytes_: dict[Any, int] = {}
    for src in byte_sources:
        if src not in bytes_:
            bytes_[src] = len(bytes_)
    return BatchLayout(manifest=dict(manifest), slots=slots,
                       derived_slots=derived, map_slots=map_slots,
                       byte_slots=dict(bytes_), max_str_len=max_str_len,
                       extern_slots=externs, extern_defs=defs)


_FIELDS = ("ids", "present", "map_present", "str_bytes", "str_lens",
           "hash_ids")


@dataclasses.dataclass
class AttributeBatch:
    """A batch of attribute bags as torch tensors.

    ids        int32 [B, n_columns]   interned value per scalar/derived slot
    present    bool  [B, n_columns]   slot has a value
    map_present bool [B, n_maps]      map attribute itself present
    str_bytes  uint8 [B, n_byte_slots, L]
    str_lens   int32 [B, n_byte_slots]
    """
    ids: Any
    present: Any
    map_present: Any
    str_bytes: Any
    str_lens: Any
    # stable 31-bit content hash per present scalar slot (stable_hash31)
    # — quota bucketing keys on this, not on ids, because ephemeral ids
    # vary with encounter order while a quota window outlives batches
    hash_ids: Any = None
    # host-only: values behind negative ephemeral ids, index (-1 - id).
    # Never moved to the device; id -1-k ↔ entry k.
    ephemeral_values: Any = None

    def value_of(self, vid: int, interner: InternTable) -> Any:
        """Resolve an id from THIS batch: non-negative ids live in the
        compile-time intern table, negative ids in the batch's own
        ephemeral side table."""
        if vid >= 0:
            return interner.value_of(vid)
        return self.ephemeral_values[-1 - vid]

    def to(self, device: str | torch.device) -> "AttributeBatch":
        """Copy to `device`. Host → CUDA goes through pinned staging
        buffers with non_blocking copies, so the transfer is one DMA per
        plane queued on the current stream (torch's pinned allocator
        keeps each staging buffer alive until its copy has run)."""
        dev = torch.device(device)
        if self.ids.device == dev:
            return self
        to_cuda = dev.type == "cuda" and self.ids.device.type == "cpu"

        def move(t: torch.Tensor) -> torch.Tensor:
            if to_cuda:
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)
        return AttributeBatch(
            **{f: move(getattr(self, f)) for f in _FIELDS},
            ephemeral_values=self.ephemeral_values)

    def rows(self, start: int, stop: int) -> "AttributeBatch":
        """Rows [start, stop) of every plane (views; the ephemeral side
        table is shared, ids index it batch-wide)."""
        return AttributeBatch(
            **{f: getattr(self, f)[start:stop] for f in _FIELDS},
            ephemeral_values=self.ephemeral_values)

    @staticmethod
    def cat(parts: "list[AttributeBatch]",
            device: str | torch.device) -> "AttributeBatch":
        """The row concatenation of `parts` (row slices of one batch, in
        order) on `device`."""
        dev = torch.device(device)
        return AttributeBatch(
            **{f: torch.cat([getattr(p, f).to(dev) for p in parts])
               for f in _FIELDS},
            ephemeral_values=parts[0].ephemeral_values)


class Tensorizer:
    """Host-side bag-batch → AttributeBatch conversion.

    Host numpy, byte-identical to the JAX package's Tensorizer; the
    planes come out as CPU torch tensors (AttributeBatch.to moves them
    to the card).
    """

    def __init__(self, layout: BatchLayout, interner: InternTable,
                 hash_slots: Any = None):
        """`hash_slots` selects which columns get the stable content
        hash (quota bucketing): an iterable of column indices, "all",
        or None (none — hashing every cell in Python costs ~10× the
        tensorize itself; only quota key slots need it, and
        PolicyEngine.tensorizer passes exactly those). The plane is
        always present, zero where not hashed."""
        self.layout = layout
        self.interner = interner
        if hash_slots == "all":
            self.hash_slots: frozenset[int] = frozenset(
                range(layout.n_columns))
        else:
            self.hash_slots = frozenset(hash_slots or ())
        # extern-converted columns: operand oracle + converter, built
        # once (layout.extern_defs carries the operand ASTs)
        self._externs: list[tuple[int, Any, Any]] = []
        if layout.extern_slots:
            from istio_tpu_torch.expr.checker import (
                AttributeDescriptorFinder)
            from istio_tpu_torch.expr.externs import (extern_ip,
                                                      extern_timestamp)
            from istio_tpu_torch.expr.oracle import OracleProgram
            finder = AttributeDescriptorFinder(dict(layout.manifest))
            conv = {"ip": extern_ip, "timestamp": extern_timestamp}
            for (name, key), col in layout.extern_slots.items():
                prog = OracleProgram.from_ast(
                    layout.extern_defs[(name, key)], finder)
                self._externs.append((col, prog, conv[name]))

    def tensorize(self, bags: Sequence[Bag]) -> AttributeBatch:
        lay = self.layout
        b = len(bags)
        ncol = lay.n_columns
        ids = np.zeros((b, ncol), dtype=np.int32)
        hash_ids = np.zeros((b, ncol), dtype=np.int32)
        present = np.zeros((b, ncol), dtype=bool)
        map_present = np.zeros((b, max(lay.n_maps, 1)), dtype=bool)
        nbyte = max(lay.n_byte_slots, 1)
        str_bytes = np.zeros((b, nbyte, lay.max_str_len), dtype=np.uint8)
        str_lens = np.zeros((b, nbyte), dtype=np.int32)
        # values unseen at compile time get negative per-batch ids —
        # consistent within the batch (slot-vs-slot EQ still works),
        # never equal to any constant, never retained after the batch
        eph_ids: dict[tuple[str, Hashable], int] = {}
        eph_values: list[Any] = []

        # lock-free constant lookup (see InternTable.reader): a
        # concurrently-added constant we miss simply becomes a batch
        # ephemeral, which this snapshot's programs never compare
        # against anyway
        by_key = self.interner.reader()
        eph_get, eph_set = eph_ids.get, eph_ids.__setitem__

        def rid(v: Any) -> int:
            key = _normalize(v)
            idx = by_key.get(key)
            if idx is not None:
                return idx
            neg = eph_get(key)
            if neg is None:
                neg = -1 - len(eph_values)
                eph_set(key, neg)
                eph_values.append(v)
            return neg

        hash_slots = self.hash_slots
        for i, bag in enumerate(bags):
            for name, col in lay.slots.items():
                v, ok = bag.get(name)
                if not ok:
                    continue
                present[i, col] = True
                ids[i, col] = rid(v)
                if col in hash_slots:
                    hash_ids[i, col] = stable_hash31(v)
            for name, mcol in lay.map_slots.items():
                v, ok = bag.get(name)
                if ok:
                    map_present[i, mcol] = True
            for (mname, key), col in lay.derived_slots.items():
                m, ok = bag.get(mname)
                if ok and isinstance(m, Mapping) and key in m:
                    present[i, col] = True
                    ids[i, col] = rid(m[key])
                    if col in hash_slots:
                        hash_ids[i, col] = stable_hash31(m[key])
            for src, bcol in lay.byte_slots.items():
                raw = self._byte_source_value(bag, src)
                if raw is None:
                    continue
                enc = raw[:lay.max_str_len]
                if enc:
                    str_bytes[i, bcol, :len(enc)] = np.frombuffer(
                        enc, dtype=np.uint8)
                str_lens[i, bcol] = len(enc)
            for col, prog, convert in self._externs:
                # normalize-at-ingest: run the extern over the operand
                # oracle; a lookup or conversion error marks the column
                # present-with-ID_INVALID (read back as err on device —
                # externs are hard contexts, oracle.py)
                try:
                    converted = convert(prog.evaluate(bag))
                except Exception:
                    present[i, col] = True
                    ids[i, col] = ID_INVALID
                    continue
                present[i, col] = True
                ids[i, col] = rid(converted)
                if col in hash_slots:
                    hash_ids[i, col] = stable_hash31(converted)

        planes = {"ids": ids, "present": present,
                  "map_present": map_present, "str_bytes": str_bytes,
                  "str_lens": str_lens, "hash_ids": hash_ids}
        return AttributeBatch(
            **{k: torch.from_numpy(v) for k, v in planes.items()},
            ephemeral_values=eph_values)

    def _byte_source_value(self, bag: Bag, src: Any) -> bytes | None:
        if isinstance(src, tuple):
            mname, key = src
            m, ok = bag.get(mname)
            if ok and isinstance(m, Mapping) and key in m:
                v = m[key]
                return v.encode("utf-8") if isinstance(v, str) else None
            return None
        v, ok = bag.get(src)
        if not ok:
            return None
        vt = self.layout.manifest.get(src)
        if vt is not None and vt in ORDER_KEY_TYPES:
            # numeric slots carry the 8-byte order-preserving key so
            # ordered comparisons ride the SAME lexicographic compare
            # as strings (bytes_ops.lex_cmp). Markers (tensor_expr
            # _compile_cmp): b"" = NaN (compares False, never err);
            # b"\x00" = malformed value (bags are untyped wire data —
            # the oracle raises per row, so the device reads err;
            # raising here would poison the whole batch)
            try:
                return order_key_bytes(v, vt)
            except Exception:
                return ORDER_KEY_ERROR
        if isinstance(v, str):
            return v.encode("utf-8")
        if isinstance(v, (bytes, bytearray)):
            # IP/bytes values ride their raw bytes (CIDR list lowering
            # compares them in v6-mapped space, models/policy_engine)
            return bytes(v)
        return None
