"""Value types of the policy expression system.

Mirrors the semantics of istio.io/api ValueType as used by the reference
(mixer/pkg/il/types.go, mixer/pkg/expr/expr.go:71-76): eleven wire types.
Runtime Python representations:

  STRING / DNS_NAME / EMAIL_ADDRESS / URI  -> str
  INT64      -> int
  DOUBLE     -> float
  BOOL       -> bool
  TIMESTAMP  -> datetime.datetime (tz-aware, UTC)
  DURATION   -> datetime.timedelta
  IP_ADDRESS -> bytes (4 or 16 bytes, like Go net.IP)
  STRING_MAP -> Mapping[str, str]
"""
from __future__ import annotations

import datetime
import enum
import re


class ValueType(enum.Enum):
    UNSPECIFIED = 0
    STRING = 1
    INT64 = 2
    DOUBLE = 3
    BOOL = 4
    TIMESTAMP = 5
    IP_ADDRESS = 6
    EMAIL_ADDRESS = 7
    URI = 8
    DNS_NAME = 9
    DURATION = 10
    STRING_MAP = 11

    def __str__(self) -> str:
        return self.name


# Types whose runtime representation is a plain Python string.
STRINGY = frozenset({ValueType.STRING, ValueType.EMAIL_ADDRESS,
                     ValueType.URI, ValueType.DNS_NAME})

_GO_DURATION_RE = re.compile(
    r"([0-9]*\.?[0-9]+)(ns|us|µs|μs|ms|s|m|h)")
_GO_UNIT_NS = {
    "ns": 1, "us": 1_000, "µs": 1_000, "μs": 1_000,
    "ms": 1_000_000, "s": 1_000_000_000, "m": 60_000_000_000,
    "h": 3_600_000_000_000,
}


def parse_go_duration(s: str) -> datetime.timedelta:
    """Parse a Go-syntax duration ("300ms", "1h30m", "-2.5s", "0").

    Matches time.ParseDuration semantics, which the reference applies to
    every string literal to decide STRING vs DURATION constants
    (mixer/pkg/expr/expr.go:143-146).
    """
    orig = s
    if not s:
        raise ValueError("empty duration")
    sign = 1
    if s[0] in "+-":
        sign = -1 if s[0] == "-" else 1
        s = s[1:]
    if not s:
        raise ValueError(f"invalid duration {orig!r}")
    if s == "0":
        return datetime.timedelta(0)
    total_ns = 0.0
    pos = 0
    while pos < len(s):
        m = _GO_DURATION_RE.match(s, pos)
        if m is None or m.start() != pos:
            raise ValueError(f"invalid duration {orig!r}")
        total_ns += float(m.group(1)) * _GO_UNIT_NS[m.group(2)]
        pos = m.end()
    return datetime.timedelta(microseconds=sign * total_ns / 1000.0)


def format_go_duration(td: datetime.timedelta) -> str:
    """Format timedelta in Go duration style (for debug output)."""
    ns = int(td.total_seconds() * 1e9)
    if ns == 0:
        return "0s"
    sign = "-" if ns < 0 else ""
    ns = abs(ns)
    parts = []
    for unit, width in (("h", 3_600_000_000_000), ("m", 60_000_000_000)):
        if ns >= width:
            parts.append(f"{ns // width}{unit}")
            ns %= width
    if ns or not parts:
        sec = ns / 1e9
        txt = f"{sec:.9f}".rstrip("0").rstrip(".")
        parts.append(f"{txt}s")
    return sign + "".join(parts)


def parse_rfc3339(s: str) -> datetime.datetime:
    """RFC3339 timestamp parse (the `timestamp()` extern format,
    mixer/pkg/il/runtime/externs.go:95-102)."""
    txt = s.replace("Z", "+00:00")
    dt = datetime.datetime.fromisoformat(txt)
    if dt.tzinfo is None:
        raise ValueError(f"timestamp {s!r} missing timezone")
    return dt


def parse_ip(s: str) -> bytes:
    """Parse dotted-quad / ipv6 text to bytes (the `ip()` extern,
    externs.go:81-86). Returns 4 or 16 bytes."""
    import ipaddress
    return ipaddress.ip_address(s).packed


def ip_equal(a: bytes, b: bytes) -> bool:
    """Compare IPs like Go net.IP.Equal: a 4-byte v4 equals its 16-byte
    v4-in-v6 form (externs.go:88-93)."""
    if len(a) == len(b):
        return a == b
    import ipaddress

    def canon(raw: bytes):
        addr = ipaddress.ip_address(raw)
        # python's IPv6Address never equals an IPv4Address, even for
        # the ::ffff:a.b.c.d mapped form Go's net.IP.Equal accepts —
        # unmap before comparing
        mapped = getattr(addr, "ipv4_mapped", None)
        return mapped if mapped is not None else addr

    try:
        return canon(a) == canon(b)
    except ValueError:
        return False


def type_of_value(v: object) -> ValueType:
    """Infer the ValueType of a runtime Python value."""
    if isinstance(v, bool):
        return ValueType.BOOL
    if isinstance(v, int):
        return ValueType.INT64
    if isinstance(v, float):
        return ValueType.DOUBLE
    if isinstance(v, str):
        return ValueType.STRING
    if isinstance(v, bytes):
        return ValueType.IP_ADDRESS
    if isinstance(v, datetime.timedelta):
        return ValueType.DURATION
    if isinstance(v, datetime.datetime):
        return ValueType.TIMESTAMP
    if isinstance(v, dict):
        return ValueType.STRING_MAP
    return ValueType.UNSPECIFIED
